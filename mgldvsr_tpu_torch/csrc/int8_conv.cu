// int8 3x3 convolution with a dynamic per-tensor activation scale and a
// per-output-channel weight scale: the MGLD_INT8_CONV switch's Int8Conv3x3
// (mgldvsr_tpu/models/layers.py:163). It replaces no Pallas kernel: the JAX
// package computes it with XLA's conv_general_dilated on int8 operands. No
// PyTorch call computes an int8 convolution on CUDA, so it is written here.
//
// The function, in the JAX module's order and arithmetic:
//   sx  = max(max|x| over the whole tensor, 1e-6) / 127          (fp32)
//   xq  = clip(rint(float(x) / sx), -127, 127)                   (int8, half to even)
//   acc = sum over taps and channels of xq * kq                  (int32, exact)
//   y   = float(acc) * (sx * sw[co]) + b[co], cast to the output type
// kq and sw (sw = max(max|k[co]|, 1e-12) / 127, from the float32 weight) come
// from the host, re-laid [9][Co][Cp] (tap-major, Cp = C rounded up to 32 with
// zero levels beyond C, which adds nothing to the sums). Every division,
// product and sum below is the correctly rounded one (__fdiv_rn, __fmul_rn,
// __fadd_rn): no fma contraction, so the result is the plain version's bit
// for bit. Never build this file with -use_fast_math.
//
// Two kernels, launched from one host call (mgld_int8_conv3x3_chain) after a
// 4-byte memset of the scratch:
//  * absmax_kernel: max|x| as the bits of a non-negative float, reduced with
//    integer max (order-free, exact) and one atomicMax a block. Bound by
//    bytes: one read of x.
//  * int8_conv_kernel: an implicit GEMM. A block owns TH x TW output pixels by
//    BN output channels and walks K = 9 * Cp in stages of 32 channels; each
//    stage stages the input patch around its tile, quantized on the way into
//    shared memory (the int8 activation is never written to device memory),
//    and the stage's weight rows, then runs mma.sync m16n8k32 (s8 x s8 ->
//    s32) for each of the nine taps: a tap is a pointer offset into the
//    patch. Strides 1 and 2 (the patch is (TH-1)*S+3 by (TW-1)*S+3 pixels).
//    The dequantisation, the bias and the cast are its epilogue. Bound by
//    operations at the shipped widths (2 * 9 * C * Co int8 operations a pixel
//    against 2-4 bytes a channel). A simple kernel: one stage loaded, then
//    computed; wgmma on s8 is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

// element types, as the wrapper numbers them
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2;

constexpr int THREADS = 256;  // 8 warps
constexpr int CK = 32;        // input channels a stage: the K of one m16n8k32
constexpr int WPITCH = 48;    // bytes a weight row in shared memory: conflict-free B loads

// --- max|x| ------------------------------------------------------------------

// |v| as an unsigned key that orders like the value: the sign bit cleared
// (NaN above infinity, as in the float's own bits)
template <typename T> struct AbsKey;
template <> struct AbsKey<float> {
  __device__ static uint32_t word(uint32_t w) { return w & 0x7fffffffu; }
  __device__ static uint32_t elem(float v) { return __float_as_uint(v) & 0x7fffffffu; }
  __device__ static uint32_t to_float_bits(uint32_t k) { return k; }
};
template <> struct AbsKey<__nv_bfloat16> {
  __device__ static uint32_t word(uint32_t w) {
    return max(w & 0x7fffu, (w >> 16) & 0x7fffu);
  }
  __device__ static uint32_t elem(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v) & 0x7fffu;
  }
  __device__ static uint32_t to_float_bits(uint32_t k) { return k << 16; }
};
template <> struct AbsKey<__half> {
  __device__ static uint32_t word(uint32_t w) {
    return max(w & 0x7fffu, (w >> 16) & 0x7fffu);
  }
  __device__ static uint32_t elem(__half v) { return __half_as_ushort(v) & 0x7fffu; }
  __device__ static uint32_t to_float_bits(uint32_t k) {
    return __float_as_uint(__half2float(__ushort_as_half((unsigned short)k)));
  }
};

// amax (one unsigned, zeroed before the launch) <- bits of max|x| over n
// elements. 16-byte loads where x lies on a 16-byte boundary, then the tail.
template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const T* __restrict__ x, int64_t n, unsigned int* __restrict__ amax) {
  constexpr int PER_VEC = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  uint32_t key = 0;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int64_t nvec = vec ? n / PER_VEC : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int64_t i = first; i < nvec; i += stride) {
    const uint4 v = __ldg(xv + i);
    key = max(key, max(max(AbsKey<T>::word(v.x), AbsKey<T>::word(v.y)),
                       max(AbsKey<T>::word(v.z), AbsKey<T>::word(v.w))));
  }
  for (int64_t i = nvec * PER_VEC + first; i < n; i += stride)
    key = max(key, AbsKey<T>::elem(x[i]));
  // float bits of non-negative values order like the values
  uint32_t bits = __reduce_max_sync(0xffffffffu, AbsKey<T>::to_float_bits(key));
  __shared__ uint32_t warp_max[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x < 32) {
    bits = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0u;
    bits = __reduce_max_sync(0xffffffffu, bits);
    if (threadIdx.x == 0 && bits != 0u) atomicMax(amax, bits);
  }
}

// --- the conv kernel ------------------------------------------------------------

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the activation scale of the JAX module: max(amax, 1e-6) / 127, NaN kept
__device__ __forceinline__ float activation_scale(const unsigned int* amax) {
  const float m = __uint_as_float(*amax);
  return __fdiv_rn(m != m ? m : fmaxf(m, 1e-6f), 127.f);
}

__device__ __forceinline__ uint32_t level(float v, float sx) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

__device__ __forceinline__ void store_out(void* out, int out_dtype, int64_t i, float v) {
  if (out_dtype == DT_BF16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else if (out_dtype == DT_F16) static_cast<__half*>(out)[i] = __float2half_rn(v);
  else static_cast<float*>(out)[i] = v;
}

// Block tile: TH x TW output pixels by BN output channels; WM x WN = 8 warps,
// each owning MT m16 tiles of pixels and NT n8 tiles of channels. Grid:
// (pixel tiles, ceil(Co / BN), N). Shared memory: the weights [9][BN][WPITCH]
// then the patch [PH * PW][apitch] (int8; apitch 48 bytes at stride 1 and 40
// at stride 2, each conflict-free for the A fragments of its pixel step).
template <typename T, int TH, int TW, int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const T* __restrict__ x, const unsigned int* __restrict__ amax,
                 const int8_t* __restrict__ wq, const float* __restrict__ sw,
                 const float* __restrict__ bias, void* __restrict__ out, int out_dtype, int C,
                 int Cp, int H, int W, int Co, int Ho, int Wo, int S) {
  constexpr int MT = TH * TW / (16 * WM);
  constexpr int NT = BN / (8 * WN);
  static_assert(WM * WN * 32 == THREADS, "eight warps");
  static_assert(MT * 16 * WM == TH * TW && NT * 8 * WN == BN, "tile split");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Ws = reinterpret_cast<int8_t*>(smem_raw);  // [9][BN][WPITCH]
  int8_t* As = Ws + 9 * BN * WPITCH;                   // [PH * PW][apitch]
  const int PH = (TH - 1) * S + 3, PW = (TW - 1) * S + 3;
  const int apitch = S == 1 ? 48 : 40;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, tg = lane & 3;

  const int tiles_x = (Wo + TW - 1) / TW;
  const int oy0 = (blockIdx.x / tiles_x) * TH, ox0 = (blockIdx.x % tiles_x) * TW;
  const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;  // the patch's corner in x (padding 1)
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const T* x_n = x + (int64_t)n * C * H * W;
  const float sx = activation_scale(amax);

  // patch offsets (in bytes) of this thread's two fragment rows per m tile
  int poff[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + mt) * 16 + g + 8 * hh;
      poff[mt][hh] = ((p / TW) * S * PW + (p % TW) * S) * apitch;
    }

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int64_t plane = (int64_t)H * W;
  for (int c0 = 0; c0 < Cp; c0 += CK) {
    __syncthreads();  // the previous stage is fully consumed
    // the patch, quantized: one task = 4 channels of one pixel, one 4-byte store;
    // neighbouring threads read neighbouring pixels of a channel plane
    for (int task = tid; task < (CK / 4) * PH * PW; task += THREADS) {
      const int pix = task % (PH * PW), quad = task / (PH * PW);
      const int py = pix / PW, px = pix % PW;
      const int gy = iy0 + py, gx = ix0 + px;
      uint32_t word = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int c = c0 + quad * 4;
        const T* src = x_n + (int64_t)c * plane + (int64_t)gy * W + gx;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < C) word |= level(to_f(src[j * plane]), sx) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(As + pix * apitch + quad * 4) = word;
    }
    // the stage's weight rows: 32 contiguous bytes of [9][Co][Cp] a (tap, channel)
    for (int task = tid; task < 9 * BN * 2; task += THREADS) {
      const int half = task & 1, row = task >> 1;
      const int tap = row / BN, col = row % BN, co = co0 + col;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co < Co)
        v = __ldg(reinterpret_cast<const uint4*>(wq + ((int64_t)tap * Co + co) * Cp + c0) + half);
      *reinterpret_cast<uint4*>(Ws + (tap * BN + col) * WPITCH + half * 16) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * PW + (tap % 3)) * apitch;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* p0 = As + poff[mt][0] + toff + tg * 4;
        const int8_t* p1 = As + poff[mt][1] + toff + tg * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p1);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* q = Ws + (tap * BN + (wn * NT + nt) * 8 + g) * WPITCH + tg * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

  // epilogue: float(acc) * (sx * sw) + b, each step rounded once, then the cast
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + mt) * 16 + g + 8 * hh;
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      if (oy >= Ho || ox >= Wo) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + (wn * NT + nt) * 8 + tg * 2 + j;
          if (co >= Co) continue;
          const float s = __fmul_rn(sx, sw[co]);
          const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][hh * 2 + j]), s),
                                    bias[co]);
          store_out(out, out_dtype, (((int64_t)n * Co + co) * Ho + oy) * Wo + ox, y);
        }
    }
}

template <typename T, int TH, int TW, int BN, int WM, int WN>
int launch_conv(const void* x, const void* amax, const void* wq, const void* sw,
                const void* bias, void* out, int out_dtype, int n, int c, int cp, int h,
                int w, int co, int stride, cudaStream_t s) {
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const int ph = (TH - 1) * stride + 3, pw = (TW - 1) * stride + 3;
  const size_t smem = (size_t)9 * BN * WPITCH + (size_t)ph * pw * (stride == 1 ? 48 : 40);
  auto kern = int8_conv_kernel<T, TH, TW, BN, WM, WN>;
  // the largest this instantiation asks for (stride 2)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(9 * BN * WPITCH + ((TH - 1) * 2 + 3) * ((TW - 1) * 2 + 3) * 40));
  if (attr != cudaSuccess) return (int)attr;
  const int64_t tiles = (int64_t)((ho + TH - 1) / TH) * ((wo + TW - 1) / TW);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (co + BN - 1) / BN, n);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const unsigned int*>(amax),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(bias), out, out_dtype, c, cp, h, w, co, ho, wo, stride);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_conv(const void* x, const void* amax, const void* wq, const void* sw,
                  const void* bias, void* out, int out_dtype, int n, int c, int cp, int h, int w,
                  int co, int stride, cudaStream_t s) {
  if (co <= 8)  // the 3-, 4- and 8-channel output convs
    return launch_conv<T, 8, 16, 8, 8, 1>(x, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w,
                                          co, stride, s);
  if (co <= 32)  // the RDB's growth convs
    return launch_conv<T, 8, 16, 32, 8, 1>(x, amax, wq, sw, bias, out, out_dtype, n, c, cp, h,
                                           w, co, stride, s);
  if ((w - 1) / stride + 1 <= 8)  // frames up to 8 pixels wide: 8 x 8 tiles
    return launch_conv<T, 8, 8, 64, 4, 2>(x, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w,
                                          co, stride, s);
  return launch_conv<T, 8, 16, 128, 2, 4>(x, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w,
                                          co, stride, s);
}

int absmax(const void* x, int dtype, long long count, void* amax, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  if (count <= 0) return 0;
  const int per_vec = dtype == DT_F32 ? 4 : 8;
  const long long work = (count + per_vec - 1) / per_vec;
  const long long want = (work + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);  // a grid-stride loop beyond
  auto* a = static_cast<unsigned int*>(amax);
  if (dtype == DT_BF16)
    absmax_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x), count, a);
  else if (dtype == DT_F16)
    absmax_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const __half*>(x), count, a);
  else
    absmax_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const float*>(x), count, a);
  return (int)cudaGetLastError();
}

int conv(const void* x, int dtype, const void* amax, const void* wq, const void* sw,
         const void* bias, void* out, int out_dtype, int n, int c, int cp, int h, int w, int co,
         int stride, cudaStream_t s) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || co <= 0 || n > 65535 || cp % CK != 0 || cp < c ||
      (stride != 1 && stride != 2) || out_dtype < DT_F32 || out_dtype > DT_F16)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return dispatch_conv<__nv_bfloat16>(x, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w,
                                        co, stride, s);
  if (dtype == DT_F16)
    return dispatch_conv<__half>(x, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w, co,
                                 stride, s);
  if (dtype == DT_F32)
    return dispatch_conv<float>(x, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w, co,
                                stride, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// max|x| of `count` elements of type `dtype` (0 f32, 1 bf16, 2 f16) into the
// 4-byte scratch `amax` as a float's bits: a memset, then absmax_kernel.
extern "C" int mgld_int8_absmax(const void* x, int dtype, long long count, void* amax,
                                void* stream) {
  return absmax(x, dtype, count, amax, (cudaStream_t)stream);
}

// The conv kernel alone on a ready `amax`: x [n, c, h, w] of type `dtype`, wq
// the levels re-laid [9][co][cp], sw and bias float32 [co], out [n, co, ho, wo]
// of type `out_dtype`, ho = (h - 1) / stride + 1 (and wo).
extern "C" int mgld_int8_conv3x3(const void* x, int dtype, const void* amax, const void* wq,
                                 const void* sw, const void* bias, void* out, int out_dtype,
                                 int n, int c, int cp, int h, int w, int co, int stride,
                                 void* stream) {
  return conv(x, dtype, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w, co, stride,
              (cudaStream_t)stream);
}

// One conv from one host call: the memset and absmax_kernel into `amax`, then
// the conv kernel on it, all on `stream`.
extern "C" int mgld_int8_conv3x3_chain(const void* x, int dtype, void* amax, const void* wq,
                                       const void* sw, const void* bias, void* out,
                                       int out_dtype, int n, int c, int cp, int h, int w, int co,
                                       int stride, void* stream) {
  auto s = (cudaStream_t)stream;
  const int err = absmax(x, dtype, (long long)n * c * h * w, amax, s);
  if (err) return err;
  return conv(x, dtype, amax, wq, sw, bias, out, out_dtype, n, c, cp, h, w, co, stride, s);
}
