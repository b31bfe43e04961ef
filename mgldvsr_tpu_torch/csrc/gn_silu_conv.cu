// conv3x3(SiLU(GroupNorm(x))) with zero padding 1 and stride 1 in one kernel,
// NCHW input [N, C, H, W], weight [Co, C, 3, 3], output [N, Co, H, W].
// Replaces the TPU kernel mgldvsr_tpu/ops/pallas/gn_silu_conv.py
// (_fused_fwd_impl -> _kernel).
//
// As there, GroupNorm's statistics are taken outside and arrive folded into
// one fp32 (scale, shift) per (frame, channel); the kernel normalises,
// applies SiLU in fp32, rounds to the working type and convolves, so the
// normalised activation never reaches device memory. Zero padding applies to
// the normalised activation: positions outside the frame contribute 0.
//
// Bound on the H100: arithmetic (2 * 9 * C * Co flops per pixel against
// 2 * (C + Co) bytes). The TPU kernel kept a whole frame and a padded copy in
// VMEM and gave up where that did not fit; a block here has 227 KB, so the
// kernel is an implicit GEMM tiled through shared memory and takes every
// shape: M = a TH x TW tile of one frame's pixels, N = BN output channels,
// K = 9 * C walked in stages of CK channels. Per stage the block stores the
// (TH+2) x (TW+2) x CK halo patch of SiLU(x * scale + shift), channel-last,
// and the [9][BN][CK] weights (read as 16-byte vectors of the [Co][C][9]
// layout and transposed in registers, so both the loads and the stores are
// vectors); each of the nine taps is then a GEMM whose A rows are the patch
// shifted by (ky, kx). bf16 and fp16 run on the tensor
// cores through mma.sync m16n8k16 with fp32 accumulators; fp32 runs on the
// FMA units (no TF32: the parity mode needs full fp32). Bias is added in
// fp32 before the one rounding to the output type. One stage is loaded, then
// computed (no pipeline, no wgmma, no TMA): several blocks per SM overlap
// each other's loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int CK = 32;        // input channels per shared-memory stage

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

// Stage the halo patch of channels [c0, c0 + CK) around the tile at (y0, x0):
// As[(py * (TW+2) + px) * CKP + c] = SiLU(x * scale + shift) rounded to T,
// 0 outside the frame and for channels >= C.
template <typename T, int TH, int TW, int CKP>
__device__ __forceinline__ void load_patch(T* __restrict__ As, const T* __restrict__ x_n,
                                           const float* __restrict__ scale_n,
                                           const float* __restrict__ shift_n, int C, int H,
                                           int W, int c0, int y0, int x0) {
  constexpr int PH = TH + 2, PW = TW + 2;
  for (int idx = threadIdx.x; idx < CK * PH * PW; idx += THREADS) {
    const int px = idx % PW;
    const int rest = idx / PW;
    const int py = rest % PH;
    const int cl = rest / PH;
    const int c = c0 + cl, gy = y0 + py - 1, gx = x0 + px - 1;
    float v = 0.f;
    if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float xv = to_f(x_n[((int64_t)c * H + gy) * W + gx]);
      v = fmaf(xv, scale_n[c], shift_n[c]);
      // the result is rounded to 8 or 11 bits below: fast exp and divide there
      if constexpr (sizeof(T) == 2) v = __fdividef(v, 1.f + __expf(-v));
      else v = v / (1.f + expf(-v));
    }
    As[(py * PW + px) * CKP + cl] = from_f<T>(v);
  }
}

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1, __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-bit element ``idx`` of nine 16-byte vectors; ``idx`` is a constant after
// unrolling, so this is a register select and a shift.
__device__ __forceinline__ uint32_t half_of(const uint4 (&raw)[9], int idx) {
  const uint4& v = raw[idx >> 3];
  const int wsel = (idx & 7) >> 1;
  const uint32_t word = wsel == 0 ? v.x : wsel == 1 ? v.y : wsel == 2 ? v.z : v.w;
  return (word >> ((idx & 1) * 16)) & 0xffffu;
}

__device__ __forceinline__ uint32_t pair_of(const uint4 (&raw)[9], int lo, int hi) {
  return half_of(raw, lo) | (half_of(raw, hi) << 16);
}

// Tensor-core kernel for 2-byte types. Block tile: TH x TW pixels by BN output
// channels; WM x WN = 8 warps, each owning MT m16 tiles of pixels and NT n8
// tiles of output channels. Grid: (pixel tiles, ceil(Co / BN), N).
template <typename T, int TH, int TW, int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks per SM: one loads while one multiplies
conv_mma_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, const T* __restrict__ wgt,
                const float* __restrict__ bias, T* __restrict__ out, int C, int H, int W,
                int Co) {
  constexpr int PW = TW + 2;
  constexpr int CKP = CK + 8;            // 80-byte pixel stride: conflict-free fragment loads
  constexpr int TAPS = BN * CKP;         // per-tap stride
  constexpr int MT = TH * TW / (16 * WM);
  constexpr int NT = BN / (8 * WN);
  static_assert(WM * WN * 32 == THREADS, "eight warps");
  static_assert(MT * 16 * WM == TH * TW && NT * 8 * WN == BN, "tile split");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ws = reinterpret_cast<T*>(smem_raw);  // [9][BN][CKP]
  T* As = Ws + 9 * TAPS;                   // [PH * PW][CKP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, tg = lane & 3;

  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const T* x_n = x + (int64_t)n * C * H * W;
  const float* scale_n = scale + (int64_t)n * C;
  const float* shift_n = shift + (int64_t)n * C;

  // patch offsets (in pixels) of this thread's two fragment rows per m tile
  int poff[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + mt) * 16 + g + 8 * hh;
      poff[mt][hh] = (p / TW) * PW + (p % TW);
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // 16-byte weight loads need whole stages and an aligned row start
  const bool vec_ok = (C % CK == 0) && ((reinterpret_cast<uintptr_t>(wgt) & 15) == 0);

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous stage is fully consumed
    load_patch<T, TH, TW, CKP>(As, x_n, scale_n, shift_n, C, H, W, c0, y0, x0);
    // weights [co][c][tap] in global -> Ws[tap][co - co0][c - c0]
    if (vec_ok) {
      // one task = 8 channels x 9 taps of one output channel: 144 contiguous
      // bytes in, transposed in registers, one 16-byte store per tap out
      constexpr int OCT = CK / 8;
      for (int task = tid; task < BN * OCT; task += THREADS) {
        const int oct = task % OCT, col = task / OCT;
        const int co = co0 + col;
        uint4 raw[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) raw[i] = make_uint4(0u, 0u, 0u, 0u);
        if (co < Co) {
          const uint4* src =
              reinterpret_cast<const uint4*>(wgt + ((int64_t)co * C + c0 + oct * 8) * 9);
#pragma unroll
          for (int i = 0; i < 9; ++i) raw[i] = src[i];
        }
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          uint4 v;
          v.x = pair_of(raw, 0 * 9 + tap, 1 * 9 + tap);
          v.y = pair_of(raw, 2 * 9 + tap, 3 * 9 + tap);
          v.z = pair_of(raw, 4 * 9 + tap, 5 * 9 + tap);
          v.w = pair_of(raw, 6 * 9 + tap, 7 * 9 + tap);
          *reinterpret_cast<uint4*>(Ws + tap * TAPS + col * CKP + oct * 8) = v;
        }
      }
    } else {
      for (int idx = tid; idx < BN * CK * 9; idx += THREADS) {
        const int r = idx % (CK * 9), col = idx / (CK * 9);
        const int co = co0 + col, c = c0 + r / 9;
        T v = from_f<T>(0.f);
        if (co < Co && c < C) v = wgt[((int64_t)co * C + c) * 9 + r % 9];
        Ws[(r % 9) * TAPS + col * CKP + r / 9] = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * PW + (tap % 3);
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const T* p0 = As + (poff[mt][0] + toff) * CKP + kk * 16 + tg * 2;
          const T* p1 = As + (poff[mt][1] + toff) * CKP + kk * 16 + tg * 2;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p0);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p1);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* q = Ws + tap * TAPS + ((wn * NT + nt) * 8 + g) * CKP + kk * 16 + tg * 2;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_m16n8k16(acc[mt][nt], a[mt], b0, b1, T());
        }
      }
    }
  }

  // epilogue: + bias in fp32, one rounding, masked at the frame and Co edges
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (wm * MT + mt) * 16 + g + 8 * hh;
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      if (gy >= H || gx >= W) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + (wn * NT + nt) * 8 + tg * 2 + j;
          if (co < Co)
            out[(((int64_t)n * Co + co) * H + gy) * W + gx] =
                from_f<T>(acc[mt][nt][hh * 2 + j] + bias[co]);
        }
    }
}

// fp32 kernel on the FMA units. Block tile: 8 x 16 pixels by 32 output
// channels; thread t owns pixel t % 128 and 16 channels (t / 128).
constexpr int F_TH = 8, F_TW = 16, F_BN = 32, F_CKP = CK + 1, F_PER = 16;

__global__ void __launch_bounds__(THREADS)
conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, const float* __restrict__ wgt,
                const float* __restrict__ bias, float* __restrict__ out, int C, int H, int W,
                int Co) {
  constexpr int PW = F_TW + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Wf = reinterpret_cast<float*>(smem_raw);  // [9][CK][F_BN]
  float* As = Wf + 9 * CK * F_BN;                  // [PH * PW][F_CKP]

  const int tid = threadIdx.x;
  const int p = tid % (F_TH * F_TW), cgp = tid / (F_TH * F_TW);
  const int tiles_x = (W + F_TW - 1) / F_TW;
  const int y0 = (blockIdx.x / tiles_x) * F_TH, x0 = (blockIdx.x % tiles_x) * F_TW;
  const int co0 = blockIdx.y * F_BN;
  const int n = blockIdx.z;
  const float* x_n = x + (int64_t)n * C * H * W;
  const int poff = (p / F_TW) * PW + (p % F_TW);

  float acc[F_PER];
#pragma unroll
  for (int j = 0; j < F_PER; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    load_patch<float, F_TH, F_TW, F_CKP>(As, x_n, scale + (int64_t)n * C,
                                         shift + (int64_t)n * C, C, H, W, c0, y0, x0);
    for (int idx = tid; idx < F_BN * CK * 9; idx += THREADS) {
      const int r = idx % (CK * 9), col = idx / (CK * 9);
      const int co = co0 + col, c = c0 + r / 9;
      float v = 0.f;
      if (co < Co && c < C) v = wgt[((int64_t)co * C + c) * 9 + r % 9];
      Wf[((r % 9) * CK + r / 9) * F_BN + col] = v;
    }
    __syncthreads();
    for (int cl = 0; cl < CK; ++cl) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float a = As[(poff + (tap / 3) * PW + tap % 3) * F_CKP + cl];
        const float* wrow = Wf + (tap * CK + cl) * F_BN + cgp * F_PER;
#pragma unroll
        for (int j = 0; j < F_PER; ++j) acc[j] = fmaf(a, wrow[j], acc[j]);
      }
    }
  }

  const int gy = y0 + p / F_TW, gx = x0 + p % F_TW;
  if (gy < H && gx < W) {
#pragma unroll
    for (int j = 0; j < F_PER; ++j) {
      const int co = co0 + cgp * F_PER + j;
      if (co < Co) out[(((int64_t)n * Co + co) * H + gy) * W + gx] = acc[j] + bias[co];
    }
  }
}

template <typename T, int TH, int TW, int BN, int WM, int WN>
int launch_mma(const void* x, const void* scale, const void* shift, const void* w,
               const void* bias, void* out, int n, int c, int h, int wd, int co,
               cudaStream_t s) {
  constexpr int CKP = CK + 8;
  constexpr size_t smem =
      sizeof(T) * (9 * BN * CKP + (size_t)(TH + 2) * (TW + 2) * CKP);
  auto kern = conv_mma_kernel<T, TH, TW, BN, WM, WN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((h + TH - 1) / TH) * ((wd + TW - 1) / TW);
  dim3 grid((unsigned)tiles, (unsigned)((co + BN - 1) / BN), (unsigned)n);
  kern<<<grid, THREADS, smem, s>>>((const T*)x, (const float*)scale, (const float*)shift,
                                   (const T*)w, (const float*)bias, (T*)out, c, h, wd, co);
  return (int)cudaGetLastError();
}

// Tile choice: few output channels (the UNet's and the VAE's last convs) take
// an 8-wide channel tile; frames no wider than 8 pixels (few pixels, long K)
// take an 8 x 8 pixel tile by 32 channels, so that enough blocks exist to fill
// the card; everything else 8 x 16 pixels by 64.
template <typename T>
int dispatch_mma(const void* x, const void* scale, const void* shift, const void* w,
                 const void* bias, void* out, int n, int c, int h, int wd, int co,
                 void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || co <= 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (co <= 8) return launch_mma<T, 8, 16, 8, 8, 1>(x, scale, shift, w, bias, out, n, c, h, wd, co, s);
  if (wd <= 8) return launch_mma<T, 8, 8, 32, 2, 4>(x, scale, shift, w, bias, out, n, c, h, wd, co, s);
  return launch_mma<T, 8, 16, 64, 4, 2>(x, scale, shift, w, bias, out, n, c, h, wd, co, s);
}

}  // namespace

extern "C" int mgld_gn_silu_conv_bf16(const void* x, const void* scale, const void* shift,
                                      const void* w, const void* bias, void* out, int n,
                                      int c, int h, int wd, int co, void* stream) {
  return dispatch_mma<__nv_bfloat16>(x, scale, shift, w, bias, out, n, c, h, wd, co, stream);
}

extern "C" int mgld_gn_silu_conv_f16(const void* x, const void* scale, const void* shift,
                                     const void* w, const void* bias, void* out, int n,
                                     int c, int h, int wd, int co, void* stream) {
  return dispatch_mma<__half>(x, scale, shift, w, bias, out, n, c, h, wd, co, stream);
}

extern "C" int mgld_gn_silu_conv_f32(const void* x, const void* scale, const void* shift,
                                     const void* w, const void* bias, void* out, int n,
                                     int c, int h, int wd, int co, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || co <= 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem =
      sizeof(float) * (9 * CK * F_BN + (size_t)(F_TH + 2) * (F_TW + 2) * F_CKP);
  cudaError_t err = cudaFuncSetAttribute(
      conv_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((h + F_TH - 1) / F_TH) * ((wd + F_TW - 1) / F_TW);
  dim3 grid((unsigned)tiles, (unsigned)((co + F_BN - 1) / F_BN), (unsigned)n);
  conv_fma_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)shift, (const float*)w,
      (const float*)bias, (float*)out, c, h, wd, co);
  return (int)cudaGetLastError();
}
