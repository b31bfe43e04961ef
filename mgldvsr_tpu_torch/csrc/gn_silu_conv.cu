// conv3x3(SiLU(GroupNorm(x))) with zero padding 1 and stride 1 in one kernel,
// NCHW input [N, C, H, W], weight [Co, C, 3, 3], output [N, Co, H, W].
// Replaces the TPU kernel mgldvsr_tpu/ops/pallas/gn_silu_conv.py
// (_fused_fwd_impl -> _kernel).
//
// As there, GroupNorm's statistics are taken outside, by gn_stats_kernel
// below (one launch, one read of x), and arrive folded into one fp32
// (scale, shift) per (frame, channel); the conv kernel normalises, applies
// SiLU in fp32, rounds to the working type and convolves, so the normalised
// activation never reaches device memory. Zero padding applies to the
// normalised activation: positions outside the frame contribute 0. Bias is
// added in fp32 before the one rounding to the output type. A chain is two
// launches from one host call (mgld_gn_silu_conv_chain_*): the statistics
// kernel, then the conv kernel on the same stream. The conv kernel is not a
// programmatic dependent launch of the statistics kernel: on an H100 its
// blocks, started early to fetch weights, made the chain 17% slower at the
// 8^2 level and 1.5% at 512^2.
//
// Bound on the H100: operations (2 * 9 * C * Co flops per pixel against
// 2 * (C + Co) bytes). The TPU kernel kept a whole frame and a padded copy in
// VMEM and gave up where that did not fit; a block here has 227 KB, so every
// conv kernel below is an implicit GEMM tiled through shared memory and takes
// every shape: M = a tile of one frame's pixels, N = output channels,
// K = 9 * C walked in stages of input channels, each of the nine taps a GEMM
// whose A rows are the staged halo patch shifted by (ky, kx).
//
// Three conv kernels live here and the wrapper chooses between them:
//
//  * conv_wgmma_kernel: bf16 with more than 8 output channels, which is every
//    chain of the full-width restore but the 4-, 8- and 3-channel output
//    convs. What it does about the bound:
//     - the products are wgmma.mma_async m64nBNk16 (bf16 in, fp32 out). The
//       weights are the B operand, read from shared memory through a
//       descriptor. They arrive re-laid once per weight tensor by the wrapper
//       as [9][Co][Cp] (tap-major, rows of Cp = C rounded up to 64 contiguous
//       channels, zero beyond C), so a [BN][64]-channel tile is BN rows of 128
//       bytes in the 128-byte swizzle, fetched by 16-byte cp.async; nothing is
//       transposed in the kernel.
//     - the activated patch is the A operand from registers: channel-last in
//       shared memory at a 144-byte pixel stride (conflict-free for ldmatrix),
//       each warp owns 16 pixels of the tile, loads its fragments with
//       ldmatrix.x4, and a tap is a pointer offset of ky * PW + kx pixels.
//     - a ring of weight tiles (3, or 6 of the smaller ones) and two patch
//       buffers: the cp.async of a later tile and a third of the
//       normalise-SiLU-transpose pass of stage s + 1 run under the wgmma
//       group of tile u, which the threads only wait for afterwards.
//     - that pass was the larger half of the kernel's time when it was
//       written the plain way. It reads 16-byte vectors along W, one channel
//       pair a lane, and writes 4-byte channel pairs, 128 contiguous bytes a
//       warp; its loads are made one iteration ahead of its arithmetic and
//       held in registers; SiLU is h + h * tanh.approx(h), h = v / 2: one
//       special-function operation an element instead of two.
//     - frames wider than 8 pixels: a block is two warpgroups of 4 x 16 pixels
//       (an 8 x 16 tile, 10 x 18 patch) by 128 output channels, 100 KB of
//       shared memory, two blocks to an SM. Frames up to 8 pixels wide (the
//       8^2 level, long K, few pixels): a warpgroup owns one 8 x 8 tile, the
//       two of a block may lie in two frames, by 64 output channels.
//     - few tiles and a long K (the 16^2 and 8^2 levels: 100 and 60 blocks
//       for 132 SMs): a thread block cluster of 2, 4 or 8 blocks shares a
//       tile and splits its stages; block 0 adds the partial sums through
//       the cluster's shared-memory window and writes the tile.
//  * conv_mma_kernel: fp16, and bf16 with at most 8 output channels (an
//    8-channel tile). mma.sync m16n8k16, one 32-channel stage loaded, then
//    computed; the [Co][C][3][3] weights transposed in registers.
//  * conv_fma_kernel: fp32 on the FMA units (no TF32: the parity mode needs
//    full fp32).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int CK = 32;        // input channels per shared-memory stage

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

// ---------------------------------------------------------------------------
// The tensor-core kernel for bf16: wgmma, weights re-laid [9][Co][Cp].
// ---------------------------------------------------------------------------

constexpr int CS = 64;           // input channels per stage: one 128-byte weight row
constexpr int ROW_BYTES = CS * 2;
constexpr int PIX_BYTES = ROW_BYTES + 16;  // patch pixel stride: ldmatrix rows hit all banks
constexpr int NWG = 2;           // warpgroups of a block, 64 pixels each
constexpr int WTHREADS = 128 * NWG;
constexpr int SM_COUNT = 132;    // of an H100: only the splits of work among clusters look at it

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// writes made through the generic proxy (cp.async) become visible to the
// async proxy, through which wgmma reads shared memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Shared-memory matrix descriptor of a tile of 128-byte rows in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8), tile 1 KB aligned):
// start address / 16 in bits 0-13, leading byte offset (unused by this
// layout) 1 in bits 16-29, stride byte offset 1024 / 16 between 8-row groups
// in bits 32-45, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wgmma reads and writes registers asynchronously; naming them here as read
// and written keeps the compiler from moving their uses across this point
template <int N> __device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// four 8x8 b16 matrices; lane l gives the row address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

#define MGLD_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MGLD_F16(d, i) MGLD_F4(d, i), MGLD_F4(d, i + 4), MGLD_F4(d, i + 8), MGLD_F4(d, i + 12)

// d += A[64x16] B[16xBN]: A from registers (the m16n8k16 A fragment, warp w
// of the warpgroup holding rows 16w..16w+15), B from shared memory, K-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, "
      "%68, p, 1, 1, 0;\n"
      "}\n"
      : MGLD_F16(d, 0), MGLD_F16(d, 16), MGLD_F16(d, 32), MGLD_F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, "
      "%36, p, 1, 1, 0;\n"
      "}\n"
      : MGLD_F16(d, 0), MGLD_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// SiLU(x * a + b) rounded to bf16, as 16 bits: v * sigmoid(v) =
// h + h * tanh(h) with h = v / 2, one special-function operation an element.
// tanh.approx is good to 2^-11 of 1, so the result is off by up to
// |v| * 2.5e-4, under half a bf16 step of any |SiLU(v)| >= 0.13 |v|, i.e. of
// every v > -2; further down the tail, where |SiLU(v)| < 0.3, it is an
// absolute error of up to 1.5e-3.
__device__ __forceinline__ uint32_t act_bits(float xv, float a, float b) {
  const float h = 0.5f * fmaf(xv, a, b);
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(fmaf(h, t, h)));
}
__device__ __forceinline__ uint32_t raw_bits(const __nv_bfloat16* p) {
  return (uint32_t)__bfloat16_as_ushort(*p);
}

// ---------------------------------------------------------------------------
// The statistics: GroupNorm of [N, C, H, W] folded into fp32 scale[N, C] and
// shift[N, C] with GroupNorm(x) = x * scale + shift, in one launch. It is what
// _fused_fwd_impl computes ahead of its kernel (there an XLA reduction). Bound
// by one read of x. In NCHW one (sample, group) is one contiguous slab of
// C/G * H * W elements: a cluster of 1 to 8 blocks owns a slab, each block
// sums its share in fp32 (16-byte loads, four in flight a thread), block 0
// collects the partial sums through the cluster's shared-memory window and
// writes the group's scales and shifts: var = max(E[x^2] - E[x]^2, 0),
// scale = rsqrt(var + eps) * weight, shift = bias - mean * scale. More blocks
// to a slab where the slabs are few and long (the VAE's 512^2 level: 160
// slabs of 2 MB), so that the card's memory rate is drawn.
// ---------------------------------------------------------------------------

constexpr int STHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(STHREADS)
gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                const float* __restrict__ bias, float* __restrict__ scale,
                float* __restrict__ shift, int64_t slab, int cg, int groups, float eps,
                int split) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[2][STHREADS / 32];
  __shared__ float total[2];
  const int tid = threadIdx.x;
  const int rank = split > 1 ? (int)cluster_rank() : 0;
  const int64_t pid = blockIdx.x / split;  // (sample, group)
  const T* base = x + pid * slab;
  // this block's share of the slab, in whole vectors
  const int64_t share = ((slab + split - 1) / split + VEC - 1) / VEC * VEC;
  const int64_t begin = rank * share;
  const int64_t end = begin + share < slab ? begin + share : slab;

  float s1 = 0.f, s2 = 0.f;
  if ((reinterpret_cast<uintptr_t>(base) & 15) == 0) {
    const int64_t vecs = end > begin ? (end - begin) / VEC : 0;
    const uint4* src = reinterpret_cast<const uint4*>(base + begin);
    float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t v0 = tid; v0 < vecs; v0 += 4 * STHREADS) {
      uint4 raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        raw[k] = v0 + k * STHREADS < vecs ? src[v0 + k * STHREADS] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float v = to_f(e[j]);
          a1[k] += v;
          a2[k] = fmaf(v, v, a2[k]);
        }
      }
    }
    s1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
    s2 = (a2[0] + a2[1]) + (a2[2] + a2[3]);
    for (int64_t i = begin + vecs * VEC + tid; i < end; i += STHREADS) {  // the ragged end
      const float v = to_f(base[i]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  } else {
    for (int64_t i = begin + tid; i < end; i += STHREADS) {
      const float v = to_f(base[i]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  if ((tid & 31) == 0) {
    part[0][tid >> 5] = s1;
    part[1][tid >> 5] = s2;
  }
  __syncthreads();
  if (tid < 2) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < STHREADS / 32; ++w) t += part[tid][w];
    total[tid] = t;
  }
  __syncthreads();
  if (split > 1) {
    cluster_sync();  // every block's totals are written
    if (rank == 0 && tid < 2) {
      float t = total[tid];
      for (int peer = 1; peer < split; ++peer)
        t += ld_cluster(cluster_map(smem_u32(&total[tid]), peer));
      total[tid] = t;
    }
    cluster_sync();  // no block leaves while its shared memory is being read
    if (rank != 0) return;
    __syncthreads();
  }
  const float mean = total[0] / (float)slab;
  const float var = fmaxf(total[1] / (float)slab - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  const int g = (int)(pid % groups);
  for (int j = tid; j < cg; j += STHREADS) {
    const float a = inv * weight[g * cg + j];
    scale[pid * cg + j] = a;
    shift[pid * cg + j] = bias[g * cg + j] - mean * a;
  }
}

template <typename T>
int launch_stats(const void* x, const void* weight, const void* bias, void* scale, void* shift,
                 int n, int c, int hw, int groups, float eps, cudaStream_t s) {
  if (n <= 0 || c <= 0 || hw <= 0 || groups <= 0 || c % groups) return (int)cudaErrorInvalidValue;
  const int cg = c / groups;
  const int64_t slab = (int64_t)cg * hw;
  const int64_t slabs = (int64_t)n * groups;
  if (slabs * 8 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // blocks to a slab: until the card's SMs have four blocks each, as long as
  // a block keeps 16 KB to read
  int split = 1;
  while (split < 8 && slabs * split < 4 * SM_COUNT &&
         slab * (int64_t)sizeof(T) >= (int64_t)split * 2 * 16384)
    split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(slabs * split));
  cfg.blockDim = dim3(STHREADS);
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gn_stats_kernel<T>, (const T*)x,
                                       (const float*)weight, (const float*)bias, (float*)scale,
                                       (float*)shift, slab, cg, groups, eps, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Geometry of a block. TW = 16: an 8 x 16 pixel tile of frame blockIdx.z,
// warpgroup g owning its rows 4g..4g+3, one 10 x 18 patch. TW = 8: warpgroup
// g owns the 8 x 8 tile number NWG * blockIdx.x + g of the list (frame, tile
// row, tile column), and the patch is NWG stacked 10 x 10 patches.
template <int TW> struct Geo {
  static constexpr int PW = TW + 2;
  static constexpr int PR = TW == 16 ? 4 * NWG + 2 : 10 * NWG;  // patch rows
  static constexpr int HALVES = TW / 8;                          // 8-pixel runs of a patch row
  static constexpr int TASKS = PR * HALVES * (CS / 2);
  static constexpr int ROUNDS = (TASKS + WTHREADS - 1) / WTHREADS;
  static constexpr int P_BYTES = PR * PW * PIX_BYTES;
  int tiles_x, tiles, units, H, W;
  int ksplit;  // blocks of a cluster, which share one tile and split its K range
  // frame, top row and left column of the tile that patch row r of the
  // block's tile number ``bx`` (blockIdx.x / ksplit) belongs to; false if
  // there is none (a block's last warpgroup past the list's end)
  __device__ __forceinline__ bool tile_of_row(int bx, int r, int& n, int& y0, int& x0) const {
    if constexpr (TW == 16) {
      n = blockIdx.z;
      y0 = (bx / tiles_x) * (4 * NWG);
      x0 = (bx % tiles_x) * TW;
      return true;
    } else {
      const int u = bx * NWG + r / 10;
      n = u / tiles;
      const int t = u % tiles;
      y0 = (t / tiles_x) * 8;
      x0 = (t % tiles_x) * 8;
      return u < units;
    }
  }
};

// One task of the pass that stages the activated halo patch of 64 channels:
// one 8-pixel run of one patch row for one channel pair (the lane), plus the
// halo pixel(s) at the run's outer end. The task is split in two, its loads
// and its arithmetic, so that the loads can be in flight under other work;
// this is what a thread holds in between.
struct PatchTask {
  uint4 raw[2];      // the run of the two channels as loaded (pixels past the edge 0)
  uint32_t halo[2];  // the halo pixels of each channel: left in the low half, right in the high
  float a[2], b[2];  // scale and shift of the two channels
  uint32_t dst;      // byte offset of the run's first word in a patch buffer
  uint32_t flags;    // bits 0-1: channel live; 2-9: run pixel inside the frame; 10, 11: left,
                     // right halo inside; 12, 13: the task has a left, right halo; 14: it exists
};

// The loads of this thread's task of round ``round`` for channels [c0, c0 + 64).
// ``vec``: W is a multiple of 8 and x is 16-byte aligned, so a run is one
// aligned vector that lies wholly inside or outside the frame.
template <int TW>
__device__ __forceinline__ PatchTask patch_load(const Geo<TW>& geo, int bx,
                                                const __nv_bfloat16* __restrict__ x,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ shift, int C, int c0,
                                                int round, bool vec) {
  using G = Geo<TW>;
  PatchTask t;
  t.flags = 0u;
  const int task = round * WTHREADS + threadIdx.x;
  if (task >= G::TASKS) return t;
  const int pair = task & 31, run = task >> 5;
  const int hx = run % G::HALVES, r = run / G::HALVES;
  int n, y0, x0;
  const bool tile = geo.tile_of_row(bx, r, n, y0, x0);
  const int gy = y0 + (TW == 16 ? r : r % 10) - 1;
  const int gx0 = x0 + 8 * hx;
  const bool left = hx == 0, right = hx == G::HALVES - 1;
  t.dst = (r * G::PW + 8 * hx) * PIX_BYTES + pair * 4;
  t.flags = (1u << 14) | (left ? 1u << 12 : 0u) | (right ? 1u << 13 : 0u);
  if (tile && gy >= 0 && gy < geo.H) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (gx0 + j < geo.W) t.flags |= 4u << j;
    if (left && gx0 > 0) t.flags |= 1u << 10;
    if (right && gx0 + 8 < geo.W) t.flags |= 1u << 11;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 2 * pair + e;
      t.raw[e] = make_uint4(0u, 0u, 0u, 0u);
      t.halo[e] = 0u;
      t.a[e] = t.b[e] = 0.f;
      if (c >= C) continue;
      t.flags |= 1u << e;
      t.a[e] = scale[(int64_t)n * C + c];
      t.b[e] = shift[(int64_t)n * C + c];
      const __nv_bfloat16* row = x + (((int64_t)n * C + c) * geo.H + gy) * geo.W;
      if (vec) {
        if (gx0 < geo.W) t.raw[e] = *reinterpret_cast<const uint4*>(row + gx0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gx = gx0 + 2 * j;
          w[j] = (gx < geo.W ? raw_bits(row + gx) : 0u) |
                 (gx + 1 < geo.W ? raw_bits(row + gx + 1) << 16 : 0u);
        }
        t.raw[e] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (t.flags & (1u << 10)) t.halo[e] = raw_bits(row + gx0 - 1);
      if (t.flags & (1u << 11)) t.halo[e] |= raw_bits(row + gx0 + 8) << 16;
    }
  }
  return t;
}

// The arithmetic and the stores of a loaded task into the patch buffer
// ``patch``: SiLU(x * scale + shift) rounded to bf16, 0 outside the frame and
// for channels >= C; a stored word is the channel pair of one pixel.
__device__ __forceinline__ void patch_finish(uint8_t* __restrict__ patch, const PatchTask& t) {
  if (!(t.flags & (1u << 14))) return;
  // [0] left halo, [1..8] the run, [9] right halo
  uint32_t words[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) words[j] = 0u;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!(t.flags & (1u << e))) continue;
    const uint32_t raw[4] = {t.raw[e].x, t.raw[e].y, t.raw[e].z, t.raw[e].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bits = j & 1 ? raw[j / 2] & 0xffff0000u : raw[j / 2] << 16;
      if (t.flags & (4u << j))
        words[1 + j] |= act_bits(__uint_as_float(bits), t.a[e], t.b[e]) << (16 * e);
    }
    if (t.flags & (1u << 10))
      words[0] |= act_bits(__uint_as_float(t.halo[e] << 16), t.a[e], t.b[e]) << (16 * e);
    if (t.flags & (1u << 11))
      words[9] |= act_bits(__uint_as_float(t.halo[e] & 0xffff0000u), t.a[e], t.b[e]) << (16 * e);
  }
  uint8_t* dst = patch + t.dst;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    if ((j == 0 && !(t.flags & (1u << 12))) || (j == 9 && !(t.flags & (1u << 13)))) continue;
    *reinterpret_cast<uint32_t*>(dst + j * PIX_BYTES) = words[j];
  }
}

// Accumulator fragment of a 64-row wgmma tile: warp w of the warpgroup owns
// rows 16w..16w+15; lane l holds, in register i, row 16w + l/4 + 8*((i/2)%2)
// and column 8*(i/4) + 2*(l%4) + i%2.
template <int TW, int BN, int NB>
__global__ void __launch_bounds__(WTHREADS, 2)
conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const __nv_bfloat16* __restrict__ wre,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int C,
                  int Cp, int Co, Geo<TW> geo) {
  using G = Geo<TW>;
  constexpr int B_BYTES = BN * ROW_BYTES;
  constexpr int STEP = WTHREADS / 8;  // weight rows fetched per pass of the block
  static_assert(BN % STEP == 0 && STEP % 8 == 0, "weight rows divide among the threads");

  extern __shared__ uint8_t smem_dyn[];
  const uint32_t b_s = (smem_u32(smem_dyn) + 1023u) & ~1023u;  // the swizzle needs 1 KB
  const uint32_t p_s = b_s + NB * B_BYTES;
  uint8_t* const patch0 = smem_dyn + (p_s - smem_u32(smem_dyn));

  const int tid = threadIdx.x;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int co0 = blockIdx.y * BN;
  // the blocks of a cluster share a tile and split the stages among them
  const int rank = geo.ksplit > 1 ? (int)cluster_rank() : 0;
  const int bx = blockIdx.x / geo.ksplit;
  const int stage0 = (Cp / CS) * rank / geo.ksplit;
  const int stages = (Cp / CS) * (rank + 1) / geo.ksplit;  // one past this block's last stage
  const int tiles_k = (stages - stage0) * 9;
  const bool vec = (geo.W % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);

  // this thread's chunk of every weight tile: 16-byte chunk ch of rows r0 + i * STEP
  const int r0 = tid >> 3, ch = tid & 7;
  const uint32_t b_chunk = b_s + r0 * ROW_BYTES + ((ch ^ (r0 & 7)) << 4);
  const __nv_bfloat16* w_src = wre + ((int64_t)(co0 + r0) * Cp + ch * 8);
  int ld_tap = 0, ld_stage = stage0, ld_slot = 0;  // the next tile to fetch
  auto fetch_tile = [&]() {
    if (ld_stage < stages) {
      const __nv_bfloat16* src = w_src + (int64_t)ld_tap * Co * Cp + ld_stage * CS;
#pragma unroll
      for (int i = 0; i < BN / STEP; ++i) {
        const bool ok = co0 + r0 + i * STEP < Co;
        cp_async16(b_chunk + ld_slot * B_BYTES + i * STEP * ROW_BYTES,
                   ok ? src + (int64_t)i * STEP * Cp : wre, ok ? 16 : 0);
      }
      if (++ld_tap == 9) { ld_tap = 0; ++ld_stage; }
      if (++ld_slot == NB) ld_slot = 0;
    }
    cp_async_commit();  // an empty group keeps the count in step
  };
#pragma unroll
  for (int i = 0; i < NB - 1; ++i) fetch_tile();

  // ldmatrix row address of this lane: row l % 8 of matrix l / 8; matrices 0, 1
  // are fragment rows 0-7 and 8-15 at k 0-7, matrices 2, 3 the same at k 8-15
  const int frow = (lane & 7) + 8 * ((lane >> 3) & 1);  // fragment row = pixel 16 * warp + frow
  const int a_pix = TW == 16 ? (4 * wgi + warp) * G::PW + frow
                             : (10 * wgi + 2 * warp + (frow >> 3)) * G::PW + (frow & 7);
  const uint32_t a_lane = p_s + a_pix * PIX_BYTES + (lane >> 4) * 16;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int round = 0; round < G::ROUNDS; ++round)
    patch_finish(patch0 + (stage0 & 1) * G::P_BYTES,
                 patch_load<TW>(geo, bx, x, scale, shift, C, stage0 * CS, round, vec));
  // the task of the loop's first pass round, loaded ahead
  PatchTask ahead;
  ahead.flags = 0u;
  if (stage0 + 1 < stages)
    ahead = patch_load<TW>(geo, bx, x, scale, shift, C, (stage0 + 1) * CS, 0, vec);

  int tap = 0, stage = stage0, slot = 0;
#pragma unroll 1
  for (int u = 0; u < tiles_k; ++u) {
    cp_async_wait<NB - 2>();  // weight tile u has landed for this thread
    fence_proxy_async();
    __syncthreads();  // ... for every thread; tile u - 1 is consumed; the patch is whole
    fetch_tile();     // tile u + NB - 1 into the slot of tile u - 1

    uint32_t a[4][4];
    const uint32_t a_addr =
        a_lane + (stage & 1) * G::P_BYTES + ((tap / 3) * G::PW + tap % 3) * PIX_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], a_addr + kk * 32);
    const uint64_t b_desc = tile_desc(b_s + slot * B_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hold(a[kk]);
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], b_desc + 2 * kk);
    wgmma_commit();
    // under the products: a round of the next stage's patch from the loads
    // made an iteration ago, then the loads of the round after it
    if (tap < G::ROUNDS && stage + 1 < stages)
      patch_finish(patch0 + ((stage + 1) & 1) * G::P_BYTES, ahead);
    {
      const int next_tap = tap == 8 ? 0 : tap + 1, next_stage = tap == 8 ? stage + 1 : stage;
      if (next_tap < G::ROUNDS && next_stage + 1 < stages)
        ahead = patch_load<TW>(geo, bx, x, scale, shift, C, (next_stage + 1) * CS, next_tap, vec);
    }
    wgmma_wait_all();
    hold(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hold(a[kk]);
    if (++tap == 9) { tap = 0; ++stage; }
    if (++slot == NB) slot = 0;
  }

  if (geo.ksplit > 1) {
    // the cluster's partial sums meet in block 0: the others park theirs in
    // their own shared memory, block 0 adds them through the cluster's window
    cp_async_wait<0>();
    __syncthreads();  // the ring and the patches are free
    float* park = reinterpret_cast<float*>(smem_dyn + (b_s - smem_u32(smem_dyn)));
    if (rank != 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) park[i * WTHREADS + tid] = acc[i];
    }
    cluster_sync();
    if (rank == 0) {
      for (int peer = 1; peer < geo.ksplit; ++peer) {
        const uint32_t theirs = cluster_map(b_s + tid * 4, peer);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += ld_cluster(theirs + i * WTHREADS * 4);
      }
    }
    cluster_sync();  // no block leaves while its shared memory is being read
    if (rank != 0) return;
  }

  // epilogue: + bias in fp32, one rounding, masked at the frame and Co edges
  int n, y0, x0;
  if (!geo.tile_of_row(bx, TW == 16 ? 0 : 10 * wgi, n, y0, x0)) return;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gy = TW == 16 ? y0 + 4 * wgi + warp : y0 + 2 * warp + hh;
    const int gx = TW == 16 ? x0 + g + 8 * hh : x0 + g;
    if (gy >= geo.H || gx >= geo.W) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + 8 * j + 2 * tg + e;
        if (co < Co)
          out[(((int64_t)n * Co + co) * geo.H + gy) * geo.W + gx] =
              __float2bfloat16(acc[4 * j + 2 * hh + e] + bias[co]);
      }
  }
}

template <int TW, int BN, int NB>
int launch_wgmma(const void* x, const void* scale, const void* shift, const void* wre,
                 const void* bias, void* out, int n, int c, int cp, int h, int wd, int co,
                 cudaStream_t s) {
  using G = Geo<TW>;
  constexpr int smem = NB * BN * ROW_BYTES + 2 * G::P_BYTES + 1024;  // + room to align to 1 KB
  auto kern = conv_wgmma_kernel<TW, BN, NB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  G geo;
  geo.H = h;
  geo.W = wd;
  geo.tiles_x = (wd + TW - 1) / TW;
  dim3 grid;
  if (TW == 16) {
    geo.tiles = geo.tiles_x * ((h + 4 * NWG - 1) / (4 * NWG));
    geo.units = geo.tiles;
    grid = dim3((unsigned)geo.tiles, (unsigned)((co + BN - 1) / BN), (unsigned)n);
  } else {
    geo.tiles = geo.tiles_x * ((h + 7) / 8);
    const long units = (long)geo.tiles * n;
    if (units > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    geo.units = (int)units;
    grid = dim3((unsigned)((units + NWG - 1) / NWG), (unsigned)((co + BN - 1) / BN), 1u);
  }
  // Few tiles and a long K (the 16^2 and 8^2 levels): clusters of 2, 4 or 8
  // blocks split the stages of one tile, as many as still fit the card's
  // 2 x 132 block slots at once.
  const long blocks = (long)grid.x * grid.y * grid.z;
  geo.ksplit = 1;
  while (geo.ksplit < 8 && blocks * geo.ksplit * 2 <= 2 * SM_COUNT &&
         geo.ksplit * 2 <= cp / CS)
    geo.ksplit *= 2;
  grid.x *= geo.ksplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = geo.ksplit;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const __nv_bfloat16*)x, (const float*)scale,
                           (const float*)shift, (const __nv_bfloat16*)wre, (const float*)bias,
                           (__nv_bfloat16*)out, c, cp, co, geo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch_wgmma(const void* x, const void* scale, const void* shift, const void* wre,
                   const void* bias, void* out, int n, int c, int cp, int h, int wd, int co,
                   cudaStream_t s) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || co <= 0 || n > 65535 || cp < c || cp % CS ||
      (reinterpret_cast<uintptr_t>(wre) & 15))
    return (int)cudaErrorInvalidValue;
  if (wd <= 8)
    return launch_wgmma<8, 64, 6>(x, scale, shift, wre, bias, out, n, c, cp, h, wd, co, s);
  return launch_wgmma<16, 128, 3>(x, scale, shift, wre, bias, out, n, c, cp, h, wd, co, s);
}

int launch_fma(const void* x, const void* scale, const void* shift, const void* w,
               const void* bias, void* out, int n, int c, int h, int wd, int co,
               cudaStream_t s) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0 || co <= 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem =
      sizeof(float) * (9 * CK * F_BN + (size_t)(F_TH + 2) * (F_TW + 2) * F_CKP);
  cudaError_t err = cudaFuncSetAttribute(
      conv_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((h + F_TH - 1) / F_TH) * ((wd + F_TW - 1) / F_TW);
  dim3 grid((unsigned)tiles, (unsigned)((co + F_BN - 1) / F_BN), (unsigned)n);
  conv_fma_kernel<<<grid, THREADS, smem, s>>>(
      (const float*)x, (const float*)scale, (const float*)shift, (const float*)w,
      (const float*)bias, (float*)out, c, h, wd, co);
  return (int)cudaGetLastError();
}

// the statistics into ``stats`` (scale [n, c], then shift [n, c]), then conv
template <typename T, typename Conv>
int chain(const void* x, const void* gn_weight, const void* gn_bias, void* stats, int n, int c,
          int h, int wd, int groups, float eps, cudaStream_t s, Conv conv) {
  if ((int64_t)h * wd > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* const scale = (float*)stats;
  float* const shift = scale + (int64_t)n * c;
  const int err = launch_stats<T>(x, gn_weight, gn_bias, scale, shift, n, c, h * wd, groups,
                                  eps, s);
  return err ? err : conv(scale, shift);
}

}  // namespace

// bf16 on the wgmma kernel. ``wre`` is the weight re-laid [9][Co][cp] with
// cp = c rounded up to a multiple of 64 and zeros in channels >= c, 16-byte
// aligned. Frames up to 8 pixels wide take 8 x 8 pixel tiles by 64 output
// channels, so that the 8^2 level's few pixels still spread over the card;
// wider frames 8 x 16 pixels by 128.
extern "C" int mgld_gn_silu_conv_wgmma_bf16(const void* x, const void* scale, const void* shift,
                                            const void* wre, const void* bias, void* out,
                                            int n, int c, int cp, int h, int wd, int co,
                                            void* stream) {
  return dispatch_wgmma(x, scale, shift, wre, bias, out, n, c, cp, h, wd, co,
                        (cudaStream_t)stream);
}

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
  return launch_fma(x, scale, shift, w, bias, out, n, c, h, wd, co, (cudaStream_t)stream);
}

// The whole chain from one host call: GroupNorm's statistics of x into the
// fp32 scratch ``stats`` (2 * n * c floats: scale, then shift), then the
// conv kernel on them. ``wre`` is the re-laid weight as for
// mgld_gn_silu_conv_wgmma_bf16, ``w`` the [co, c, 3, 3] weight as for the
// other entries.
extern "C" int mgld_gn_silu_conv_chain_wgmma_bf16(const void* x, const void* gn_weight,
                                                  const void* gn_bias, void* stats,
                                                  const void* wre, const void* bias, void* out,
                                                  int n, int c, int cp, int h, int wd, int co,
                                                  int groups, float eps, void* stream) {
  auto s = (cudaStream_t)stream;
  return chain<__nv_bfloat16>(x, gn_weight, gn_bias, stats, n, c, h, wd, groups, eps, s,
                              [&](const float* scale, const float* shift) {
                                return dispatch_wgmma(x, scale, shift, wre, bias, out, n, c, cp,
                                                      h, wd, co, s);
                              });
}

extern "C" int mgld_gn_silu_conv_chain_bf16(const void* x, const void* gn_weight,
                                            const void* gn_bias, void* stats, const void* w,
                                            const void* bias, void* out, int n, int c, int h,
                                            int wd, int co, int groups, float eps,
                                            void* stream) {
  return chain<__nv_bfloat16>(x, gn_weight, gn_bias, stats, n, c, h, wd, groups, eps,
                              (cudaStream_t)stream,
                              [&](const float* scale, const float* shift) {
                                return dispatch_mma<__nv_bfloat16>(x, scale, shift, w, bias, out,
                                                                   n, c, h, wd, co, stream);
                              });
}

extern "C" int mgld_gn_silu_conv_chain_f16(const void* x, const void* gn_weight,
                                           const void* gn_bias, void* stats, const void* w,
                                           const void* bias, void* out, int n, int c, int h,
                                           int wd, int co, int groups, float eps,
                                           void* stream) {
  return chain<__half>(x, gn_weight, gn_bias, stats, n, c, h, wd, groups, eps,
                       (cudaStream_t)stream, [&](const float* scale, const float* shift) {
                         return dispatch_mma<__half>(x, scale, shift, w, bias, out, n, c, h, wd,
                                                     co, stream);
                       });
}

extern "C" int mgld_gn_silu_conv_chain_f32(const void* x, const void* gn_weight,
                                           const void* gn_bias, void* stats, const void* w,
                                           const void* bias, void* out, int n, int c, int h,
                                           int wd, int co, int groups, float eps,
                                           void* stream) {
  auto s = (cudaStream_t)stream;
  return chain<float>(x, gn_weight, gn_bias, stats, n, c, h, wd, groups, eps, s,
                      [&](const float* scale, const float* shift) {
                        return launch_fma(x, scale, shift, w, bias, out, n, c, h, wd, co, s);
                      });
}

// GroupNorm of a contiguous [n, c, hw] tensor folded into fp32 scale and shift
// of [n, c] (see gn_stats_kernel); weight and bias are fp32 [c].
extern "C" int mgld_gn_scale_shift_bf16(const void* x, const void* weight, const void* bias,
                                        void* scale, void* shift, int n, int c, int hw,
                                        int groups, float eps, void* stream) {
  return launch_stats<__nv_bfloat16>(x, weight, bias, scale, shift, n, c, hw, groups, eps,
                                     (cudaStream_t)stream);
}

extern "C" int mgld_gn_scale_shift_f16(const void* x, const void* weight, const void* bias,
                                       void* scale, void* shift, int n, int c, int hw,
                                       int groups, float eps, void* stream) {
  return launch_stats<__half>(x, weight, bias, scale, shift, n, c, hw, groups, eps,
                              (cudaStream_t)stream);
}

extern "C" int mgld_gn_scale_shift_f32(const void* x, const void* weight, const void* bias,
                                       void* scale, void* shift, int n, int c, int hw,
                                       int groups, float eps, void* stream) {
  return launch_stats<float>(x, weight, bias, scale, shift, n, c, hw, groups, eps,
                             (cudaStream_t)stream);
}
