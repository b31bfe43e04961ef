// Self-attention softmax(Q K^T / sqrt(d)) V with an fp32 online softmax.
// Replaces the TPU kernel mgldvsr_tpu/ops/pallas/attention.py
// (resident_attention -> _attn_kernel).
//
// Three kernels live here and the wrapper chooses between them by type and
// head dim:
//
//  * attention_wgmma_kernel: bf16 at head dim 64, which is every gated call
//    of the full-width restore at 512 px (320/5, 640/10, 256/4). Tensor
//    cores.
//  * attention_kernel<T, D>: fp32 (the parity mode, no TF32) and bf16 at
//    head dims 8, 16, 32, 128. fp32 FMA units.
//  * attention_wide_kernel<T, D>: head dim 512, the VAE's single-head mid
//    attention, which the gate passes at 32^2 to 57^2 latents (frames of
//    256 to 456 px; to 45^2 in fp32). fp32 FMA units.
//
// Bound on the H100: operations. One call does 4*N*N*D flops per head
// against 4*N*D elements moved, and at D = 64 the exponentials of the
// softmax (N*N per head on the 16-per-clock special function units of an
// SM) take about as many clocks as the two products take on the tensor
// cores. The TPU kernel kept a head's whole K/V resident in VMEM; K+V at
// N = 4096 is 1 MB in bf16, beyond a block's 227 KB of shared memory, so
// both kernels stream K/V tiles through shared memory and carry a running
// max and sum per query row (flash-attention style). The [N, N] logits
// never reach device memory.
//
// What attention_wgmma_kernel does about the bound:
//  * both products run as wgmma.mma_async (bf16 in, fp32 out). S = Q K^T is
//    m64n128k16 with Q and K read from shared memory through descriptors;
//    O += P V is m64n64k16 with P taken from registers: the fp32 S fragment
//    rounded pairwise to bf16 already has the A-fragment layout, so P never
//    touches shared memory. V stays [keys][D] and is read as the
//    transposed (MN-major) B operand.
//  * a row of D = 64 bf16 is 128 bytes, so tiles are stored in the 128-byte
//    swizzle the descriptors name: 16-byte chunk c of row r sits at chunk
//    c ^ (r % 8), tiles 1024-byte aligned. The loads apply the XOR.
//  * K/V tile j+1 is fetched by 16-byte cp.async while tile j is multiplied
//    (two stages); rows past N are zero-filled by the src-size 0 form.
//  * softmax on the accumulator fragment: each thread holds two rows, the
//    row max is reduced over the four lanes that share a row by shuffles,
//    exp2 with scale*log2(e) folded in, keys >= N masked to -inf.
//  * a block is two warpgroups of 64 query rows each (128 rows) of one
//    head with 80 KB of shared memory, so two blocks share an SM and one
//    block's softmax overlaps another's products.
//  * q, k, v and o are [B, N, H, D] with unit stride in D and explicit
//    batch, row and head strides, so the caller's head-interleaved
//    projections are read in place and the output needs no permute.
//
// Partial waves: the grid is (ceil(N/128), B*H). Two blocks to an SM, 264
// are resident: [25,4096,64] has 800 blocks (3.03 waves: the last 8 blocks
// run alone), [20,4096,64] 640 (2.42), [50,1024,64] 400 (1.52). Two blocks
// on an SM take about 1.5 times as long as one alone, so a wave of single
// blocks costs two thirds of a full one: [25,4096,64] pays up to that for
// its last 8 blocks. A 64-row block (one warpgroup, three to an SM, 396
// resident) was built and timed on an H100 and dropped: 1600 blocks (4.04
// waves) and 800 (2.02) fall as badly, the K/V traffic from L2 doubles, and
// it tied at [25,4096,64] and lost 8% at [20,4096,64]. chip_smoke.py times
// one and two blocks to an SM, and PERF.md holds the numbers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The FMA kernel: contiguous [BH, N, D]; one block per (query tile of QT
// rows, bh); thread t owns query row q0 + t, keeps its scaled q and its
// output accumulator in registers, and reads each key/value row of the tile
// as a shared-memory broadcast. Keys at index >= N are masked; query rows
// >= N compute nothing visible.
// ---------------------------------------------------------------------------

constexpr int QT = 128;  // queries (threads) per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(QT)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n, float scale) {
  constexpr int KT = D <= 64 ? 32 : 16;  // keys per shared-memory tile
  __shared__ float ks[KT][D];
  __shared__ float vs[KT][D];
  __shared__ float sc[KT][QT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int row = blockIdx.x * QT + tid;
  const bool live = row < n;
  const long base = (long)bh * n * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_f(q[base + (long)row * D + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < n; k0 += KT) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < KT * D; idx += QT) {
      const int r = idx / D, c = idx % D;
      const int key = k0 + r;
      const bool ok = key < n;
      ks[r][c] = ok ? to_f(k[base + (long)key * D + c]) : 0.f;
      vs[r][c] = ok ? to_f(v[base + (long)key * D + c]) : 0.f;
    }
    __syncthreads();

    float tile_max = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      if (k0 + j >= n) s = -INFINITY;
      sc[j][tid] = s;
      tile_max = fmaxf(tile_max, s);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      const float p = expf(sc[j][tid] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) o[base + (long)row * D + d] = from_f<T>(acc[d] * inv);
  }
}

// ---------------------------------------------------------------------------
// The wide kernel: head dim 512, contiguous [BH, N, D]. A thread cannot hold
// a row of q and of the output in registers at this width (the FMA kernel's
// design), so a block of WT threads takes WQ query rows, stages them in
// shared memory, and splits the work two ways. For the logits of a tile of
// WK keys, thread (row r, key j) reduces over D from shared memory; the 16
// lanes of a row then reduce its tile max and sum by shuffles and carry the
// row's running max and sum. For the output, thread t owns columns t,
// t + WT, ... of all WQ rows and adds the tile's probabilities times V.
// Rows of q and K are padded by 4 floats, so the 8 lanes of a 16-byte load
// phase read 8 rows at 32 distinct banks. 98 KB of shared memory: two
// blocks to an SM.
// ---------------------------------------------------------------------------

constexpr int WQ = 16;   // query rows of a block
constexpr int WK = 16;   // keys of a tile
constexpr int WT = 256;  // threads: WQ x WK logits, one each

template <int D>
constexpr int wide_smem_bytes() {
  return (2 * WQ * (D + 4) + WK * D + WQ * WK + 2 * WQ) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(WT)
attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int n, float scale) {
  static_assert(D % WT == 0, "each thread owns D / WT output columns");
  static_assert(WQ * WK == WT && WK == 16, "a warp holds the logits of two rows");
  constexpr int LD = D + 4;    // padded row of q and K, in floats
  constexpr int CPT = D / WT;  // output columns of a thread
  extern __shared__ float4 wide_smem[];
  float* qs = reinterpret_cast<float*>(wide_smem);  // [WQ][LD], scaled
  float* ks = qs + WQ * LD;                          // [WK][LD]
  float* vs = ks + WK * LD;                          // [WK][D]
  float* ps = vs + WK * D;                           // [WQ][WK] the tile's probabilities
  float* cs = ps + WQ * WK;                          // [WQ] the tile's rescale of a row
  float* ls = cs + WQ;                               // [WQ] the rows' sums

  const int tid = threadIdx.x, lane = tid & 31;
  const int r = (tid >> 5) * 2 + (lane >> 4);  // this thread's logit: row r, key j
  const int j = lane & 15;
  const int q0 = blockIdx.x * WQ;
  const long base = (long)blockIdx.y * n * D;

  for (int idx = tid; idx < WQ * D; idx += WT) {
    const int rr = idx / D, c = idx % D, row = q0 + rr;
    qs[rr * LD + c] = row < n ? to_f(q[base + (long)row * D + c]) * scale : 0.f;
  }
  float acc[WQ][CPT];
#pragma unroll
  for (int rr = 0; rr < WQ; ++rr)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[rr][cc] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < n; k0 += WK) {
    __syncthreads();  // the previous tile, its probabilities and rescales are consumed
    for (int idx = tid; idx < WK * D; idx += WT) {
      const int rr = idx / D, c = idx % D, key = k0 + rr;
      const bool ok = key < n;
      ks[rr * LD + c] = ok ? to_f(k[base + (long)key * D + c]) : 0.f;
      vs[rr * D + c] = ok ? to_f(v[base + (long)key * D + c]) : 0.f;
    }
    __syncthreads();

    const float4* qr = reinterpret_cast<const float4*>(qs + r * LD);
    const float4* kr = reinterpret_cast<const float4*>(ks + j * LD);
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = qr[c], b = kr[c];
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
    if (k0 + j >= n) s = -INFINITY;
    float tile_max = s;
#pragma unroll
    for (int off = 8; off; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);  // finite: key k0 < n is in the tile
    const float p = expf(s - m_new);
    float tile_sum = p;
#pragma unroll
    for (int off = 8; off; off >>= 1) tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l = l * corr + tile_sum;
    m = m_new;
    ps[r * WK + j] = p;
    if (j == 0) cs[r] = corr;
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < WQ; ++rr) {
      const float c_r = cs[rr];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[rr][cc] *= c_r;
    }
#pragma unroll 4
    for (int jj = 0; jj < WK; ++jj) {
      float vv[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) vv[cc] = vs[jj * D + tid + cc * WT];
#pragma unroll
      for (int rr = 0; rr < WQ; ++rr) {
        const float pr = ps[rr * WK + jj];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[rr][cc] = fmaf(pr, vv[cc], acc[rr][cc]);
      }
    }
  }

  if (j == 0) ls[r] = l;
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < WQ; ++rr) {
    const int row = q0 + rr;
    if (row >= n) break;
    const float inv = 1.f / ls[rr];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      o[base + (long)row * D + tid + cc * WT] = from_f<T>(acc[rr][cc] * inv);
  }
}

template <typename T, int D>
int launch_wide(const T* q, const T* k, const T* v, T* o, int bh, int n, float scale,
                cudaStream_t s) {
  constexpr int smem = wide_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_wide_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + WQ - 1) / WQ, bh);
  attention_wide_kernel<T, D><<<grid, WT, smem, s>>>(q, k, v, o, n, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n,
           int d, float scale, void* stream) {
  dim3 grid((n + QT - 1) / QT, bh);
  cudaStream_t s = (cudaStream_t)stream;
  const T* qp = (const T*)q;
  const T* kp = (const T*)k;
  const T* vp = (const T*)v;
  T* op = (T*)o;
  switch (d) {
    case 8: attention_kernel<T, 8><<<grid, QT, 0, s>>>(qp, kp, vp, op, n, scale); break;
    case 16: attention_kernel<T, 16><<<grid, QT, 0, s>>>(qp, kp, vp, op, n, scale); break;
    case 32: attention_kernel<T, 32><<<grid, QT, 0, s>>>(qp, kp, vp, op, n, scale); break;
    case 64: attention_kernel<T, 64><<<grid, QT, 0, s>>>(qp, kp, vp, op, n, scale); break;
    case 128: attention_kernel<T, 128><<<grid, QT, 0, s>>>(qp, kp, vp, op, n, scale); break;
    case 512: return launch_wide<T, 512>(qp, kp, vp, op, bh, n, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core kernel: bf16, head dim 64.
// ---------------------------------------------------------------------------

constexpr int HD = 64;               // head dim
constexpr int KEYS = 128;             // keys per tile
constexpr int ROW_BYTES = HD * 2;    // 128: one swizzle row
constexpr int KV_BYTES = KEYS * ROW_BYTES;  // one K or V tile, 16 KB
constexpr int WG_ROWS = 64;          // query rows of one warpgroup (a wgmma tile)
constexpr int NWG = 2;               // warpgroups of a block
constexpr int THREADS = 128 * NWG;
constexpr int QROWS = WG_ROWS * NWG;  // query rows of a block

struct Strides {  // of a [B, N, H, D] view, in elements; D has stride 1
  long long b, n, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// writes made through the generic proxy (cp.async) become visible to the
// async proxy, through which wgmma reads shared memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// This thread's share of a tile of ROWS rows of 128 bytes: chunk c = tid % 8
// of rows r0 + i * (THREADS / 8), r0 = tid / 8. The step is a multiple of 8,
// so every row of the thread has the swizzle of r0 and the caller folds it
// into ``dst`` (the tile's base + r0 * 128 + ((c ^ (r0 % 8)) << 4)) once.
// ``src`` points at chunk c of row ``first_row`` (the tile's first row + r0);
// rows >= n become zeros and read nothing (``safe`` is any valid address).
template <int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long row_stride, int first_row, int n,
                                          const __nv_bfloat16* safe) {
  constexpr int STEP = THREADS / 8;
  static_assert(ROWS % STEP == 0 && STEP % 8 == 0, "rows divide among the threads");
  if (first_row + ROWS - STEP < n) {  // all of this thread's rows exist
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i)
      cp_async16(dst + i * STEP * ROW_BYTES, src + i * STEP * row_stride, 16);
  } else {
#pragma unroll
    for (int i = 0; i < ROWS / STEP; ++i) {
      const bool ok = first_row + i * STEP < n;
      cp_async16(dst + i * STEP * ROW_BYTES, ok ? src + i * STEP * row_stride : safe,
                 ok ? 16 : 0);
    }
  }
}

// Shared-memory matrix descriptor of a tile of 128-byte rows in the 128-byte
// swizzle: start address / 16 in bits 0-13, leading byte offset (unused by
// this layout) 1 in bits 16-29, stride byte offset 1024 / 16 between 8-row
// groups in bits 32-45, layout type 1 (128-byte swizzle) in bits 62-63.
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
// wgmma reads and writes registers asynchronously; naming them here as
// read and written keeps the compiler from moving their uses across this
// point or reusing them early
template <int N> __device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define MGLD_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MGLD_F16(d, i) MGLD_F4(d, i), MGLD_F4(d, i + 4), MGLD_F4(d, i + 8), MGLD_F4(d, i + 12)

// d[64] (+)= A[64x16] B[16x128]: A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a_desc,
                                                    uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : MGLD_F16(d, 0), MGLD_F16(d, 16), MGLD_F16(d, 32), MGLD_F16(d, 48)
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// d[32] += A[64x16] B[16x64]: A from registers, B from shared memory stored
// [k][n] (MN-major: the transpose bit of B is set)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t b_desc) {
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
      "%36, p, 1, 1, 1;\n"
      "}\n"
      : MGLD_F16(d, 0), MGLD_F16(d, 16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Accumulator fragment of a 64-row wgmma tile: warp w of the warpgroup owns
// rows 16w..16w+15; lane l holds, in register i, row 16w + l/4 + 8*((i/2)%2)
// and column 8*(i/4) + 2*(l%4) + i%2. So a thread has two rows ("lo": l/4,
// "hi": l/4 + 8), and the four lanes l%4 share them.
__global__ void __launch_bounds__(THREADS, 2)
attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int heads, int n, Strides sq, Strides sk, Strides sv, Strides so,
                       float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle needs 1 KB
  const uint32_t k_s = q_s + QROWS * ROW_BYTES;                // two stages of K
  const uint32_t v_s = k_s + 2 * KV_BYTES;                     // two stages of V

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * QROWS;
  const int tiles = (n + KEYS - 1) / KEYS;

  // this thread's chunk of every tile (see load_tile)
  const int r0 = tid >> 3, ch = tid & 7;
  const uint32_t chunk = r0 * ROW_BYTES + ((ch ^ (r0 & 7)) << 4);
  const __nv_bfloat16* qg = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kg = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vg = v + b * sv.b + h * sv.h;
  const __nv_bfloat16* k_src = kg + r0 * sk.n + ch * 8;  // advances a tile at a time
  const __nv_bfloat16* v_src = vg + r0 * sv.n + ch * 8;

  load_tile<QROWS>(q_s + chunk, qg + (q0 + r0) * sq.n + ch * 8, sq.n, q0 + r0, n, qg);
  load_tile<KEYS>(k_s + chunk, k_src, sk.n, r0, n, kg);
  load_tile<KEYS>(v_s + chunk, v_src, sv.n, r0, n, vg);
  cp_async_commit();

  float acc[32];  // O fragment: 64 rows x 64 columns over the warpgroup
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row maxima of the raw logits
  float l_lo = 0.f, l_hi = 0.f;              // this lane's share of the row sums
  const uint64_t q_desc = tile_desc(q_s + wg * WG_ROWS * ROW_BYTES);

  for (int j = 0; j < tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();   // tile j (and Q) has landed for this thread
    fence_proxy_async();
    __syncthreads();       // ... for every thread; and tile j-1 is consumed
    if (j + 1 < tiles) {   // fetch tile j+1 under this tile's arithmetic
      k_src += KEYS * sk.n;
      v_src += KEYS * sv.n;
      const int first_row = (j + 1) * KEYS + r0;
      load_tile<KEYS>(k_s + (st ^ 1) * KV_BYTES + chunk, k_src, sk.n, first_row, n, kg);
      load_tile<KEYS>(v_s + (st ^ 1) * KV_BYTES + chunk, v_src, sv.n, first_row, n, vg);
      cp_async_commit();
    }

    // S = Q K^T: four k-steps of 16 along D, 32 bytes apart inside a row
    float s[64];
    const uint64_t k_desc = tile_desc(k_s + st * KV_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_m64n128k16_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    if ((j + 1) * KEYS > n) {  // the ragged last tile: keys >= n count for nothing
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int key = j * KEYS + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (key >= n) s[i] = -INFINITY;
      }
    }

    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[i], s[i + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[i + 2], s[i + 3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // every tile holds a key < n, so the maxima are finite; the guard keeps
    // -inf - (-inf) out of the exponent all the same
    const float ms_lo = mx_lo == -INFINITY ? 0.f : mx_lo * scale_log2;
    const float ms_hi = mx_hi == -INFINITY ? 0.f : mx_hi * scale_log2;
    const float c_lo = ex2(m_lo * scale_log2 - ms_lo);  // 0 on the first tile
    const float c_hi = ex2(m_hi * scale_log2 - ms_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;

    // P = exp2(S scale log2e - max), rounded to bf16 pairwise: p[4kk..4kk+3]
    // is the A fragment of k-step kk of the second product
    uint32_t p[32];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 64; i += 4) {
      const float e0 = ex2(fmaf(s[i], scale_log2, -ms_lo));
      const float e1 = ex2(fmaf(s[i + 1], scale_log2, -ms_lo));
      const float e2 = ex2(fmaf(s[i + 2], scale_log2, -ms_hi));
      const float e3 = ex2(fmaf(s[i + 3], scale_log2, -ms_hi));
      sum_lo += e0 + e1;
      sum_hi += e2 + e3;
      p[i / 2] = pack_bf16(e0, e1);
      p[i / 2 + 1] = pack_bf16(e2, e3);
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      acc[i] *= c_lo;
      acc[i + 1] *= c_lo;
      acc[i + 2] *= c_hi;
      acc[i + 3] *= c_hi;
    }

    // O += P V: eight k-steps of 16 keys, 16 rows = 2048 bytes apart
    const uint64_t v_desc = tile_desc(v_s + st * KV_BYTES);
    hold(p);
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      wgmma_m64n64k16_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                         v_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(p);
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int row_lo = q0 + wg * WG_ROWS + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
  __nv_bfloat16* og = o + b * so.b + h * so.h + 2 * (lane & 3);
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(og + row_lo * so.n + 8 * jb) =
          __floats2bfloat162_rn(acc[4 * jb] * inv_lo, acc[4 * jb + 1] * inv_lo);
    if (row_hi < n)
      *reinterpret_cast<__nv_bfloat162*>(og + row_hi * so.n + 8 * jb) =
          __floats2bfloat162_rn(acc[4 * jb + 2] * inv_hi, acc[4 * jb + 3] * inv_hi);
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                 int n, const long long* st, float scale_log2, cudaStream_t s) {
  // Q tile + two stages of K and V + room to align the base to 1 KB
  constexpr int smem = QROWS * ROW_BYTES + 4 * KV_BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(attention_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n + QROWS - 1) / QROWS), (unsigned)(batch * heads));
  attention_wgmma_kernel<<<grid, THREADS, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, heads, n, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mgld_attention_f32(const void* q, const void* k, const void* v, void* o,
                                  int bh, int n, int d, float scale, void* stream) {
  return launch<float>(q, k, v, o, bh, n, d, scale, stream);
}

extern "C" int mgld_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                   int bh, int n, int d, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, n, d, scale, stream);
}

// bf16, head dim 64, [B, N, H, D] views: strides holds the batch, row and
// head strides in elements of q, k, v and o in turn (12 values); D has
// stride 1 and every base and stride is a multiple of 8 elements (16 bytes;
// the output's of 2).
extern "C" int mgld_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                         int batch, int heads, int n, const long long* strides,
                                         float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0 || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  return launch_wgmma(q, k, v, o, batch, heads, n, strides, scale_log2, (cudaStream_t)stream);
}
