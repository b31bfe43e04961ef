// Self-attention softmax(Q K^T / sqrt(d)) V with an fp32 online softmax.
// Replaces the TPU kernel mgldvsr_tpu/ops/pallas/attention.py
// (resident_attention -> _attn_kernel).
//
// Four kernels live here and the wrapper chooses between them by type and
// head dim:
//
//  * attention_wgmma_kernel: bf16 at head dim 64, which is every gated call
//    of the full-width restore at 512 px (320/5, 640/10, 256/4). Tensor
//    cores.
//  * attention_kernel<T, D>: fp32 (the parity mode, no TF32) and bf16 at
//    head dims 8, 16, 32, 128. fp32 FMA units.
//  * attention_wide_wgmma_kernel<TOK>: bf16 at head dim 512, the VAE's
//    single-head mid attention, which the gate passes at 32^2 to 57^2
//    latents (frames of 256 to 456 px). Tensor cores; reads the VAE's
//    [B, D, N] conv outputs in place (TOK) or [B, N, D] rows.
//  * attention_wide_fma_kernel: fp32 at head dim 512 (32^2 to 45^2
//    latents), [B, N, D] rows. fp32 FMA units, tiled in registers.
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
//
// Head dim 512 (4*N*N*512 flops a call; the bound at [5,1024,512] is 0.011
// ms in bf16 and 0.160 ms in fp32). What attention_wide_wgmma_kernel does:
//  * a row of 512 bf16 is 1 KB, so a 64-token tile is stored as 128-byte
//    rows in the same swizzle: under [B, N, D] eight sub-tiles of 64 d (a
//    row a token, S accumulated over 8 sub-tiles x 4 k-steps), under
//    [B, D, N] 512 rows of 64 tokens (a row a d). The [B, D, N] layout is
//    the VAE's own (its q, k, v are 1x1-conv outputs in NCHW): wgmma reads
//    Q and K there as MN-major operands (both transpose bits) and V as a
//    K-major one, so the VAE's views need no copy, and the output goes out
//    in the same layout, so that the reshape back to NCHW is a view.
//  * the output of a 64-row tile is 64 x 512 fp32, 128 KB: more than one
//    warpgroup's registers. Two warpgroups own 256 columns each (128
//    accumulators a thread) and each computes the whole 64 x 64 logits of
//    a key tile (1.5x the minimal operations; splitting D for S as well
//    would send the partial logits through shared memory every tile).
//  * Q, a K and a V tile of 64 keys: 3 x 64 KB + 1 KB of shared memory,
//    one block (8 warps) to an SM. K tile j+1 loads during the softmax
//    and P V of tile j, V tile j+1 during S of tile j+1.
//  * grid (ceil(N/64), B): 80 blocks at [5,1024] (0.61 of a wave on 132
//    SMs), 180 at [5,2304] (1.36 waves), 255 at [5,3249] (1.93 waves).
// What attention_wide_fma_kernel does: see its comment; 112 KB of shared
// memory and at most 128 registers a thread, two blocks (16 warps) to an
// SM: 160 blocks at [5,1024] and 320 at [5,2025] (0.61 and 1.21 of the
// 264 resident).
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

// ---------------------------------------------------------------------------
// Head dim 512, the VAE's single-head mid attention: two kernels, one a type.
// ---------------------------------------------------------------------------

constexpr int WD = 512;             // head dim
constexpr int WROWS = 64;           // query rows of a block: one wgmma tile
constexpr int WKEYS = 64;           // keys of a tile
constexpr int WTILE = 64 * WD * 2;  // a 64-token tile in bf16: 64 KB
constexpr int WTHREADS = 256;       // two warpgroups
constexpr int WCOLS = WD / 2;       // output columns of a warpgroup

struct WideStrides {  // in elements: q, k, v and o's batch stride and row stride
  long long qb, ql, kb, kl, vb, vl, ob, ol;
};

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Byte offset of element (token, d) of a 64-token x 512 tile in shared
// memory. TOK, the [B, D, N] layout (tokens contiguous, a token's d values
// N apart): 512 rows of 128 bytes, a row a d holding 64 tokens. Else
// [B, N, D]: eight 8 KB sub-tiles of 64 d, a row of 128 bytes a token. Both
// in the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).
template <bool TOK>
__device__ __forceinline__ uint32_t wide_offset(int tok, int d) {
  if (TOK) return d * 128 + ((((tok >> 3) ^ d) & 7) << 4) + (tok & 7) * 2;
  return (d >> 6) * 8192 + tok * 128 + ((((d >> 3) ^ tok) & 7) << 4) + (d & 7) * 2;
}

// The 16-byte chunks of a 64-token tile, 16 a thread: chunk c is (d = c / 8,
// tokens 8 (c % 8)..+7) under TOK and (token c / 64, d 8 (c % 64)..+7)
// otherwise, so that 8 or 64 neighbouring threads read one contiguous run.
template <bool TOK>
__device__ __forceinline__ void wide_chunk(int c, int& tok, int& d) {
  if (TOK) {
    d = c >> 3;
    tok = (c & 7) * 8;
  } else {
    tok = c >> 6;
    d = (c & 63) * 8;
  }
}

// Tokens t0..t0+63 of one batch (``g``: its base; ``ld``: the stride between
// d rows under TOK, between token rows otherwise) into the tile at ``dst``.
// Chunks of tokens >= n are zero-filled and read nothing; under TOK n is a
// multiple of 8 (the wrapper's route), so no chunk straddles n.
template <bool TOK>
__device__ __forceinline__ void wide_load(uint32_t dst, const __nv_bfloat16* g, long long ld,
                                          int t0, int n) {
#pragma unroll
  for (int i = 0; i < WTILE / 16 / WTHREADS; ++i) {
    int tok, d;
    wide_chunk<TOK>(i * WTHREADS + threadIdx.x, tok, d);
    const bool ok = t0 + tok < n;
    const __nv_bfloat16* src = TOK ? g + d * ld + t0 + tok : g + (t0 + tok) * ld + d;
    cp_async16(dst + wide_offset<TOK>(tok, d), ok ? src : g, ok ? 16 : 0);
  }
}

// The mirror of wide_load: the tile at ``tile`` (a generic address in shared
// memory) to tokens t0.. of the output; tokens >= n are not written.
template <bool TOK>
__device__ __forceinline__ void wide_store(__nv_bfloat16* g, long long ld, const uint8_t* tile,
                                           int t0, int n) {
#pragma unroll
  for (int i = 0; i < WTILE / 16 / WTHREADS; ++i) {
    int tok, d;
    wide_chunk<TOK>(i * WTHREADS + threadIdx.x, tok, d);
    if (t0 + tok < n)
      *reinterpret_cast<uint4*>(TOK ? g + d * ld + t0 + tok : g + (t0 + tok) * ld + d) =
          *reinterpret_cast<const uint4*>(tile + wide_offset<TOK>(tok, d));
  }
}

// d[32] (+)= A[64x16] B[16x64], both from shared memory; TA, TB: the
// transpose bits (1: the operand is stored MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a_desc,
                                                   uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : MGLD_F16(d, 0), MGLD_F16(d, 16)
      : "l"(a_desc), "l"(b_desc), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[OFF..OFF+31] += A[64x16] B[16x64]: A from registers, B from shared
// memory stored MN-major (the transpose bit of B is set)
template <int OFF>
__device__ __forceinline__ void wgmma_m64n64k16_rs_at(float (&d)[128], uint32_t a0, uint32_t a1,
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
      : MGLD_F16(d, OFF), MGLD_F16(d, OFF + 16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(1));
}

// d[128] += A[64x16] B[16x256]: A from registers, B from shared memory
// stored K-major
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, "
      "%132, p, 1, 1, 0;\n"
      "}\n"
      : MGLD_F16(d, 0), MGLD_F16(d, 16), MGLD_F16(d, 32), MGLD_F16(d, 48), MGLD_F16(d, 64),
        MGLD_F16(d, 80), MGLD_F16(d, 96), MGLD_F16(d, 112)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc), "r"(1));
}

// bf16, head dim 512. A block: 64 query rows of one batch, two warpgroups.
// Warpgroup w owns output columns [256 w, 256 w + 256) (128 fp32
// accumulators a thread) and computes the whole 64 x 64 logits of a key
// tile itself: 1.5x the minimal operations, and no logits cross shared
// memory. Shared memory: Q, a K tile and a V tile, 64 KB each (193 KB, one
// block to an SM). K tile j+1 is fetched while the softmax and P V of tile
// j run, V tile j+1 while S of tile j+1 runs. The output goes back through
// the Q tile's memory, so both layouts are written in 16-byte chunks.
template <bool TOK>
__global__ void __launch_bounds__(WTHREADS, 1)
attention_wide_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            int n, WideStrides st, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t q_s = (base + 1023u) & ~1023u;  // the swizzle needs 1 KB
  const uint32_t k_s = q_s + WTILE;
  const uint32_t v_s = k_s + WTILE;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int q0 = blockIdx.x * WROWS;
  const int tiles = (n + WKEYS - 1) / WKEYS;
  const __nv_bfloat16* kg = k + blockIdx.y * st.kb;
  const __nv_bfloat16* vg = v + blockIdx.y * st.vb;

  wide_load<TOK>(q_s, q + blockIdx.y * st.qb, st.ql, q0, n);
  wide_load<TOK>(k_s, kg, st.kl, 0, n);
  cp_async_commit();
  wide_load<TOK>(v_s, vg, st.vl, 0, n);
  cp_async_commit();

  float acc[128];  // O fragment: 64 rows x this warpgroup's 256 columns
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running row maxima of the raw logits
  float l_lo = 0.f, l_hi = 0.f;              // this lane's share of the row sums

  for (int j = 0; j < tiles; ++j) {
    // in flight: K tile j (with Q on the first tile), then V tile j
    cp_async_wait_one();
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T over 32 k-steps of 16 d: under TOK 16 rows (2 KB) apart,
    // else 32 bytes apart inside a row and a sub-tile every four
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WD / 16; ++kk) {
      if (TOK)
        wgmma_m64n64k16_ss<1, 1>(s, tile_desc(q_s + kk * 2048), tile_desc(k_s + kk * 2048),
                                 kk > 0);
      else
        wgmma_m64n64k16_ss<0, 0>(s, tile_desc(q_s + (kk >> 2) * 8192) + 2 * (kk & 3),
                                 tile_desc(k_s + (kk >> 2) * 8192) + 2 * (kk & 3), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    __syncthreads();  // both warpgroups are done with K tile j
    if (j + 1 < tiles) wide_load<TOK>(k_s, kg, st.kl, (j + 1) * WKEYS, n);
    cp_async_commit();  // empty after the last tile: the waits count groups

    if ((j + 1) * WKEYS > n) {  // the ragged last tile: keys >= n count for nothing
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = j * WKEYS + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (key >= n) s[i] = -INFINITY;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
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
    uint32_t p[16];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
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
    for (int i = 0; i < 128; i += 4) {
      acc[i] *= c_lo;
      acc[i + 1] *= c_lo;
      acc[i + 2] *= c_hi;
      acc[i + 3] *= c_hi;
    }

    cp_async_wait_one();  // V tile j has landed (K tile j+1 may be in flight)
    fence_proxy_async();
    __syncthreads();

    // O += P V: four k-steps of 16 keys. Under TOK V is K-major (a row a d;
    // this warpgroup's 256 rows start 32 KB in), one n = 256 product a
    // k-step; else MN-major, one n = 64 product a sub-tile of its columns.
    hold(p);
    hold(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WKEYS / 16; ++kk) {
      const uint32_t a0 = p[4 * kk], a1 = p[4 * kk + 1], a2 = p[4 * kk + 2], a3 = p[4 * kk + 3];
      if (TOK) {
        wgmma_m64n256k16_rs(acc, a0, a1, a2, a3, tile_desc(v_s + wg * WCOLS * 128) + 2 * kk);
      } else {
        const uint32_t vt = v_s + wg * 4 * 8192 + kk * 2048;
        wgmma_m64n64k16_rs_at<0>(acc, a0, a1, a2, a3, tile_desc(vt));
        wgmma_m64n64k16_rs_at<32>(acc, a0, a1, a2, a3, tile_desc(vt + 8192));
        wgmma_m64n64k16_rs_at<64>(acc, a0, a1, a2, a3, tile_desc(vt + 2 * 8192));
        wgmma_m64n64k16_rs_at<96>(acc, a0, a1, a2, a3, tile_desc(vt + 3 * 8192));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(acc);
    hold(p);

    __syncthreads();  // both warpgroups are done with V tile j
    if (j + 1 < tiles) wide_load<TOK>(v_s, vg, st.vl, (j + 1) * WKEYS, n);
    cp_async_commit();
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;

  // the normalised output, rounded to bf16, into the Q tile's memory in the
  // output's tile layout (every wgmma has read it), then out in 16-byte chunks
  fence_proxy_async();
  uint8_t* stage = smem_raw + (q_s - base);
  const int tok_lo = warp * 16 + (lane >> 2), tok_hi = tok_lo + 8;
#pragma unroll
  for (int jb = 0; jb < 32; ++jb) {
    const int d = wg * WCOLS + 8 * jb + 2 * (lane & 3);
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(acc[4 * jb] * inv_lo, acc[4 * jb + 1] * inv_lo);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(acc[4 * jb + 2] * inv_hi, acc[4 * jb + 3] * inv_hi);
    if (TOK) {  // d and d + 1 lie in two rows
      *reinterpret_cast<__nv_bfloat16*>(stage + wide_offset<TOK>(tok_lo, d)) = lo.x;
      *reinterpret_cast<__nv_bfloat16*>(stage + wide_offset<TOK>(tok_lo, d + 1)) = lo.y;
      *reinterpret_cast<__nv_bfloat16*>(stage + wide_offset<TOK>(tok_hi, d)) = hi.x;
      *reinterpret_cast<__nv_bfloat16*>(stage + wide_offset<TOK>(tok_hi, d + 1)) = hi.y;
    } else {
      *reinterpret_cast<__nv_bfloat162*>(stage + wide_offset<TOK>(tok_lo, d)) = lo;
      *reinterpret_cast<__nv_bfloat162*>(stage + wide_offset<TOK>(tok_hi, d)) = hi;
    }
  }
  __syncthreads();
  wide_store<TOK>(o + blockIdx.y * st.ob, st.ol, stage, q0, n);
}

template <bool TOK>
int launch_wide_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int n,
                      const WideStrides& st, float scale_log2, cudaStream_t s) {
  constexpr int smem = 3 * WTILE + 1024;  // Q, K and V tiles + room to align the base
  cudaError_t err = cudaFuncSetAttribute(attention_wide_wgmma_kernel<TOK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n + WROWS - 1) / WROWS), (unsigned)batch);
  attention_wide_wgmma_kernel<TOK><<<grid, WTHREADS, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, n, st, scale_log2);
  return (int)cudaGetLastError();
}

// float32, head dim 512, [B, N, D] with unit stride in D: an FMA kernel tiled
// in registers, SGEMM-fashion. A block: 32 query rows of one batch, 256
// threads, all 512 output columns (an 8 x 8 tile of the output a thread),
// keys in tiles of 128. Q stays in shared memory (64 KB); K streams through
// in chunks of 32 d ([128 keys][32], 16 KB) for S = Q K^T (a 4 x 4 tile of
// the logits a thread), then V in chunks of 8 keys ([8][512], 16 KB) for
// O += P V, the next chunk fetched by cp.async while one is used. Both
// products do 64 FMAs a thread for every eight 16-byte shared-memory reads,
// most of them broadcast among the lanes that share a row; the softmax
// works on the tile's [128][32] logits in shared memory, a warp four rows.
// 112 KB of shared memory: two blocks to an SM.
constexpr int FROWS = 32;                        // query rows of a block
constexpr int FKEYS = 128;                       // keys of a tile
constexpr int FKD = 32;                          // d of a K chunk
constexpr int FVK = 8;                           // keys of a V chunk
constexpr int FCHUNK = FKEYS * FKD;              // floats of a chunk of either kind: 4096
constexpr int FKCHUNKS = WD / FKD;               // K chunks a tile: 16
constexpr int FCHUNKS = FKCHUNKS + FKEYS / FVK;  // chunks a tile: 16 of K, then 16 of V
constexpr int FTHREADS = 256;
constexpr int F_SMEM = (FROWS * WD + 2 * FCHUNK + FKEYS * FROWS + FROWS) * 4;  // 114,816 B

// where P[key][row] of a tile lies in its [128][32] buffer: a key's rows
// rotated by a multiple of 4, so that the logits' writes, the softmax's
// reads and the output's (float4, broadcast) reads each meet distinct banks
__device__ __forceinline__ int prot(int row, int key) {
  return key * FROWS + ((row + 4 * ((key & 7) + (key >> 4))) & 31);
}

__global__ void __launch_bounds__(FTHREADS, 2)
attention_wide_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o, int n,
                          WideStrides st, float scale) {
  extern __shared__ float4 fsmem[];
  float4* qs = fsmem;                  // [32][128]: float4 c of row r at c ^ (r % 8)
  float4* ring = qs + FROWS * WD / 4;  // two chunks
  float* ps = reinterpret_cast<float*>(ring + 2 * FCHUNK / 4);  // [128 keys][32 rows], prot
  float* cs = ps + FKEYS * FROWS;  // [32]: the tile's rescale of a row, at the end 1 / sum

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FROWS;
  const int tiles = (n + FKEYS - 1) / FKEYS;
  const float* qg = q + blockIdx.y * st.qb;
  const float* kg = k + blockIdx.y * st.kb;
  const float* vg = v + blockIdx.y * st.vb;

  // chunk g of the stream (tile g / 32: K chunks 0-15, then V chunks) into
  // slot g % 2 of the ring; keys >= n are zero-filled
  auto load_chunk = [&](int g) {
    const uint32_t dst = smem_u32(ring + (g & 1) * (FCHUNK / 4));
    const int k0 = (g / FCHUNKS) * FKEYS, u = g % FCHUNKS;
#pragma unroll
    for (int i = 0; i < FCHUNK / 4 / FTHREADS; ++i) {
      const int idx = i * FTHREADS + tid;
      if (u < FKCHUNKS) {  // [128 keys][8 float4]: float4 c of key r at c ^ (r % 8)
        const int key = idx >> 3, c = idx & 7;
        const bool ok = k0 + key < n;
        cp_async16(dst + (key * 8 + (c ^ (key & 7))) * 16,
                   ok ? kg + (k0 + key) * st.kl + u * FKD + 4 * c : kg, ok ? 16 : 0);
      } else {  // [8 keys][128 float4]
        const int key = (u - FKCHUNKS) * FVK + (idx >> 7), c = idx & 127;
        const bool ok = k0 + key < n;
        cp_async16(dst + idx * 16, ok ? vg + (k0 + key) * st.vl + 4 * c : vg, ok ? 16 : 0);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < FROWS * WD / 4 / FTHREADS; ++i) {
    const int idx = i * FTHREADS + tid, r = idx >> 7, c = idx & 127;
    const bool ok = q0 + r < n;
    cp_async16(smem_u32(qs + r * 128 + (c ^ (r & 7))), ok ? qg + (q0 + r) * st.ql + 4 * c : qg,
               ok ? 16 : 0);
  }
  load_chunk(0);
  cp_async_commit();

  // the logits: rows srow + 4 i, keys skey + 8 j
  const int srow = 16 * (w >> 2) + (lane >> 3), skey = 32 * (w & 3) + (lane & 7);
  // the softmax: row xrow, keys 16 xpart..+15
  const int xrow = 4 * w + (lane & 3), xpart = lane >> 2;
  // the output: rows orow..+7, float4 columns ocol and ocol + 32
  const int orow = 8 * (w >> 1), ocol = 64 * (w & 1) + lane;

  float sacc[4][4], oacc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) oacc[r][c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // of row xrow, the same in its eight lanes

  const int chunks = tiles * FCHUNKS;
  for (int g = 0; g < chunks; ++g) {
    if (g + 1 < chunks) load_chunk(g + 1);
    cp_async_commit();
    cp_async_wait_one();  // chunk g (and Q) has landed for this thread
    __syncthreads();      // ... for every thread
    const float4* ch = ring + (g & 1) * (FCHUNK / 4);
    const int u = g % FCHUNKS, k0 = (g / FCHUNKS) * FKEYS;

    if (u < FKCHUNKS) {
      if (u == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
      }
#pragma unroll 2
      for (int c = 0; c < FKD / 4; ++c) {
        float4 kf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kf[j] = ch[(skey + 8 * j) * 8 + (c ^ (lane & 7))];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = srow + 4 * i;
          const float4 qf = qs[r * 128 + ((u * 8 + c) ^ (r & 7))];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = sacc[i][j];
            a = fmaf(qf.x, kf[j].x, a);
            a = fmaf(qf.y, kf[j].y, a);
            a = fmaf(qf.z, kf[j].z, a);
            a = fmaf(qf.w, kf[j].w, a);
            sacc[i][j] = a;
          }
        }
      }
      if (u == FKCHUNKS - 1) {  // the tile's logits are whole: the softmax
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ps[prot(srow + 4 * i, skey + 8 * j)] = sacc[i][j];
        __syncthreads();
        float x[16], mx = m_run;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int key = 16 * xpart + e;
          x[e] = k0 + key < n ? ps[prot(xrow, key)] * scale : -INFINITY;
          mx = fmaxf(mx, x[e]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float corr = expf(m_run - mx);  // 0 on the first tile (m_run = -inf)
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float pe = expf(x[e] - mx);
          ps[prot(xrow, 16 * xpart + e)] = pe;
          sum += pe;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        l_run = l_run * corr + sum;
        m_run = mx;
        if (xpart == 0) cs[xrow] = corr;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float cr = cs[orow + r];
#pragma unroll
          for (int c = 0; c < 8; ++c) oacc[r][c] *= cr;
        }
      }
    } else {
      const int key0 = (u - FKCHUNKS) * FVK;
#pragma unroll 2
      for (int kk = 0; kk < FVK; ++kk) {
        const int key = key0 + kk;
        const float4 pa = *reinterpret_cast<const float4*>(ps + prot(orow, key));
        const float4 pb = *reinterpret_cast<const float4*>(ps + prot(orow + 4, key));
        const float4 va = ch[kk * 128 + ocol], vb = ch[kk * 128 + ocol + 32];
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          oacc[r][0] = fmaf(pr[r], va.x, oacc[r][0]);
          oacc[r][1] = fmaf(pr[r], va.y, oacc[r][1]);
          oacc[r][2] = fmaf(pr[r], va.z, oacc[r][2]);
          oacc[r][3] = fmaf(pr[r], va.w, oacc[r][3]);
          oacc[r][4] = fmaf(pr[r], vb.x, oacc[r][4]);
          oacc[r][5] = fmaf(pr[r], vb.y, oacc[r][5]);
          oacc[r][6] = fmaf(pr[r], vb.z, oacc[r][6]);
          oacc[r][7] = fmaf(pr[r], vb.w, oacc[r][7]);
        }
      }
    }
    __syncthreads();  // slot g % 2 and the probabilities are free again
  }

  if (xpart == 0) cs[xrow] = 1.f / l_run;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + orow + r;
    if (row >= n) break;
    const float inv = cs[orow + r];
    float4* out = reinterpret_cast<float4*>(o + blockIdx.y * st.ob + row * st.ol);
    out[ocol] = make_float4(oacc[r][0] * inv, oacc[r][1] * inv, oacc[r][2] * inv,
                            oacc[r][3] * inv);
    out[ocol + 32] = make_float4(oacc[r][4] * inv, oacc[r][5] * inv, oacc[r][6] * inv,
                                 oacc[r][7] * inv);
  }
}

int launch_wide_fma(const void* q, const void* k, const void* v, void* o, int batch, int n,
                    const WideStrides& st, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(attention_wide_fma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n + FROWS - 1) / FROWS), (unsigned)batch);
  attention_wide_fma_kernel<<<grid, FTHREADS, F_SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, n, st, scale);
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

// Head dim 512: q, k, v and o hold ``batch`` batches of n tokens; strides
// holds the batch stride and the row stride in elements of q, k, v and o in
// turn (8 values). Rows are token rows of 512 d ([B, N, D]) unless
// ``tok_major`` (bf16 only): then they are d rows of n tokens ([B, D, N],
// n a multiple of 8). Every base and row stride is a multiple of 16 bytes.
extern "C" int mgld_attention_wide_bf16(const void* q, const void* k, const void* v, void* o,
                                        int batch, int n, int tok_major,
                                        const long long* strides, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || (tok_major && n % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const WideStrides st{strides[0], strides[1], strides[2], strides[3],
                       strides[4], strides[5], strides[6], strides[7]};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  return tok_major ? launch_wide_wgmma<true>(q, k, v, o, batch, n, st, scale_log2, s)
                   : launch_wide_wgmma<false>(q, k, v, o, batch, n, st, scale_log2, s);
}

extern "C" int mgld_attention_wide_f32(const void* q, const void* k, const void* v, void* o,
                                       int batch, int n, const long long* strides, float scale,
                                       void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0) return (int)cudaErrorInvalidValue;
  const WideStrides st{strides[0], strides[1], strides[2], strides[3],
                       strides[4], strides[5], strides[6], strides[7]};
  return launch_wide_fma(q, k, v, o, batch, n, st, scale, (cudaStream_t)stream);
}
