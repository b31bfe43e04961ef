// The GroupNorm kernels of the default configuration, both bound on the H100
// by device-memory traffic: the fused GroupNorm (group_norm_kernel) and the
// channel sums that the VAE's low-precision GroupNorms of 128^2 pixels and
// more take (channel_sums_kernel, at the end of the file).
//
// GroupNorm of a contiguous [N, C, *spatial] tensor in one kernel: one read of
// x, one write of y. Replaces the TPU kernel
// mgldvsr_tpu/ops/pallas/groupnorm.py (fused_group_norm -> _fused_gn_kernel).
//
// What it computes, per (sample, group): fp32 sums of x as it is,
// var = max(E[x^2] - E[x]^2, 0), a_c = rsqrt(var + eps) * weight_c,
// b_c = bias_c - mean * a_c, both rounded to x's type, and
// y = round(round(x * a_c) + b_c) in x's type.
//
// Bound on the H100: device-memory traffic, one read and one write of the
// activation. The TPU kernel held one NHWC sample in fast memory and folded
// channels into groups with one-hot matmuls. In NCHW one (sample, group) is
// one contiguous slab of C/G * S elements, and what the design does about the
// bound is to keep that slab on chip between its two uses:
//
//  * A thread block cluster of 1, 2, 4 or 8 blocks owns a slab. Each block
//    loads its share (whole 16-byte vectors, four loads in flight a thread)
//    into dynamic shared memory and sums it in fp32 on the way. The largest
//    slab of the restore (30 channels x 64^2 bf16 = 240 KB) is 30 KB a block
//    at a split of 8, so several blocks fit an SM and nothing is read twice.
//  * The partial (sum, sum of squares) meet through the cluster's
//    shared-memory window. Every block reads every peer's pair, in rank order,
//    so all blocks of a slab hold the same totals bit for bit, and writes y
//    for its own share from shared memory.
//  * The wrapper chooses the split from the number and size of the slabs, so
//    that the 132 SMs have several blocks each and a small slab (the 8^2
//    levels: 5 KB) takes one block.
//  * A share that exceeds the shared memory a block may ask for (a long
//    float32 or temporal slab) is not staged: the same kernel walks it a
//    second time from global memory (stage_bytes == 0). A slab whose base is
//    off a 16-byte boundary takes scalar loops, also unstaged.
//  * The channel of an element is offset / S: one division a 16-byte vector,
//    none an element; the group's a_c and b_c wait in shared memory.
#include "gn_common.cuh"

namespace {

constexpr int GTHREADS = 256;
constexpr int GWARPS = GTHREADS / 32;
constexpr int INFLIGHT = 4;  // 16-byte loads a thread issues before it uses the first

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float& s1, float& s2) {
  constexpr int VEC = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float v = to_f(e[j]);
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
}

// round(round(x * a) + b) in T: two roundings, no fused multiply-add across them
template <typename T> __device__ __forceinline__ T scale_shift(T x, float a, float b) {
  return from_f<T>(__fadd_rn(to_f(from_f<T>(__fmul_rn(to_f(x), a))), b));
}

// x, y: [slabs][slab]; slab = cg * s elements of one (sample, group), s
// spatial elements a channel; weight, bias: fp32 [groups * cg]. The grid is
// slabs * split blocks in clusters of split. stage_bytes: the dynamic shared
// memory for a block's share, 0 = do not stage. Behind it lie cg floats of a
// and cg of b.
template <typename T>
__global__ void __launch_bounds__(GTHREADS)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, T* __restrict__ y, uint32_t slab, uint32_t s,
                  int cg, int groups, float eps, int split, uint32_t stage_bytes) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ uint4 dyn[];
  __shared__ float part[2][GWARPS];
  __shared__ float mine[2];   // this block's sums, read by the peers
  __shared__ float total[2];  // the slab's
  uint4* stage = dyn;
  float* a_s = reinterpret_cast<float*>(reinterpret_cast<char*>(dyn) + stage_bytes);
  float* b_s = a_s + cg;

  const int tid = threadIdx.x;
  const int rank = split > 1 ? (int)cluster_rank() : 0;
  const int64_t pid = blockIdx.x / split;  // (sample, group)
  const T* xs = x + pid * slab;
  T* ys = y + pid * slab;
  // this block's share of the slab, in whole vectors
  const uint32_t share = ((slab + split - 1) / split + VEC - 1) / VEC * VEC;
  const uint64_t begin64 = (uint64_t)rank * share;
  const uint32_t begin = begin64 < slab ? (uint32_t)begin64 : slab;
  const uint32_t end = begin64 + share < slab ? (uint32_t)(begin64 + share) : slab;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(ys)) & 15) == 0;
  const bool staged = aligned && stage_bytes != 0;
  const uint32_t vecs = aligned ? (end - begin) / VEC : 0;
  const uint4* src = reinterpret_cast<const uint4*>(xs + begin);
  // past the whole vectors: the ragged end of the slab (under VEC elements),
  // or the whole share of a slab off the 16-byte boundary
  const uint32_t loose = begin + vecs * VEC;

  float s1 = 0.f, s2 = 0.f;
  {
    float a1[INFLIGHT], a2[INFLIGHT];
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) a1[k] = a2[k] = 0.f;
    for (uint32_t v0 = tid; v0 < vecs; v0 += INFLIGHT * GTHREADS) {
      uint4 raw[INFLIGHT];
#pragma unroll
      for (int k = 0; k < INFLIGHT; ++k)
        raw[k] = v0 + k * GTHREADS < vecs ? src[v0 + k * GTHREADS] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < INFLIGHT; ++k) {
        // each thread stages the vectors it will itself read back
        if (staged && v0 + k * GTHREADS < vecs) stage[v0 + k * GTHREADS] = raw[k];
        accumulate<T>(raw[k], a1[k], a2[k]);
      }
    }
    s1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
    s2 = (a2[0] + a2[1]) + (a2[2] + a2[3]);
    for (uint32_t i = loose + tid; i < end; i += GTHREADS) {
      const float v = to_f(xs[i]);
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
    for (int w = 0; w < GWARPS; ++w) t += part[tid][w];
    mine[tid] = t;
  }
  if (split > 1) {
    cluster_sync();  // every block's sums are written
    if (tid < 2) {
      float t = 0.f;
      for (int peer = 0; peer < split; ++peer)  // the same order in every block
        t += ld_cluster(cluster_map(smem_u32(&mine[tid]), peer));
      total[tid] = t;
    }
    cluster_arrive();  // this block has read its peers; waited for before it leaves
  } else {
    __syncthreads();
    if (tid < 2) total[tid] = mine[tid];
  }
  __syncthreads();
  const float mean = total[0] / (float)slab;
  const float var = fmaxf(total[1] / (float)slab - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  const int g = (int)(pid % groups);
  for (int j = tid; j < cg; j += GTHREADS) {
    const float a = inv * weight[g * cg + j];
    a_s[j] = to_f(from_f<T>(a));
    b_s[j] = to_f(from_f<T>(bias[g * cg + j] - mean * a));
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(ys + begin);
#pragma unroll 4
  for (uint32_t v = tid; v < vecs; v += GTHREADS) {
    uint4 raw = staged ? stage[v] : src[v];
    T* e = reinterpret_cast<T*>(&raw);
    const uint32_t off = begin + v * VEC;
    uint32_t ch = off / s;
    uint32_t rem = off - ch * s;
    if (rem + VEC <= s) {  // one channel for the whole vector
      const float a = a_s[ch], b = b_s[ch];
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = scale_shift<T>(e[j], a, b);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        e[j] = scale_shift<T>(e[j], a_s[ch], b_s[ch]);
        if (++rem == s) {
          rem = 0;
          ++ch;
        }
      }
    }
    dst[v] = raw;
  }
  for (uint32_t i = loose + tid; i < end; i += GTHREADS) {
    const uint32_t ch = i / s;
    ys[i] = scale_shift<T>(xs[i], a_s[ch], b_s[ch]);
  }
  if (split > 1) cluster_wait();  // no block leaves while its sums are being read
}

// A block may ask for 227 KB of shared memory; the statically declared
// arrays and the group's a and b take their part of it.
constexpr int MAX_DYNAMIC_BYTES = 226 * 1024;

template <typename T>
int launch_group_norm(const void* x, const void* weight, const void* bias, void* y,
                      long long slabs, int cg, long long s, int groups, float eps, int split,
                      int stage_bytes, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (slabs <= 0 || cg <= 0 || s <= 0 || groups <= 0 || (long long)cg * s >= (1LL << 31) ||
      (split != 1 && split != 2 && split != 4 && split != 8) || slabs * split >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const uint32_t slab = (uint32_t)((long long)cg * s);
  const long long share = ((slab + split - 1) / split + VEC - 1) / VEC * VEC;
  const long long dynamic = (long long)stage_bytes + 2LL * cg * (long long)sizeof(float);
  if (stage_bytes < 0 || stage_bytes % 16 || dynamic > MAX_DYNAMIC_BYTES ||
      (stage_bytes != 0 && stage_bytes < share * (long long)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  if (dynamic > 48 * 1024) {  // rare: the wrapper aims at shares of 32 KB and less
    cudaError_t err = cudaFuncSetAttribute(
        group_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(slabs * split));
  cfg.blockDim = dim3(GTHREADS);
  cfg.dynamicSmemBytes = (size_t)dynamic;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, group_norm_kernel<T>, (const T*)x,
                                       (const float*)weight, (const float*)bias, (T*)y, slab,
                                       (uint32_t)s, cg, groups, eps, split,
                                       (uint32_t)stage_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// GroupNorm of contiguous x [slabs / groups, groups * cg, s] into y of the
// same shape and type; weight and bias fp32 [groups * cg]; slabs = samples *
// groups. split in {1, 2, 4, 8} blocks share a slab; stage_bytes is the shared
// memory for a block's share (a multiple of 16 that holds it), or 0 to walk
// the share twice from global memory.
extern "C" int mgld_group_norm_bf16(const void* x, const void* weight, const void* bias, void* y,
                                    long long slabs, int cg, long long s, int groups, float eps,
                                    int split, int stage_bytes, void* stream) {
  return launch_group_norm<__nv_bfloat16>(x, weight, bias, y, slabs, cg, s, groups, eps, split,
                                          stage_bytes, (cudaStream_t)stream);
}

extern "C" int mgld_group_norm_f16(const void* x, const void* weight, const void* bias, void* y,
                                   long long slabs, int cg, long long s, int groups, float eps,
                                   int split, int stage_bytes, void* stream) {
  return launch_group_norm<__half>(x, weight, bias, y, slabs, cg, s, groups, eps, split,
                                   stage_bytes, (cudaStream_t)stream);
}

extern "C" int mgld_group_norm_f32(const void* x, const void* weight, const void* bias, void* y,
                                   long long slabs, int cg, long long s, int groups, float eps,
                                   int split, int stage_bytes, void* stream) {
  return launch_group_norm<float>(x, weight, bias, y, slabs, cg, s, groups, eps, split,
                                  stage_bytes, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// Channel sums: the fp32 sum and sum of squares of each (n, c) row of H*W
// elements of a contiguous [N, C, H, W] tensor. Replaces the TPU kernel
// mgldvsr_tpu/ops/pallas/groupnorm.py (channel_sums -> _channel_sums_impl).
//
// Bound on the H100: one read of x (8 bytes of output a row). The text-to-
// image decode gives it 128-512 rows of 32-512 KB at batch 1, the restore
// 640-2560 rows at batch 5. The Triton kernel it replaced, one program a
// row, was as fast on the device; its launcher took 34-41 us of host a
// call, so at batch 1 the host set the pace. So this is one ctypes launch,
// and the design is about keeping bytes in flight to the end:
//
//  * One block a row: at every shape the port runs (128 rows and more) it
//    was faster than a row split over a thread block cluster of 2-8 blocks.
//  * Each thread issues four 16-byte loads (8 bf16 or f16, 4 f32) before it
//    adds the first, and sums in fp32. Blocks of 256, 512 or 1024 threads:
//    the wrapper's plan (ops/kernels/groupnorm.channel_sums_plan) takes the
//    fewest threads with which the last wave of blocks still keeps 8 MB in
//    flight (at 640 rows of 512 KB all blocks fit the card at once; at 1280
//    a fifth wave of 1024-thread blocks is the one that keeps the memory
//    busy).
//  * The elements before the row's first 16-byte boundary (a row of odd H*W
//    starts off it) and after its last whole vector are summed one at a
//    time.
//  * No atomics: two calls on the same input give the same bits.

namespace {

constexpr int SUMS_MAX_THREADS = 1024;
static_assert(INFLIGHT == 4, "channel_sums_kernel folds four accumulators");

// x: rows of hw elements; s1, s2: fp32 [rows] (sums, sums of squares). The
// grid is one block a row.
template <typename T>
__global__ void __launch_bounds__(SUMS_MAX_THREADS)
channel_sums_kernel(const T* __restrict__ x, float* __restrict__ s1_out,
                    float* __restrict__ s2_out, uint32_t hw) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[2][SUMS_MAX_THREADS / 32];
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const uint32_t row = blockIdx.x;
  const T* xs = x + (int64_t)row * hw;
  // elements before the first 16-byte boundary of the row, whole vectors after it
  uint32_t head = ((16u - (uint32_t)(reinterpret_cast<uintptr_t>(xs) & 15u)) & 15u) / sizeof(T);
  head = head < hw ? head : hw;
  const uint32_t nvec = (hw - head) / VEC;
  const uint4* src = reinterpret_cast<const uint4*>(xs + head);

  float a1[INFLIGHT], a2[INFLIGHT];
#pragma unroll
  for (int k = 0; k < INFLIGHT; ++k) a1[k] = a2[k] = 0.f;
  for (uint32_t v0 = tid; v0 < nvec; v0 += INFLIGHT * threads) {
    uint4 raw[INFLIGHT];
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k)
      raw[k] = v0 + k * threads < nvec ? src[v0 + k * threads] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) accumulate<T>(raw[k], a1[k], a2[k]);
  }
  float s1 = (a1[0] + a1[1]) + (a1[2] + a1[3]);
  float s2 = (a2[0] + a2[1]) + (a2[2] + a2[3]);
  // the head and the ragged end, under VEC elements each
  const uint32_t tail = head + nvec * VEC;
  const uint32_t loose = head + (hw - tail);
  for (uint32_t i = tid; i < loose; i += threads) {
    const float v = to_f(xs[i < head ? i : tail + (i - head)]);
    s1 += v;
    s2 = fmaf(v, v, s2);
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
    for (int w = 0; w < threads / 32; ++w) t += part[tid][w];
    (tid == 0 ? s1_out : s2_out)[row] = t;
  }
}

template <typename T>
int launch_channel_sums(const void* x, void* s1, void* s2, long long rows, long long hw,
                        int threads, cudaStream_t stream) {
  if (rows <= 0 || hw <= 0 || hw >= (1LL << 31) || rows >= (1LL << 31) || threads < 32 ||
      threads > SUMS_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  channel_sums_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      (const T*)x, (float*)s1, (float*)s2, (uint32_t)hw);
  return (int)cudaGetLastError();
}

}  // namespace

// (sum, sum of squares) in fp32 of each of the rows of hw contiguous
// elements of x into s1 and s2: fp32 [rows] each. One block of threads a
// row, a multiple of 32 up to 1024.
extern "C" int mgld_channel_sums_bf16(const void* x, void* s1, void* s2, long long rows,
                                      long long hw, int threads, void* stream) {
  return launch_channel_sums<__nv_bfloat16>(x, s1, s2, rows, hw, threads, (cudaStream_t)stream);
}

extern "C" int mgld_channel_sums_f16(const void* x, void* s1, void* s2, long long rows,
                                     long long hw, int threads, void* stream) {
  return launch_channel_sums<__half>(x, s1, s2, rows, hw, threads, (cudaStream_t)stream);
}

extern "C" int mgld_channel_sums_f32(const void* x, void* s1, void* s2, long long rows,
                                     long long hw, int threads, void* stream) {
  return launch_channel_sums<float>(x, s1, s2, rows, hw, threads, (cudaStream_t)stream);
}
