// Self-attention softmax(Q K^T / sqrt(d)) V over [BH, N, D] tensors with an
// fp32 online softmax. Replaces the TPU kernel
// mgldvsr_tpu/ops/pallas/attention.py (resident_attention -> _attn_kernel).
//
// Bound on the H100: arithmetic. At the UNet's 64^2 latents (N = 4096,
// D = 64) one call does 4*N*N*D flops per head, and this first version
// runs them on the fp32 FMA units, not the tensor cores. The TPU kernel
// kept a head's whole K/V resident in VMEM; here K+V for N = 4096 is 1 MB
// in bf16, beyond one block's 227 KB of shared memory, so each block
// streams K/V tiles through shared memory and carries a running max and
// sum per query (flash-attention style). The [N, N] logits never reach
// device memory.
//
// Layout: one block per (query tile of QT rows, bh); thread t owns query
// row q0 + t, keeps its scaled q and its output accumulator in registers,
// and reads each key/value row of the tile as a shared-memory broadcast.
// Keys at index >= N are masked; query rows >= N compute nothing visible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

}  // namespace

extern "C" int mgld_attention_f32(const void* q, const void* k, const void* v, void* o,
                                  int bh, int n, int d, float scale, void* stream) {
  return launch<float>(q, k, v, o, bh, n, d, scale, stream);
}

extern "C" int mgld_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                   int bh, int n, int d, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, n, d, scale, stream);
}
