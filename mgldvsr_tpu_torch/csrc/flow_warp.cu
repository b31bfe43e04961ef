// Bilinear backward warp of NHWC float32 latents by a [N,H,W,2] flow, and
// its input gradient. Replaces the TPU one-hot-matmul kernels
// mgldvsr_tpu/ops/pallas/flow_warp.py (pallas_flow_warp, _pallas_warp_dx).
//
// Bound on the H100: memory latency and launch overhead. The guidance warp
// moves ~0.6 MB a call (6 x 64 x 64 x 4 floats in, out, and the flow),
// far below what saturates HBM, so the design is the simplest direct form:
// one thread per output (pixel, channel) with a 4-tap gather; the gradient
// is the transpose, a 4-tap scatter with fp32 atomicAdd (the order of the
// adds, and so the last bits of dx, vary from run to run).
#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Taps {
  int x0, y0;
  float tx, ty;
};

__device__ __forceinline__ Taps taps_of(const float* flow, int n, int y, int x,
                                        int h, int w) {
  const long p = ((long)n * h + y) * w + x;
  const float px = (float)x + flow[2 * p];
  const float py = (float)y + flow[2 * p + 1];
  const float fx = floorf(px), fy = floorf(py);
  Taps t;
  // clamp before the cast: every tap of a clamped base lies outside
  t.x0 = (int)fminf(fmaxf(fx, -2.f), (float)(w + 1));
  t.y0 = (int)fminf(fmaxf(fy, -2.f), (float)(h + 1));
  t.tx = px - fx;
  t.ty = py - fy;
  return t;
}

__device__ __forceinline__ bool inside(int yy, int xx, int h, int w) {
  return xx >= 0 && xx < w && yy >= 0 && yy < h;
}

__global__ void warp_fwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ flow,
                                float* __restrict__ out, int n, int h, int w,
                                int c) {
  const long total = (long)n * h * w * c;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int ch = (int)(i % c);
    const long pix = i / c;
    const int xx = (int)(pix % w);
    const int yy = (int)((pix / w) % h);
    const int nn = (int)(pix / ((long)w * h));
    const Taps t = taps_of(flow, nn, yy, xx, h, w);
    const float* img = x + (long)nn * h * w * c + ch;
    auto tap = [&](int ty_, int tx_) -> float {
      return inside(ty_, tx_, h, w) ? img[((long)ty_ * w + tx_) * c] : 0.f;
    };
    const float top = tap(t.y0, t.x0) * (1.f - t.tx) + tap(t.y0, t.x0 + 1) * t.tx;
    const float bot =
        tap(t.y0 + 1, t.x0) * (1.f - t.tx) + tap(t.y0 + 1, t.x0 + 1) * t.tx;
    out[i] = top * (1.f - t.ty) + bot * t.ty;
  }
}

__global__ void warp_dx_kernel(const float* __restrict__ g,
                               const float* __restrict__ flow,
                               float* __restrict__ dx, int n, int h, int w,
                               int c) {
  const long total = (long)n * h * w * c;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int ch = (int)(i % c);
    const long pix = i / c;
    const int xx = (int)(pix % w);
    const int yy = (int)((pix / w) % h);
    const int nn = (int)(pix / ((long)w * h));
    const Taps t = taps_of(flow, nn, yy, xx, h, w);
    const float gv = g[i];
    float* img = dx + (long)nn * h * w * c + ch;
    auto scatter = [&](int ty_, int tx_, float wt) {
      if (inside(ty_, tx_, h, w)) atomicAdd(img + ((long)ty_ * w + tx_) * c, wt * gv);
    };
    scatter(t.y0, t.x0, (1.f - t.tx) * (1.f - t.ty));
    scatter(t.y0, t.x0 + 1, t.tx * (1.f - t.ty));
    scatter(t.y0 + 1, t.x0, (1.f - t.tx) * t.ty);
    scatter(t.y0 + 1, t.x0 + 1, t.tx * t.ty);
  }
}

int grid_for(long total, int threads) {
  long blocks = (total + threads - 1) / threads;
  if (blocks > 65535L * 32) blocks = 65535L * 32;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int mgld_warp_fwd_f32(const void* x, const void* flow, void* out,
                                 int n, int h, int w, int c, void* stream) {
  const int threads = 256;
  const long total = (long)n * h * w * c;
  warp_fwd_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)flow, (float*)out, n, h, w, c);
  return (int)cudaGetLastError();
}

extern "C" int mgld_warp_dx_f32(const void* g, const void* flow, void* dx, int n,
                                int h, int w, int c, void* stream) {
  const int threads = 256;
  const long total = (long)n * h * w * c;
  cudaError_t err = cudaMemsetAsync(dx, 0, total * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  warp_dx_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)flow, (float*)dx, n, h, w, c);
  return (int)cudaGetLastError();
}
