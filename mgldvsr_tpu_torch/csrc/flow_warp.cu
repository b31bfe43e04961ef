// Bilinear backward warp of NHWC float32 latents by a [N,H,W,2] flow, and
// its input gradient. Replaces the TPU one-hot-matmul kernels
// mgldvsr_tpu/ops/pallas/flow_warp.py (pallas_flow_warp, _pallas_warp_dx)
// where a warp is called on its own (flow_warp_guided); the restore's
// guidance step runs the guidance pair of guidance.cu instead, which does
// the same taps and the loss around them in two launches.
//
// Bound on the H100: memory latency and launch overhead (a guidance-sized
// call moves ~0.6 MB). One thread per pixel: the flow and the four tap
// weights are read and computed once for all channels (warp_taps.cuh), the
// channels go as float4 where they can. The gradient is the transpose, a
// 4-tap scatter with atomicAdd (the order of the adds, and so the last bits
// of dx, vary from run to run), after a memset of dx.
#include "warp_taps.cuh"

namespace {

using namespace mgld;

template <int V>
__global__ void warp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                                float* __restrict__ out, int n, int h, int w, int c) {
  const int hw = h * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (image, pixel)
  if (i >= n * hw) return;
  const int img = i / hw, pix = i - img * hw;
  const int y = pix / w, xx = pix - y * w;
  const Taps t = taps_at(flow + 2 * i, y, xx, h, w);
  const float* src = x + img * hw * c;
  const Layout l = packed_layout(h, w, c);
  for (int ch = 0; ch < c; ch += V) vstore<V>(out + i * c + ch, gather<V>(src, t, h, w, l, ch));
}

template <int V>
__global__ void warp_dx_kernel(const float* __restrict__ g, const float* __restrict__ flow,
                               float* __restrict__ dx, int n, int h, int w, int c) {
  const int hw = h * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * hw) return;
  const int img = i / hw, pix = i - img * hw;
  const int y = pix / w, xx = pix - y * w;
  const Taps t = taps_at(flow + 2 * i, y, xx, h, w);
  float* dst = dx + img * hw * c;
  const Layout l = packed_layout(h, w, c);
  for (int ch = 0; ch < c; ch += V) scatter<V>(dst, t, h, w, l, ch, vload<V>(g + i * c + ch));
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int mgld_warp_fwd_f32(const void* x, const void* flow, void* out, int n, int h,
                                 int w, int c, void* stream) {
  const int pixels = n * h * w;
  if (pixels == 0 || c == 0) return 0;
  auto s = (cudaStream_t)stream;
  const int blocks = blocks_for(pixels, kThreads);
  const Layout l = packed_layout(h, w, c);
  if (vec4_ok(l, c, x) && vec4_ok(l, c, out)) {
    warp_fwd_kernel<4><<<blocks, kThreads, 0, s>>>((const float*)x, (const float*)flow,
                                                     (float*)out, n, h, w, c);
  } else {
    warp_fwd_kernel<1><<<blocks, kThreads, 0, s>>>((const float*)x, (const float*)flow,
                                                     (float*)out, n, h, w, c);
  }
  return (int)cudaGetLastError();
}

extern "C" int mgld_warp_dx_f32(const void* g, const void* flow, void* dx, int n, int h, int w,
                                int c, void* stream) {
  const int pixels = n * h * w;
  if (pixels == 0 || c == 0) return 0;
  auto s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(dx, 0, (size_t)pixels * c * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = blocks_for(pixels, kThreads);
  const Layout l = packed_layout(h, w, c);
  if (vec4_ok(l, c, g) && vec4_ok(l, c, dx)) {
    warp_dx_kernel<4><<<blocks, kThreads, 0, s>>>((const float*)g, (const float*)flow,
                                                    (float*)dx, n, h, w, c);
  } else {
    warp_dx_kernel<1><<<blocks, kThreads, 0, s>>>((const float*)g, (const float*)flow,
                                                    (float*)dx, n, h, w, c);
  }
  return (int)cudaGetLastError();
}
