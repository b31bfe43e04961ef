// Bilinear backward warp of NHWC float32 images by a [N,H,W,2] flow, and
// its input gradient. Replaces the TPU one-hot-matmul kernels
// mgldvsr_tpu/ops/pallas/flow_warp.py (pallas_flow_warp, _pallas_warp_dx)
// where a warp is called on its own (flow_warp_guided, stage 2's swc loss,
// E*warp); the restore's guidance step runs the guidance pair of
// guidance.cu instead, which does the same taps and the loss around them in
// two launches.
//
// Bound on the H100: device-memory bytes (one read of x and the flow, one
// write of out; ~20 flops an output element) and, for small calls, the
// launch. The tap arithmetic is warp_taps.cuh's, so every path below equals
// the plain warp bit for bit.
//
//  * warp_tile_kernel, every image whose channels cannot go as float4 (the
//    3-channel RGB frames of the swc loss and E*warp): a block owns a 16 x 64
//    pixel tile of one image, four pixels a thread, a warp on 32 neighbouring
//    pixels of a tile row. A thread issues the flow loads of its four pixels
//    before any arithmetic, then gathers each pixel's taps through L1 (a
//    tile's taps are mostly one neighbourhood of the image: a flow of a few
//    pixels hits lines its neighbours fetched) and stores its channels,
//    a warp writing 32 C contiguous floats. Four blocks to an SM (64
//    registers a thread). Staging each tile's tap box in shared memory with
//    16-byte copies, and its outputs for 16-byte stores, was measured on an
//    H100 against this: 47% slower under a smooth flow of a few pixels, 6%
//    faster under a scattered one (PERF.md, section 6).
//  * warp_fwd_kernel<4>, packed channels in fours at 16-byte aligned
//    addresses (4-channel latents): one thread a pixel, each tap one float4.
//  * warp_fwd_kernel<1>, the rest (more than 4 channels, not in fours or
//    off the 16-byte boundary): one thread a pixel, one float a load.
//
// The gradient is the transpose, a 4-tap scatter with atomicAdd (the order
// of the adds, and so the last bits of dx, vary from run to run), after a
// memset of dx.
#include <limits.h>

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

constexpr int TILE_H = 16, TILE_W = 64;
constexpr int TTHREADS = 256;
constexpr int PPT = TILE_H * TILE_W / TTHREADS;  // pixels a thread

template <int C>
__global__ void __launch_bounds__(TTHREADS, 4)
warp_tile_kernel(const float* __restrict__ x, const float* __restrict__ flow,
                 float* __restrict__ out, int h, int w, int tiles_x, int tiles) {
  const int tid = threadIdx.x;
  const int img = blockIdx.x / tiles, tile = blockIdx.x - img * tiles;
  const int ty0 = (tile / tiles_x) * TILE_H, tx0 = (tile % tiles_x) * TILE_W;
  const int hw = h * w;
  const float* const src = x + img * hw * C;
  // the flow of this thread's pixels p = tid + TTHREADS k (tile row p / TILE_W,
  // a warp on 32 neighbouring pixels), all loads issued before any arithmetic
  float fx[PPT], fy[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + TTHREADS * k;
    const int yy = ty0 + p / TILE_W, xx = tx0 + p % TILE_W;
    const int i = img * hw + yy * w + xx;
    const bool live = yy < h && xx < w;
    fx[k] = live ? __ldg(flow + 2 * i) : 0.f;
    fy[k] = live ? __ldg(flow + 2 * i + 1) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + TTHREADS * k;
    const int yy = ty0 + p / TILE_W, xx = tx0 + p % TILE_W;
    if (yy >= h || xx >= w) continue;
    const Taps t = taps_of(fx[k], fy[k], yy, xx, h, w);
    float v[4][C];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ty = t.y0 + (j >> 1), tx = t.x0 + (j & 1);
      const bool in = inside(ty, tx, h, w);
      const float* const tap = src + (ty * w + tx) * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) v[j][ch] = in ? __ldg(tap + ch) : 0.f;
    }
    const float ux = __fsub_rn(1.f, t.tx), uy = __fsub_rn(1.f, t.ty);
    float* const dst = out + (img * hw + yy * w + xx) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      dst[ch] = blend(v[0][ch], v[1][ch], v[2][ch], v[3][ch], t, ux, uy);
  }
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

template <int C>
int launch_tile(const float* x, const float* flow, float* out, int n, int h, int w,
                cudaStream_t s) {
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles = tiles_x * ((h + TILE_H - 1) / TILE_H);
  if ((long long)tiles * n > INT_MAX) return (int)cudaErrorInvalidValue;
  warp_tile_kernel<C><<<tiles * n, TTHREADS, 0, s>>>(x, flow, out, h, w, tiles_x, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mgld_warp_fwd_f32(const void* x, const void* flow, void* out, int n, int h,
                                 int w, int c, void* stream) {
  const int pixels = n * h * w;
  if (pixels == 0 || c == 0) return 0;
  auto s = (cudaStream_t)stream;
  auto xf = (const float*)x, ff = (const float*)flow;
  auto of = (float*)out;
  const Layout l = packed_layout(h, w, c);
  if (vec4_ok(l, c, x) && vec4_ok(l, c, out)) {
    warp_fwd_kernel<4><<<blocks_for(pixels, kThreads), kThreads, 0, s>>>(xf, ff, of, n, h, w, c);
    return (int)cudaGetLastError();
  }
  switch (c) {
    case 1: return launch_tile<1>(xf, ff, of, n, h, w, s);
    case 2: return launch_tile<2>(xf, ff, of, n, h, w, s);
    case 3: return launch_tile<3>(xf, ff, of, n, h, w, s);
    case 4: return launch_tile<4>(xf, ff, of, n, h, w, s);
  }
  warp_fwd_kernel<1><<<blocks_for(pixels, kThreads), kThreads, 0, s>>>(xf, ff, of, n, h, w, c);
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
