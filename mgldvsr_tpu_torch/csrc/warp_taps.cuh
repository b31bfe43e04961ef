// The bilinear taps of a backward warp out(p) = x(p + flow(p)), zeros
// outside, over NHWC float32 images: shared by the standalone warp kernels
// (flow_warp.cu) and the guidance pair (guidance.cu).
//
// The arithmetic is the plain version's (ops/warp.py, bilinear_taps and
// flow_warp), one operation for one operation and in the same order. The
// _rn intrinsics keep nvcc from contracting a multiply and an add into one
// fma, so a gathered value equals the plain warp's bit for bit, and the
// scatter's per-tap products equal warp_dx_plain's.
//
// Images are [N, H, W, C] stacks addressed through element strides
// (Layout): packed NHWC, or the planar layout of an NHWC view of NCHW
// memory, in which the restore's sampler holds its latents. The standalone
// warp (packed NHWC only) reads and writes a pixel's channels as float4
// (V = 4: 16 bytes, one access) where they come 4 at a time at 16-byte
// aligned addresses; the guidance pair, laid out for the planar layout,
// one float at a time (V = 1: neighbouring threads on neighbouring
// addresses). Index arithmetic is 32-bit: the wrappers raise where an
// offset would reach 2^31.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mgld {

struct Taps {
  int x0, y0;     // the base tap, clamped to [-2, w+1] x [-2, h+1]
  float tx, ty;   // blend weights towards x0 + 1 and y0 + 1
};

// p + flow at pixel (y, x), the flow (fx, fy): floor, clamp before the cast
// (every tap of a clamped base lies outside and reads zero), fractional
// weights
__device__ __forceinline__ Taps taps_of(float fx, float fy, int y, int x, int h, int w) {
  const float px = __fadd_rn((float)x, fx);
  const float py = __fadd_rn((float)y, fy);
  const float bx = floorf(px), by = floorf(py);
  Taps t;
  t.x0 = (int)fminf(fmaxf(bx, -2.f), (float)(w + 1));
  t.y0 = (int)fminf(fmaxf(by, -2.f), (float)(h + 1));
  t.tx = __fsub_rn(px, bx);
  t.ty = __fsub_rn(py, by);
  return t;
}

__device__ __forceinline__ Taps taps_at(const float* flow_px, int y, int x, int h, int w) {
  return taps_of(flow_px[0], flow_px[1], y, x, h, w);
}

// element strides of an [N, H, W, C] stack
struct Layout {
  int frame, row, col, chan;
};

__host__ __device__ inline Layout packed_layout(int h, int w, int c) {
  return Layout{h * w * c, w * c, c, 1};
}

__device__ __forceinline__ int offset(const Layout& l, int y, int x, int ch) {
  return y * l.row + x * l.col + ch * l.chan;
}

__device__ __forceinline__ bool inside(int yy, int xx, int h, int w) {
  return xx >= 0 && xx < w && yy >= 0 && yy < h;
}

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> vload(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void vstore(float* p, const Vec<V>& a) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else {
    *p = a.v[0];
  }
}

template <int V>
__device__ __forceinline__ Vec<V> vzero() {
  Vec<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = 0.f;
  return r;
}

// channels [ch, ch + V) of the image at tap (yy, xx); zero outside
template <int V>
__device__ __forceinline__ Vec<V> tap_load(const float* img, int yy, int xx, int h, int w,
                                           const Layout& l, int ch) {
  return inside(yy, xx, h, w) ? vload<V>(img + offset(l, yy, xx, ch)) : vzero<V>();
}

// the plain warp's blend of one channel's four taps: top = v00 (1 - tx) +
// v01 tx, bot likewise, out = top (1 - ty) + bot ty, with ux = 1 - tx and
// uy = 1 - ty
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                       const Taps& t, float ux, float uy) {
  const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, t.tx));
  const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, t.tx));
  return __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, t.ty));
}

// the 4-tap bilinear sample of channels [ch, ch + V)
template <int V>
__device__ __forceinline__ Vec<V> gather(const float* img, const Taps& t, int h, int w,
                                         const Layout& l, int ch) {
  const Vec<V> v00 = tap_load<V>(img, t.y0, t.x0, h, w, l, ch);
  const Vec<V> v01 = tap_load<V>(img, t.y0, t.x0 + 1, h, w, l, ch);
  const Vec<V> v10 = tap_load<V>(img, t.y0 + 1, t.x0, h, w, l, ch);
  const Vec<V> v11 = tap_load<V>(img, t.y0 + 1, t.x0 + 1, h, w, l, ch);
  const float ux = __fsub_rn(1.f, t.tx), uy = __fsub_rn(1.f, t.ty);
  Vec<V> out;
#pragma unroll
  for (int j = 0; j < V; ++j) out.v[j] = blend(v00.v[j], v01.v[j], v10.v[j], v11.v[j], t, ux, uy);
  return out;
}

// dst[tap] += wt * g for channels [ch, ch + V), if the tap is inside: one
// vector atomic a tap on Hopper (float4 atomicAdd on global memory, sm_90)
template <int V>
__device__ __forceinline__ void tap_add(float* img, int yy, int xx, int h, int w,
                                        const Layout& l, int ch, float wt, const Vec<V>& g) {
  if (!inside(yy, xx, h, w)) return;
  float* p = img + offset(l, yy, xx, ch);
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(__fmul_rn(g.v[0], wt), __fmul_rn(g.v[1], wt),
                          __fmul_rn(g.v[2], wt), __fmul_rn(g.v[3], wt)));
  } else {
    atomicAdd(p, __fmul_rn(g.v[0], wt));
  }
}

// the transpose of gather: the weights of warp_dx_plain, (1 - tx)(1 - ty),
// tx (1 - ty), (1 - tx) ty, tx ty, each times the cotangent
template <int V>
__device__ __forceinline__ void scatter(float* img, const Taps& t, int h, int w,
                                        const Layout& l, int ch, const Vec<V>& g) {
  const float ux = __fsub_rn(1.f, t.tx), uy = __fsub_rn(1.f, t.ty);
  tap_add<V>(img, t.y0, t.x0, h, w, l, ch, __fmul_rn(ux, uy), g);
  tap_add<V>(img, t.y0, t.x0 + 1, h, w, l, ch, __fmul_rn(t.tx, uy), g);
  tap_add<V>(img, t.y0 + 1, t.x0, h, w, l, ch, __fmul_rn(ux, t.ty), g);
  tap_add<V>(img, t.y0 + 1, t.x0 + 1, h, w, l, ch, __fmul_rn(t.tx, t.ty), g);
}

// float4 access needs packed channels in fours, every stride a multiple of
// 4 elements and a 16-byte aligned base
__host__ inline bool vec4_ok(const Layout& l, int c, const void* base) {
  return c % 4 == 0 && l.chan == 1 && ((l.col | l.row | l.frame) & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(base) & 15) == 0;
}

__host__ inline int blocks_for(int total, int threads) {
  return (int)(((long long)total + threads - 1) / threads);
}

}  // namespace mgld
