// Motion guidance's gradient in two launches: d temporal_warp_loss / d
// latents for NHWC float32 latents [b*t, h, w, c], flows (forward,
// backward) [b, t-1, h, w, 2] and occlusions (fwd, bwd) [b, t-1, h, w, 1].
// On the restore path it replaces both TPU kernels of
// mgldvsr_tpu/ops/pallas/flow_warp.py (pallas_flow_warp :103 and
// _pallas_warp_dx :203) together with the autograd graph of the loss
// around them (ops/kernels/guidance.py says what the loss is).
//
// Each target frame k has at most two masked mean-L1 terms, a backward one
// (mask 1 - fwd_occ) and a forward one (mask 1 - bwd_occ); a term's
// neighbour `prev` is a warp of another frame or zero. With r = m prev -
// m lat[k] and N = b h w c, a term's gradient is -m sgn(r) / N into lat[k]
// (the direct part) and +m sgn(r) / N through the warp's transpose into the
// source frame. The host's term table (GuidanceTable) says, per frame and
// term, which mask, source frame, flow and scratch slot it uses, so every
// mode and every t run these two kernels.
//
//   guidance_residual_kernel (launch A): a thread per (window, frame,
//     pixel) gathers each term's prev with the 4-tap warp (warp_taps.cuh,
//     bit for bit the plain warp), stores the frame's direct part with a
//     plain store (the thread owns the pixel: no atomics, no memset) and
//     writes each warp's cotangent m sgn(r) / N to the scratch.
//   guidance_scatter_kernel (launch B): a thread per (window, warp, pixel)
//     recomputes the taps and adds the cotangent's 4 weighted taps into a
//     64-bit fixed-point accumulator of the source frame (integer atomics:
//     the sum does not depend on the order the atomics land in, so a
//     restore is the same bit for bit from run to run; float atomics made
//     the gradient differ by ~5e-11 between identical calls, which the
//     residuals' sign amplifies over the steps). Then guidance_finish_kernel
//     adds each accumulator to the direct part, which A stored, rounding
//     once. Each weighted tap (a float product, as the plain warp's
//     transpose forms it) is scaled by a power of two that puts 1/N in [2^31, 2^32):
//     exact in double, a tap's rounding to the integer grid under 2^-32 of
//     1/N. Occlusion masks in [0, 1] keep every sum far inside 64 bits.
//
// Bound on the H100: bytes, under 1 MB for the restore's call (5 frames of
// 64x64x4, their flows and masks, the gradient and the scratch), ~0.3 us
// at 3.35 TB/s: each launch sits at a launch's floor. What the pair
// removes is the host's work: the loss's ~170 small elementwise launches, a
// memset and autograd's graph a step. A thread per pixel: the flow, masks
// and tap weights read and computed once for all channels. Laid out for
// the latents the sampler holds, NHWC views of NCHW memory: a pixel's
// channels a plane apart, so the thread walks the channels one plane at a
// time and neighbouring threads touch neighbouring addresses. The latents,
// the gradient and the scratch's slots share that layout, passed as
// strides (packed NHWC works too, one float at a time). 32-bit index
// arithmetic: the wrapper raises before an offset could reach 2^31.
#include <string.h>

#include "warp_taps.cuh"

namespace {

using namespace mgld;

constexpr int kMaxFrames = 32;
constexpr int kThreads = 256;

struct GuidanceTable {
  // per target frame, per term (0: backward, 1: forward): occlusion index
  // (-1: no such term), source frame (-1: prev is zero), flow index, slot
  int term[kMaxFrames][2][4];
  // per scratch slot: source frame, term kind (0: backward flow, 1: forward
  // flow), flow index
  int warp[2 * kMaxFrames][3];
};

__device__ __forceinline__ float sgn(float r) {
  return (float)((r > 0.f) - (r < 0.f));
}

__global__ void guidance_residual_kernel(
    const float* __restrict__ lat, const float* __restrict__ flow_fwd,
    const float* __restrict__ flow_bwd, const float* __restrict__ occ_fwd,
    const float* __restrict__ occ_bwd, float* __restrict__ grad, float* __restrict__ cot,
    const GuidanceTable tab, const Layout l, int b, int t, int h, int w, int c, int slots,
    float inv_n) {
  const int hw = h * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // ((window, frame), pixel)
  if (i >= b * t * hw) return;
  const int frame = i / hw, pix = i - frame * hw;
  const int win = frame / t, k = frame - win * t;
  const int y = pix / w, x = pix - y * w;
  const int at = offset(l, y, x, 0);  // this pixel in a frame of lat, grad and cot
  // each term's mask, source frame and taps, read once for all channels
  bool has[2], warped[2];
  float m[2];
  const float* src[2];
  float* out[2];
  Taps taps[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int* e = tab.term[k][j];
    has[j] = e[0] >= 0;
    warped[j] = has[j] && e[1] >= 0;
    m[j] = 0.f;
    src[j] = nullptr;
    out[j] = nullptr;
    if (!has[j]) continue;
    const int pair = win * (t - 1) + e[0];
    m[j] = __fsub_rn(1.f, (j == 0 ? occ_fwd : occ_bwd)[pair * hw + pix]);
    if (!warped[j]) continue;
    const int fpair = win * (t - 1) + e[2];
    // the backward term warps by the backward flow, the forward term by the forward one
    taps[j] = taps_at((j == 0 ? flow_bwd : flow_fwd) + 2 * (fpair * hw + pix), y, x, h, w);
    src[j] = lat + (win * t + e[1]) * l.frame;
    out[j] = cot + (win * slots + e[3]) * l.frame + at;
  }
  for (int ch = 0; ch < c; ++ch) {
    const float v = lat[frame * l.frame + at + ch * l.chan];
    float direct = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!has[j]) continue;
      const float prev = warped[j] ? gather<1>(src[j], taps[j], h, w, l, ch).v[0] : 0.f;
      // the plain loss's r = m prev - m lat, its sgn, and autograd's
      // (1/N sgn) m; the direct part is its negation
      const float r = __fsub_rn(__fmul_rn(m[j], prev), __fmul_rn(m[j], v));
      const float ct = __fmul_rn(__fmul_rn(inv_n, sgn(r)), m[j]);
      direct = __fsub_rn(direct, ct);
      if (warped[j]) out[j][ch * l.chan] = ct;
    }
    grad[frame * l.frame + at + ch * l.chan] = direct;
  }
}

// one weighted tap of a cotangent into the fixed-point accumulator
__device__ __forceinline__ void tap_add_fixed(unsigned long long* acc, int yy, int xx, int h,
                                              int w, const Layout& l, int ch, float wt, float g,
                                              double scale) {
  if (!inside(yy, xx, h, w)) return;
  const long long q = __double2ll_rn((double)__fmul_rn(g, wt) * scale);
  atomicAdd(acc + offset(l, yy, xx, ch), (unsigned long long)q);
}

__global__ void guidance_scatter_kernel(const float* __restrict__ flow_fwd,
                                        const float* __restrict__ flow_bwd,
                                        const float* __restrict__ cot,
                                        unsigned long long* __restrict__ acc,
                                        const GuidanceTable tab, const Layout l, int b, int t,
                                        int h, int w, int c, int slots, double scale) {
  const int hw = h * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // ((window, slot), pixel)
  if (i >= b * slots * hw) return;
  const int row = i / hw, pix = i - row * hw;
  const int win = row / slots, slot = row - win * slots;
  const int y = pix / w, x = pix - y * w;
  const int* e = tab.warp[slot];
  const int fpair = win * (t - 1) + e[2];
  const Taps taps = taps_at((e[1] == 0 ? flow_bwd : flow_fwd) + 2 * (fpair * hw + pix), y, x,
                            h, w);
  const float* g = cot + row * l.frame + offset(l, y, x, 0);
  unsigned long long* dst = acc + (win * t + e[0]) * l.frame;
  const float ux = __fsub_rn(1.f, taps.tx), uy = __fsub_rn(1.f, taps.ty);
  const float w00 = __fmul_rn(ux, uy), w01 = __fmul_rn(taps.tx, uy);
  const float w10 = __fmul_rn(ux, taps.ty), w11 = __fmul_rn(taps.tx, taps.ty);
  for (int ch = 0; ch < c; ++ch) {
    const float gc = g[ch * l.chan];
    // an occluded or zero-residual pixel adds nothing: skip its atomics
    if (gc == 0.f) continue;
    tap_add_fixed(dst, taps.y0, taps.x0, h, w, l, ch, w00, gc, scale);
    tap_add_fixed(dst, taps.y0, taps.x0 + 1, h, w, l, ch, w01, gc, scale);
    tap_add_fixed(dst, taps.y0 + 1, taps.x0, h, w, l, ch, w10, gc, scale);
    tap_add_fixed(dst, taps.y0 + 1, taps.x0 + 1, h, w, l, ch, w11, gc, scale);
  }
}

// grad += acc / scale over the n elements of both (dense, one layout: the
// same storage offsets), one rounding to float an element
__global__ void guidance_finish_kernel(float* __restrict__ grad,
                                       const long long* __restrict__ acc, double inv_scale,
                                       int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  grad[i] = (float)((double)grad[i] + (double)acc[i] * inv_scale);
}

bool load_table(const int* host, GuidanceTable* tab) {
  if (host == nullptr) return false;
  memcpy(tab, host, sizeof(GuidanceTable));
  return true;
}

}  // namespace

// table: kMaxFrames * 2 * 4 + 2 * kMaxFrames * 3 ints on the host, as
// GuidanceTable lays them out (ops/kernels/guidance.py _kernel_table);
// lat, grad and the scratch's slots share one layout, element strides
// (frame, row, col, chan)
extern "C" int mgld_guidance_residual_f32(const void* lat, const void* flow_fwd,
                                          const void* flow_bwd, const void* occ_fwd,
                                          const void* occ_bwd, void* grad, void* cot,
                                          const int* table, int s_frame, int s_row, int s_col,
                                          int s_chan, int b, int t, int h, int w, int c,
                                          int slots, float inv_n, void* stream) {
  GuidanceTable tab;
  if (t < 1 || t > kMaxFrames || slots < 0 || slots > 2 * kMaxFrames || !load_table(table, &tab))
    return (int)cudaErrorInvalidValue;
  const int threads_total = b * t * h * w;
  if (threads_total == 0 || c == 0) return 0;
  auto s = (cudaStream_t)stream;
  const Layout l{s_frame, s_row, s_col, s_chan};
  guidance_residual_kernel<<<blocks_for(threads_total, kThreads), kThreads, 0, s>>>(
      (const float*)lat, (const float*)flow_fwd, (const float*)flow_bwd, (const float*)occ_fwd,
      (const float*)occ_bwd, (float*)grad, (float*)cot, tab, l, b, t, h, w, c, slots, inv_n);
  return (int)cudaGetLastError();
}

// the layout of grad, of the accumulator (int64, zeros, grad's strides) and of
// cot's slots in element strides (frame, row, col, chan); scale: the fixed
// point's power of two. Launches B, then the finishing kernel.
extern "C" int mgld_guidance_scatter_f32(const void* flow_fwd, const void* flow_bwd,
                                         const void* cot, void* grad, void* acc,
                                         const int* table, int s_frame, int s_row, int s_col,
                                         int s_chan, int b, int t, int h, int w, int c,
                                         int slots, double scale, void* stream) {
  GuidanceTable tab;
  if (t < 1 || t > kMaxFrames || slots < 0 || slots > 2 * kMaxFrames || !load_table(table, &tab))
    return (int)cudaErrorInvalidValue;
  const int threads_total = b * slots * h * w;
  if (threads_total == 0 || c == 0) return 0;
  auto s = (cudaStream_t)stream;
  const Layout l{s_frame, s_row, s_col, s_chan};
  guidance_scatter_kernel<<<blocks_for(threads_total, kThreads), kThreads, 0, s>>>(
      (const float*)flow_fwd, (const float*)flow_bwd, (const float*)cot,
      (unsigned long long*)acc, tab, l, b, t, h, w, c, slots, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = b * t * h * w * c;
  guidance_finish_kernel<<<blocks_for(n, kThreads), kThreads, 0, s>>>(
      (float*)grad, (const long long*)acc, 1.0 / scale, n);
  return (int)cudaGetLastError();
}
