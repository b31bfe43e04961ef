// RAFT correlation-window lookup for one pyramid level. Replaces the TPU
// kernel mgldvsr_tpu/ops/pallas/corr_lookup.py (_pallas_window_patches,
// driven by lookup_corr_pallas) together with the bilinear blend and the
// transposed flatten that lookup_corr_pallas does around it.
//
// Bound on the H100: device-memory traffic of the output and the scattered
// window reads. The TPU kernel zero-padded every level map and pulled
// integer patches through one-hot matmuls because Mosaic has no dynamic
// lane gather; here each thread reads its four bilinear taps straight from
// the unpadded level map with zeros outside, so no padded pyramid exists.
//
// One thread per (pair b, query q, window cell). The output is
// [B, HW, n_levels * (2r+1)^2] (= [B,H,W,C] flattened); within a level,
// cell = xi * win + yi holds the sample at offset (dx, dy) = (xi - r,
// yi - r): the reference's transposed window order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void corr_lookup_kernel(const float* __restrict__ corr,
                                   const float* __restrict__ coords,
                                   float* __restrict__ out, int b, int hw, int hl,
                                   int wl, int level, int n_levels, int radius) {
  const int win = 2 * radius + 1;
  const int cells = win * win;
  const long total = (long)b * hw * cells;
  const float inv_scale = 1.f / (float)(1 << level);
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int cell = (int)(i % cells);
    const long query = i / cells;  // b * hw + q
    const int xi = cell / win, yi = cell % win;
    const float cx = coords[2 * query] * inv_scale;
    const float cy = coords[2 * query + 1] * inv_scale;
    const float fx = floorf(cx), fy = floorf(cy);
    const float tx = cx - fx, ty = cy - fy;
    // clamp the base before the cast, as the reference clamps its window
    // start: a clamped window lies wholly outside and reads zeros
    const int x0 = (int)fminf(fmaxf(fx, (float)(-radius - 2)), (float)(wl + radius + 1));
    const int y0 = (int)fminf(fmaxf(fy, (float)(-radius - 2)), (float)(hl + radius + 1));
    const int xx = x0 - radius + xi;
    const int yy = y0 - radius + yi;
    const float* map = corr + query * (long)hl * wl;
    auto at = [&](int y, int x) -> float {
      return (x >= 0 && x < wl && y >= 0 && y < hl) ? map[(long)y * wl + x] : 0.f;
    };
    const float val = (1.f - ty) * (1.f - tx) * at(yy, xx) + (1.f - ty) * tx * at(yy, xx + 1) +
                      ty * (1.f - tx) * at(yy + 1, xx) + ty * tx * at(yy + 1, xx + 1);
    out[query * (long)(n_levels * cells) + level * cells + cell] = val;
  }
}

}  // namespace

extern "C" int mgld_corr_lookup_f32(const void* corr, const void* coords, void* out,
                                    int b, int hw, int hl, int wl, int level,
                                    int n_levels, int radius, void* stream) {
  const int threads = 256;
  const long total = (long)b * hw * (2 * radius + 1) * (2 * radius + 1);
  long blocks = (total + threads - 1) / threads;
  if (blocks > 65535L * 32) blocks = 65535L * 32;
  corr_lookup_kernel<<<(int)(blocks > 0 ? blocks : 1), threads, 0, (cudaStream_t)stream>>>(
      (const float*)corr, (const float*)coords, (float*)out, b, hw, hl, wl, level, n_levels,
      radius);
  return (int)cudaGetLastError();
}
