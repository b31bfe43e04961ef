// RAFT correlation-window lookup, all pyramid levels in one launch. Replaces
// the TPU kernel mgldvsr_tpu/ops/pallas/corr_lookup.py
// (_pallas_window_patches, driven by lookup_corr_pallas) together with the
// bilinear blend and the transposed flatten that lookup_corr_pallas does
// around it.
//
// Bound on the H100: device-memory traffic of the output and of the window
// reads, which are scattered: a query reads (2r+2)^2 cells of its own map at
// every level. The TPU kernel zero-padded every level map and pulled integer
// patches through one-hot matmuls because Mosaic has no dynamic lane gather;
// here the windows are read straight from the unpadded maps with zeros
// outside, so no padded pyramid exists.
//
// One warp per (query, level), the warps of one query side by side in a
// block. The levels' addresses and sizes arrive by value in one struct. A
// warp stages the (2r+2)^2 integer window of its level in shared memory, rows
// of 2r+2 contiguous floats, each cell read once and all of a lane's loads in
// flight together (the first version, a warp a query walking the levels in
// turn, spent its time waiting for one round of loads after another); then
// it blends the (2r+1)^2 samples from the staged window. The output is
// [B, HW, n_levels * (2r+1)^2] (= [B,H,W,C] flattened); within a level,
// cell = xi * win + yi holds the sample at offset (dx, dy) = (xi - r, yi - r),
// the reference's transposed window order. So the samples of (query, level)
// are the contiguous run number query * n_levels + level, a query's whole
// output is one contiguous run, and so is a block's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int LWARPS = 8;  // (query, level) windows of a block

struct Levels {
  const float* corr[MAX_LEVELS];  // [B * HW, hl, wl]
  int hl[MAX_LEVELS];
  int wl[MAX_LEVELS];
};

// R > 0: the radius at compile time (divisions by constants, the window's
// loads unrolled into registers); R == 0: radius
template <int R>
__global__ void __launch_bounds__(LWARPS * 32)
corr_lookup_kernel(const __grid_constant__ Levels lv, const float* __restrict__ coords,
                   float* __restrict__ out, long tasks, int n_levels, int radius) {
  extern __shared__ float windows[];  // [LWARPS][side * side]
  const int r = R > 0 ? R : radius;
  const int side = 2 * r + 2, win = 2 * r + 1;
  const int cells = win * win, area = side * side;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = windows + warp * area;

  for (long task = (long)blockIdx.x * LWARPS + warp; task < tasks;
       task += (long)gridDim.x * LWARPS) {
    const long query = task / n_levels;
    const int l = (int)(task - query * n_levels);
    const int hl = lv.hl[l], wl = lv.wl[l];
    const float inv_scale = 1.f / (float)(1 << l);
    const float cx = coords[2 * query] * inv_scale, cy = coords[2 * query + 1] * inv_scale;
    const float fx = floorf(cx), fy = floorf(cy);
    const float tx = cx - fx, ty = cy - fy;
    // clamp the base before the cast, as the reference clamps its window
    // start: a clamped window lies wholly outside and reads zeros
    const int x0 = (int)fminf(fmaxf(fx, (float)(-r - 2)), (float)(wl + r + 1)) - r;
    const int y0 = (int)fminf(fmaxf(fy, (float)(-r - 2)), (float)(hl + r + 1)) - r;
    const float* map = lv.corr[l] + query * ((long)hl * wl);
    auto cell_at = [&](int i) -> float {
      const int y = y0 + i / side, x = x0 + i % side;
      return (i < area && x >= 0 && x < wl && y >= 0 && y < hl) ? map[(long)y * wl + x] : 0.f;
    };
    if constexpr (R > 0) {
      constexpr int ROUNDS = ((2 * R + 2) * (2 * R + 2) + 31) / 32;
      float v[ROUNDS];
#pragma unroll
      for (int k = 0; k < ROUNDS; ++k) v[k] = cell_at(lane + 32 * k);
#pragma unroll
      for (int k = 0; k < ROUNDS; ++k)
        if (lane + 32 * k < area) mine[lane + 32 * k] = v[k];
    } else {
      for (int i = lane; i < area; i += 32) mine[i] = cell_at(i);
    }
    __syncwarp();
    float* dst = out + task * cells;
    for (int cell = lane; cell < cells; cell += 32) {
      const int xi = cell / win, yi = cell % win;
      const float* p = mine + yi * side + xi;
      dst[cell] = (1.f - ty) * (1.f - tx) * p[0] + (1.f - ty) * tx * p[1] +
                  ty * (1.f - tx) * p[side] + ty * tx * p[side + 1];
    }
    __syncwarp();  // the window is free for the warp's next task
  }
}

}  // namespace

// levels: n_levels rows of (address of a contiguous fp32 [b * hw, hl, wl] map,
// hl, wl), in host memory; coords: fp32 [b * hw, 2] level-0 (x, y); out: fp32
// [b * hw, n_levels * (2 * radius + 1)^2].
extern "C" int mgld_corr_lookup_f32(const long long* levels, const void* coords, void* out,
                                    int b, int hw, int n_levels, int radius, void* stream) {
  if (b <= 0 || hw <= 0 || n_levels <= 0 || n_levels > MAX_LEVELS || radius < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.corr[l] = reinterpret_cast<const float*>(levels[3 * l]);
    lv.hl[l] = (int)levels[3 * l + 1];
    lv.wl[l] = (int)levels[3 * l + 2];
  }
  const int side = 2 * radius + 2;
  const size_t smem = sizeof(float) * LWARPS * side * side;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long tasks = (long)b * hw * n_levels;
  long blocks = (tasks + LWARPS - 1) / LWARPS;
  if (blocks > 65535L * 32) blocks = 65535L * 32;
  auto kernel = radius == 4 ? corr_lookup_kernel<4> : corr_lookup_kernel<0>;
  kernel<<<(int)blocks, LWARPS * 32, smem, (cudaStream_t)stream>>>(
      lv, (const float*)coords, (float*)out, tasks, n_levels, radius);
  return (int)cudaGetLastError();
}
