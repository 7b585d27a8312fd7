// Backward of one pyramid level of the fused correlation + 7x7 bilinear
// window lookup (the forward is corr_level.cu).
//
// No Pallas kernel computes this: the JAX package differentiates its lookup
// (droid_slam_tpu/ops/corr.py::CorrPyramid, corr_index) with XLA's autodiff,
// and the reference hand-writes it as corr_index_backward / altcorr_backward.
// Per edge n and source pixel p the forward is
//   out[n, p, i*7 + j] = sum over the 4 bilinear corners of tap (i, j) of
//                        w_corner * <f1[n, p], f2[n, y, x]>
// over the 8x8 integer support at (x0, y0) = floor(clip(c - r, -1e4, 1e4)),
// corners outside the map contributing nothing. Given g = dL/dout [N, P, 49]
// this launch computes, for a chunk of edges:
//   - dPatch[n, p] (8x8): each support cell's sum of g * corner weight over
//     the taps that read it, zero outside the map;
//   - df1[n, p, :] = sum over the support of dPatch * f2[n, y, x, :], one
//     fmaf chain per channel over the cells in row-major order;
//   - dV[n, p, :] (the pixel's row of the dense volume gradient, H2*W2
//     floats): dPatch at the support cells, zero elsewhere.
// The wrapper (ops/corr.py::corr_level_backward) then forms
// df2[n] = dV[n]^T f1[n] with one batched product. Each output element is
// written by one thread from sums in a fixed order: no atomics, so equal
// inputs give equal bits; rows of dV never collide, which is what lets the
// many-to-one scatter onto f2 go through a product.
//
// What bounds it on the H100 (the training path's shapes: 208 edges, 48x64
// down to 6x8, C=128, f32): the bytes of each level's call (g, f1, f2 and
// coords read once, df1 and df2 written once; f1 and df1 count at every
// level, as in the corr_level rows) take ~1.2 ms over the 4 levels at
// 3.35 TB/s, its 4*C operations per in-map support cell (df1 and df2) less.
// This first design moves far more: the dense dV (7.9 GB at level 0, in
// chunks) is written here and read again by the product, which does
// 2*P*H2*W2*C operations per edge instead of 2*64*C per pixel. A fused df2
// (the contributions sorted by target row, as corr_tile_f32.cuh's sort
// launch sorts pixels) is later work.
//
// Layout: one warp per source pixel, 8 pixels per block, grid (P/8, edges
// of the chunk). A warp stages its pixel's 8x8 dPatch in shared memory (two
// cells per lane), writes its dV row with the lanes along the map's
// columns, and accumulates df1 with each lane owning channels lane + 32k.

#include <cuda_runtime.h>

#include "corr_tile.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLaneChannels = 8;  // C <= 256

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
corr_backward_kernel(const float* __restrict__ g, const float* __restrict__ f2, const float* __restrict__ coords,
                     float* __restrict__ df1, float* __restrict__ dV, int P, int H2, int W2, int C) {
  using corr_tile::kRd;
  using corr_tile::kRows;
  __shared__ float patch[kWarpsPerBlock][kRows * kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= P) return;  // whole warps only; no block barrier follows
  const long long n = blockIdx.y;
  const long long pix = n * P + p;

  // the forward's window origin and fractions (corr_tile::origin)
  const float cx = coords[2 * pix], cy = coords[2 * pix + 1];
  const float x0f = corr_tile::origin(cx), y0f = corr_tile::origin(cy);
  const float dx = (cx - corr_tile::kR) - x0f;
  const float dy = (cy - corr_tile::kR) - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;

  // dPatch: cell (jy, ix) is corner v00 of tap (ix, jy), v10 of (ix-1, jy),
  // v01 of (ix, jy-1) and v11 of (ix-1, jy-1); tap (i, j) is g[i*7 + j]
  const float* gp = g + pix * (kRd * kRd);
  const float w00 = (1.0f - dx) * (1.0f - dy), w10 = dx * (1.0f - dy);
  const float w01 = (1.0f - dx) * dy, w11 = dx * dy;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int cell = lane + 32 * k;
    const int jy = cell / kRows, ix = cell % kRows;
    float v = 0.0f;
    if (ix < kRd && jy < kRd) v += gp[ix * kRd + jy] * w00;
    if (ix > 0 && jy < kRd) v += gp[(ix - 1) * kRd + jy] * w10;
    if (ix < kRd && jy > 0) v += gp[ix * kRd + jy - 1] * w01;
    if (ix > 0 && jy > 0) v += gp[(ix - 1) * kRd + jy - 1] * w11;
    const int y = y0 + jy, x = x0 + ix;
    const bool in_map = y >= 0 && y < H2 && x >= 0 && x < W2;
    patch[warp][cell] = in_map ? v : 0.0f;
  }
  __syncwarp();

  // the pixel's dV row: dPatch inside the support, zero elsewhere
  float* row = dV + pix * ((long long)H2 * W2);
  for (int y = 0; y < H2; ++y) {
    const int jy = y - y0;
    const bool row_in = jy >= 0 && jy < kRows;
    for (int x = lane; x < W2; x += 32) {
      const int ix = x - x0;
      row[(long long)y * W2 + x] = (row_in && ix >= 0 && ix < kRows) ? patch[warp][jy * kRows + ix] : 0.0f;
    }
  }

  // df1: the support's f2 rows weighted by dPatch, cells in row-major order
  float acc[kMaxLaneChannels];
#pragma unroll
  for (int k = 0; k < kMaxLaneChannels; ++k) acc[k] = 0.0f;
  const float* f2n = f2 + n * H2 * W2 * C;
  for (int cell = 0; cell < kRows * kRows; ++cell) {
    const int y = y0 + cell / kRows, x = x0 + cell % kRows;
    if (y < 0 || y >= H2 || x < 0 || x >= W2) continue;
    const float w = patch[warp][cell];
    const float* src = f2n + ((long long)y * W2 + x) * C + lane;
#pragma unroll
    for (int k = 0; k < kMaxLaneChannels; ++k)
      if (32 * k < C) acc[k] = fmaf(w, src[32 * k], acc[k]);
  }
  float* dst = df1 + pix * C + lane;
#pragma unroll
  for (int k = 0; k < kMaxLaneChannels; ++k)
    if (32 * k < C) dst[32 * k] = acc[k];
}

}  // namespace

// g [N, P, 49], f2 [N, H2, W2, C], coords [N, P, 2], df1 [N, P, C], dV
// [N, P, H2*W2], all f32 and contiguous, for the N edges of one chunk.
// Returns the CUDA error of the launch.
extern "C" int corr_backward_launch(const void* g, const void* f2, const void* coords,
                                    void* df1, void* dV, int N, int P, int H2, int W2, int C,
                                    int radius, void* stream) {
  if (radius != corr_tile::kR || N <= 0 || N > 65535 || P <= 0 || H2 <= 0 || W2 <= 0 ||
      C <= 0 || C % 32 != 0 || C > 32 * kMaxLaneChannels)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kWarpsPerBlock - 1) / kWarpsPerBlock, N);
  corr_backward_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(df1), static_cast<float*>(dV), P, H2, W2, C);
  return (int)cudaGetLastError();
}
