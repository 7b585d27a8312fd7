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
// the backward is, with dPatch[n, p] (8x8) each support cell's sum of g *
// corner weight over the taps that read it, zero outside the map:
//   df1[n, p, :]    = sum over the support of dPatch * f2[n, y, x, :];
//   df2[n, y, x, :] = sum over the pixels whose support holds (y, x) of
//                     dPatch[n, p][y - y0][x - x0] * f1[n, p, :].
//
// What bounds it on the H100 (the training path's shapes: 208 edges, 48x64
// down to 6x8, C=128, f32): the bytes of each level's call (g, f1, f2 and
// coords read once, df1 and df2 written once; f1 and df1 count at every
// level) take ~1.2 ms over the 4 levels at 3.35 TB/s; its 4*C operations
// per in-map support cell (df1 and df2), ~0.94 ms at 67 TFLOP/s, a little
// less. f32 FMA on the CUDA cores throughout: the tensor cores take f32
// only as TF32, which would break the 1e-4 * max|plain| bound.
//
// The first design (one warp per pixel gathering df1 from device memory,
// each pixel's row of a dense volume gradient dV [P, H2*W2] written in
// 2 GiB chunks of edges, then df2 = dV^T f1 as one cuBLAS product) took
// 34.59 ms per 4-level backward: the dense dV (7.9 GB at level 0) and its
// product, and a df1 gather that loaded each cell's channels with no reuse.
//
// This design: three launches per level, one entry point (stage 0, 1, 2),
// nothing summed with atomics, so equal inputs give equal bits.
//   0. corr_sort_kernel (corr_tile_f32.cuh) sorts each edge's pixels by
//      window row, then window column (windows off the map's rows last), and
//      writes each bin's start: the pixels whose window has first row y0 and
//      first column in [a, b] are one contiguous range of perm.
//   1. df1 over sorted-pixel tiles: a block takes one edge and 64
//      consecutive sorted pixels (8 warps of 8), computes their dPatch into
//      shared memory (and into the scratch dpatch [N, P, 64], by pixel, for
//      stage 2) while the first f2 row of the tile's band is in flight, and
//      streams the band's rows through two cp.async row buffers (two blocks
//      fit on an SM at level 0). Per staged row a warp takes the in-map
//      columns of its pixels' windows that hold the row, lays the 8 pixels'
//      weights on them out as [column][pixel] in shared memory (zero where a
//      window misses), and for each column loads f2 once (a float4 of
//      channels per lane) and adds it into all 8 pixels' register tiles:
//      one 16-byte load per 32 fmaf, where a load per pixel and cell took 4.
//   2. df2 per target: a block owns one edge, 8 map rows (a warp each) and
//      one tile of 8 columns [xs, xs+8), all channels (a float4 per lane and
//      group of 128). Its candidates are the pixels with y0 in
//      [y_lo - 7, y_hi] and x0 in [xs - 7, xs + 7]: one range of perm per
//      bin row. In rounds of 64, warps 0 and 1 read them (a ballot drops the
//      far-left windows that share the bin of x0 = -7), the block stages
//      their f1 rows and the dPatch rows of its 8 map rows with cp.async,
//      shifts each candidate's weights onto the tile's columns, and each
//      warp adds the candidates whose window holds its row into acc[8
//      columns][4 channels]: a candidate's f1 row leaves device memory once
//      per block, not once per row. Every df2 element is written once (0
//      where no candidate reaches it).
//
// Order contract (what the tests' numpy emulations reproduce):
//   - df1[n, p, c] is one fmaf chain from 0 over p's support cells in
//     row-major order (rows ascending, then columns), cells off the map
//     skipped: the first design's chain (the zero weights stage 1 adds for
//     columns outside a window leave the sum's bits as they are for finite
//     f2), so its bits did not move;
//   - df2[n, y, x, c] is one fmaf chain from 0 over the candidates in sorted
//     order: bin ascending (y0, then x0), then pixel ascending within a bin.
//
// What holds it above its bound (phase 9a of chip_smoke.py at the training
// shapes, tuned over six variants, PERF.md): stage 1's staging of f2 rows
// (each row is staged by every tile whose band holds it, ~8x at level 0)
// and its per-block set-up; stage 2's rounds (each candidate's f1 and dPatch
// rows staged by ~4 blocks at level 0 and its chain at level 3 thousands of
// candidates long), and the 1.9x of its fmaf that multiply a zero (a window
// straddles two column tiles).
//
// Edges lie on grid x with the tiles (N * tiles blocks), so no launch has a
// grid-y limit of 65535 edges.

#include <cuda_runtime.h>

#include "corr_tile.cuh"
#include "corr_tile_f32.cuh"

namespace {

using namespace corr_tile_f32;

constexpr int kCells = kRows * kRows;  // 64 support cells
// stage 1: sorted pixels per block, warps, pixels per warp, f2 row buffers
constexpr int kTilePix = 64;
constexpr int kDf1Warps = 8;
constexpr int kDf1Threads = kDf1Warps * 32;
constexpr int kWarpPix = kTilePix / kDf1Warps;
constexpr int kRing = 2;
// stage 2: target rows per block (one warp each), tile columns, candidates
constexpr int kDf2Rows = 8;
constexpr int kDf2Threads = kDf2Rows * 32;
constexpr int kCols = 8;
constexpr int kBatch = 64;  // candidates staged per round: found by warps 0 and 1

// dynamic shared memory of stages 1 and 2 (mirrored by
// ops/corr.py::corr_backward_plan): stage 1 the f2 row buffers and the
// tile's dPatch, stage 2 the round's f1 rows and shifted weights
__host__ __device__ constexpr int df1_smem_bytes(int w2, int c) {
  return (kRing * w2 * row_floats(c) + kTilePix * kCells + kDf1Warps * w2 * kWarpPix) * 4;
}
__host__ __device__ constexpr int df2_smem_bytes(int c) { return (kBatch * c + 2 * kBatch * kCells) * 4; }
// stage 1's static shared memory: the tile's origins, fractions, pixels and
// the band reduction's scratch
constexpr int kDf1StaticBytes = 5 * kTilePix * 4 + kRed * 4;
__host__ __device__ constexpr int df1_blocks_per_edge(int p) { return (p + kTilePix - 1) / kTilePix; }
__host__ __device__ constexpr int df2_blocks_per_edge(int h2, int w2) {
  return (h2 + kDf2Rows - 1) / kDf2Rows * ((w2 + kCols - 1) / kCols);
}

template <int C>
__global__ void __launch_bounds__(kDf1Threads, 2)
corr_backward_df1_kernel(const float* __restrict__ g,       // [N, P, 49]
                         const float* __restrict__ f2,      // [N, H2, W2, C]
                         const float* __restrict__ coords,  // [N, P, 2]
                         const int* __restrict__ perm,      // [N, P]: stage 0's order
                         float* __restrict__ dpatch,        // [N, P, 64]
                         float* __restrict__ df1,           // [N, P, C]
                         int P, int H2, int W2) {
  constexpr int kG = (C / 4 + 31) / 32;  // float4 channel groups per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);       // [kRing][W2][C + 4]
  float* patch = ring + kRing * W2 * row_floats(C);   // [kTilePix][64], by tile position
  float* wt = patch + kTilePix * kCells + (threadIdx.x >> 5) * W2 * kWarpPix;  // the warp's [W2][8]
  __shared__ int sx0[kTilePix], sy0[kTilePix], spix[kTilePix], sred[kRed];
  __shared__ float sdx[kTilePix], sdy[kTilePix];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = df1_blocks_per_edge(P);
  const int n = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - n * tiles) * kTilePix;
  const int* pn = perm + (size_t)n * P;
  const int nvalid = min(kTilePix, P - p0);

  tile_pixels(pn, P, p0, kTilePix, spix);
  const int2 band = tile_band<kTilePix>(coords + (size_t)n * P * 2, P, p0, H2, sy0, sx0, sdx, sdy,
                                        sred, pn);  // ends with a block barrier

  // the band's first rows are in flight while dPatch is computed
  const float* f2n = f2 + (size_t)n * H2 * W2 * C;
  const size_t row_elems = (size_t)W2 * C;
  const int buf_floats = W2 * row_floats(C);
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (band.x + s <= band.y) stage_row_f32<C>(f2n + (band.x + s) * row_elems, ring + s * buf_floats, W2);
    cp_async_commit();  // possibly empty: keeps one group per row
  }

  // dPatch: cell (jy, ix) is corner v00 of tap (ix, jy), v10 of (ix-1, jy),
  // v01 of (ix, jy-1) and v11 of (ix-1, jy-1); tap (i, j) is g[i*7 + j]
#pragma unroll 4
  for (int q = tid; q < kTilePix * kCells; q += kDf1Threads) {
    const int i = q / kCells, cell = q - i * kCells;
    float v = 0.0f;
    if (i < nvalid) {
      const int jy = cell / kRows, ix = cell % kRows;
      const float dx = sdx[i], dy = sdy[i];
      const float* gp = g + ((size_t)n * P + spix[i]) * (kRd * kRd);
      const float w00 = (1.0f - dx) * (1.0f - dy), w10 = dx * (1.0f - dy);
      const float w01 = (1.0f - dx) * dy, w11 = dx * dy;
      if (ix < kRd && jy < kRd) v += gp[ix * kRd + jy] * w00;
      if (ix > 0 && jy < kRd) v += gp[(ix - 1) * kRd + jy] * w10;
      if (ix < kRd && jy > 0) v += gp[ix * kRd + jy - 1] * w01;
      if (ix > 0 && jy > 0) v += gp[(ix - 1) * kRd + jy - 1] * w11;
      const int y = sy0[i] + jy, x = sx0[i] + ix;
      const bool in_map = y >= 0 && y < H2 && x >= 0 && x < W2;
      v = in_map ? v : 0.0f;
      dpatch[((size_t)n * P + spix[i]) * kCells + cell] = v;
    }
    patch[q] = v;
  }

  // the warp's pixels: tile positions warp * 8 + j (past P: kNoRow, no row)
  int y0[kWarpPix], x0[kWarpPix];
#pragma unroll
  for (int j = 0; j < kWarpPix; ++j) {
    y0[j] = sy0[warp * kWarpPix + j];
    x0[j] = sx0[warp * kWarpPix + j];
  }
  float acc[kWarpPix][kG][4];
#pragma unroll
  for (int j = 0; j < kWarpPix; ++j)
#pragma unroll
    for (int s = 0; s < kG; ++s) acc[j][s][0] = acc[j][s][1] = acc[j][s][2] = acc[j][s][3] = 0.f;

  for (int y = band.x; y <= band.y; ++y) {
    const int r = y - band.x;
    if (y + kRing - 1 <= band.y)
      stage_row_f32<C>(f2n + (y + kRing - 1) * row_elems, ring + (r + kRing - 1) % kRing * buf_floats, W2);
    cp_async_commit();
    cp_async_wait<kRing - 1>();  // row y's group has landed
    __syncthreads();             // and the dPatch tile, on the first row
    const float* cur = ring + r % kRing * buf_floats;
    // the in-map columns [lo, lo + U) of the windows of the warp's pixels
    // that hold row y (warp-uniform), and the warp's weights on them,
    // transposed: wt[u][j] = dPatch_j[y - y0_j][lo + u - x0_j], 0 where
    // pixel j's window misses the column or the row. Each column's f2
    // float4 is loaded once and meets all 8 pixels' weights: a zero weight
    // adds fmaf(0, f2, acc) = acc, so every pixel's chain is still its
    // in-map cells in row-major order
    int lo = 1 << 30, hi = -1;
#pragma unroll
    for (int j = 0; j < kWarpPix; ++j)
      if ((unsigned)(y - y0[j]) < (unsigned)kRows) {
        lo = min(lo, x0[j]);
        hi = max(hi, x0[j] + kRows - 1);
      }
    lo = max(lo, 0);
    hi = min(hi, W2 - 1);
    if (lo <= hi) {
      const int U = hi - lo + 1;
      for (int e = lane; e < U * kWarpPix; e += 32) {
        const int u = e / kWarpPix, j = e % kWarpPix;
        const int i = warp * kWarpPix + j;
        const int jy = y - sy0[i], ix = lo + u - sx0[i];
        wt[e] = ((unsigned)jy < (unsigned)kRows && (unsigned)ix < (unsigned)kRows)
                    ? patch[i * kCells + jy * kRows + ix] : 0.f;
      }
      __syncwarp();
      for (int u = 0; u < U; ++u) {
        const float4 wa = *reinterpret_cast<const float4*>(wt + u * kWarpPix);
        const float4 wb = *reinterpret_cast<const float4*>(wt + u * kWarpPix + 4);
        const float w[kWarpPix] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int s = 0; s < kG; ++s) {
          if ((lane + 32 * s) * 4 < C) {
            const float4 f = *reinterpret_cast<const float4*>(cur + (lo + u) * row_floats(C) + (lane + 32 * s) * 4);
#pragma unroll
            for (int j = 0; j < kWarpPix; ++j) {
              acc[j][s][0] = fmaf(w[j], f.x, acc[j][s][0]);
              acc[j][s][1] = fmaf(w[j], f.y, acc[j][s][1]);
              acc[j][s][2] = fmaf(w[j], f.z, acc[j][s][2]);
              acc[j][s][3] = fmaf(w[j], f.w, acc[j][s][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // before the buffer of row y is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kWarpPix; ++j) {
    const int i = warp * kWarpPix + j;
    if (i >= nvalid) continue;
    float* dst = df1 + ((size_t)n * P + spix[i]) * C;
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      const int cg = lane + 32 * s;
      if (cg * 4 < C)
        *reinterpret_cast<float4*>(dst + cg * 4) =
            make_float4(acc[j][s][0], acc[j][s][1], acc[j][s][2], acc[j][s][3]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kDf2Threads, C <= 128 ? 3 : 2)
corr_backward_df2_kernel(const float* __restrict__ f1,      // [N, P, C]
                         const float* __restrict__ coords,  // [N, P, 2]
                         const int* __restrict__ perm,      // [N, P]: stage 0's order
                         const int* __restrict__ starts,    // [N, bins + 1]: stage 0's bin starts
                         const float* __restrict__ dpatch,  // [N, P, 64]: stage 1's
                         float* __restrict__ df2,           // [N, H2, W2, C]
                         int P, int H2, int W2) {
  constexpr int kG = (C / 4 + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sf1 = reinterpret_cast<float*>(smem);  // [kBatch][C]: the round's f1 rows
  float* sraw = sf1 + kBatch * C;               // [kBatch][64]: the round's dPatch rows
  float* sw = sraw + kBatch * kCells;           // [kBatch][8 rows][8 tile columns]
  __shared__ int sp[kBatch], sy0[kBatch], sd[kBatch];
  __shared__ int rs[kDf2Rows + kRows], rcum[kDf2Rows + kRows + 1], scount[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (W2 + kCols - 1) / kCols;
  const int per_edge = df2_blocks_per_edge(H2, W2);
  const int n = blockIdx.x / per_edge;
  const int rem = blockIdx.x - n * per_edge;
  const int y_lo = rem / n_tiles * kDf2Rows, xs = (rem % n_tiles) * kCols;
  const int y_hi = min(y_lo + kDf2Rows, H2) - 1;
  const int y = y_lo + warp;  // the warp's target row (idle past y_hi)

  const int bins_row = W2 + kRows;
  const int* sn = starts + (size_t)n * (sort_bins(H2, W2) + 1);
  const int* pn = perm + (size_t)n * P;
  const float* cn = coords + (size_t)n * P * 2;
  const float* dpn = dpatch + (size_t)n * P * kCells;
  const float* f1n = f1 + (size_t)n * P * C;

  // the stream of candidates: bin rows ky = y_lo .. y_hi + 7 (first window
  // row ky - 7), each the bins of x0 in [xs - 7, min(xs + 7, W2 - 1)]
  const int n_ky = y_hi + kRows - y_lo;
  if (tid == 0) {
    const int kx_lo = xs, kx_hi = min(xs + 2 * kRows - 2, W2 + kRows - 2);
    int total = 0;
    for (int k = 0; k < n_ky; ++k) {
      const int ky = y_lo + k;
      rs[k] = sn[ky * bins_row + kx_lo];
      rcum[k] = total;
      total += sn[ky * bins_row + kx_hi + 1] - rs[k];
    }
    rcum[n_ky] = total;
  }
  __syncthreads();
  const int total = rcum[n_ky];

  float acc[kCols][kG][4];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int s = 0; s < kG; ++s) acc[k][s][0] = acc[k][s][1] = acc[k][s][2] = acc[k][s][3] = 0.f;

  // warps 0 and 1 find a round's candidates in stream order (one each per
  // lane) and keep those whose window meets the tile's columns (the
  // far-left windows share the bin of x0 = -7); the next round's are
  // loaded while this round is staged and multiplied
  int p = 0, d = kRows, k = 0;
  auto find = [&](int b) {
    p = 0;
    d = kRows;
    const int idx = b + warp * 32 + lane;
    if (warp < 2 && idx < total) {
      while (rcum[k + 1] <= idx) ++k;
      p = pn[rs[k] + idx - rcum[k]];
      d = (int)origin(cn[2 * (size_t)p]) - xs;  // x0 - xs
    }
  };
  find(0);
  for (int b = 0; b < total; b += kBatch) {
    const bool hit = warp < 2 && d > -kRows && d < kRows;
    const unsigned vote = __ballot_sync(kFull, hit);
    if (warp < 2 && lane == 0) scount[warp] = __popc(vote);
    __syncthreads();
    const int count = scount[0] + scount[1];
    if (hit) {  // warp 1's candidates follow warp 0's
      const int slot = (warp == 1 ? scount[0] : 0) + __popc(vote & ((1u << lane) - 1u));
      sp[slot] = p;
      sy0[slot] = y_lo + k - (kRows - 1);
      sd[slot] = d;
    }
    __syncthreads();
    // stage the round (16-byte cp.async copies): f1 rows and dPatch rows
    constexpr int kVec = C / 4;
    for (int q = threadIdx.x; q < count * kVec; q += kDf2Threads) {
      const int m = q / kVec, v = q - m * kVec;
      cp_async16(sf1 + m * C + v * 4, f1n + (size_t)sp[m] * C + v * 4);
    }
    for (int q = threadIdx.x; q < count * (kCells / 4); q += kDf2Threads) {
      const int m = q / (kCells / 4), v = q - m * (kCells / 4);
      const int row = sy0[m] + v / (kRows / 4);  // the map row of this piece
      if (row >= y_lo && row <= y_hi)  // only the rows the block's warps read
        cp_async16(sraw + m * kCells + v * 4, dpn + (size_t)sp[m] * kCells + v * 4);
    }
    cp_async_commit();
    find(b + kBatch);
    cp_async_wait<0>();
    __syncthreads();
    // each candidate's dPatch shifted onto the tile's columns:
    // sw[m][jy][k] = dPatch[jy][k - d], zero outside the window
    for (int q = threadIdx.x; q < count * kCells; q += kDf2Threads) {
      const int m = q / kCells, e = q - m * kCells;
      const int src = (e % kCols) - sd[m];
      sw[q] = (unsigned)src < (unsigned)kRows ? sraw[m * kCells + (e / kCols) * kRows + src] : 0.f;
    }
    __syncthreads();
    if (y <= y_hi) {
      for (int m = 0; m < count; ++m) {
        const int jy = y - sy0[m];
        if ((unsigned)jy >= (unsigned)kRows) continue;  // warp-uniform: the window misses row y
        const float4 wa = *reinterpret_cast<const float4*>(sw + m * kCells + jy * kCols);
        const float4 wb = *reinterpret_cast<const float4*>(sw + m * kCells + jy * kCols + 4);
        const float wk[kCols] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int s = 0; s < kG; ++s) {
          const int cg = lane + 32 * s;
          if (cg * 4 < C) {
            const float4 f = *reinterpret_cast<const float4*>(sf1 + m * C + cg * 4);
#pragma unroll
            for (int kk = 0; kk < kCols; ++kk) {
              acc[kk][s][0] = fmaf(wk[kk], f.x, acc[kk][s][0]);
              acc[kk][s][1] = fmaf(wk[kk], f.y, acc[kk][s][1]);
              acc[kk][s][2] = fmaf(wk[kk], f.z, acc[kk][s][2]);
              acc[kk][s][3] = fmaf(wk[kk], f.w, acc[kk][s][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // before the next round overwrites the staging
  }

  if (y > y_hi) return;
  float* dst = df2 + (((size_t)n * H2 + y) * W2 + xs) * C;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (xs + k >= W2) break;
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      const int cg = lane + 32 * s;
      if (cg * 4 < C)
        *reinterpret_cast<float4*>(dst + (size_t)k * C + cg * 4) =
            make_float4(acc[k][s][0], acc[k][s][1], acc[k][s][2], acc[k][s][3]);
    }
  }
}

template <int C>
int launch_stage(int stage, const float* g, const float* f1, const float* f2, const float* coords,
                 int* perm, int* starts, float* dpatch, float* df1, float* df2, int N, int P, int H2,
                 int W2, long long grid, int smem_bytes, cudaStream_t stream) {
  switch (stage) {
    case 0: {
      if (grid != N || smem_bytes != (sort_bins(H2, W2) + P) * 4) return (int)cudaErrorInvalidValue;
      return launch_sort(coords, perm, N, P, H2, W2, stream, starts);
    }
    case 1: {
      if (grid != (long long)N * df1_blocks_per_edge(P) || smem_bytes != df1_smem_bytes(W2, C) ||
          smem_bytes > kSmemLimit - kDf1StaticBytes)
        return (int)cudaErrorInvalidValue;
      const cudaError_t err = cudaFuncSetAttribute(corr_backward_df1_kernel<C>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      corr_backward_df1_kernel<C><<<(unsigned)grid, kDf1Threads, smem_bytes, stream>>>(
          g, f2, coords, perm, dpatch, df1, P, H2, W2);
      return (int)cudaGetLastError();
    }
    case 2: {
      if (grid != (long long)N * df2_blocks_per_edge(H2, W2) || smem_bytes != df2_smem_bytes(C))
        return (int)cudaErrorInvalidValue;
      const cudaError_t err = cudaFuncSetAttribute(corr_backward_df2_kernel<C>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
      corr_backward_df2_kernel<C><<<(unsigned)grid, kDf2Threads, smem_bytes, stream>>>(
          f1, coords, perm, starts, dpatch, df2, P, H2, W2);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes: launch one stage (0 the sort, 1
// df1 and the dPatch scratch, 2 df2) of one level's backward. g [N, P, 49],
// f1 [N, P, C], f2 [N, H2, W2, C], coords [N, P, 2], df1 [N, P, C], df2
// [N, H2, W2, C] and the scratch dpatch [N, P, 64] f32, perm [N, P] and
// starts [N, (H2 + 8) * (W2 + 8) + 1] int32, all contiguous, 16-byte
// aligned. grid and smem_bytes are the stage's blocks and dynamic shared
// memory from ops/corr.py::corr_backward_plan, checked here. Returns 0 or
// the CUDA error of the launch.
extern "C" int corr_backward_launch(int stage, const void* g, const void* f1, const void* f2,
                                    const void* coords, void* perm, void* starts, void* dpatch,
                                    void* df1, void* df2, int N, int P, int H2, int W2, int C,
                                    int radius, long long grid, int smem_bytes, void* stream) {
  if (radius != corr_tile::kR || N <= 0 || P <= 0 || H2 <= 0 || W2 <= 0 || grid <= 0 ||
      grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CORR_BACKWARD_STAGE(CH)                                                                     \
  launch_stage<CH>(stage, static_cast<const float*>(g), static_cast<const float*>(f1),              \
                   static_cast<const float*>(f2), static_cast<const float*>(coords),                \
                   static_cast<int*>(perm), static_cast<int*>(starts), static_cast<float*>(dpatch), \
                   static_cast<float*>(df1), static_cast<float*>(df2), N, P, H2, W2, grid,          \
                   smem_bytes, st)
  switch (C) {
    case 32: return CORR_BACKWARD_STAGE(32);
    case 64: return CORR_BACKWARD_STAGE(64);
    case 128: return CORR_BACKWARD_STAGE(128);
    case 256: return CORR_BACKWARD_STAGE(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CORR_BACKWARD_STAGE
}
