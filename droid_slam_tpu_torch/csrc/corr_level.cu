// One pyramid level of fused correlation + 7x7 bilinear window lookup.
//
// Replaces the TPU kernel `_corr_level_kernel` of
// droid_slam_tpu/ops/pallas_corr.py (reached through `corr_level_pallas`):
// for each edge n and source pixel p it returns the (2r+1)^2 bilinear
// samples of the correlation map <f1[n,p], f2[n,y,x]> around the pixel's
// target coordinates, taps in (i, j) order with i the x-offset, taps outside
// the map exactly 0. Same contract as ops/corr.py::corr_level_ref. Per pixel
// that is the 8x8 integer support at floor(clip(c - r, -1e4, 1e4)), 64 dot
// products of length C, blended with the bilinear corner weights.
//
// What bounds it on the H100: bytes. At the tracking path's shapes (N=48
// edges, P=1200 pixels, C=128, bf16, 4 levels) the inputs and the output
// are read and written once in 0.0375 ms at 3.35 TB/s, against ~1 GFLOP of
// window dots. The volume never leaves the chip.
//
// The first design (one warp per pixel, lane-strided channels, a 5-shuffle
// butterfly per dot, f2 rows re-read through L1/L2 by every neighbouring
// pixel) took 0.72 ms per 4-level lookup on the H100, 19x its bound, and
// cost the same at every level although f2 shrinks 80x from L0 to L3: its
// time followed the 64 dependent shuffle chains per pixel, not the bytes.
//
// This design (bf16 features; corr_tile.cuh): a block is one edge and a tile
// of 64 source pixels. The tile's f1 rows sit in registers as tensor-core A
// fragments; the f2 rows of the tile's window band are staged once in
// shared memory (cp.async into three row buffers, so two rows are in flight
// while one is multiplied) and each is multiplied against
// the whole tile with mma.sync (bf16 in, f32 accumulate), so a row shared by
// 64 pixels is read once per block, and the dots cost no shuffles. Each
// warp passes its 16 pixels' D rows through shared memory and copies the 8
// columns x0..x0+7 of every row r = y - y0 in [0, 8) of a pixel's window
// into that pixel's 8x8 support (zero outside the map); after the band the
// block blends the 49 taps and writes them as contiguous [P, 49] rows.
//
// float32 features (corr_level_f32_kernel, corr_tile_f32.cuh): the motion
// probe at every compute type (one edge) and the operator's lookups of
// float32 tracking. The tensor cores' f32 input is TF32, which keeps ~3
// digits and would break the 1e-4 * max|plain| bound, so the dots run on
// the CUDA cores in f32 FMA. What bounds it: bytes, as in bf16 (N=48,
// P=1200, C=128, iid coords, 4 levels: f1, f2, the coords and the taps, 204
// MB, 0.061 ms at 3.35 TB/s, against ~1 GFLOP of window dots).
// The f32 first design (one warp per pixel, lane-strided channels, a
// 5-shuffle butterfly per dot: 64 dependent chains per pixel) took
// 0.5711-0.6800 ms per 4-level lookup there. This design: each edge's
// pixels sorted by window row then column (one counting-sort launch), tiles
// of 64 consecutive sorted pixels, f1 staged once, each f2 row of the
// tile's band staged once through three cp.async buffers, and a warp
// multiplies a row only over the columns its pixels' windows hold, from a
// 4-pixel x up to 8-column register tile; the supports and the blend are
// the bf16 kernel's. It takes 0.4833-0.4838 ms per 4-level lookup on an
// NVIDIA H100 80GB HBM3 at 700 W (0.13 of its bound; the first design
// 0.6744-0.6748 ms in the same runs): it multiplies whole row
// segments (4-5x the window dots at level 0), and at levels 2-3 the
// per-block latency (the sort, f1 staging, row barriers) outweighs the
// work. The probe (N=1: 16-pixel tiles, 75 blocks at level 0) takes
// 0.103-0.124 ms, against 0.31 ms for the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corr_tile.cuh"
#include "corr_tile_f32.cuh"

namespace {

using namespace corr_tile;

// ---- bf16: tensor-core row-band tiles --------------------------------------

// dynamic shared memory of the tile kernel: the f2 row buffers and the
// tile's 8x8 supports (mirrored by ops/corr.py::corr_tile_plan)
__host__ __device__ constexpr int level_smem_bytes(int w2pad, int row_stride) {
  return kStages * w2pad * row_stride + kTP * kRows * kRows * 4;
}

template <int C, int NT>
__global__ void __launch_bounds__(kThreads)
corr_level_tile_kernel(const __nv_bfloat16* __restrict__ f1,  // [N, P, C]
                       const __nv_bfloat16* __restrict__ f2,  // [N, H2, W2, C]
                       const float* __restrict__ coords,      // [N, P, 2]
                       float* __restrict__ out,               // [N, P, 49]
                       int P, int H2, int W2, int w2pad, int row_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* buf = smem;                                                // [kStages][w2pad][C]
  float* sup = reinterpret_cast<float*>(smem + kStages * w2pad * row_stride);  // [kTP][8 * 8]
  __shared__ int sx0[kTP], sy0[kTP], sred[kRed];
  __shared__ float sdx[kTP], sdy[kTP];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * kTP;

  uint32_t a[C / 16][4];
  load_a<C>(f1 + (size_t)n * P * C, P, p0 + warp * 16, lane, a);
  for (int q = tid; q < kTP * kRows * kRows; q += kThreads) sup[q] = 0.f;
  zero_pad_columns(buf, W2, w2pad, row_stride);
  const int2 band =
      tile_band(coords + (size_t)n * P * 2, P, p0, H2, sy0, sx0, sdx, sdy, sred);

  // lane (g, t) holds D rows g and g + 8 of its warp's 16 pixels: it copies
  // the columns x0..x0+7 of those rows that it holds into the supports
  const int g = lane >> 2, t = lane & 3;
  const int pa = warp * 16 + g, pb = pa + 8;
  const int y0a = sy0[pa], y0b = sy0[pb], x0a = sx0[pa], x0b = sx0[pb];
  band_loop<C, NT>(
      f2 + (size_t)n * H2 * W2 * C, W2, w2pad, row_stride, buf, band, a,
      [&](int y, int col0, int nt, const float (&acc)[NT][4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = y - (h ? y0b : y0a);
          if (r < 0 || r >= kRows) continue;
          float* s = sup + (h ? pb : pa) * kRows * kRows + r * kRows;
          // columns >= W2 multiply the zero-padded f2 columns (0), columns
          // past w2pad are never written: both read back as 0
          const int i0 = col0 + 2 * t - (h ? x0b : x0a);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int i = i0 + 8 * j;
            if (j < nt && i >= -1 && i < kRows) {
              if (i >= 0) s[i] = acc[j][2 * h];
              if (i + 1 < kRows) s[i + 1] = acc[j][2 * h + 1];
            }
          }
        }
      });
  __syncthreads();

  // support index s = (y offset) * 8 + (x offset); tap q = i * 7 + j
  const int nvalid = min(kTP, P - p0);
  float* o = out + ((size_t)n * P + p0) * (kRd * kRd);
  for (int q = tid; q < nvalid * kRd * kRd; q += kThreads) {
    const int p = q / (kRd * kRd);
    const int tap = q - p * (kRd * kRd);
    const int i = tap / kRd;
    const int j = tap - i * kRd;
    const float* s = sup + p * kRows * kRows;
    const float dx = sdx[p], dy = sdy[p];
    const float v00 = s[j * kRows + i];
    const float v10 = s[j * kRows + i + 1];
    const float v01 = s[(j + 1) * kRows + i];
    const float v11 = s[(j + 1) * kRows + i + 1];
    o[q] = v00 * (1.f - dx) * (1.f - dy) + v10 * dx * (1.f - dy) + v01 * (1.f - dx) * dy +
           v11 * dx * dy;
  }
}

template <int C, int NT>
int launch_tile(const void* f1, const void* f2, const void* coords, void* out, int N, int P,
                int H2, int W2, int w2pad, int row_stride, int smem_bytes, cudaStream_t stream) {
  if (w2pad != w2_padded(W2) || row_stride != row_stride_bytes(C) || NT != chunk_tiles(w2pad) ||
      smem_bytes != level_smem_bytes(w2pad, row_stride))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(corr_level_tile_kernel<C, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kTP - 1) / kTP, N);
  corr_level_tile_kernel<C, NT><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(out), P, H2, W2, w2pad, row_stride);
  return (int)cudaGetLastError();
}

template <int C>
int dispatch_tiles(const void* f1, const void* f2, const void* coords, void* out, int N, int P, int H2, int W2, int w2pad, int row_stride, int n_tiles, int smem_bytes, cudaStream_t stream) {
  switch (n_tiles) {
    case 1: return launch_tile<C, 1>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    case 2: return launch_tile<C, 2>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    case 4: return launch_tile<C, 4>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    case 8: return launch_tile<C, 8>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- f32: CUDA-core band tiles (corr_tile_f32.cuh) -------------------------

template <int C>
__global__ void __launch_bounds__(corr_tile_f32::kMaxThreads)
corr_level_f32_kernel(const float* __restrict__ f1,      // [N, P, C]
                      const float* __restrict__ f2,      // [N, H2, W2, C]
                      const float* __restrict__ coords,  // [N, P, 2]
                      const int* __restrict__ perm,      // [N, P]: corr_sort_kernel's order
                      float* __restrict__ out,           // [N, P, 49]
                      int P, int H2, int W2, int w2pad, int tp) {
  using namespace corr_tile_f32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* f1s = reinterpret_cast<float*>(smem);          // [tp][C + 4], by tile position
  float* ring = f1s + tp * row_floats(C);               // [kStages][w2pad][C + 4]
  float* sup = ring + kStages * w2pad * row_floats(C);  // [tp][8 * 8], by tile position
  __shared__ int sx0[kMaxTP], sy0[kMaxTP], spix[kMaxTP], sred[kRed];
  __shared__ float sdx[kMaxTP], sdy[kMaxTP];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * tp;
  const int* pn = perm + (size_t)n * P;

  for (int q = tid; q < tp * kRows * kRows; q += blockDim.x) sup[q] = 0.f;
  zero_pad_columns_f32<C>(ring, W2, w2pad);
  tile_pixels(pn, P, p0, tp, spix);
  __syncthreads();
  stage_f1<C>(f1 + (size_t)n * P * C, P, p0, tp, spix, f1s);  // in flight during tile_band
  cp_async_commit();
  const int2 band =
      tile_band_tp(tp, coords + (size_t)n * P * 2, P, p0, H2, sy0, sx0, sdx, sdy, sred, pn);

  // the thread's 4 pixels (tile positions pix + 4k): it copies the columns
  // x0..x0+7 of their window rows that it holds into their supports
  const int pix = warp * kPixW + (lane >> 3);
  int y0[kPixT], x0[kPixT];
#pragma unroll
  for (int k = 0; k < kPixT; ++k) {
    y0[k] = sy0[pix + 4 * k];
    x0[k] = sx0[pix + 4 * k];
  }
  band_loop_f32<C>(
      f2 + (size_t)n * H2 * W2 * C, W2, w2pad, ring, band, f1s,
      [&](int y) {  // the in-map columns of the windows of the warp's pixels that hold row y
        int lo = 1 << 30, hi = -1;
#pragma unroll
        for (int k = 0; k < kPixT; ++k) {
          if ((unsigned)(y - y0[k]) < (unsigned)kRows) {
            lo = min(lo, x0[k]);
            hi = max(hi, x0[k] + kRows - 1);
          }
        }
        lo = max(__reduce_min_sync(kFull, lo), 0);
        hi = min(__reduce_max_sync(kFull, hi), W2 - 1);
        return lo > hi ? make_int2(0, 0) : make_int2(lo & ~7, (hi & ~7) + 8);
      },
      [&](int y, int col, const auto& acc) {
        constexpr int NJ = pass_cols<decltype(acc)>();
#pragma unroll
        for (int k = 0; k < kPixT; ++k) {
          const int r = y - y0[k];
          if ((unsigned)r >= (unsigned)kRows) continue;
          float* s = sup + (pix + 4 * k) * kRows * kRows + r * kRows;
          // columns past W2 stay 0, as do rows and columns off the map
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int i = col + 8 * j - x0[k];
            if ((unsigned)i < (unsigned)kRows && col + 8 * j < W2) s[i] = acc[k][j];
          }
        }
      });
  __syncthreads();

  // the blend of the bf16 kernel: support s = (y offset) * 8 + (x offset);
  // tap q = i * 7 + j; each pixel's 49 taps are one contiguous row of out
  const int nvalid = min(tp, P - p0);
  float* on = out + (size_t)n * P * (kRd * kRd);
  for (int q = tid; q < nvalid * kRd * kRd; q += blockDim.x) {
    const int p = q / (kRd * kRd);
    const int tap = q - p * (kRd * kRd);
    const int i = tap / kRd;
    const int j = tap - i * kRd;
    const float* s = sup + p * kRows * kRows;
    const float dx = sdx[p], dy = sdy[p];
    const float v00 = s[j * kRows + i];
    const float v10 = s[j * kRows + i + 1];
    const float v01 = s[(j + 1) * kRows + i];
    const float v11 = s[(j + 1) * kRows + i + 1];
    on[(size_t)spix[p] * (kRd * kRd) + tap] =
        v00 * (1.f - dx) * (1.f - dy) + v10 * dx * (1.f - dy) + v01 * (1.f - dx) * dy +
        v11 * dx * dy;
  }
}

template <int C>
int launch_f32(const void* f1, const void* f2, const void* coords, void* perm, void* out, int N,
               int P, int H2, int W2, int tp, int w2pad, int row_stride, int n_tiles,
               int smem_bytes, cudaStream_t stream) {
  using namespace corr_tile_f32;
  if (!valid_tp(tp) || w2pad != w2_padded(W2) || row_stride != 4 * row_floats(C) ||
      n_tiles != first_pass_cols(w2pad) || smem_bytes != smem_bytes_f32(tp, w2pad, C, true))
    return (int)cudaErrorInvalidValue;
  if (perm == nullptr) return (int)cudaErrorInvalidValue;
  int err = launch_sort(coords, static_cast<int*>(perm), N, P, H2, W2, stream);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(corr_level_f32_kernel<C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != 0) return err;
  const dim3 grid((P + tp - 1) / tp, N);
  corr_level_f32_kernel<C><<<grid, tp / kPixW * 32, smem_bytes, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const float*>(coords), static_cast<const int*>(perm), static_cast<float*>(out),
      P, H2, W2, w2pad, tp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns 0 or the CUDA error code
// of the launch. is_bf16 selects the element type of f1/f2 (else float32).
// tp, w2pad, row_stride, n_tiles and smem_bytes are the tile plan of
// ops/corr.py::corr_tile_plan (bf16) or corr_tile_plan_f32 (float32),
// checked here against this file's layout. perm is an int32 [N, P] scratch
// for float32's sort (bf16 ignores it).
extern "C" int corr_level_launch(const void* f1, const void* f2, const void* coords, void* perm,
                                 void* out, int N, int P, int H2, int W2, int C, int radius, int is_bf16,
                                 int tp, int w2pad, int row_stride, int n_tiles, int smem_bytes,
                                 void* stream) {
  if (radius != corr_tile::kR || N <= 0 || N > 65535 || P <= 0 || H2 <= 0 || W2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (tp != corr_tile::kTP) return (int)cudaErrorInvalidValue;
    switch (C) {
      case 32: return dispatch_tiles<32>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      case 64: return dispatch_tiles<64>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      case 128: return dispatch_tiles<128>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      case 256: return dispatch_tiles<256>(f1, f2, coords, out, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (C) {
    case 32: return launch_f32<32>(f1, f2, coords, perm, out, N, P, H2, W2, tp, w2pad, row_stride, n_tiles, smem_bytes, st);
    case 64: return launch_f32<64>(f1, f2, coords, perm, out, N, P, H2, W2, tp, w2pad, row_stride, n_tiles, smem_bytes, st);
    case 128: return launch_f32<128>(f1, f2, coords, perm, out, N, P, H2, W2, tp, w2pad, row_stride, n_tiles, smem_bytes, st);
    case 256: return launch_f32<256>(f1, f2, coords, perm, out, N, P, H2, W2, tp, w2pad, row_stride, n_tiles, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
