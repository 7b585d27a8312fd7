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
// float32 features keep the first design (f32 FMA on the CUDA cores): the
// tensor cores' f32 input is TF32, which keeps ~3 digits and would break
// the 1e-4 * max|plain| bound. Only the f32 motion probe (one edge) and the
// replays at small shapes run it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corr_tile.cuh"

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

// ---- f32: the first design --------------------------------------------------

constexpr int kF32Warps = 8;

template <int CPL>
__global__ void __launch_bounds__(kF32Warps * 32)
corr_level_kernel(const float* __restrict__ f1,      // [N, P, C]
                  const float* __restrict__ f2,      // [N, H2, W2, C]
                  const float* __restrict__ coords,  // [N, P, 2]
                  float* __restrict__ out,           // [N, P, 49]
                  int P, int H2, int W2) {
  constexpr int C = 32 * CPL;
  constexpr int NSUP = kRows * kRows;
  __shared__ float sup[kF32Warps][NSUP];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int p = blockIdx.x * kF32Warps + warp;
  if (p >= P) return;  // ragged pixel tile: the whole warp leaves

  const size_t np = (size_t)n * P + p;
  const float cx = coords[2 * np + 0] - kR;
  const float cy = coords[2 * np + 1] - kR;
  // floor of the CLIPPED coordinate: a float->int cast truncates toward zero
  // and is undefined far out of range
  const float x0f = floorf(fminf(fmaxf(cx, -1e4f), 1e4f));
  const float y0f = floorf(fminf(fmaxf(cy, -1e4f), 1e4f));
  const float dx = cx - x0f;
  const float dy = cy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  float a[CPL];
  const float* f1p = f1 + np * C;
#pragma unroll
  for (int k = 0; k < CPL; ++k) a[k] = f1p[lane + 32 * k];

  const float* f2n = f2 + (size_t)n * H2 * W2 * C;
  for (int s = 0; s < NSUP; ++s) {
    const int y = y0 + s / kRows;
    const int x = x0 + s % kRows;
    float acc = 0.f;
    // warp-uniform branch: every lane works on the same pixel
    if (y >= 0 && y < H2 && x >= 0 && x < W2) {
      const float* row = f2n + ((size_t)y * W2 + x) * C;
#pragma unroll
      for (int k = 0; k < CPL; ++k) acc = fmaf(a[k], row[lane + 32 * k], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) sup[warp][s] = acc;
  }
  __syncwarp();

  float* o = out + np * (kRd * kRd);
  for (int q = lane; q < kRd * kRd; q += 32) {
    const int i = q / kRd;
    const int j = q % kRd;
    const float v00 = sup[warp][j * kRows + i];
    const float v10 = sup[warp][j * kRows + i + 1];
    const float v01 = sup[warp][(j + 1) * kRows + i];
    const float v11 = sup[warp][(j + 1) * kRows + i + 1];
    o[q] = v00 * (1.f - dx) * (1.f - dy) + v10 * dx * (1.f - dy) + v01 * (1.f - dx) * dy +
           v11 * dx * dy;
  }
}

template <int CPL>
int launch_f32(const void* f1, const void* f2, const void* coords, void* out, int N, int P,
               int H2, int W2, cudaStream_t stream) {
  const dim3 grid((P + kF32Warps - 1) / kF32Warps, N);
  corr_level_kernel<CPL><<<grid, kF32Warps * 32, 0, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(out), P, H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns 0 or the CUDA error code
// of the launch. is_bf16 selects the element type of f1/f2 (else float32).
// tp, w2pad, row_stride, n_tiles and smem_bytes are the bf16 tile plan of
// ops/corr.py::corr_tile_plan, checked here against this file's layout;
// float32 takes the first design and ignores them.
extern "C" int corr_level_launch(const void* f1, const void* f2, const void* coords, void* out,
                                 int N, int P, int H2, int W2, int C, int radius, int is_bf16,
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
    case 32: return launch_f32<1>(f1, f2, coords, out, N, P, H2, W2, st);
    case 64: return launch_f32<2>(f1, f2, coords, out, N, P, H2, W2, st);
    case 128: return launch_f32<4>(f1, f2, coords, out, N, P, H2, W2, st);
    case 256: return launch_f32<8>(f1, f2, coords, out, N, P, H2, W2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
