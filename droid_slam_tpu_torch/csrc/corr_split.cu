// One pyramid level of correlation + 7x7 bilinear window lookup, in two
// kernels that stage the window's rows through device memory.
//
// Replaces the TPU kernels of droid_slam_tpu/ops/pallas_corr.py reached
// through `corr_level_pallas_split`:
//   corr_slab_tile_kernel / corr_slab_kernel <- `_corr_slab_kernel` (stage A)
//   corr_window_warp_kernel                  <- `_corr_window_kernel` (stage B)
// Together they compute what ops/corr.py::corr_level_split_ref computes:
// for each edge n and source pixel p, the (2r+1)^2 bilinear samples of the
// correlation map <f1[n,p], f2[n,y,x]> around the pixel's target coordinates,
// taps in (i, j) order with i the x-offset, taps outside the map exactly 0.
//
// Stage A writes slab[n, p, r, x] = <f1[n,p], f2[n, y0+r, x]> for the 8 rows
// r of the window's integer support and every column x of the map (a row
// outside the map is 0); stage B reads the 8 columns x0..x0+7 of that slab
// (a column outside the map is 0) and blends the four shifted 7x7
// sub-patches with the bilinear corner weights. y0 and x0 are the floor of
// the coordinate minus r, clipped to +-1e4 first, in the same float
// expression in both stages, so the window cannot shift by a row between
// them.
//
// What bounds stage A on the H100: bytes. At the backend's shapes (one chunk
// of N=256 edges, P=1200, C=128, bf16, 4 levels) f1, f2 and the coords are
// read once and the f32 slab written once (393 MB of it at level 0) in
// 0.348 ms at 3.35 TB/s, against ~25 GFLOP of slab dots.
//
// The first design (one warp per pixel, lanes over the 8*W2 slab entries,
// whole dots over C on the CUDA cores in f32 FMA) took 10.66 ms per 4-level
// lookup on the H100, 31x its bound and slower than the plain version: each
// pixel re-read, through L1/L2, the f2 rows its neighbours also read (up to
// 80 KB per pixel at level 0, ~25 GB per chunk against 0.55 GB of
// compulsory traffic), with the dots on the CUDA cores.
//
// This design (bf16 features; corr_tile.cuh): a block is one edge and a tile
// of 64 source pixels with its f1 rows in registers as tensor-core A
// fragments; each f2 row of the tile's window band is staged once in shared
// memory (cp.async into three row buffers) and multiplied against the whole tile
// with mma.sync (bf16 in, f32 accumulate). A pixel whose window holds row y
// stores its D row straight from the accumulators into slab[n, p, y - y0]
// (each quad of lanes writes 32 contiguous bytes); the rows of its window
// outside the map are written as zeros, once.
//
// float32 features keep the first design (the tensor cores' f32 input is
// TF32, which would break the 1e-4 * max|plain| bound); the backend's lookup
// at the bench configuration is bf16.
//
// What bounds stage B on the H100: bytes, at 32-byte sectors. Per level it
// reads each pixel's 8x8 support from the slab and writes 49 f32 taps. At
// the backend's chunk (N=256, P=1200, iid coords, 4 levels; the counts
// chip_smoke.py phase 3b makes) the exact bytes (the in-map support
// values, coords, taps) are 502 MB, a bound of 0.150 ms at 3.35 TB/s.
// Device memory moves whole sectors: a support row's 8 columns at an
// arbitrary x0 usually span two of them (level 0, W2=40: 133 MB of
// sectors for 79 MB of values), and at levels 2 and 3 (W2 = 10, 5) the
// rows are so short that the whole slab is read. With the taps and coords
// that is 663 MB, a floor of 0.198 ms. Counted in 64-byte pairs of
// sectors, it is 802 MB (0.239 ms); the times below follow that count, as
// if device memory read whole pairs.
//
// The first design (one thread per tap, 4 scalar slab loads each) took
// 0.387 ms per 4-level lookup: each of a pixel's 49 threads re-read its
// coords and recomputed its origin, and its loads, one slab row apart
// between neighbouring threads, fetched the pixel's 64 support values 196
// times (~300 load instructions per pixel, through L1).
//
// This design (corr_window_warp_kernel): 8 lanes per pixel, 4 pixels per
// warp, 8 warps per block.
//   - Origins once: the warp's 8 coordinates (x, y of its 4 pixels, 32
//     contiguous bytes) are loaded by lanes 0-7, one each, which take the
//     floor and fraction with origin(), the expression of stage A; x0, dx
//     and dy reach the pixel's lanes by shuffle.
//   - One read of the support: lane c of a pixel loads column x0 + c of
//     all 8 rows, so each of the warp's 8 load instructions reads 4 rows of
//     32 contiguous bytes (1-2 sectors each). Columns outside [0, W2) are
//     not read and count as 0. The 8 loads are independent, so a warp has
//     them all in flight at once.
//   - Blend from registers: lane c takes column x0 + c + 1 from lane c + 1
//     (8 shuffles) and lanes 0-6 blend taps (i = c, j = 0..6) with the
//     four-term expression of the first design, in its order.
//   - Contiguous stores: the taps go to a per-warp shared stage in out's
//     order, and the warp's 4 pixels (784 contiguous bytes of out) leave as
//     49 16-byte stores; a block's 32 pixels are one range of out. Pixels
//     are indexed over N*P flat in 64 bits; a warp past the end returns, the
//     last one stores its whole pixels with scalar stores.
//   - Latency: ~1-2 KB of sectors per warp in flight. `-Xptxas -v`: 32
//     registers, 6272 bytes of shared memory, no spills, no block barrier,
//     so 8 blocks of 256 threads fit on an SM: 64 warps, full occupancy.
// It takes 0.280 ms per 4-level lookup on an H100 80GB HBM3 at 700 W,
// moving those 64-byte pairs at 2.7-3.0 TB/s per level, about the rate at
// which one sum() streams the slab (2.2-2.9 TB/s; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "corr_tile.cuh"

namespace {

using namespace corr_tile;

// ---- stage A, bf16: tensor-core row-band tiles -----------------------------

// dynamic shared memory: the f2 row buffers (ops/corr.py::corr_tile_plan)
__host__ __device__ constexpr int slab_smem_bytes(int w2pad, int row_stride) {
  return kStages * w2pad * row_stride;
}

template <int C, int NT>
__global__ void __launch_bounds__(kThreads)
corr_slab_tile_kernel(const __nv_bfloat16* __restrict__ f1,  // [N, P, C]
                      const __nv_bfloat16* __restrict__ f2,  // [N, H2, W2, C]
                      const float* __restrict__ coords,      // [N, P, 2]
                      float* __restrict__ slab,              // [N, P, kRows, W2]
                      int P, int H2, int W2, int w2pad, int row_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* buf = smem;  // [kStages][w2pad][C]
  __shared__ int sy0[kTP], sred[kRed];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * kTP;

  uint32_t a[C / 16][4];
  load_a<C>(f1 + (size_t)n * P * C, P, p0 + warp * 16, lane, a);
  zero_pad_columns(buf, W2, w2pad, row_stride);
  const int2 band =
      tile_band(coords + (size_t)n * P * 2, P, p0, H2, sy0, nullptr, nullptr, nullptr, sred);

  // the window rows outside the map, zeros: for each pixel (one warp per
  // pixel) the rows above the map, [0, top), and below it, [bottom, 8), are
  // two contiguous runs of its [8, W2] slab
  const int nvalid = min(kTP, P - p0);
  float* sl = slab + ((size_t)n * P + p0) * kRows * W2;
  for (int pl = warp; pl < nvalid; pl += kWarps) {
    const int top = min(max(-sy0[pl], 0), kRows);
    const int bottom = max(min(H2 - sy0[pl], kRows), top);
    float* dst = sl + (size_t)pl * kRows * W2;
    for (int q = lane; q < top * W2; q += 32) dst[q] = 0.f;
    for (int q = bottom * W2 + lane; q < kRows * W2; q += 32) dst[q] = 0.f;
  }

  // lane (g, t) holds D rows g and g + 8 of its warp's 16 pixels
  const int g = lane >> 2, t = lane & 3;
  const int pa = warp * 16 + g, pb = pa + 8;
  const int y0a = sy0[pa], y0b = sy0[pb];
  const bool even = (W2 & 1) == 0;
  band_loop<C, NT>(
      f2 + (size_t)n * H2 * W2 * C, W2, w2pad, row_stride, buf, band, a,
      [&](int y, int col0, int nt, const float (&acc)[NT][4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = y - (h ? y0b : y0a);
          if (r < 0 || r >= kRows) continue;
          float* dst = sl + ((size_t)(h ? pb : pa) * kRows + r) * W2;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = col0 + 8 * j + 2 * t;
            if (j >= nt || col >= W2) continue;
            if (even) {
              *reinterpret_cast<float2*>(dst + col) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
            } else {
              dst[col] = acc[j][2 * h];
              if (col + 1 < W2) dst[col + 1] = acc[j][2 * h + 1];
            }
          }
        }
      });
}

template <int C, int NT>
int launch_slab_tile(const void* f1, const void* f2, const void* coords, void* slab, int N, int P,
                     int H2, int W2, int w2pad, int row_stride, int smem_bytes,
                     cudaStream_t stream) {
  if (w2pad != w2_padded(W2) || row_stride != row_stride_bytes(C) || NT != chunk_tiles(w2pad) ||
      smem_bytes != slab_smem_bytes(w2pad, row_stride))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(corr_slab_tile_kernel<C, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kTP - 1) / kTP, N);
  corr_slab_tile_kernel<C, NT><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(slab), P, H2, W2, w2pad, row_stride);
  return (int)cudaGetLastError();
}

template <int C>
int dispatch_tiles(const void* f1, const void* f2, const void* coords, void* slab, int N, int P, int H2, int W2, int w2pad, int row_stride, int n_tiles, int smem_bytes, cudaStream_t stream) {
  switch (n_tiles) {
    case 1: return launch_slab_tile<C, 1>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    case 2: return launch_slab_tile<C, 2>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    case 4: return launch_slab_tile<C, 4>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    case 8: return launch_slab_tile<C, 8>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, smem_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- stage A, f32: the first design -----------------------------------------

constexpr int kF32Warps = 8;

template <int C>
__global__ void __launch_bounds__(kF32Warps * 32)
corr_slab_kernel(const float* __restrict__ f1,      // [N, P, C]
                 const float* __restrict__ f2,      // [N, H2, W2, C]
                 const float* __restrict__ coords,  // [N, P, 2]
                 float* __restrict__ slab,          // [N, P, kRows, W2]
                 int P, int H2, int W2) {
  __shared__ __align__(16) float f1s[kF32Warps][C];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int p = blockIdx.x * kF32Warps + warp;
  if (p >= P) return;  // ragged pixel tile: the whole warp leaves

  const size_t np = (size_t)n * P + p;
  const int y0 = (int)origin(coords[2 * np + 1]);

  const float* f1p = f1 + np * C;
  for (int k = lane; k < C; k += 32) f1s[warp][k] = f1p[k];
  __syncwarp();

  const float* f2n = f2 + (size_t)n * H2 * W2 * C;
  const float* a = f1s[warp];
  float* out = slab + np * kRows * W2;
  const int total = kRows * W2;
  for (int q = lane; q < total; q += 32) {
    const int r = q / W2;
    const int x = q - r * W2;
    const int y = y0 + r;
    float acc = 0.f;
    if (y >= 0 && y < H2) {
      const float* row = f2n + ((size_t)y * W2 + x) * C;
#pragma unroll 4
      for (int c = 0; c < C; c += 8) {
        const float4 b0 = *reinterpret_cast<const float4*>(row + c);
        const float4 b1 = *reinterpret_cast<const float4*>(row + c + 4);
        const float4 a0 = *reinterpret_cast<const float4*>(a + c);
        const float4 a1 = *reinterpret_cast<const float4*>(a + c + 4);
        acc = fmaf(a0.x, b0.x, acc);
        acc = fmaf(a0.y, b0.y, acc);
        acc = fmaf(a0.z, b0.z, acc);
        acc = fmaf(a0.w, b0.w, acc);
        acc = fmaf(a1.x, b1.x, acc);
        acc = fmaf(a1.y, b1.y, acc);
        acc = fmaf(a1.z, b1.z, acc);
        acc = fmaf(a1.w, b1.w, acc);
      }
    }
    out[q] = acc;
  }
}

template <int C>
int launch_slab_f32(const void* f1, const void* f2, const void* coords, void* slab, int N, int P,
                    int H2, int W2, cudaStream_t stream) {
  const dim3 grid((P + kF32Warps - 1) / kF32Warps, N);
  corr_slab_kernel<C><<<grid, kF32Warps * 32, 0, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(slab), P, H2, W2);
  return (int)cudaGetLastError();
}

// ---- stage B ------------------------------------------------------------------

constexpr int kTaps = kRd * kRd;                   // 49 taps per pixel
constexpr int kWinLanes = kRows;                   // lanes per pixel: one per support column
constexpr int kWarpPix = 32 / kWinLanes;           // 4 pixels per warp
constexpr int kWinWarps = 8;                       // warps per block
constexpr int kWinPix = kWinWarps * kWarpPix;      // 32 pixels per block
constexpr int kWarpTaps = kWarpPix * kTaps;        // 196: one warp's run of out
constexpr unsigned kAll = 0xffffffffu;
static_assert(kWarpTaps % 4 == 0, "a warp's run of out must be whole 16-byte stores");

__global__ void __launch_bounds__(kWinWarps * 32)
corr_window_warp_kernel(const float* __restrict__ slab,    // [NP, kRows, W2]
                        const float* __restrict__ coords,  // [NP, 2]
                        float* __restrict__ out,           // [NP, kTaps]
                        long long n_pix, int W2) {
  __shared__ __align__(16) float stage[kWinWarps][kWarpTaps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p0 = ((long long)blockIdx.x * kWinWarps + warp) * kWarpPix;
  if (p0 >= n_pix) return;  // warp-uniform: the kernel has no block barrier
  const int nv = (int)min((long long)kWarpPix, n_pix - p0);  // the warp's pixels
  const int q = lane / kWinLanes;  // the lane's pixel
  const int c = lane % kWinLanes;  // its support column

  // origins, once per coordinate: lane k < 2 nv takes coords[p0 + k/2][k%2]
  int o = 0;
  float frac = 0.f;
  if (lane < 2 * nv) {
    const float v = coords[2 * p0 + lane];
    const float of = origin(v);
    o = (int)of;
    frac = (v - kR) - of;
  }
  const int x0 = __shfl_sync(kAll, o, 2 * q);
  const float dx = __shfl_sync(kAll, frac, 2 * q);
  const float dy = __shfl_sync(kAll, frac, 2 * q + 1);

  // the support, read once: column x0 + c of the pixel's 8 slab rows
  const int x = x0 + c;
  const bool in = q < nv && x >= 0 && x < W2;
  const float* s = slab + (in ? (p0 + q) * kRows * W2 + x : 0);
  float a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) a[r] = in ? s[(size_t)r * W2] : 0.f;

  // column x0 + c + 1 from lane c + 1; lanes c < 7 blend taps (i = c, j)
  float b[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) b[r] = __shfl_down_sync(kAll, a[r], 1);
  float* st = stage[warp];
  if (c < kRd) {
#pragma unroll
    for (int j = 0; j < kRd; ++j)
      st[q * kTaps + c * kRd + j] = a[j] * (1.f - dx) * (1.f - dy) + b[j] * dx * (1.f - dy) +
                                    a[j + 1] * (1.f - dx) * dy + b[j + 1] * dx * dy;
  }
  __syncwarp();

  // the warp's pixels are one contiguous run of out (16-byte aligned: the
  // wrapper's out is, and p0 is a multiple of 4)
  float* dst = out + p0 * kTaps;
  if (nv == kWarpPix) {
    const float4* src4 = reinterpret_cast<const float4*>(st);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int k = lane; k < kWarpTaps / 4; k += 32) dst4[k] = src4[k];
  } else {
    for (int k = lane; k < nv * kTaps; k += 32) dst[k] = st[k];
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns 0 or the CUDA error
// code of its launch.

// Stage A. is_bf16 selects the element type of f1/f2 (else float32). tp,
// w2pad, row_stride, n_tiles and smem_bytes are the bf16 tile plan of
// ops/corr.py::corr_tile_plan, checked here against this file's layout;
// float32 takes the first design and ignores them.
extern "C" int corr_slab_launch(const void* f1, const void* f2, const void* coords, void* slab,
                                int N, int P, int H2, int W2, int C, int radius, int is_bf16,
                                int tp, int w2pad, int row_stride, int n_tiles, int smem_bytes,
                                void* stream) {
  if (radius != corr_tile::kR || N <= 0 || N > 65535 || P <= 0 || H2 <= 0 || W2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (tp != corr_tile::kTP) return (int)cudaErrorInvalidValue;
    switch (C) {
      case 32: return dispatch_tiles<32>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      case 64: return dispatch_tiles<64>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      case 128: return dispatch_tiles<128>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      case 256: return dispatch_tiles<256>(f1, f2, coords, slab, N, P, H2, W2, w2pad, row_stride, n_tiles, smem_bytes, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (C) {
    case 32: return launch_slab_f32<32>(f1, f2, coords, slab, N, P, H2, W2, st);
    case 64: return launch_slab_f32<64>(f1, f2, coords, slab, N, P, H2, W2, st);
    case 128: return launch_slab_f32<128>(f1, f2, coords, slab, N, P, H2, W2, st);
    case 256: return launch_slab_f32<256>(f1, f2, coords, slab, N, P, H2, W2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Stage B. slab is the f32 [N, P, 8, W2] output of stage A; out must be
// 16-byte aligned. block_pixels is ops/corr.py::WINDOW_BLOCK_PIXELS, checked
// against this file's layout.
extern "C" int corr_window_launch(const void* slab, const void* coords, void* out, int N,
                                  int P, int W2, int radius, int block_pixels, void* stream) {
  if (radius != corr_tile::kR || block_pixels != kWinPix || N <= 0 || P <= 0 || W2 <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const long long n_pix = (long long)N * P;
  const long long blocks = (n_pix + kWinPix - 1) / kWinPix;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  corr_window_warp_kernel<<<(unsigned)blocks, kWinWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<const float*>(coords),
      static_cast<float*>(out), n_pix, W2);
  return (int)cudaGetLastError();
}
