// Shared tile machinery of the float32 correlation kernels (corr_level.cu,
// corr_split.cu): the band tile of corr_tile.cuh with the dots on the CUDA
// cores in f32 FMA. The tensor cores take f32 only as TF32, which keeps ~3
// digits and would break the 1e-4 * max|plain| bound, so there is no mma
// here.
//
// Two launches per level:
//   1. corr_sort_kernel, one block per edge: a stable counting sort of the
//      edge's pixels by the first row, then the first column, of their
//      window (pixels whose window misses the map last), into perm [N, P].
//      Tiles of consecutive sorted pixels need nearly the same rows, so the
//      warps of a block multiply the same band rows and none idles at the
//      row barriers while another works (with tiles of consecutive source
//      pixels and iid-noise coordinates, the band spans most of the map and
//      each warp needed a different third of it).
//   2. the kernel: a block takes one edge n and tp consecutive sorted pixels
//      (64, or 32 or 16 when the grid would leave most SMs idle: the motion
//      probe runs one edge), tp / 16 warps. It takes the tile's window
//      origins and band with corr_tile.cuh::tile_band (the expressions of
//      the bf16 kernels), stages the tile's f1 rows in shared memory once,
//      and streams each f2 row of the band through a ring of kStages row
//      buffers with cp.async, as band_loop does for bf16. A warp multiplies
//      a band row only if one of its 16 pixels needs it, and only over the
//      columns its caller asks for (a warp-uniform vote on the pixels'
//      origins): every column for the slab, the union of the windows'
//      columns for the fused lookup.
// A thread holds a register micro-tile of 4 pixels (tile positions pix + 4k,
// pix = 16 warp + lane / 8) by up to 8 columns (col0 + lane % 8 + 8j), and
// walks C in ascending order with fmaf, 4 channels per 16-byte shared load:
// 16 NJ FMA per 4 + NJ loads. Staged rows are C + 4 floats apart, an odd
// number of 16-byte units, so the 4 pixel rows and the 8 consecutive columns
// that one warp-wide load touches fall on distinct banks. Every output is
// one thread's fmaf chain from 0 over c = 0..C-1: results repeat bit for bit
// and do not depend on the tile size or the sort.
//
// Layouts (the f32 tile plan, mirrored by ops/corr.py::corr_tile_plan_f32,
// which passes it in and which the entry points check):
//   dynamic shared memory = [tp][C + 4] f1 rows, [kStages][w2pad][C + 4] f2
//   rows (columns [W2, w2pad) zero), and for corr_level [tp][8 * 8] supports.
//   The sort's dynamic shared memory: (H2 + 8) * (W2 + 8) int bins and P
//   int keys.
// Shapes refused (the first design took every shape; no path of the repo
// comes near these): a map wider than 136 at C=128, 64 at C=256, 272 at
// C=64 or 520 at C=32 (corr_slab: 528), where even a 16-pixel tile
// exceeds the 227 KB of shared memory a block can have
// (ops/corr.py::corr_tile_plan_f32 raises before any launch), and a level
// whose sort bins and keys exceed 227 KB (the entry point returns
// cudaErrorInvalidValue, and the wrapper raises).

#pragma once

#include <type_traits>

#include "corr_tile.cuh"

namespace corr_tile_f32 {

using namespace corr_tile;

constexpr int kPixT = 4;          // pixels per thread: tile positions pix + 4k
constexpr int kPixW = 4 * kPixT;  // pixels per warp: 4 quarter-warps
// channel steps unrolled in the dot loop: of 2, 4 or 8 pixels per thread
// and 1, 2 or 4 steps, 4 and 4 ran fastest on the H100 (8 pixels halve the
// warps per SM, which the row barriers and load latency need)
constexpr int kUnroll = 4;
constexpr int kMaxNJ = 8;     // columns per thread in one pass: a pass covers 64
constexpr int kPadF = 4;      // floats of padding per staged row (16 bytes)
constexpr int kMaxTP = 64;    // the largest pixel tile
constexpr int kMaxThreads = kMaxTP / kPixW * 32;
constexpr int kSmemLimit = 232448;  // shared memory one block may use on Hopper (227 KB)
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int row_floats(int c) { return c + kPadF; }
// columns per thread in the first pass of a row (the plan's n_tiles)
__host__ __device__ constexpr int first_pass_cols(int w2pad) {
  return w2pad / 8 < kMaxNJ ? w2pad / 8 : kMaxNJ;
}
__host__ __device__ constexpr int smem_bytes_f32(int tp, int w2pad, int c, bool supports) {
  return (tp + kStages * w2pad) * row_floats(c) * 4 + (supports ? tp * kRows * kRows * 4 : 0);
}
__host__ __device__ constexpr bool valid_tp(int tp) { return tp == 16 || tp == 32 || tp == 64; }

// tile_band at a runtime tile size (16, 32 or 64), over sorted positions
__device__ __forceinline__ int2 tile_band_tp(int tp, const float* coords, int P, int p0, int H2,
                                             int* sy0, int* sx0, float* sdx, float* sdy,
                                             int* sred, const int* perm) {
  switch (tp) {
    case 16: return tile_band<16>(coords, P, p0, H2, sy0, sx0, sdx, sdy, sred, perm);
    case 32: return tile_band<32>(coords, P, p0, H2, sy0, sx0, sdx, sdy, sred, perm);
    default: return tile_band<64>(coords, P, p0, H2, sy0, sx0, sdx, sdy, sred, perm);
  }
}

// ---- the sort ----------------------------------------------------------------

__host__ __device__ constexpr int sort_bins(int h2, int w2) { return (h2 + kRows) * (w2 + kRows); }

// Bin of a pixel: its window's first row (windows that miss the map: the
// last row of bins), then its first column clamped to [-7, W2].
__device__ __forceinline__ int sort_key(const float* c, int H2, int W2) {
  const int y0 = (int)origin(c[1]);
  const int x0 = (int)origin(c[0]);
  const int ky = (y0 + kRows - 1 >= 0 && y0 < H2) ? y0 + kRows - 1 : H2 + kRows - 1;
  const int kx = min(max(x0 + kRows - 1, 0), W2 + kRows - 1);
  return ky * (W2 + kRows) + kx;
}

constexpr int kSortThreads = 256;

// perm[n, i] = the pixel at sorted position i of edge n, one block per
// edge: every pixel's bin into shared memory, the counts per bin (integer
// atomics: the counts are exact), their exclusive prefix sum over the block,
// then warp 0 takes the pixels 32 at a time in pixel order and places each
// after the earlier pixels of its bin (__match_any_sync ranks the warp's
// equal keys): a stable sort.
static __global__ void __launch_bounds__(kSortThreads)
corr_sort_kernel(const float* __restrict__ coords, int* __restrict__ perm, int P, int H2, int W2) {
  extern __shared__ int sort_smem[];
  __shared__ int warp_sums[kSortThreads / 32];
  const int bins = sort_bins(H2, W2);
  int* cnt = sort_smem;         // [bins]
  int* keys = sort_smem + bins; // [P]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cn = coords + (size_t)blockIdx.x * P * 2;
  int* pn = perm + (size_t)blockIdx.x * P;
  for (int b = tid; b < bins; b += kSortThreads) cnt[b] = 0;
  __syncthreads();
  for (int q = tid; q < P; q += kSortThreads) {
    const int key = sort_key(cn + 2 * q, H2, W2);
    keys[q] = key;
    atomicAdd(&cnt[key], 1);
  }
  __syncthreads();
  // exclusive prefix sum: thread t takes bins [t * seg, (t + 1) * seg)
  const int seg = (bins + kSortThreads - 1) / kSortThreads;
  const int lo = min(tid * seg, bins), hi = min(lo + seg, bins);
  int sum = 0;
  for (int b = lo; b < hi; ++b) sum += cnt[b];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int b = lo; b < hi; ++b) {
    const int c = cnt[b];
    cnt[b] = run;
    run += c;
  }
  __syncthreads();
  if (warp != 0) return;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < P; base += 32) {
    const int q = base + lane;
    const int key = q < P ? keys[q] : -1 - lane;  // past P: a key of its own
    const unsigned same = __match_any_sync(kFull, key);
    const int slot = q < P ? cnt[key] + __popc(same & below) : 0;
    __syncwarp();
    if (q < P) {
      pn[slot] = q;
      if ((same & below) == 0) cnt[key] += __popc(same);  // the bin's first lane moves it on
    }
    __syncwarp();
  }
}

static int launch_sort(const void* coords, int* perm, int N, int P, int H2, int W2,
                       cudaStream_t stream) {
  const long long bytes = ((long long)sort_bins(H2, W2) + P) * 4;
  if (bytes > kSmemLimit - 64) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  corr_sort_kernel<<<N, kSortThreads, (int)bytes, stream>>>(static_cast<const float*>(coords),
                                                            perm, P, H2, W2);
  return (int)cudaGetLastError();
}

// ---- the tile ----------------------------------------------------------------

// spix[i] = the edge's pixel at tile position i (i < tp, p0 + i < P)
__device__ __forceinline__ void tile_pixels(const int* perm, int P, int p0, int tp, int* spix) {
  const int t = threadIdx.x;
  if (t < tp && p0 + t < P) spix[t] = perm[p0 + t];
}

// The tile's f1 rows by tile position into f1s (16-byte cp.async copies;
// positions past P zero; the caller commits).
template <int C>
__device__ __forceinline__ void stage_f1(const float* f1n, int P, int p0, int tp, const int* spix,
                                         float* f1s) {
  constexpr int kVec = C / 4;
  for (int q = threadIdx.x; q < tp * kVec; q += blockDim.x) {
    const int i = q / kVec, v = q - i * kVec;
    float* dst = f1s + i * row_floats(C) + v * 4;
    if (p0 + i < P)
      cp_async16(dst, f1n + (size_t)spix[i] * C + v * 4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// One f2 row [W2][C] f32 into a row buffer (16-byte cp.async copies; the
// caller commits).
template <int C>
__device__ __forceinline__ void stage_row_f32(const float* row, float* buf, int W2) {
  constexpr int kVec = C / 4;
  for (int q = threadIdx.x; q < W2 * kVec; q += blockDim.x)
    cp_async16(buf + (q / kVec) * row_floats(C) + (q % kVec) * 4, row + (size_t)q * 4);
}

// Zero the staged columns [W2, w2pad) of every row buffer.
template <int C>
__device__ __forceinline__ void zero_pad_columns_f32(float* ring, int W2, int w2pad) {
  constexpr int S = row_floats(C);
  const int per_buf = (w2pad - W2) * S;
  for (int q = threadIdx.x; q < kStages * per_buf; q += blockDim.x) {
    const int s = q / per_buf, rem = q - s * per_buf;
    ring[(s * w2pad + W2) * S + rem] = 0.f;
  }
}

// acc[k][j] = <f1s row pix + 4k, buf column col + 8j>: one fmaf chain from 0
// per output over ascending channels.
template <int C, int NJ>
__device__ __forceinline__ void dots(const float* f1s, const float* buf, int pix, int col,
                                     float (&acc)[kPixT][NJ]) {
  constexpr int S = row_floats(C);
#pragma unroll
  for (int k = 0; k < kPixT; ++k)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[k][j] = 0.f;
  const float* a0 = f1s + pix * S;
  const float* b0 = buf + col * S;
#pragma unroll kUnroll
  for (int c = 0; c < C; c += 4) {
    float4 a[kPixT];
#pragma unroll
    for (int k = 0; k < kPixT; ++k) a[k] = *reinterpret_cast<const float4*>(a0 + 4 * k * S + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(b0 + 8 * j * S + c);
#pragma unroll
      for (int k = 0; k < kPixT; ++k) {
        acc[k][j] = fmaf(a[k].x, b.x, acc[k][j]);
        acc[k][j] = fmaf(a[k].y, b.y, acc[k][j]);
        acc[k][j] = fmaf(a[k].z, b.z, acc[k][j]);
        acc[k][j] = fmaf(a[k].w, b.w, acc[k][j]);
      }
    }
  }
}

template <int C, int NJ, typename Epilogue>
__device__ __forceinline__ void pass(const float* f1s, const float* buf, int pix, int y, int col,
                                     Epilogue& epi) {
  float acc[kPixT][NJ];
  dots<C, NJ>(f1s, buf, pix, col, acc);
  epi(y, col, acc);
}

// The number of columns per thread of an accumulator array passed to an
// epilogue (a generic lambda's `const auto& acc`).
template <typename Acc>
__host__ __device__ constexpr int pass_cols() {
  return std::extent<std::remove_reference_t<Acc>, 1>::value;
}

// Multiply the f1 tile against the rows of the band, with the f2 rows
// staged through kStages buffers of ring (rows y+1 .. y+kStages-1 in flight
// while row y is multiplied). cols(y) gives, warp-uniformly, the columns
// [x, y) (multiples of 8) the warp multiplies row y over; an empty range
// skips the row. epi(y, col, acc) takes each pass: the thread's outputs at
// columns col + 8j, acc float[kPixT][NJ]. The f1 staging must be committed
// before the call; every buffer must have zero columns [W2, w2pad).
template <int C, typename Cols, typename Epilogue>
__device__ __forceinline__ void band_loop_f32(const float* f2n, int W2, int w2pad, float* ring,
                                              int2 band, const float* f1s, Cols&& cols,
                                              Epilogue&& epi) {
  const size_t row_elems = (size_t)W2 * C;
  const int buf_floats = w2pad * row_floats(C);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pix = warp * kPixW + (lane >> 3);
  const int cg = lane & 7;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (band.x + s <= band.y)
      stage_row_f32<C>(f2n + (band.x + s) * row_elems, ring + s * buf_floats, W2);
    cp_async_commit();  // possibly empty: keeps one group per row
  }
  for (int y = band.x; y <= band.y; ++y) {
    const int i = y - band.x;
    if (y + kStages - 1 <= band.y)
      stage_row_f32<C>(f2n + (y + kStages - 1) * row_elems,
                       ring + (i + kStages - 1) % kStages * buf_floats, W2);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // row y's group (and the f1 tile) have landed
    __syncthreads();
    const int2 range = cols(y);
    const float* cur = ring + i % kStages * buf_floats;
    for (int col0 = range.x; col0 < range.y; col0 += 8 * kMaxNJ) {
      const int col = col0 + cg;
      switch (min(kMaxNJ, (range.y - col0) / 8)) {
        case 1: pass<C, 1>(f1s, cur, pix, y, col, epi); break;
        case 2: pass<C, 2>(f1s, cur, pix, y, col, epi); break;
        case 3: pass<C, 3>(f1s, cur, pix, y, col, epi); break;
        case 4: pass<C, 4>(f1s, cur, pix, y, col, epi); break;
        case 5: pass<C, 5>(f1s, cur, pix, y, col, epi); break;
        case 6: pass<C, 6>(f1s, cur, pix, y, col, epi); break;
        case 7: pass<C, 7>(f1s, cur, pix, y, col, epi); break;
        default: pass<C, 8>(f1s, cur, pix, y, col, epi); break;
      }
    }
    __syncthreads();  // before the buffer of row y is refilled
  }
  cp_async_wait<0>();  // an empty band leaves the f1 copies outstanding
}

}  // namespace corr_tile_f32
