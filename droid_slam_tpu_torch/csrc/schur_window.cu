// The depth Schur complement of the tracking step's dense-window GN step,
// over the occupied (depth frame, pose) cells only.
//
// Replaces no Pallas kernel. The JAX package writes this part of
// ba_iteration_dense_window in XLA (droid_slam_tpu/ops/ba.py:722): every
// edge's pose-depth coupling is scattered into a dense E [Ka, Pw*6, HW] and
// S = sum_k E_k Q_k E_k^T is one contraction, the TPU's shape (one large
// matmul). At the tracking step's shapes (Pw 64, Ka 72, HW 1200, 144
// edges) that E holds 33.2M elements, and S is a 25.5 GFLOP f32 product,
// while at most 2N = 288 of its Ka * Pw = 4608 cells can be non-zero: one
// per edge row (the edge's E_i row at (its depth frame, pose i), then its
// E_j row at (its depth frame, pose j)). The plain version
// (ops/ba.py::window_schur_ref) is that dense code.
//
// What bounds it on the H100: bytes. The rows read once (2N x 6 x HW f32,
// 8.3 MB), the cells' E and E*Q written and read back in the storage type,
// Q and w, the pose system read and written once: ~10 MB, a few us at
// 3.35 TB/s; the products, sum over frames of (cells of the frame)^2 x 36
// x HW, are ~0.1 GFLOP at this occupancy.
//
// Design. schur_window_launch runs four kernels, each with a static grid
// (blocks past the work the device counted return), no allocation, no
// float atomics, every sum in an order fixed by the inputs:
//   cells   one block: each of the 2N rows (E_i rows in edge order, then
//           E_j rows) to its cell k*Pw + p, or to none (edge not valid,
//           k outside [0, Ka), p outside [0, min(Pw, t1 - t0))); the
//           occupied cells numbered frame-major, p ascending (per-frame
//           offsets, CSR), each frame's pairs of cells (a, b), slot a <=
//           slot b, numbered after it; t0, t1, kf0 read on the device;
//   sums    a block per cell and chunk of 256 pixels, a thread per
//           pixel: E_c, the sum of the cell's rows in ascending row order
//           (each row rounded to the storage type, the sum in f32, rounded
//           once more; the 6 rows of a row in flight together),
//           E_c * Q_k in the storage type, and the chunk's part of
//           vq_c = sum_x (E_c Q_k)[u, x] w_k[x];
//   gram    a block per pair of cells of one frame: G_ab = (E_a Q) E_b^T
//           and G_ba = (E_b Q) E_a^T, 72 f32 sums over HW (both, since
//           the storage type's rounding of E*Q makes S not exactly
//           symmetric, as in the dense product);
//   assemble a block per pose row p, over the frames where p is occupied
//           (ascending): S from the G blocks where the column's pose is
//           occupied too, A = Hm - S, the damping on the live diagonal,
//           rhs = v - sum_k vq (the chunks' parts in order).
// After the solve, schur_backsub_launch writes
// dz[k, x] = Q (w - sum over the frame's cells of E_c[:, x] . dx[p_c]),
// one thread per (k, x).
//
// The storage type T is bf16 or f32. With bf16 every product of two
// stored values is exact in f32, so the sums differ from the dense
// einsum's only in the order of the additions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kCellThreads = 1024;
constexpr int kSumThreads = 256;
constexpr int kGramThreads = 128;
constexpr int kAssembleThreads = 256;
constexpr int kBacksubThreads = 256;
constexpr int kGram = 72;  // G_ab and G_ba, 6 x 6 each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T to_store(float x);
template <> __device__ __forceinline__ float to_store<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_store<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the storage type and back
template <typename T> __device__ __forceinline__ float rounded(float x) { return to_f(to_store<T>(x)); }

// Exclusive prefix sum of each thread's ``mine`` over the block; the block's
// total in *total. ``tot`` is shared scratch of 33 ints.
__device__ int block_exclusive_scan(int mine, int* tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < warps ? tot[lane] : 0;
    int ti = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ti, o);
      if (lane >= o) ti += y;
    }
    if (lane < warps) tot[lane] = ti - t;
    if (lane == 31) tot[32] = ti;
  }
  __syncthreads();
  const int excl = tot[warp] + incl - mine;
  *total = tot[32];
  __syncthreads();
  return excl;
}

// dynamic shared memory: the occupancy of the Ka * Pw cells (bytes)
__global__ void __launch_bounds__(kCellThreads) schur_cells_kernel(
    const long long* __restrict__ ii, const long long* __restrict__ jj, const unsigned char* __restrict__ valid,
    const long long* __restrict__ t0p, const long long* __restrict__ t1p, const long long* __restrict__ kf0p,
    int N, int Pw, int Ka, int* __restrict__ row_cell, int* __restrict__ cell_of, int* __restrict__ cell_key,
    int* __restrict__ frame_off, int* __restrict__ pair_off, int* __restrict__ counts,
    unsigned char* __restrict__ occ) {
  extern __shared__ unsigned char s_occ[];
  __shared__ int tot[33];
  const int tid = threadIdx.x, R = 2 * N, n = Ka * Pw;
  const long long t0 = *t0p, kf0 = *kf0p;
  const long long live = min(static_cast<long long>(Pw), *t1p - t0);
  for (int f = tid; f < n; f += blockDim.x) s_occ[f] = 0;
  __syncthreads();
  for (int r = tid; r < R; r += blockDim.x) {
    const int e = r < N ? r : r - N;
    const long long k = ii[e] - kf0;
    const long long p = (r < N ? ii[e] : jj[e]) - t0;
    const bool ok = valid[e] != 0 && k >= 0 && k < Ka && p >= 0 && p < live;
    const int f = ok ? static_cast<int>(k * Pw + p) : -1;
    row_cell[r] = f;  // the flat cell for now
    if (ok) s_occ[f] = 1;
  }
  __syncthreads();

  // each thread a contiguous run of frames: number their cells and pairs
  const int per = (Ka + blockDim.x - 1) / blockDim.x;
  const int k_lo = min(Ka, tid * per), k_hi = min(Ka, k_lo + per);
  int cells = 0, pairs = 0;
  for (int k = k_lo; k < k_hi; ++k) {
    int nk = 0;
    for (int p = 0; p < Pw; ++p) nk += s_occ[k * Pw + p];
    cells += nk;
    pairs += nk * (nk + 1) / 2;
  }
  int n_cells, n_pairs;
  int cell = block_exclusive_scan(cells, tot, &n_cells);
  int pair = block_exclusive_scan(pairs, tot, &n_pairs);
  for (int k = k_lo; k < k_hi; ++k) {
    frame_off[k] = cell;
    pair_off[k] = pair;
    const int first = cell;
    for (int p = 0; p < Pw; ++p) {
      const int f = k * Pw + p;
      if (s_occ[f]) {
        cell_of[f] = cell;
        cell_key[cell++] = f;
      } else {
        cell_of[f] = -1;
      }
    }
    const int nk = cell - first;
    pair += nk * (nk + 1) / 2;
  }
  if (tid == 0) {
    frame_off[Ka] = n_cells;
    pair_off[Ka] = n_pairs;
    counts[0] = n_cells;
    counts[1] = n_pairs;
  }
  for (int f = tid; f < n; f += blockDim.x) occ[f] = s_occ[f];
  __syncthreads();  // cell_of is written
  for (int r = tid; r < R; r += blockDim.x) {
    const int f = row_cell[r];
    row_cell[r] = f >= 0 ? cell_of[f] : -1;
  }
}

// grid (x chunks of kSumThreads, cell blocks); dynamic shared memory: the
// rows of the block's cell (2N ints at most)
template <typename T>
__global__ void __launch_bounds__(kSumThreads) schur_sums_kernel(
    const float* __restrict__ Ei, const float* __restrict__ Ej, const float* __restrict__ Q,
    const float* __restrict__ w, const int* __restrict__ row_cell, const int* __restrict__ cell_key,
    const int* __restrict__ counts, int N, int HW, int Pw, T* __restrict__ Ec, T* __restrict__ EQc,
    float* __restrict__ vq_part) {
  extern __shared__ int s_rows[];
  __shared__ int s_count;
  __shared__ float red[kSumThreads / 32][6];
  const int R = 2 * N, lane = threadIdx.x & 31;
  const int n_cells = counts[0];
  const int x = blockIdx.x * kSumThreads + threadIdx.x;
  for (int c = blockIdx.y; c < n_cells; c += gridDim.y) {
    if (threadIdx.x < 32) {  // the cell's rows, in ascending order
      int m = 0;
      for (int r0 = 0; r0 < R; r0 += 32) {
        const int r = r0 + lane;
        const bool mine = r < R && row_cell[r] == c;
        const unsigned b = __ballot_sync(0xffffffffu, mine);
        if (mine) s_rows[m + __popc(b & ((1u << lane) - 1u))] = r;
        m += __popc(b);
      }
      if (lane == 0) s_count = m;
    }
    __syncthreads();
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (x < HW) {
      const size_t kx = static_cast<size_t>(cell_key[c] / Pw) * HW + x;
      const float q = rounded<T>(Q[kx]);
      const float wq = rounded<T>(w[kx]);
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int m = s_count;
      for (int i = 0; i < m; ++i) {
        const int r = s_rows[i];
        const float* src = (r < N ? Ei + static_cast<size_t>(r) * 6 * HW : Ej + static_cast<size_t>(r - N) * 6 * HW) + x;
        float row[6];
#pragma unroll
        for (int u = 0; u < 6; ++u) row[u] = src[u * HW];
#pragma unroll
        for (int u = 0; u < 6; ++u) acc[u] += rounded<T>(row[u]);
      }
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        const T e = to_store<T>(acc[u]);
        const T eq = to_store<T>(to_f(e) * q);
        const size_t at = (static_cast<size_t>(c) * 6 + u) * HW + x;
        Ec[at] = e;
        EQc[at] = eq;
        part[u] = to_f(eq) * wq;
      }
    }
    const float s = block_sum<6, kSumThreads>(part, red);  // also orders the next cell's row list
    if (threadIdx.x < 6) vq_part[(static_cast<size_t>(c) * gridDim.x + blockIdx.x) * 6 + threadIdx.x] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGramThreads) schur_gram_kernel(
    const T* __restrict__ Ec, const T* __restrict__ EQc, const int* __restrict__ frame_off,
    const int* __restrict__ pair_off, const int* __restrict__ counts, int HW, int Ka, float* __restrict__ G) {
  __shared__ float red[kGramThreads / 32][kGram];
  const int n_pairs = counts[1];
  for (int g = blockIdx.x; g < n_pairs; g += gridDim.x) {
    int lo = 0, hi = Ka;  // pair_off[lo] <= g < pair_off[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (pair_off[mid] <= g) lo = mid; else hi = mid;
    }
    const int c0 = frame_off[lo], n = frame_off[lo + 1] - c0;
    int l = g - pair_off[lo], sa = 0;
    while (l >= n - sa) {
      l -= n - sa;
      ++sa;
    }
    const size_t a = static_cast<size_t>(c0 + sa) * 6 * HW, b = static_cast<size_t>(c0 + sa + l) * 6 * HW;
    float s[kGram];
#pragma unroll
    for (int i = 0; i < kGram; ++i) s[i] = 0.f;
    for (int x = threadIdx.x; x < HW; x += blockDim.x) {
      float ea[6], qa[6], eb[6], qb[6];
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        ea[u] = to_f(Ec[a + u * HW + x]);
        qa[u] = to_f(EQc[a + u * HW + x]);
        eb[u] = to_f(Ec[b + u * HW + x]);
        qb[u] = to_f(EQc[b + u * HW + x]);
      }
#pragma unroll
      for (int u = 0; u < 6; ++u) {
#pragma unroll
        for (int v = 0; v < 6; ++v) {
          s[u * 6 + v] += qa[u] * eb[v];
          s[36 + u * 6 + v] += qb[u] * ea[v];
        }
      }
    }
    const float t = block_sum<kGram, kGramThreads>(s, red);
    if (threadIdx.x < kGram) G[static_cast<size_t>(g) * kGram + threadIdx.x] = t;
  }
}

// dynamic shared memory: the frames where the block's pose is occupied and
// its cells there (2 Ka ints)
__global__ void __launch_bounds__(kAssembleThreads) schur_assemble_kernel(
    const float* __restrict__ Hm, const float* __restrict__ v, const float* __restrict__ G,
    const float* __restrict__ vq_part, const int* __restrict__ cell_of, const int* __restrict__ frame_off,
    const int* __restrict__ pair_off, const long long* __restrict__ t0p, const long long* __restrict__ t1p,
    int Pw, int Ka, int chunks, float lm, float ep, float* __restrict__ Ad, float* __restrict__ rhs) {
  extern __shared__ int s_frames[];
  int* s_cells = s_frames + Ka;
  __shared__ int s_n;
  const int p = blockIdx.x, P6 = Pw * 6, lane = threadIdx.x & 31;
  const bool live = p < *t1p - *t0p;
  if (threadIdx.x < 32) {  // the frames of pose p's cells, ascending
    int m = 0;
    for (int k0 = 0; k0 < Ka; k0 += 32) {
      const int k = k0 + lane;
      const int c = k < Ka ? cell_of[k * Pw + p] : -1;
      const unsigned b = __ballot_sync(0xffffffffu, c >= 0);
      if (c >= 0) {
        const int at = m + __popc(b & ((1u << lane) - 1u));
        s_frames[at] = k;
        s_cells[at] = c;
      }
      m += __popc(b);
    }
    if (lane == 0) s_n = m;
  }
  __syncthreads();
  const int nf = s_n;
  for (int j = threadIdx.x; j < P6; j += blockDim.x) {
    const int q = j / 6, v6 = j % 6;
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int f = 0; f < nf; ++f) {
      const int k = s_frames[f], ca = s_cells[f];
      const int cb = cell_of[k * Pw + q];
      if (cb < 0) continue;
      // the pair (lower pose, higher pose): G_ab where p <= q, else G_ba
      const int c0 = frame_off[k], n = frame_off[k + 1] - c0;
      const bool upper = p <= q;
      const int sa = (upper ? ca : cb) - c0, sb = (upper ? cb : ca) - c0;
      const int g = pair_off[k] + sa * n - sa * (sa - 1) / 2 + (sb - sa);
      const float* blk = G + static_cast<size_t>(g) * kGram + (upper ? 0 : 36);
#pragma unroll
      for (int u = 0; u < 6; ++u) s[u] += blk[u * 6 + v6];
    }
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      const int i = p * 6 + u;
      float A = __fsub_rn(Hm[static_cast<size_t>(i) * P6 + j], s[u]);
      if (i == j && live) A = __fadd_rn(A, __fadd_rn(ep, __fmul_rn(lm, A)));
      Ad[static_cast<size_t>(i) * P6 + j] = A;
    }
  }
  if (threadIdx.x < 6) {
    const int u = threadIdx.x;
    float s = 0.f;
    for (int f = 0; f < nf; ++f)
      for (int ch = 0; ch < chunks; ++ch) s += vq_part[(static_cast<size_t>(s_cells[f]) * chunks + ch) * 6 + u];
    rhs[p * 6 + u] = __fsub_rn(v[p * 6 + u], s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBacksubThreads) schur_backsub_kernel(
    const T* __restrict__ Ec, const int* __restrict__ cell_key, const int* __restrict__ frame_off,
    const float* __restrict__ Q, const float* __restrict__ w, const float* __restrict__ dx6, int HW, int Pw,
    int Ka, float* __restrict__ dz) {
  const int at = blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= Ka * HW) return;
  const int k = at / HW, x = at - k * HW;
  float acc = 0.f;
  for (int c = frame_off[k]; c < frame_off[k + 1]; ++c) {
    const int p = cell_key[c] % Pw;
    const T* e = Ec + static_cast<size_t>(c) * 6 * HW + x;
#pragma unroll
    for (int u = 0; u < 6; ++u) acc += to_f(e[u * HW]) * rounded<T>(dx6[p * 6 + u]);
  }
  dz[at] = Q[at] * (w[at] - acc);
}

template <typename T>
int window(const void* ii, const void* jj, const void* valid, const void* t0, const void* t1, const void* kf0,
           const void* Ei, const void* Ej, const void* Q, const void* w, const void* Hm, const void* v,
           void* row_cell, void* cell_of, void* cell_key, void* frame_off, void* pair_off, void* counts,
           void* occ, void* Ec, void* EQc, void* vq_part, void* G, void* Ad, void* rhs, int N, int HW, int Pw,
           int Ka, int sum_blocks, int gram_blocks, float lm, float ep, cudaStream_t st) {
  const int chunks = (HW + kSumThreads - 1) / kSumThreads;
  const auto* t0_ = static_cast<const long long*>(t0);
  const auto* t1_ = static_cast<const long long*>(t1);
  schur_cells_kernel<<<1, kCellThreads, Ka * Pw, st>>>(
      static_cast<const long long*>(ii), static_cast<const long long*>(jj), static_cast<const unsigned char*>(valid),
      t0_, t1_, static_cast<const long long*>(kf0), N, Pw, Ka, static_cast<int*>(row_cell),
      static_cast<int*>(cell_of), static_cast<int*>(cell_key), static_cast<int*>(frame_off),
      static_cast<int*>(pair_off), static_cast<int*>(counts), static_cast<unsigned char*>(occ));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  schur_sums_kernel<T><<<dim3(chunks, sum_blocks), kSumThreads, 2 * N * sizeof(int), st>>>(
      static_cast<const float*>(Ei), static_cast<const float*>(Ej), static_cast<const float*>(Q),
      static_cast<const float*>(w), static_cast<const int*>(row_cell), static_cast<const int*>(cell_key),
      static_cast<const int*>(counts), N, HW, Pw, static_cast<T*>(Ec), static_cast<T*>(EQc),
      static_cast<float*>(vq_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  schur_gram_kernel<T><<<gram_blocks, kGramThreads, 0, st>>>(
      static_cast<const T*>(Ec), static_cast<const T*>(EQc), static_cast<const int*>(frame_off),
      static_cast<const int*>(pair_off), static_cast<const int*>(counts), HW, Ka, static_cast<float*>(G));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  schur_assemble_kernel<<<Pw, kAssembleThreads, 2 * Ka * sizeof(int), st>>>(
      static_cast<const float*>(Hm), static_cast<const float*>(v), static_cast<const float*>(G),
      static_cast<const float*>(vq_part), static_cast<const int*>(cell_of), static_cast<const int*>(frame_off),
      static_cast<const int*>(pair_off), t0_, t1_, Pw, Ka, chunks, lm, ep, static_cast<float*>(Ad),
      static_cast<float*>(rhs));
  return cudaGetLastError();
}

}  // namespace

// Ad [Pw*6, Pw*6] and rhs [Pw*6] of the damped pose system, and the
// scratch schur_backsub_launch reads (row_cell [2N], cell_of [Ka*Pw],
// cell_key [2N], frame_off and pair_off [Ka+1], counts [2] int32; occ
// [Ka*Pw] bytes; Ec, EQc [2N, 6, HW] of the storage type; vq_part [2N,
// ceil(HW / sum_x), 6] and G [gram pairs, 72] f32). ii, jj int64 [N];
// valid bytes [N]; t0, t1, kf0 0-dim int64; Ei, Ej [N, 6, HW], Q, w [Ka,
// HW], Hm, v f32. sum_x is the cell-sum pass's x per block (checked
// against its layout); the cell blocks stride over the cells the device
// counted, the Gram blocks over its pairs (G's rows bound the pairs); 2N
// ints, Ka*Pw bytes and 2 Ka ints of shared memory (Ka <= 4096).
extern "C" int schur_window_launch(const void* ii, const void* jj, const void* valid, const void* t0,
                                   const void* t1, const void* kf0, const void* Ei, const void* Ej,
                                   const void* Q, const void* w, const void* Hm, const void* v, void* row_cell,
                                   void* cell_of, void* cell_key, void* frame_off, void* pair_off, void* counts,
                                   void* occ, void* Ec, void* EQc, void* vq_part, void* G, void* Ad, void* rhs,
                                   int N, int HW, int Pw, int Ka, int is_bf16, int sum_x, int sum_blocks,
                                   int gram_blocks, float lm, float ep, void* stream) {
  if (N < 0 || HW <= 0 || Pw <= 0 || Ka <= 0 || sum_x != kSumThreads || sum_blocks <= 0 || sum_blocks > 65535 ||
      gram_blocks <= 0 || Ka > 4096 || Ka * Pw > 40960 || 2 * N * static_cast<int>(sizeof(int)) > 40960)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return window<__nv_bfloat16>(ii, jj, valid, t0, t1, kf0, Ei, Ej, Q, w, Hm, v, row_cell, cell_of, cell_key,
                                 frame_off, pair_off, counts, occ, Ec, EQc, vq_part, G, Ad, rhs, N, HW, Pw, Ka,
                                 sum_blocks, gram_blocks, lm, ep, st);
  return window<float>(ii, jj, valid, t0, t1, kf0, Ei, Ej, Q, w, Hm, v, row_cell, cell_of, cell_key, frame_off,
                       pair_off, counts, occ, Ec, EQc, vq_part, G, Ad, rhs, N, HW, Pw, Ka, sum_blocks, gram_blocks,
                       lm, ep, st);
}

// dz [Ka, HW] f32 from the cells of schur_window_launch and dx6 [Pw*6] f32.
extern "C" int schur_backsub_launch(const void* Ec, const void* cell_key, const void* frame_off, const void* Q,
                                    const void* w, const void* dx6, void* dz, int HW, int Pw, int Ka, int is_bf16,
                                    void* stream) {
  if (HW <= 0 || Pw <= 0 || Ka <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (Ka * HW + kBacksubThreads - 1) / kBacksubThreads;
  const auto* ck = static_cast<const int*>(cell_key);
  const auto* fo = static_cast<const int*>(frame_off);
  const auto* q = static_cast<const float*>(Q);
  const auto* w_ = static_cast<const float*>(w);
  const auto* dx = static_cast<const float*>(dx6);
  auto* out = static_cast<float*>(dz);
  if (is_bf16)
    schur_backsub_kernel<__nv_bfloat16><<<blocks, kBacksubThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(Ec), ck, fo, q, w_, dx, HW, Pw, Ka, out);
  else
    schur_backsub_kernel<float><<<blocks, kBacksubThreads, 0, st>>>(static_cast<const float*>(Ec), ck, fo, q, w_,
                                                                   dx, HW, Pw, Ka, out);
  return static_cast<int>(cudaGetLastError());
}
