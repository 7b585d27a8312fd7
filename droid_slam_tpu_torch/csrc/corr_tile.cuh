// Shared tile machinery of the Hopper correlation kernels (corr_level.cu,
// corr_split.cu): a block takes one edge n and a tile of kTP consecutive
// source pixels, keeps the tile's f1 rows as bf16 tensor-core A fragments in
// registers, and streams the f2 rows of the tile's window band through
// shared memory, computing D[pixel, x] = <f1[n, p], f2[n, y, x]> for one
// map row y at a time with mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// The band is the union of the tile's window rows [y0, y0 + 8) clamped to
// [0, H2): pixels past P (the ragged last tile) and pixels whose window lies
// wholly outside the map add no rows, so an empty band computes nothing.
// Smooth flow (tracking) gives a band of ~8-12 rows; iid-noise coordinates
// give up to the whole map, which is then the full volume on tensor cores.
//
// Layouts (the tile plan, mirrored by ops/corr.py::corr_tile_plan, which
// passes it in and which the entry points check):
//   - 4 warps, 16 pixels each (one m16 row tile per warp), kTP = 64;
//   - an f2 row [W2 x C] is staged as [w2pad][C] bf16 with a row stride of
//     2*C + 16 bytes: the 16-byte pad puts the 8 rows that one B fragment
//     load touches on distinct banks; columns [W2, w2pad) are zero;
//   - kStages = 3 row buffers: cp.async fills rows y+1 and y+2 while row y
//     is multiplied;
//   - columns are multiplied in chunks of NT n8 tiles, NT = chunk_tiles(w2pad)
//     (1, 2, 4 or 8, a template parameter): a narrow map keeps few
//     accumulator registers, so more blocks fit on an SM to hide latency.
// Every output element is written by one thread from sums in a fixed order:
// no atomics, no split-K, so identical inputs give identical bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace corr_tile {

constexpr int kR = 3;              // window radius
constexpr int kRows = 2 * kR + 2;  // 8: rows (and columns) of the integer support
constexpr int kRd = 2 * kR + 1;    // 7: taps per axis
constexpr int kTP = 64;            // source pixels per block
constexpr int kWarps = 4;          // warps per block, 16 pixels each
constexpr int kThreads = kWarps * 32;
constexpr int kRowPad = 16;        // bytes of padding per staged f2 row
constexpr int kStages = 3;         // f2 row buffers: two rows in flight
constexpr int kNoRow = -(1 << 20); // window origin of a pixel past P
constexpr int kRed = 2 * kTP / 32; // ints of the band reduction's scratch

// first row/column of the window: floor of the clipped coordinate minus r
// (the float expression of the first design and of ops/corr.py::_window_origin)
__device__ __forceinline__ float origin(float c) {
  return floorf(fminf(fmaxf(c - kR, -1e4f), 1e4f));
}

__host__ __device__ constexpr int w2_padded(int w2) { return (w2 + 7) / 8 * 8; }
__host__ __device__ constexpr int row_stride_bytes(int c) { return 2 * c + kRowPad; }
// n8 tiles per accumulator chunk: the map's tiles rounded up to 1, 2, 4 or 8
__host__ __device__ constexpr int chunk_tiles(int w2pad) {
  return w2pad <= 8 ? 1 : w2pad <= 16 ? 2 : w2pad <= 32 ? 4 : 8;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a * b on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of one warp's 16 pixels over all of C, from f1 [P, C] of
// the block's edge. Lane (g = lane/4, t = lane%4) holds, per k-step of 16
// channels: rows g and g+8, channels 2t, 2t+1 and 2t+8, 2t+9. Rows past P
// are zero.
template <int C>
__device__ __forceinline__ void load_a(const __nv_bfloat16* f1n, int P, int row0, int lane,
                                       uint32_t (&a)[C / 16][4]) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = row0 + g, rb = ra + 8;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(f1n + (size_t)min(ra, P - 1) * C);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(f1n + (size_t)min(rb, P - 1) * C);
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    a[ks][0] = ra < P ? pa[ks * 8 + t] : 0u;
    a[ks][1] = rb < P ? pb[ks * 8 + t] : 0u;
    a[ks][2] = ra < P ? pa[ks * 8 + 4 + t] : 0u;
    a[ks][3] = rb < P ? pb[ks * 8 + 4 + t] : 0u;
  }
}

// Stage one f2 row [W2][C] bf16 into a shared row buffer (16-byte cp.async
// copies; the caller commits).
template <int C>
__device__ __forceinline__ void stage_row(const __nv_bfloat16* row, unsigned char* buf, int W2,
                                          int row_stride) {
  constexpr int kVec = C / 8;  // 16-byte pieces per map column
  const int total = W2 * kVec;
  for (int q = threadIdx.x; q < total; q += kThreads)
    cp_async16(buf + (q / kVec) * row_stride + (q % kVec) * 16, row + (size_t)q * 8);
}

// acc[j] = D[warp's 16 pixels, col0 + 8j .. col0 + 8j + 8) for the staged
// row in buf, j < nt <= NT. Lane (g, t) holds D rows g (acc[j][0..1]) and
// g+8 (acc[j][2..3]) at columns col0 + 8j + 2t, +1.
template <int C, int NT>
__device__ __forceinline__ void row_mma(const unsigned char* buf, int row_stride, int col0, int nt,
                                        const uint32_t (&a)[C / 16][4], float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const uint32_t* b =
            reinterpret_cast<const uint32_t*>(buf + (col0 + 8 * j + g) * row_stride);
        mma_bf16(acc[j], a[ks], b[ks * 8 + t], b[ks * 8 + 4 + t]);
      }
    }
  }
}

// Window origins of the block's TP pixels (kTP for the bf16 kernels; 16, 32
// or 64 for the f32 ones, corr_tile_f32.cuh) and the band they need. Threads
// [0, TP) take one tile position each (a TP below 32 fills its warp with
// lanes that add no rows): position q = p0 + tid is pixel perm[q] of the
// edge when perm is given, else pixel q. sy0 (and sx0/sdx/sdy when given)
// receive the origins by position, kNoRow past P; sred holds kRed ints.
// Returns [lo, hi] (lo > hi: empty). Ends with __syncthreads.
template <int TP = kTP>
__device__ __forceinline__ int2 tile_band(const float* coords, int P, int p0, int H2, int* sy0,
                                          int* sx0, float* sdx, float* sdy, int* sred,
                                          const int* perm = nullptr) {
  static_assert(TP % 16 == 0 && TP <= kTP, "16, 32 or 64 pixels per tile");
  constexpr int kLanes = TP < 32 ? 32 : TP;  // whole warps take part in the reductions
  const int tid = threadIdx.x;
  if (tid < kLanes) {
    const int q = p0 + tid;
    int lo = 1 << 30, hi = -1;
    if (tid >= TP) {
      // a lane past the tile: no pixel
    } else if (q < P) {
      const int p = perm != nullptr ? perm[q] : q;
      const float cx = coords[2 * (size_t)p + 0] - kR;
      const float cy = coords[2 * (size_t)p + 1] - kR;
      const float y0f = floorf(fminf(fmaxf(cy, -1e4f), 1e4f));
      const int y0 = (int)y0f;
      sy0[tid] = y0;
      if (sx0 != nullptr) {
        const float x0f = floorf(fminf(fmaxf(cx, -1e4f), 1e4f));
        sx0[tid] = (int)x0f;
        sdx[tid] = cx - x0f;
        sdy[tid] = cy - y0f;
      }
      if (y0 + kRows - 1 >= 0 && y0 < H2) {
        lo = max(y0, 0);
        hi = min(y0 + kRows - 1, H2 - 1);
      }
    } else {
      sy0[tid] = kNoRow;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((tid & 31) == 0) {
      sred[2 * (tid >> 5)] = lo;
      sred[2 * (tid >> 5) + 1] = hi;
    }
  }
  __syncthreads();
  int2 band = make_int2(sred[0], sred[1]);
#pragma unroll
  for (int w = 1; w < kLanes / 32; ++w) {
    band.x = min(band.x, sred[2 * w]);
    band.y = max(band.y, sred[2 * w + 1]);
  }
  return band;
}

// Multiply the tile against every row of the band, with the f2 rows staged
// through kStages shared row buffers (buf + s * w2pad * row_stride): rows
// y+1 .. y+kStages-1 are in flight while row y is multiplied. epi(y, col0,
// nt, acc) consumes each chunk of NT n8 tiles of row y (the accumulator
// layout of row_mma). Every buffer must have zero columns [W2, w2pad)
// before the first __syncthreads here.
template <int C, int NT, typename Epilogue>
__device__ __forceinline__ void band_loop(const __nv_bfloat16* f2n, int W2, int w2pad,
                                          int row_stride, unsigned char* buf, int2 band,
                                          const uint32_t (&a)[C / 16][4], Epilogue&& epi) {
  const size_t row_elems = (size_t)W2 * C;
  const int buf_bytes = w2pad * row_stride;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (band.x + s <= band.y)
      stage_row<C>(f2n + (band.x + s) * row_elems, buf + s * buf_bytes, W2, row_stride);
    cp_async_commit();  // possibly empty: keeps one group per row
  }
  for (int y = band.x; y <= band.y; ++y) {
    const int i = y - band.x;
    if (y + kStages - 1 <= band.y)
      stage_row<C>(f2n + (y + kStages - 1) * row_elems, buf + (i + kStages - 1) % kStages * buf_bytes,
                   W2, row_stride);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // row y's group has landed
    __syncthreads();
    const unsigned char* cur = buf + i % kStages * buf_bytes;
    for (int col0 = 0; col0 < w2pad; col0 += 8 * NT) {
      const int nt = min(NT, (w2pad - col0) / 8);
      float acc[NT][4];
      row_mma<C, NT>(cur, row_stride, col0, nt, a, acc);
      epi(y, col0, nt, acc);
    }
    __syncthreads();  // before the buffer of row y is refilled
  }
}

// Zero the staged columns [W2, w2pad) of every row buffer.
__device__ __forceinline__ void zero_pad_columns(unsigned char* buf, int W2, int w2pad,
                                                 int row_stride) {
  const int words = row_stride / 4;
  const int per_buf = (w2pad - W2) * words;
  for (int q = threadIdx.x; q < kStages * per_buf; q += kThreads) {
    const int s = q / per_buf, rem = q - s * per_buf;
    reinterpret_cast<uint32_t*>(buf + (s * w2pad + W2 + rem / words) * row_stride)[rem % words] = 0u;
  }
}

}  // namespace corr_tile
