// One pyramid level of correlation + 7x7 bilinear window lookup, in two
// kernels that stage the window's rows through device memory.
//
// Replaces the TPU kernels of droid_slam_tpu/ops/pallas_corr.py reached
// through `corr_level_pallas_split`:
//   corr_slab_kernel   <- `_corr_slab_kernel` (stage A)
//   corr_window_kernel <- `_corr_window_kernel` (stage B)
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
// them. The TPU pair padded the map's width and the pixel tile and selected
// rows and columns with one-hot masked sums; here each thread indexes its
// rows and columns directly and the ragged pixel tile is masked.
//
// Bound at the backend's shapes (one chunk of N=256 edges, P=1200 pixels,
// C=128, level 0 of 30x40, bf16): f1 78.6 MB + f2 78.6 MB + coords 2.5 MB
// read, the f32 slab written once (393 MB) and its 8x8 support read once
// (78.6 MB), the output written (60 MB): about 0.69 GB, 0.21 ms at
// 3.35 TB/s, against 25 GFLOP of slab dots (0.025 ms on the bf16 tensor
// cores): bytes bound it, and the slab round trip is most of them.
//
// Design (first, simple version; no tensor cores, no TMA):
//   stage A: one warp per source pixel, 8 warps per block, blocks laid out
//     as (pixel tile, edge). The warp stages its f1 row in shared memory as
//     f32; its lanes share the pixel's 8*W2 slab entries, each lane one
//     (row, column) dot at a time over C with 16-byte loads of the f2 row,
//     so the slab writes of a warp are contiguous. Accumulation is f32.
//   stage B: one thread per output tap, reading its four slab values.
// Known costs to remove later: the dots run on the CUDA cores (f32 FMA),
// each f2 row is read again by every pixel whose window covers it (L1/L2
// serve the reuse), and the slab round trip itself, which the fused
// corr_level.cu does not pay.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;  // rows of the window's integer support (2r+2, r=3)
constexpr int kR = 3;
constexpr int kRd = 2 * kR + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 8 consecutive elements as f32, from a 16-byte (bf16) or 32-byte (f32)
// aligned address
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// first row/column of the window: floor of the clipped coordinate minus r
__device__ __forceinline__ float origin(float c) {
  return floorf(fminf(fmaxf(c - kR, -1e4f), 1e4f));
}

template <typename T, int C>
__global__ void __launch_bounds__(kWarps * 32)
corr_slab_kernel(const T* __restrict__ f1,          // [N, P, C]
                 const T* __restrict__ f2,          // [N, H2, W2, C]
                 const float* __restrict__ coords,  // [N, P, 2]
                 float* __restrict__ slab,          // [N, P, kRows, W2]
                 int P, int H2, int W2) {
  __shared__ __align__(16) float f1s[kWarps][C];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;  // ragged pixel tile: the whole warp leaves

  const size_t np = (size_t)n * P + p;
  const int y0 = (int)origin(coords[2 * np + 1]);

  const T* f1p = f1 + np * C;
  for (int k = lane; k < C; k += 32) f1s[warp][k] = to_f32(f1p[k]);
  __syncwarp();

  const T* f2n = f2 + (size_t)n * H2 * W2 * C;
  const float* a = f1s[warp];
  float* out = slab + np * kRows * W2;
  const int total = kRows * W2;
  for (int t = lane; t < total; t += 32) {
    const int r = t / W2;
    const int x = t - r * W2;
    const int y = y0 + r;
    float acc = 0.f;
    if (y >= 0 && y < H2) {
      const T* row = f2n + ((size_t)y * W2 + x) * C;
#pragma unroll 4
      for (int c = 0; c < C; c += 8) {
        float b[8];
        load8(row + c, b);
        const float4 a0 = *reinterpret_cast<const float4*>(a + c);
        const float4 a1 = *reinterpret_cast<const float4*>(a + c + 4);
        acc = fmaf(a0.x, b[0], acc);
        acc = fmaf(a0.y, b[1], acc);
        acc = fmaf(a0.z, b[2], acc);
        acc = fmaf(a0.w, b[3], acc);
        acc = fmaf(a1.x, b[4], acc);
        acc = fmaf(a1.y, b[5], acc);
        acc = fmaf(a1.z, b[6], acc);
        acc = fmaf(a1.w, b[7], acc);
      }
    }
    out[t] = acc;
  }
}

__global__ void __launch_bounds__(256)
corr_window_kernel(const float* __restrict__ slab,    // [N, P, kRows, W2]
                   const float* __restrict__ coords,  // [N, P, 2]
                   float* __restrict__ out,           // [N, P, kRd^2]
                   long long n_taps, int W2) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_taps) return;
  const long long np = g / (kRd * kRd);
  const int tap = (int)(g - np * (kRd * kRd));
  const int i = tap / kRd;  // x-offset
  const int j = tap - i * kRd;  // y-offset

  const float cx = coords[2 * np + 0];
  const float cy = coords[2 * np + 1];
  const float x0f = origin(cx);
  const float y0f = origin(cy);
  const float dx = (cx - kR) - x0f;
  const float dy = (cy - kR) - y0f;
  const int x0 = (int)x0f;

  const float* s = slab + np * kRows * W2;
  const int xa = x0 + i;
  const int xb = xa + 1;
  const bool oka = xa >= 0 && xa < W2;
  const bool okb = xb >= 0 && xb < W2;
  const float v00 = oka ? s[j * W2 + xa] : 0.f;
  const float v10 = okb ? s[j * W2 + xb] : 0.f;
  const float v01 = oka ? s[(j + 1) * W2 + xa] : 0.f;
  const float v11 = okb ? s[(j + 1) * W2 + xb] : 0.f;
  out[g] = v00 * (1.f - dx) * (1.f - dy) + v10 * dx * (1.f - dy) +
           v01 * (1.f - dx) * dy + v11 * dx * dy;
}

template <typename T, int C>
void launch_slab(const void* f1, const void* f2, const void* coords, void* slab, int N,
                 int P, int H2, int W2, cudaStream_t stream) {
  const dim3 grid((P + kWarps - 1) / kWarps, N);
  corr_slab_kernel<T, C><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(slab), P, H2, W2);
}

template <typename T>
int dispatch_slab(const void* f1, const void* f2, const void* coords, void* slab, int N,
                  int P, int H2, int W2, int C, cudaStream_t stream) {
  switch (C) {
    case 32: launch_slab<T, 32>(f1, f2, coords, slab, N, P, H2, W2, stream); break;
    case 64: launch_slab<T, 64>(f1, f2, coords, slab, N, P, H2, W2, stream); break;
    case 128: launch_slab<T, 128>(f1, f2, coords, slab, N, P, H2, W2, stream); break;
    case 256: launch_slab<T, 256>(f1, f2, coords, slab, N, P, H2, W2, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each returns 0 or the CUDA error
// code of its launch.

// Stage A. is_bf16 selects the element type of f1/f2 (else float32).
extern "C" int corr_slab_launch(const void* f1, const void* f2, const void* coords,
                                void* slab, int N, int P, int H2, int W2, int C,
                                int radius, int is_bf16, void* stream) {
  if (radius != kR || N <= 0 || N > 65535 || P <= 0 || H2 <= 0 || W2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_slab<__nv_bfloat16>(f1, f2, coords, slab, N, P, H2, W2, C, st);
  return dispatch_slab<float>(f1, f2, coords, slab, N, P, H2, W2, C, st);
}

// Stage B. slab is the f32 [N, P, 8, W2] output of stage A.
extern "C" int corr_window_launch(const void* slab, const void* coords, void* out, int N,
                                  int P, int W2, int radius, void* stream) {
  if (radius != kR || N <= 0 || P <= 0 || W2 <= 0) return (int)cudaErrorInvalidValue;
  const long long n_taps = (long long)N * P * kRd * kRd;
  const int threads = 256;
  const long long blocks = (n_taps + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  corr_window_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<const float*>(coords),
      static_cast<float*>(out), n_taps, W2);
  return (int)cudaGetLastError();
}
