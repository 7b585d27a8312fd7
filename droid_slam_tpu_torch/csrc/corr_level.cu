// One pyramid level of fused correlation + 7x7 bilinear window lookup.
//
// Replaces the TPU kernel `_corr_level_kernel` of
// droid_slam_tpu/ops/pallas_corr.py (reached through `corr_level_pallas`):
// for each edge n and source pixel p it returns the (2r+1)^2 bilinear
// samples of the correlation map <f1[n,p], f2[n,y,x]> around the pixel's
// target coordinates, taps in (i, j) order with i the x-offset, taps outside
// the map exactly 0. Same contract as ops/corr.py::corr_level_ref.
//
// What it computes, per pixel: the 8x8 integer support at
// floor(clip(c - r, -1e4, 1e4)) needs 64 dot products of length C; the four
// shifted 7x7 sub-patches of that support are blended with the bilinear
// corner weights. The TPU kernel built a whole [H2*W2, tile] volume with one
// MXU dot and then picked the windows with one-hot masked sums; on Hopper
// each pixel reads only its own support rows (the reference altcorr
// strategy), so the volume never exists anywhere.
//
// Bound at the main-path shapes (N=48 edges, P=1200 pixels, C=128, bf16):
// level 0 moves f1 14.7 MB + f2 14.7 MB + coords 0.5 MB + out 11.3 MB, about
// 12 us at 3.35 TB/s, against about 0.94 GFLOP of window dots: memory-bound
// on paper. Each f2 row is read by up to 64 neighbouring pixels, so the
// design leans on L1/L2 for that reuse instead of staging it.
//
// Design (first, simple version): one warp per source pixel, 8 warps per
// block, blocks laid out as (pixel tile, edge). Each lane holds C/32 channels
// of f1 in registers; for every in-bounds support position the warp reads
// the f2 row coalesced (lane-strided channels), multiplies, and reduces with
// a butterfly of shuffles. The 64 sums go to shared memory, then lanes write
// the 49 blended taps. Accumulation is f32 for bf16 and f32 inputs alike.
// Known costs to remove later: 5 shuffles per dot, no reuse of f2 rows
// across the warps of a block, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int CPL, int R>
__global__ void __launch_bounds__(kWarps * 32)
corr_level_kernel(const T* __restrict__ f1,          // [N, P, C]
                  const T* __restrict__ f2,          // [N, H2, W2, C]
                  const float* __restrict__ coords,  // [N, P, 2]
                  float* __restrict__ out,           // [N, P, (2R+1)^2]
                  int P, int H2, int W2) {
  constexpr int C = 32 * CPL;
  constexpr int RD = 2 * R + 1;
  constexpr int SUP = RD + 1;
  constexpr int NSUP = SUP * SUP;
  __shared__ float sup[kWarps][NSUP];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;  // ragged pixel tile: the whole warp leaves

  const size_t np = (size_t)n * P + p;
  const float cx = coords[2 * np + 0] - R;
  const float cy = coords[2 * np + 1] - R;
  // floor of the CLIPPED coordinate: a float->int cast truncates toward zero
  // and is undefined far out of range
  const float x0f = floorf(fminf(fmaxf(cx, -1e4f), 1e4f));
  const float y0f = floorf(fminf(fmaxf(cy, -1e4f), 1e4f));
  const float dx = cx - x0f;
  const float dy = cy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  float a[CPL];
  const T* f1p = f1 + np * C;
#pragma unroll
  for (int k = 0; k < CPL; ++k) a[k] = to_f32(f1p[lane + 32 * k]);

  const T* f2n = f2 + (size_t)n * H2 * W2 * C;
  for (int s = 0; s < NSUP; ++s) {
    const int y = y0 + s / SUP;
    const int x = x0 + s % SUP;
    float acc = 0.f;
    // warp-uniform branch: every lane works on the same pixel
    if (y >= 0 && y < H2 && x >= 0 && x < W2) {
      const T* row = f2n + ((size_t)y * W2 + x) * C;
#pragma unroll
      for (int k = 0; k < CPL; ++k) acc = fmaf(a[k], to_f32(row[lane + 32 * k]), acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) sup[warp][s] = acc;
  }
  __syncwarp();

  // support index s = (y offset) * SUP + (x offset); tap t = i * RD + j
  float* o = out + np * (RD * RD);
  for (int t = lane; t < RD * RD; t += 32) {
    const int i = t / RD;
    const int j = t % RD;
    const float v00 = sup[warp][j * SUP + i];
    const float v10 = sup[warp][j * SUP + i + 1];
    const float v01 = sup[warp][(j + 1) * SUP + i];
    const float v11 = sup[warp][(j + 1) * SUP + i + 1];
    o[t] = v00 * (1.f - dx) * (1.f - dy) + v10 * dx * (1.f - dy) +
           v01 * (1.f - dx) * dy + v11 * dx * dy;
  }
}

template <typename T, int CPL>
void launch(const void* f1, const void* f2, const void* coords, void* out, int N,
            int P, int H2, int W2, cudaStream_t stream) {
  const dim3 grid((P + kWarps - 1) / kWarps, N);
  corr_level_kernel<T, CPL, 3><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(out), P, H2, W2);
}

template <typename T>
int dispatch_c(const void* f1, const void* f2, const void* coords, void* out, int N,
               int P, int H2, int W2, int C, cudaStream_t stream) {
  switch (C) {
    case 32: launch<T, 1>(f1, f2, coords, out, N, P, H2, W2, stream); break;
    case 64: launch<T, 2>(f1, f2, coords, out, N, P, H2, W2, stream); break;
    case 128: launch<T, 4>(f1, f2, coords, out, N, P, H2, W2, stream); break;
    case 256: launch<T, 8>(f1, f2, coords, out, N, P, H2, W2, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Returns 0 or the CUDA error code
// of the launch. is_bf16 selects the element type of f1/f2 (else float32).
extern "C" int corr_level_launch(const void* f1, const void* f2, const void* coords,
                                 void* out, int N, int P, int H2, int W2, int C,
                                 int radius, int is_bf16, void* stream) {
  if (radius != 3 || N <= 0 || N > 65535 || P <= 0 || H2 <= 0 || W2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_c<__nv_bfloat16>(f1, f2, coords, out, N, P, H2, W2, C, st);
  return dispatch_c<float>(f1, f2, coords, out, N, P, H2, W2, C, st);
}
