// Fixed-order block reductions shared by the BA kernels (schur_window.cu,
// ba_window.cu).
#pragma once

// Sums K per-thread values over the block in a fixed order (a shuffle tree
// per warp, then the warps in order); thread t < K returns the t-th sum.
// ``red`` is shared scratch of THREADS / 32 rows.
template <int K, int THREADS>
__device__ float block_sum(float (&v)[K], float (*red)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float s = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < K) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
  }
  __syncthreads();
  return s;
}
