// The linearisation of the tracking step's dense-window GN step, and the
// assembly of its pose system and its depth system.
//
// Replaces no Pallas kernel. The JAX package writes this part of
// ba_iteration_dense_window in XLA: ops/ba.py::build_edge_blocks (every
// edge's reprojection Jacobians on [N, HW] planes and its 6x6 Gram blocks)
// and the dense window's block scatters (the pose system's four block and
// two vector scatters, the depth system's two, the RGB-D prior and Q's
// masks). In PyTorch that is ~200 small launches and eight sorted scatters
// (index_put_ with accumulate) per GN step; the plain version
// (ops/ba.py::linearize_window_ref) is that code.
//
// What bounds it on the H100: launches. The bytes are each valid edge's
// target and weight (16 B a pixel) and source depth (4 B) read, its E_i and
// E_j written (48 B), the depth window's prior, depths and damping read and
// Q and w written (20 B a pixel of Ka frames), Hm written: ~14 MB at the
// allkf cell's 146 edge rows and 30x40 pixels, ~30 MB at the stereo cell's
// 40x64, 4-9 us at 3.35 TB/s. The arithmetic is ~200 f32 FMAs a pixel.
//
// Design. ba_window_launch runs two kernels, each with a static grid sized
// by N, HW, Pw and Ka (t0, t1 and kf0 are read on the device), no
// allocation, no float atomics, every sum in an order fixed by the inputs:
//   linearize  a block per (tile of 256 pixels, edge row), a thread per
//              pixel. The block's first thread builds the edge's relative
//              pose G_ij = G_j o G_i^-1 (a self edge (i, i) takes the rig's
//              baseline); each thread reprojects its pixel, applies the
//              min-depth validity and the 1e-3 weights, forms J_j, J_z and
//              the residuals, and writes E_j, E_i = -A E_j (A the matrix
//              form of adjT(G_ij)), C and w. H_jj's upper triangle and v_j
//              are summed over the tile in a fixed order (a shuffle tree per
//              warp, then the warps in order) into per-tile partials; H_ii =
//              A H_jj A^T, H_ij = -A H_jj, H_ji = H_ij^T and v_i = -A v_j
//              follow in the assembly, since A is constant over the edge. A
//              row whose edge is not valid writes zero E rows and returns; a
//              stereo self edge writes zero E rows and no partials (it drops
//              out of every pose block) but its C and w (it stays in the
//              depth system);
//   assemble   blocks [0, Pw): one pose row p each. The valid edges that
//              touch p (i - t0 == p or j - t0 == p, not self edges) are
//              listed in edge order; 16 at a time, their partials are summed
//              in tile order and their blocks derived in shared memory, and
//              each thread adds them to its columns of Hm, edges in index
//              order. Rows and columns past the live window (p >= t1 - t0)
//              get the identity and zeros. Blocks past Pw: one (depth frame
//              k, 256 pixels) each: C and w summed over the valid edges with
//              i - kf0 == k in edge order, then the RGB-D prior (alpha where
//              the sensor depth is positive, else the damping eta), and Q =
//              in_kx / C, in_kx the window's frames and the frames a valid
//              edge touches.
// Two launches per GN step, 24 per allkf frame: one pass for what is per
// pixel of an edge, one for what sums over edges; merging them would need a
// grid-wide barrier, splitting the assembly would add a launch for no less
// work.
//
// motion_only steps take the same kernels and leave the depth outputs unread.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kLinThreads = 256;  // pixels of a linearisation block
constexpr int kAsmThreads = 256;  // threads of an assembly block (and pixels of a depth block)
constexpr int kPart = 27;         // a tile's partial: H_jj's upper triangle (21), then v_j (6)
constexpr int kChunk = 16;        // edges a pose-row block derives at once
constexpr int kMaxCols = 4;       // columns of Hm per assembly thread: Pw * 6 <= 1024

// G_ij = G_j o G_i^-1 of edge (i, j) as g = (R row-major, t): poses are
// (t, q_xyzw) rows; a self edge takes the rig's baseline ((-0.1, 0, 0),
// identity), as ops/projective.py::relative_poses does.
__device__ void edge_pose(const float* __restrict__ poses, long long i, long long j, float* g) {
  if (i == j) {
    for (int k = 0; k < 9; ++k) g[k] = (k % 4 == 0) ? 1.f : 0.f;
    g[9] = -0.1f;
    g[10] = 0.f;
    g[11] = 0.f;
    return;
  }
  const float* gi = poses + i * 7;
  const float* gj = poses + j * 7;
  // q = q_j * conj(q_i), Hamilton product, xyzw
  const float x1 = gj[3], y1 = gj[4], z1 = gj[5], w1 = gj[6];
  const float x2 = -gi[3], y2 = -gi[4], z2 = -gi[5], w2 = gi[6];
  const float qx = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  const float qy = w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2;
  const float qz = w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2;
  const float qw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  // t = t_j - q t_i (two-cross-product rotation)
  const float px = gi[0], py = gi[1], pz = gi[2];
  const float ux = 2.f * (qy * pz - qz * py), uy = 2.f * (qz * px - qx * pz), uz = 2.f * (qx * py - qy * px);
  g[9] = gj[0] - (px + qw * ux + (qy * uz - qz * uy));
  g[10] = gj[1] - (py + qw * uy + (qz * ux - qx * uz));
  g[11] = gj[2] - (pz + qw * uz + (qx * uy - qy * ux));
  g[0] = 1.f - 2.f * (qy * qy + qz * qz);
  g[1] = 2.f * (qx * qy - qw * qz);
  g[2] = 2.f * (qx * qz + qw * qy);
  g[3] = 2.f * (qx * qy + qw * qz);
  g[4] = 1.f - 2.f * (qx * qx + qz * qz);
  g[5] = 2.f * (qy * qz - qw * qx);
  g[6] = 2.f * (qx * qz - qw * qy);
  g[7] = 2.f * (qy * qz + qw * qx);
  g[8] = 1.f - 2.f * (qx * qx + qy * qy);
}

// grid (HW tiles, N); partials [N, tiles, kPart]
__global__ void __launch_bounds__(kLinThreads) ba_linearize_kernel(
    const float* __restrict__ poses, const float* __restrict__ disps, const float* __restrict__ intr,
    const float2* __restrict__ target, const float2* __restrict__ weight, const long long* __restrict__ ii,
    const long long* __restrict__ jj, const unsigned char* __restrict__ valid, int HW, int W, float min_depth,
    float* __restrict__ Ei, float* __restrict__ Ej, float* __restrict__ Ck, float* __restrict__ wk,
    float* __restrict__ part) {
  __shared__ float s_g[12];
  __shared__ float red[kLinThreads / 32][kPart];
  const int e = blockIdx.y, x = blockIdx.x * kLinThreads + threadIdx.x;
  const size_t rows = static_cast<size_t>(e) * 6 * HW;
  if (!valid[e]) {  // the whole block
    if (x < HW) {
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        Ei[rows + u * HW + x] = 0.f;
        Ej[rows + u * HW + x] = 0.f;
      }
    }
    return;
  }
  const long long i = ii[e], j = jj[e];
  const bool self = i == j;
  if (threadIdx.x == 0) edge_pose(poses, i, j, s_g);
  __syncthreads();
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = s_g[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = s_g[9 + k];

  float h[kPart];
#pragma unroll
  for (int k = 0; k < kPart; ++k) h[k] = 0.f;
  if (x < HW) {
    const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
    const float X0 = (static_cast<float>(x % W) - cx) / fx;
    const float Y0 = (static_cast<float>(x / W) - cy) / fy;
    const float d0 = disps[i * HW + x];
    const float X1 = R[0] * X0 + R[1] * Y0 + R[2] + t[0] * d0;
    const float Y1 = R[3] * X0 + R[4] * Y0 + R[5] + t[1] * d0;
    const float Z1 = R[6] * X0 + R[7] * Y0 + R[8] + t[2] * d0;
    const float zi = 1.f / (Z1 < 0.5f * min_depth ? 1.f : Z1);
    const float x1 = fx * X1 * zi + cx, y1 = fy * Y1 * zi + cy;
    const float ok = Z1 > min_depth ? 1.f : 0.f;
    const size_t px = static_cast<size_t>(e) * HW + x;
    const float2 tg = target[px], wt = weight[px];
    const float ru = tg.x - x1, rv = tg.y - y1;
    const float wu = 0.001f * ok * wt.x, wv = 0.001f * ok * wt.y;
    // Jp rows (au, 0, bu), (0, av, bv); J_j per twist component
    const float au = fx * zi, bu = -fx * X1 * zi * zi, av = fy * zi, bv = -fy * Y1 * zi * zi;
    const float Ju[6] = {au * d0, 0.f, bu * d0, bu * Y1, au * Z1 - bu * X1, -au * Y1};
    const float Jv[6] = {0.f, av * d0, bv * d0, -av * Z1 + bv * Y1, -bv * X1, av * X1};
    const float Jzu = au * t[0] + bu * t[2], Jzv = av * t[1] + bv * t[2];
    Ck[px] = wu * Jzu * Jzu + wv * Jzv * Jzv;
    wk[px] = wu * ru * Jzu + wv * rv * Jzv;
    const float pu = self ? 0.f : wu, pv = self ? 0.f : wv;
    float ej[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) ej[c] = pu * Ju[c] * Jzu + pv * Jv[c] * Jzv;
    // E_i = -A E_j = (-R^T a, R^T (t x a - b)), (a, b) the halves of E_j
    const float a0 = ej[0], a1 = ej[1], a2 = ej[2];
    const float c0 = t[1] * a2 - t[2] * a1 - ej[3];
    const float c1 = t[2] * a0 - t[0] * a2 - ej[4];
    const float c2 = t[0] * a1 - t[1] * a0 - ej[5];
    float ei[6];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ei[r] = -(R[r] * a0 + R[3 + r] * a1 + R[6 + r] * a2);
      ei[3 + r] = R[r] * c0 + R[3 + r] * c1 + R[6 + r] * c2;
    }
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      Ei[rows + u * HW + x] = ei[u];
      Ej[rows + u * HW + x] = ej[u];
    }
    int n = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) h[n++] = pu * Ju[a] * Ju[b] + pv * Jv[a] * Jv[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) h[21 + a] = pu * Ju[a] * ru + pv * Jv[a] * rv;
  }
  if (self) return;  // the whole block: a self edge has no pose blocks
  const float s = block_sum<kPart, kLinThreads>(h, red);
  if (threadIdx.x < kPart) part[(static_cast<size_t>(e) * gridDim.x + blockIdx.x) * kPart + threadIdx.x] = s;
}

// index of (a, b) in H_jj's upper triangle, rows a ascending, b >= a
__device__ __forceinline__ int tri(int a, int b) {
  if (a > b) {
    const int s = a;
    a = b;
    b = s;
  }
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

// Lists the valid edges with key(e) true into s_list in edge order (warp 0
// of the block, all 32 lanes); returns the count through *s_n after the
// barrier that follows.
template <typename Key>
__device__ void list_edges(int N, const unsigned char* __restrict__ valid, int* s_list, int* s_n, Key key) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int m = 0;
    for (int e0 = 0; e0 < N; e0 += 32) {
      const int e = e0 + lane;
      const bool mine = e < N && valid[e] && key(e);
      const unsigned b = __ballot_sync(0xffffffffu, mine);
      if (mine) s_list[m + __popc(b & ((1u << lane) - 1u))] = e;
      m += __popc(b);
    }
    if (lane == 0) *s_n = m;
  }
  __syncthreads();
}

// one pose row p of Hm [Pw*6, Pw*6], v and live6
__device__ void pose_row(const float* __restrict__ poses, const long long* __restrict__ ii,
                         const long long* __restrict__ jj, const unsigned char* __restrict__ valid, long long t0,
                         long long t1, const float* __restrict__ part, int N, int tiles, int Pw, int* s_list,
                         float* __restrict__ Hm, float* __restrict__ v, float* __restrict__ live6) {
  __shared__ int s_n;
  __shared__ int s_rel[kChunk][2];
  __shared__ float s_A[kChunk][36];
  __shared__ float s_H[kChunk][36];  // H_jj
  __shared__ float s_M[kChunk][36];  // A H_jj = -H_ij
  __shared__ float s_Hii[kChunk][36];
  __shared__ float s_red[kChunk][kPart];  // H_jj's triangle and v_j
  __shared__ float s_vi[kChunk][6];
  const int p = blockIdx.x, P6 = Pw * 6, tid = threadIdx.x;
  const long long nlive = t1 - t0;
  if (p >= nlive) {  // a dead row: the identity's
    for (int at = tid; at < 6 * P6; at += blockDim.x) {
      const int u = at / P6, c = at - u * P6;
      Hm[static_cast<size_t>(p * 6 + u) * P6 + c] = c == p * 6 + u ? 1.f : 0.f;
    }
    if (tid < 6) {
      v[p * 6 + tid] = 0.f;
      live6[p * 6 + tid] = 0.f;
    }
    return;
  }
  list_edges(N, valid, s_list, &s_n, [&](int e) {
    const long long i = ii[e], j = jj[e];
    return i != j && (i - t0 == p || j - t0 == p);
  });
  const int L = s_n;
  float acc[kMaxCols][6];
#pragma unroll
  for (int s = 0; s < kMaxCols; ++s)
#pragma unroll
    for (int u = 0; u < 6; ++u) acc[s][u] = 0.f;
  float vacc = 0.f;
  for (int c0 = 0; c0 < L; c0 += kChunk) {
    const int n = min(kChunk, L - c0);
    if (tid < n) {  // the edge's A = [[R^T, 0], [-R^T [t]x, R^T]]
      const int e = s_list[c0 + tid];
      const long long i = ii[e], j = jj[e];
      float g[12];
      edge_pose(poses, i, j, g);
      const float* R = g;
      const float tx = g[9], ty = g[10], tz = g[11];
      const float tc[9] = {0.f, -tz, ty, tz, 0.f, -tx, -ty, tx, 0.f};  // [t]x
      float* A = s_A[tid];
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c) {
          A[r * 6 + c] = R[c * 3 + r];
          A[r * 6 + 3 + c] = 0.f;
          A[(3 + r) * 6 + 3 + c] = R[c * 3 + r];
          float m = 0.f;
          for (int k = 0; k < 3; ++k) m += R[k * 3 + r] * tc[k * 3 + c];
          A[(3 + r) * 6 + c] = -m;
        }
      }
      s_rel[tid][0] = static_cast<int>(max(-1LL, min(static_cast<long long>(Pw), i - t0)));
      s_rel[tid][1] = static_cast<int>(max(-1LL, min(static_cast<long long>(Pw), j - t0)));
    }
    for (int at = tid; at < n * kPart; at += blockDim.x) {  // the partials, in tile order
      const int k = at / kPart, q = at - k * kPart;
      const float* src = part + static_cast<size_t>(s_list[c0 + k]) * tiles * kPart + q;
      float s = 0.f;
      for (int tl = 0; tl < tiles; ++tl) s += src[tl * kPart];
      s_red[k][q] = s;
    }
    __syncthreads();
    for (int at = tid; at < n * 36; at += blockDim.x) {
      const int k = at / 36, uc = at - k * 36;
      s_H[k][uc] = s_red[k][tri(uc / 6, uc % 6)];
    }
    __syncthreads();
    for (int at = tid; at < n * 36; at += blockDim.x) {  // M = A H_jj
      const int k = at / 36, u = (at - k * 36) / 6, c = at % 6;
      float m = 0.f;
#pragma unroll
      for (int a = 0; a < 6; ++a) m += s_A[k][u * 6 + a] * s_H[k][a * 6 + c];
      s_M[k][u * 6 + c] = m;
    }
    for (int at = tid; at < n * 6; at += blockDim.x) {  // v_i = -A v_j
      const int k = at / 6, u = at % 6;
      float m = 0.f;
#pragma unroll
      for (int a = 0; a < 6; ++a) m += s_A[k][u * 6 + a] * s_red[k][21 + a];
      s_vi[k][u] = -m;
    }
    __syncthreads();
    for (int at = tid; at < n * 36; at += blockDim.x) {  // H_ii = M A^T
      const int k = at / 36, u = (at - k * 36) / 6, c = at % 6;
      float m = 0.f;
#pragma unroll
      for (int a = 0; a < 6; ++a) m += s_M[k][u * 6 + a] * s_A[k][c * 6 + a];
      s_Hii[k][u * 6 + c] = m;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kMaxCols; ++s) {
      const int col = tid + s * kAsmThreads;
      const int q = col / 6, c = col - q * 6;
      for (int k = 0; k < n && col < P6; ++k) {
        const int ir = s_rel[k][0], jr = s_rel[k][1];
        if (ir == p) {
          if (q == ir) {
#pragma unroll
            for (int u = 0; u < 6; ++u) acc[s][u] += s_Hii[k][u * 6 + c];
          } else if (q == jr) {  // H_ij = -M
#pragma unroll
            for (int u = 0; u < 6; ++u) acc[s][u] -= s_M[k][u * 6 + c];
          }
        } else {  // jr == p
          if (q == ir) {  // H_ji = H_ij^T
#pragma unroll
            for (int u = 0; u < 6; ++u) acc[s][u] -= s_M[k][c * 6 + u];
          } else if (q == jr) {
#pragma unroll
            for (int u = 0; u < 6; ++u) acc[s][u] += s_H[k][u * 6 + c];
          }
        }
      }
    }
    if (tid < 6) {
      for (int k = 0; k < n; ++k) vacc += s_rel[k][0] == p ? s_vi[k][tid] : s_red[k][21 + tid];
    }
    __syncthreads();  // the next chunk overwrites the staged blocks
  }
#pragma unroll
  for (int s = 0; s < kMaxCols; ++s) {
    const int col = tid + s * kAsmThreads;
    if (col < P6) {
      const bool live = col / 6 < nlive;
#pragma unroll
      for (int u = 0; u < 6; ++u) Hm[static_cast<size_t>(p * 6 + u) * P6 + col] = live ? acc[s][u] : 0.f;
    }
  }
  if (tid < 6) {
    v[p * 6 + tid] = vacc;
    live6[p * 6 + tid] = 1.f;
  }
}

// one (depth frame k, chunk of kAsmThreads pixels) of Q and w [Ka, HW]
__device__ void depth_chunk(int b, const long long* __restrict__ ii, const unsigned char* __restrict__ valid,
                            long long t0, long long t1, long long kf0, const float* __restrict__ Ck,
                            const float* __restrict__ wk, const float* __restrict__ disps,
                            const float* __restrict__ sens, const float* __restrict__ eta, int N, int F, int HW,
                            int Ka, float alpha, int* s_list, float* __restrict__ Q, float* __restrict__ w) {
  __shared__ int s_n;
  __shared__ int s_touched;
  const int chunks = (HW + kAsmThreads - 1) / kAsmThreads;
  const int k = b / chunks, x = (b - k * chunks) * kAsmThreads + threadIdx.x;
  if (threadIdx.x < 32) {  // a valid edge touches frame k (its frame clamped into the window)
    int any = 0;
    for (int e0 = 0; e0 < N; e0 += 32) {
      const int e = e0 + threadIdx.x;
      const long long kr = e < N && valid[e] ? max(0LL, min(static_cast<long long>(Ka - 1), ii[e] - kf0)) : -1;
      any |= __any_sync(0xffffffffu, kr == k);
    }
    if (threadIdx.x == 0) s_touched = any;
  }
  list_edges(N, valid, s_list, &s_n, [&](int e) { return ii[e] - kf0 == k; });
  if (x >= HW) return;
  float c = 0.f, r = 0.f;
  for (int m = 0; m < s_n; ++m) {
    const size_t px = static_cast<size_t>(s_list[m]) * HW + x;
    c += Ck[px];
    r += wk[px];
  }
  const long long frame = kf0 + k;
  const size_t at = static_cast<size_t>(max(0LL, min(static_cast<long long>(F - 1), frame))) * HW + x;
  const float d_s = sens[at];
  if (d_s > 0.f) {  // the RGB-D prior
    c = c + alpha;
    r = __fsub_rn(r, __fmul_rn(alpha, __fsub_rn(disps[at], d_s)));
  } else {
    c = c + eta[at];
  }
  const bool in_kx = frame < F && ((frame >= t0 && frame < t1) || s_touched);
  Q[static_cast<size_t>(k) * HW + x] = (in_kx ? 1.f : 0.f) / (c == 0.f ? 1.f : c);
  w[static_cast<size_t>(k) * HW + x] = r;
}

// grid: Pw pose-row blocks, then Ka * ceil(HW / kAsmThreads) depth blocks;
// dynamic shared memory: N ints (an edge list)
__global__ void __launch_bounds__(kAsmThreads) ba_assemble_kernel(
    const float* __restrict__ poses, const long long* __restrict__ ii, const long long* __restrict__ jj,
    const unsigned char* __restrict__ valid, const long long* __restrict__ t0p, const long long* __restrict__ t1p,
    const long long* __restrict__ kf0p, const float* __restrict__ part, const float* __restrict__ Ck,
    const float* __restrict__ wk, const float* __restrict__ disps, const float* __restrict__ sens,
    const float* __restrict__ eta, int N, int F, int HW, int Pw, int Ka, int tiles, float alpha,
    float* __restrict__ Hm, float* __restrict__ v, float* __restrict__ live6, float* __restrict__ Q,
    float* __restrict__ w) {
  extern __shared__ int s_list[];
  const long long t0 = *t0p, t1 = *t1p;
  if (static_cast<int>(blockIdx.x) < Pw)
    pose_row(poses, ii, jj, valid, t0, t1, part, N, tiles, Pw, s_list, Hm, v, live6);
  else
    depth_chunk(blockIdx.x - Pw, ii, valid, t0, t1, *kf0p, Ck, wk, disps, sens, eta, N, F, HW, Ka, alpha, s_list,
                Q, w);
}

}  // namespace

// The dense-window GN step's systems: Hm [Pw*6, Pw*6], v [Pw, 6], live6
// [Pw*6], Ei, Ej [N, 6, HW], Q, w [Ka, HW], all f32; scratch Ck, wk [N, HW]
// and part [N, ceil(HW / lin_x), 27] f32. poses [F, 7], disps, sens, eta
// [F, HW], intr [4], target, weight [N, HW, 2] f32; ii, jj int64 [N]; valid
// bytes [N]; t0, t1, kf0 0-dim int64 (kf0 >= 0). lin_x is the
// linearisation's pixels per block (checked against its layout). N ints of
// shared memory (N <= 5120), Pw * 6 <= 1024.
extern "C" int ba_window_launch(const void* poses, const void* disps, const void* intr, const void* sens,
                                const void* target, const void* weight, const void* eta, const void* ii,
                                const void* jj, const void* valid, const void* t0, const void* t1, const void* kf0,
                                void* Ei, void* Ej, void* Ck, void* wk, void* part, void* Hm, void* v, void* live6,
                                void* Q, void* w, int N, int F, int HW, int W, int Pw, int Ka, int lin_x,
                                float alpha, float min_depth, void* stream) {
  if (N < 0 || N > 5120 || F <= 0 || HW <= 0 || W <= 0 || HW % W || Pw <= 0 || Pw * 6 > kAsmThreads * kMaxCols ||
      Ka <= 0 || lin_x != kLinThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (HW + kLinThreads - 1) / kLinThreads;
  const auto* ii_ = static_cast<const long long*>(ii);
  const auto* jj_ = static_cast<const long long*>(jj);
  const auto* ok = static_cast<const unsigned char*>(valid);
  if (N > 0) {
    ba_linearize_kernel<<<dim3(tiles, N), kLinThreads, 0, st>>>(
        static_cast<const float*>(poses), static_cast<const float*>(disps), static_cast<const float*>(intr),
        static_cast<const float2*>(target), static_cast<const float2*>(weight), ii_, jj_, ok, HW, W, min_depth,
        static_cast<float*>(Ei), static_cast<float*>(Ej), static_cast<float*>(Ck), static_cast<float*>(wk),
        static_cast<float*>(part));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = Pw + Ka * ((HW + kAsmThreads - 1) / kAsmThreads);
  ba_assemble_kernel<<<blocks, kAsmThreads, N * sizeof(int), st>>>(
      static_cast<const float*>(poses), ii_, jj_, ok, static_cast<const long long*>(t0),
      static_cast<const long long*>(t1), static_cast<const long long*>(kf0), static_cast<const float*>(part),
      static_cast<const float*>(Ck), static_cast<const float*>(wk), static_cast<const float*>(disps),
      static_cast<const float*>(sens), static_cast<const float*>(eta), N, F, HW, Pw, Ka, tiles, alpha,
      static_cast<float*>(Hm), static_cast<float*>(v), static_cast<float*>(live6), static_cast<float*>(Q),
      static_cast<float*>(w));
  return static_cast<int>(cudaGetLastError());
}
