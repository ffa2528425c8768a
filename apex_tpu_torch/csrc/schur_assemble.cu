// Fused linearization and implicit-Schur assembly of BAL projection rows,
// for Hopper (sm_90a): one factor group's rows, straight from the pool
// tensors and the group's indices, to its contributions to H_cc, g_c, H_pp,
// g_p, its couplings W and its cost.
//
// Replaces no TPU kernel. The JAX package leaves this to XLA
// (apex_tpu/core/problem.py group linearization, apex_tpu/linalg/schur.py
// assembly), as the port left it to ~200 eager PyTorch operations per group
// and one contended index_add_ per block sum (linalg/schur.py
// SchurContext.assemble's generic path). Per row it computes what the
// generic path computes, with the same formulas:
//   1. gather the SE3 pose [t, q], the R3 landmark and the R3 intrinsics
//      [f, k1, k2] (from the pool, or the group's per-row constants);
//   2. p_cam = R(q) p_w + t and the BAL pinhole projection and Jacobians of
//      cameras/bal_pinhole.py at the depth-clamped point, masked by select
//      with factors/projection.py's ok mask (cheirality, isfinite,
//      |uv| < 1e8); the pose Jacobian is J_pc [R | -R [p_w]x];
//   3. the group weight, the free masks, then core/corrector.py's corrector
//      for l2 (none) and huber. Huber's rho'' is never positive, so the
//      corrector takes its trivial branch: r and J scaled by sqrt(rho').
// The camera columns (pose, then intrinsics where optimized: NC = 9 or 6)
// go to the entity-local offsets of the plan's per-entity table.
//
// Three kernels per group, no atomics, sums in a fixed order (an assemble
// gives the same bits run to run):
//   - landmark_pass: a sub-warp of `width` lanes (a power of two, at least
//     the group's longest landmark run up to 32) per landmark run, each lane
//     a row of the run: it writes the row's W_k = Jc^T Jl [De, 3] and a
//     compact record [Jc (2 x NC) | r (2)] into scratch, and the sub-warp
//     reduces Jl^T Jl and Jl^T r by xor shuffles and adds them to H_pp /
//     g_p once. Where a warp's rows are 32 consecutive rows (always in the
//     bucketed layout, whose runs are the group's cap) W and the records go
//     out through shared memory, each store instruction 32 consecutive
//     values: a row per lane stored directly wrote each 32-B sector in
//     pieces from 32 instructions, and the pass took 3.7x as long at
//     venice's size. Weight-0 rows (the bucketed layout's padding) skip
//     the arithmetic and write zeros.
//   - entity_pass: one CTA per tile of at most TILE_ROWS rows of one camera
//     entity, in the plan's camera-major order: each thread sums Jc^T Jc
//     (upper triangle), Jc^T r and r.r over its rows of the tile in
//     registers, then the CTA reduces them (shuffles, then the warps in
//     order) to one partial per tile.
//   - finalize: one CTA per entity of the group adds the sum of its tiles'
//     partials, in tile order, to H_cc / g_c (both triangles); one more CTA
//     sums every tile's r.r in a fixed order and adds half of it to the cost.
//
// What bounds it: HBM bytes. Per row it reads the observation, the weight,
// the loss parameter, three int64 pool indices, the int64 entity id, the
// pose free mask where one is set and the camera-major index, gathers the
// pose, the intrinsics and the landmark (L2-resident across a run), and
// writes W (27 values at De = 9); the pools, H_pp / g_p and H_cc / g_c are
// small beside them: about 330 B per row in f64, 0.71 ms at venice's
// 6,491,429 rows at 3.35 TB/s. The compact record (20 values) is written
// once and read once, about 2/5 more: the design's own traffic, which
// keeps the camera-major pass free of gathers from five arrays. Arithmetic
// is ~600 operations per row, well under the byte time at the FP64 rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

// Every field is 8 bytes, so the layout is the ctypes Structure's of
// kernels/schur_assemble.py field for field. Index arrays are int64 where
// the problem stores them, int32 where the plan built them. It lies outside
// the anonymous namespace, so that the C entry points that take it keep
// external linkage.
struct SchurAssembleArgs {
  const void* pose;             // [N, 7] SE3 pool
  const long long* pose_idx;    // [K]
  const void* point;            // [N, 3] R3 pool
  const long long* point_idx;   // [K]
  const void* intr;             // [N, 3] R3 pool, or [K, 3] per-row constants
  const long long* intr_idx;    // [K], or null: row k's own constants
  const void* obs;              // [K, 2]
  const void* weight;           // [K], or null: 1
  const void* huber;            // [K, 1] huber scale, or null: l2
  const void* mask_pose;        // [K, 6], or null: free
  const void* mask_point;       // [K, 3], or null
  const void* mask_intr;        // [K, 3], or null
  const long long* ent;         // [K] camera entity of each row
  const int* ent_cols;          // [E, 2] entity-local first column of the pose / intrinsics
  const int* lm_perm;           // [K] landmark-major row order, or null: rows in it already
  const int* seg_lm;            // [S] landmark id of each run
  const int* seg_off;           // [S + 1] run bounds in landmark-major order
  const int* cam_perm;          // [K] camera-major row order
  const int* tile_off;          // [T + 1] tile bounds in camera-major order
  const int* fin_ent;           // [Eg] the group's entities
  const int* fin_off;           // [Eg + 1] their tiles
  void* W;                      // [K, De, 3] out
  void* rec;                    // [K, 2 NC + 2] scratch
  void* part;                   // [T, NA] scratch
  void* Hcc;                    // [E, De, De] accumulated
  void* gc;                     // [E, De] accumulated
  void* Hpp;                    // [P, 3, 3] accumulated
  void* gp;                     // [P, 3] accumulated
  void* cost;                   // [] accumulated
  long long S;                  // landmark runs
  long long width;              // lanes per run
  long long T;                  // tiles
  long long Eg;                 // entities of the group
  long long De;                 // entity width
};

namespace {

using Args = SchurAssembleArgs;

constexpr int kLandmarkThreads = 128;
constexpr int kEntityThreads = 128;
constexpr int kEntityWarps = kEntityThreads / 32;
constexpr int kFinalThreads = 256;
// the constants of cameras/base.py, core/losses.py and factors/projection.py
constexpr double kMinDepth = 1e-6;
constexpr double kEps = 2.220446049250313e-16;
constexpr double kTiny = 2.2250738585072014e-308;
constexpr double kMaxPixel = 1e8;


template <int NC>
struct Counts {
  static constexpr int kPairs = NC * (NC + 1) / 2;  // upper triangle of Jc^T Jc
  static constexpr int kSums = kPairs + NC + 1;     // + Jc^T r + r.r
  static constexpr int kRecord = 2 * NC + 2;
};

template <typename T, int NC>
__device__ __forceinline__ void zero_row(T r[2], T jc[2][NC], T jl[2][3]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    r[e] = T(0);
#pragma unroll
    for (int i = 0; i < NC; ++i) jc[e][i] = T(0);
#pragma unroll
    for (int j = 0; j < 3; ++j) jl[e][j] = T(0);
  }
}

// One row of a group, linearized as the generic path does (steps 1-3 of
// the header): r [2], jc [2][NC] (pose then intrinsics columns), jl [2][3].
template <typename T, int NC>
__device__ __forceinline__ void bal_pinhole_row(const Args& a, long long k, T r[2],
                                                T jc[2][NC], T jl[2][3]) {
  const T w = a.weight ? static_cast<const T*>(a.weight)[k] : T(1);
  if (w == T(0)) {
    zero_row<T, NC>(r, jc, jl);
    return;
  }
  const T* pose = static_cast<const T*>(a.pose) + 7 * a.pose_idx[k];
  const T* pw = static_cast<const T*>(a.point) + 3 * a.point_idx[k];
  const T* in = static_cast<const T*>(a.intr) + 3 * (a.intr_idx ? a.intr_idx[k] : k);
  const T* ob = static_cast<const T*>(a.obs) + 2 * k;
  const T px = pw[0], py = pw[1], pz = pw[2];
  const T f = in[0], k1 = in[1], k2 = in[2];

  // manifolds/utils.py quat_to_mat, q = [w, x, y, z]
  const T qw = pose[3], qx = pose[4], qy = pose[5], qz = pose[6];
  const T xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const T wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const T xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const T R[3][3] = {{T(1) - T(2) * (yy + zz), T(2) * (xy - wz), T(2) * (xz + wy)},
                     {T(2) * (xy + wz), T(1) - T(2) * (xx + zz), T(2) * (yz - wx)},
                     {T(2) * (xz - wy), T(2) * (yz + wx), T(1) - T(2) * (xx + yy)}};
  const T x = R[0][0] * px + R[0][1] * py + R[0][2] * pz + pose[0];
  const T y = R[1][0] * px + R[1][1] * py + R[1][2] * pz + pose[1];
  const T z = R[2][0] * px + R[2][1] * py + R[2][2] * pz + pose[2];

  // cameras/bal_pinhole.py at the depth-clamped point (cameras/base.py)
  const bool valid = z < T(-kMinDepth);
  const T zs = z < T(-kMinDepth) ? z : T(-kMinDepth);
  const T iz = T(-1) / zs;
  const T xn = x * iz, yn = y * iz;
  const T r2 = xn * xn + yn * yn;
  const T d = T(1) + r2 * (k1 + k2 * r2);
  const T u = f * d * xn, v = f * d * yn;
  const bool ok = valid && isfinite(u) && isfinite(v) && fabs(u) < T(kMaxPixel) &&
                  fabs(v) < T(kMaxPixel);
  if (!ok) {
    zero_row<T, NC>(r, jc, jl);
    return;
  }
  r[0] = (u - ob[0]) * w;
  r[1] = (v - ob[1]) * w;

  const T a2 = T(2) * (k1 + T(2) * k2 * r2);
  const T juxn = f * (d + a2 * xn * xn);
  const T juyn = f * (a2 * xn * yn);
  const T jvyn = f * (d + a2 * yn * yn);
  const T z2 = zs * zs;
  const T xz2 = x / z2, yz2 = y / z2;
  const T jp[2][3] = {{juxn * iz, juyn * iz, juxn * xz2 + juyn * yz2},
                      {juyn * iz, jvyn * iz, juyn * xz2 + jvyn * yz2}};
  // R [p_w]x
  T M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    M[i][0] = R[i][1] * pz - R[i][2] * py;
    M[i][1] = R[i][2] * px - R[i][0] * pz;
    M[i][2] = R[i][0] * py - R[i][1] * px;
  }
  const T* mp = a.mask_pose ? static_cast<const T*>(a.mask_pose) + 6 * k : nullptr;
  const T* ml = a.mask_point ? static_cast<const T*>(a.mask_point) + 3 * k : nullptr;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T l = jp[e][0] * R[0][j] + jp[e][1] * R[1][j] + jp[e][2] * R[2][j];
      const T m = jp[e][0] * M[0][j] + jp[e][1] * M[1][j] + jp[e][2] * M[2][j];
      jl[e][j] = ml ? l * w * ml[j] : l * w;
      jc[e][j] = mp ? l * w * mp[j] : l * w;
      jc[e][3 + j] = mp ? -m * w * mp[3 + j] : -m * w;
    }
  }
  if constexpr (NC == 9) {
    const T* mi = a.mask_intr ? static_cast<const T*>(a.mask_intr) + 3 * k : nullptr;
    const T ji[2][3] = {{d * xn, f * xn * r2, f * xn * r2 * r2},
                        {d * yn, f * yn * r2, f * yn * r2 * r2}};
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        jc[e][6 + j] = mi ? ji[e][j] * w * mi[j] : ji[e][j] * w;
  }

  if (a.huber) {
    // core/losses.py _huber, then corrector.py's trivial branch (rho'' <= 0)
    const T s = r[0] * r[0] + r[1] * r[1];
    const T scale = static_cast<const T*>(a.huber)[k];
    T rho1 = T(1);
    if (s > scale * scale) {
      const T safe = s > T(kEps) ? s : T(kEps);
      const T out = scale / sqrt(safe);
      rho1 = out > T(kTiny) ? out : T(kTiny);
    }
    const T g = sqrt(rho1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r[e] *= g;
#pragma unroll
      for (int i = 0; i < NC; ++i) jc[e][i] *= g;
#pragma unroll
      for (int j = 0; j < 3; ++j) jl[e][j] *= g;
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kLandmarkThreads)
landmark_pass(const Args a) {
  constexpr int kW = 3 * NC, kRec = Counts<NC>::kRecord;
  __shared__ T stage[kLandmarkThreads / 32][32 * kW];
  const int width = int(a.width);
  const int lane = threadIdx.x & 31;
  const int sub = lane / width, sl = lane % width;
  const long long runs_per_warp = 32 / width;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  T* const wstage = stage[threadIdx.x >> 5];
  T* const Wout = static_cast<T*>(a.W);
  T* const rec = static_cast<T*>(a.rec);
  const int De = int(a.De);
  // every loop bound below is the same for every lane of the warp, so
  // every lane reaches the warp-wide votes, stores and shuffles
  for (long long base = warp * runs_per_warp; base < a.S; base += warps * runs_per_warp) {
    const long long s = base + sub;
    const int beg = s < a.S ? a.seg_off[s] : 0;
    const int end = s < a.S ? a.seg_off[s + 1] : 0;
    const int trips = __reduce_max_sync(0xffffffffu, (end - beg + width - 1) / width);
    T h[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) h[j] = T(0);
    for (int trip = 0; trip < trips; ++trip) {
      const int i = beg + sl + trip * width;
      const bool have = i < end;
      const long long k = have ? (a.lm_perm ? (long long)a.lm_perm[i] : (long long)i) : -1;
      T r[2], jc[2][NC], jl[2][3];
      if (have) {
        bal_pinhole_row<T, NC>(a, k, r, jc, jl);
      } else {
        zero_row<T, NC>(r, jc, jl);
      }
      T wrow[kW], rrow[kRec];
      int cp = 0, ci = 0;
      if (have) {
        const int* cols = a.ent_cols + 2 * a.ent[k];
        cp = cols[0];
        ci = cols[1];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 3; ++j) wrow[3 * c + j] = jc[0][c] * jl[0][j] + jc[1][c] * jl[1][j];
        rrow[c] = jc[0][c];
        rrow[NC + c] = jc[1][c];
      }
      rrow[2 * NC] = r[0];
      rrow[2 * NC + 1] = r[1];

      // Where the warp's rows are the 32 consecutive rows k0..k0+31 (always
      // in the bucketed layout: runs of the group's cap, a lane per row)
      // and the entity is no wider than its columns here, W's rows and the
      // records go out through the warp's staging buffer in shared memory,
      // so that each store instruction writes 32 consecutive values. The
      // strides there are odd (3 NC, 2 NC + 3), free of bank conflicts.
      const long long k0 = __shfl_sync(0xffffffffu, k, 0);
      if (__all_sync(0xffffffffu, have && k == k0 + lane) && De == NC) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = c < 6 ? cp + c : ci + c - 6;
#pragma unroll
          for (int j = 0; j < 3; ++j) wstage[lane * kW + 3 * col + j] = wrow[3 * c + j];
        }
        __syncwarp();
        for (int v = lane; v < 32 * kW; v += 32) Wout[k0 * kW + v] = wstage[v];
        __syncwarp();
#pragma unroll
        for (int v = 0; v < kRec; ++v) wstage[lane * (kRec + 1) + v] = rrow[v];
        __syncwarp();
        for (int v = lane; v < 32 * kRec; v += 32)
          rec[k0 * kRec + v] = wstage[(v / kRec) * (kRec + 1) + v % kRec];
        __syncwarp();
      } else if (have) {
        T* Wk = Wout + k * De * 3;
        for (int c = 0; c < De; ++c) {
          const bool mine = (c >= cp && c < cp + 6) || (NC == 9 && c >= ci && c < ci + 3);
          if (!mine) Wk[3 * c] = Wk[3 * c + 1] = Wk[3 * c + 2] = T(0);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = c < 6 ? cp + c : ci + c - 6;
#pragma unroll
          for (int j = 0; j < 3; ++j) Wk[3 * col + j] = wrow[3 * c + j];
        }
        T* out = rec + k * kRec;
#pragma unroll
        for (int v = 0; v < kRec; ++v) out[v] = rrow[v];
      }

      h[0] += jl[0][0] * jl[0][0] + jl[1][0] * jl[1][0];
      h[1] += jl[0][0] * jl[0][1] + jl[1][0] * jl[1][1];
      h[2] += jl[0][0] * jl[0][2] + jl[1][0] * jl[1][2];
      h[3] += jl[0][1] * jl[0][1] + jl[1][1] * jl[1][1];
      h[4] += jl[0][1] * jl[0][2] + jl[1][1] * jl[1][2];
      h[5] += jl[0][2] * jl[0][2] + jl[1][2] * jl[1][2];
#pragma unroll
      for (int j = 0; j < 3; ++j) h[6 + j] += jl[0][j] * r[0] + jl[1][j] * r[1];
    }
    for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < 9; ++j) h[j] += __shfl_xor_sync(0xffffffffu, h[j], off);
    }
    if (s < a.S && sl == 0) {
      const long long lm = a.seg_lm[s];
      T* H = static_cast<T*>(a.Hpp) + 9 * lm;
      T* g = static_cast<T*>(a.gp) + 3 * lm;
      H[0] += h[0]; H[1] += h[1]; H[2] += h[2];
      H[3] += h[1]; H[4] += h[3]; H[5] += h[4];
      H[6] += h[2]; H[7] += h[4]; H[8] += h[5];
      g[0] += h[6]; g[1] += h[7]; g[2] += h[8];
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kEntityThreads)
entity_pass(const Args a) {
  using C = Counts<NC>;
  __shared__ T red[kEntityWarps][C::kSums];
  const int t = blockIdx.x;
  const int end = a.tile_off[t + 1];
  const T* rec = static_cast<const T*>(a.rec);
  T acc[C::kSums];
#pragma unroll
  for (int j = 0; j < C::kSums; ++j) acc[j] = T(0);
  for (int i = a.tile_off[t] + threadIdx.x; i < end; i += kEntityThreads) {
    const T* row = rec + (long long)a.cam_perm[i] * C::kRecord;
    T j0[NC], j1[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      j0[c] = row[c];
      j1[c] = row[NC + c];
    }
    const T r0 = row[2 * NC], r1 = row[2 * NC + 1];
    int p = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int b = c; b < NC; ++b) acc[p++] += j0[c] * j0[b] + j1[c] * j1[b];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[C::kPairs + c] += j0[c] * r0 + j1[c] * r1;
    acc[C::kSums - 1] += r0 * r0 + r1 * r1;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < C::kSums; ++j) {
    T v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C::kSums; j += kEntityThreads) {
    T v = red[0][j];
#pragma unroll
    for (int w = 1; w < kEntityWarps; ++w) v += red[w][j];
    static_cast<T*>(a.part)[(long long)t * C::kSums + j] = v;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kFinalThreads)
finalize(const Args a) {
  using C = Counts<NC>;
  const T* part = static_cast<const T*>(a.part);
  if (blockIdx.x == a.Eg) {
    // the cost: every tile's r.r, strided over the threads, then a tree
    __shared__ T red[kFinalThreads];
    T v = T(0);
    for (long long t = threadIdx.x; t < a.T; t += kFinalThreads)
      v += part[t * C::kSums + C::kSums - 1];
    red[threadIdx.x] = v;
    __syncthreads();
    for (int n = kFinalThreads / 2; n > 0; n >>= 1) {
      if (threadIdx.x < n) red[threadIdx.x] += red[threadIdx.x + n];
      __syncthreads();
    }
    if (threadIdx.x == 0) *static_cast<T*>(a.cost) += T(0.5) * red[0];
    return;
  }
  const int j = threadIdx.x;
  if (j >= C::kSums - 1) return;
  const int g = blockIdx.x;
  const long long e = a.fin_ent[g];
  T v = T(0);
  for (int t = a.fin_off[g]; t < a.fin_off[g + 1]; ++t) v += part[(long long)t * C::kSums + j];
  const int* cols = a.ent_cols + 2 * e;
  const int De = int(a.De);
  if (j < C::kPairs) {
    // pair j of the upper triangle, row-major
    int c = 0, rest = j;
    while (rest >= NC - c) {
      rest -= NC - c;
      ++c;
    }
    const int b = c + rest;
    const int cc = c < 6 ? cols[0] + c : cols[1] + c - 6;
    const int cb = b < 6 ? cols[0] + b : cols[1] + b - 6;
    T* H = static_cast<T*>(a.Hcc) + e * De * De;
    H[cc * De + cb] += v;
    if (b != c) H[cb * De + cc] += v;
  } else {
    const int c = j - C::kPairs;
    static_cast<T*>(a.gc)[e * De + (c < 6 ? cols[0] + c : cols[1] + c - 6)] += v;
  }
}

template <typename T, int NC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.S > 0) {
    const long long runs_per_cta = (32 / a.width) * (kLandmarkThreads / 32);
    long long ctas = (a.S + runs_per_cta - 1) / runs_per_cta;
    if (ctas > 1048576) ctas = 1048576;
    landmark_pass<T, NC><<<(unsigned)ctas, kLandmarkThreads, 0, stream>>>(a);
  }
  if (a.T > 0) {
    entity_pass<T, NC><<<(unsigned)a.T, kEntityThreads, 0, stream>>>(a);
    finalize<T, NC><<<(unsigned)(a.Eg + 1), kFinalThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
int run(const Args* a, int nc, int device, void* stream) {
  if ((nc != 6 && nc != 9) || a->width < 1 || a->width > 32 || (a->width & (a->width - 1)) ||
      a->De < nc)
    return (int)cudaErrorInvalidValue;
  // this library's runtime has its own current device: set the tensors',
  // and put the caller's back
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = nc == 9 ? launch<T, 9>(*a, (cudaStream_t)stream) : launch<T, 6>(*a, (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace

// C entry points for ctypes: one factor group's assembly (the three kernels
// on `stream`), `nc` = 9 (pose and intrinsics optimized) or 6 (pose alone).
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int schur_assemble_f64(const SchurAssembleArgs* a, int nc, int device, void* stream) {
  return run<double>(a, nc, device, stream);
}

extern "C" int schur_assemble_f32(const SchurAssembleArgs* a, int nc, int device, void* stream) {
  return run<float>(a, nc, device, stream);
}
