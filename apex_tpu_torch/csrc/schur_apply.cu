// The coupling products of the implicit Schur solve, for Hopper (sm_90a):
// sums over one coupling group's rows W_k [De, 3] (linalg/schur.py):
//   - wt_x: t_p += sum_k W_k^T x[ent(k)] over the landmark's rows; fused
//     with the landmark blocks' inverse, u_p = Hpp^-1[p] t_p is stored
//     instead (the caller's landmarks are then each in one group alone);
//   - w_u: y_e += sum_k W_k u[lm(k)] over the entity's rows;
//   - diag: Z_e += sum_k W_k Hpp^-1[lm(k)] W_k^T (the Schur-Jacobi blocks'
//     sums, both triangles from the upper one).
//
// Replaces no TPU kernel. The JAX package leaves these sums to XLA
// (apex_tpu/linalg/schur.py), as the port left them to a gather of a [K, 3]
// or [K, De] copy, a batched matrix-vector product over K tiny matrices and
// an atomic index_add_ per group (linalg/schur.py's plain version, which
// the CPU and every group these kernels do not take still run).
//
// The rows are walked in the two orders of kernels/schur_apply.py's
// RowOrders, W read where it is stored (no copy of it in either order):
//   - landmark_pass (wt_x): a sub-warp of `width` lanes per landmark run (a
//     power of two, the group's longest run up to 32), a lane per row; the
//     sub-warp sums its run by xor shuffles and writes the landmark's three
//     values once;
//   - camera_pass (w_u, diag): one CTA per tile of at most TILE_ROWS rows of
//     one entity in camera-major order; each thread sums its rows in
//     registers, the CTA reduces them (shuffles, then the warps in order) to
//     one partial per tile in scratch; finalize then adds each entity's
//     tiles' partials in tile order to the output.
// No atomics: every sum runs in a fixed order, so a call gives the same
// bits run to run. Per-row products stay in registers; nothing per row is
// written to device memory.
//
// What bounds them: HBM bytes. W is 3 De values a row (216 B in f64 at
// De = 9; 1.40 GB at venice's 6,491,429 rows, 0.42 ms at 3.35 TB/s), each
// read once per pass; beside it per row two int32 ids (the row in the
// order, its entity or landmark), and the vectors, which the caches hold
// (x: 16,002 values; u: 993,923 x 3; Hpp^-1, read by diag: 993,923 x 9).
// Arithmetic is 27 multiply-adds a row (wt_x, w_u) or about 220 (diag),
// far below the byte time at the FP64 rate. What the design does about
// the bytes: each warp stages its 32 rows of W through shared memory, each
// load instruction reading 32 consecutive values of W where the rows are
// consecutive (the landmark-major order of build_ba_problem's layouts) and
// a row's 3 De values from neighbouring lanes otherwise (the camera-major
// order), so every 32-B sector of a row is fetched once; the run and tile
// bounds and per-row ids are int32 and read in order; a row's vector values
// (x, u, its Hpp^-1 block) are loaded before its W, and the camera pass
// loads a chunk's row and landmark ids one chunk ahead, so that a chunk
// costs one round trip to memory, not two or three.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>
#include <stdint.h>

// Every field is 8 bytes, so the layout is the ctypes Structure's of
// kernels/schur_apply.py field for field. It lies outside the anonymous
// namespace, so that the C entry points that take it keep external linkage.
struct SchurApplyArgs {
  const void* W;          // [K, De, 3] the group's couplings, in row order
  const int* lm_perm;     // [K] landmark-major row order, or null: the rows' own
  const int* lm_ent;      // [K] entity of each row, in landmark-major order
  const int* seg_lm;      // [S] landmark of each run
  const int* seg_off;     // [S + 1] run bounds in landmark-major order
  const int* cam_perm;    // [K] camera-major row order
  const int* cam_lm;      // [K] landmark of each row, in camera-major order
  const int* tile_off;    // [T + 1] tile bounds in camera-major order
  const int* fin_ent;     // [Eg] the group's entities
  const int* fin_off;     // [Eg + 1] their tiles
  const void* in;         // wt_x: x [E, De]; w_u: u [P, 3]; diag: unused
  const void* Hinv;       // [P, 3, 3]: diag, and wt_x fused; else null
  void* out;              // wt_x: [P, 3]; w_u: [E, De]; diag: [E, De, De]
  void* part;             // [T, NA] scratch of camera_pass
  long long S;            // landmark runs
  long long width;        // lanes per run
  long long T;            // tiles
  long long Eg;           // entities of the group
};

namespace {

using Args = SchurApplyArgs;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kFinalThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
// the operations of the entry points
constexpr int kWtX = 0, kWU = 1, kDiag = 2;

template <int DE, bool DIAG>
struct Sums {
  // values per tile partial: y's De, or Z's upper triangle
  static constexpr int kN = DIAG ? DE * (DE + 1) / 2 : DE;
};

// The warp's 32 rows of W into `stage` (row of lane l at l * SP, SP odd so
// that lanes reading their own rows hit distinct banks), rows[l] < 0: none.
// Value v of the 32 x NW block goes to lane v % 32: where the rows are
// consecutive, each load instruction reads 32 consecutive values of W.
template <typename T, int NW, int SP>
__device__ __forceinline__ void stage_rows(const T* __restrict__ W, const int* rows, T* stage,
                                           int lane) {
  T v[NW];
#pragma unroll
  for (int it = 0; it < NW; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / NW;
    const int k = rows[r];
    v[it] = k >= 0 ? W[(long long)k * NW + (idx - r * NW)] : T(0);
  }
#pragma unroll
  for (int it = 0; it < NW; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / NW;
    stage[r * SP + (idx - r * NW)] = v[it];
  }
}

template <typename T, int DE, bool FUSE>
__global__ void __launch_bounds__(kThreads) landmark_pass(const Args a) {
  constexpr int NW = 3 * DE, SP = NW | 1;
  __shared__ T stage_all[kWarps][32 * SP];
  __shared__ int rows_all[kWarps][32];
  const int lane = threadIdx.x & 31;
  T* const stage = stage_all[threadIdx.x >> 5];
  int* const rows = rows_all[threadIdx.x >> 5];
  const int width = int(a.width);
  const int sub = lane / width, sl = lane % width;
  const long long runs_per_warp = 32 / width;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const T* const W = static_cast<const T*>(a.W);
  const T* const x = static_cast<const T*>(a.in);
  // every loop bound below is the same for every lane of the warp, so
  // every lane reaches the warp-wide votes, barriers and shuffles
  for (long long base = warp * runs_per_warp; base < a.S; base += warps * runs_per_warp) {
    const long long s = base + sub;
    const int beg = s < a.S ? a.seg_off[s] : 0;
    const int end = s < a.S ? a.seg_off[s + 1] : 0;
    const int trips = __reduce_max_sync(kAll, (end - beg + width - 1) / width);
    T t0 = T(0), t1 = T(0), t2 = T(0);
    for (int trip = 0; trip < trips; ++trip) {
      const int i = beg + sl + trip * width;
      const bool have = i < end;
      // the row's entity and x there first, so that their loads are in
      // flight with W's
      T xe[DE];
      if (have) {
        const T* xp = x + (long long)a.lm_ent[i] * DE;
#pragma unroll
        for (int c = 0; c < DE; ++c) xe[c] = xp[c];
      }
      rows[lane] = have ? (a.lm_perm ? a.lm_perm[i] : i) : -1;
      __syncwarp();
      stage_rows<T, NW, SP>(W, rows, stage, lane);
      __syncwarp();
      if (have) {
        // W_k^T x[ent(k)], then the run's sum
        const T* w = stage + lane * SP;
        T r0 = T(0), r1 = T(0), r2 = T(0);
#pragma unroll
        for (int c = 0; c < DE; ++c) {
          const T xc = xe[c];
          r0 += w[3 * c] * xc;
          r1 += w[3 * c + 1] * xc;
          r2 += w[3 * c + 2] * xc;
        }
        t0 += r0;
        t1 += r1;
        t2 += r2;
      }
      __syncwarp();
    }
    for (int off = width >> 1; off > 0; off >>= 1) {
      t0 += __shfl_xor_sync(kAll, t0, off);
      t1 += __shfl_xor_sync(kAll, t1, off);
      t2 += __shfl_xor_sync(kAll, t2, off);
    }
    if (s < a.S && sl == 0) {
      const long long lm = a.seg_lm[s];
      T* o = static_cast<T*>(a.out) + 3 * lm;
      if constexpr (FUSE) {
        const T* H = static_cast<const T*>(a.Hinv) + 9 * lm;
        o[0] = H[0] * t0 + H[1] * t1 + H[2] * t2;
        o[1] = H[3] * t0 + H[4] * t1 + H[5] * t2;
        o[2] = H[6] * t0 + H[7] * t1 + H[8] * t2;
      } else {
        o[0] += t0;
        o[1] += t1;
        o[2] += t2;
      }
    }
  }
}

template <typename T, int DE, bool DIAG>
__global__ void __launch_bounds__(kThreads) camera_pass(const Args a) {
  constexpr int NW = 3 * DE, SP = NW | 1, NA = Sums<DE, DIAG>::kN;
  __shared__ T stage_all[kWarps][32 * SP];
  __shared__ int rows_all[kWarps][32];
  __shared__ T red[kWarps][NA];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  T* const stage = stage_all[wid];
  int* const rows = rows_all[wid];
  const int t = blockIdx.x;
  const int beg = a.tile_off[t], end = a.tile_off[t + 1];
  const T* const W = static_cast<const T*>(a.W);
  T acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = T(0);
  // each warp takes chunks of 32 consecutive rows of the tile; the bound is
  // the same for every lane of the warp. A chunk's row and landmark ids are
  // loaded one chunk ahead, so that the chunk's W and its landmarks' values
  // are one round trip to memory
  int k_next = beg + 32 * wid + lane < end ? a.cam_perm[beg + 32 * wid + lane] : -1;
  int l_next = beg + 32 * wid + lane < end ? a.cam_lm[beg + 32 * wid + lane] : 0;
  for (int c0 = beg + 32 * wid; c0 < end; c0 += kThreads) {
    const int i = c0 + lane;
    const bool have = i < end;
    const int k = k_next;
    const long long l = l_next;
    if (i + kThreads < end) {
      k_next = a.cam_perm[i + kThreads];
      l_next = a.cam_lm[i + kThreads];
    }
    // the row's Hpp^-1 block or u before W, so that their loads are in
    // flight together
    constexpr int NV = DIAG ? 9 : 3;
    T v[NV];
    if (have) {
      const T* src = DIAG ? static_cast<const T*>(a.Hinv) + 9 * l
                          : static_cast<const T*>(a.in) + 3 * l;
#pragma unroll
      for (int m = 0; m < NV; ++m) v[m] = src[m];
    }
    rows[lane] = have ? k : -1;
    __syncwarp();
    stage_rows<T, NW, SP>(W, rows, stage, lane);
    __syncwarp();
    if (have) {
      const T* w = stage + lane * SP;
      if constexpr (DIAG) {
        // Y = W_k Hpp^-1, row by row, and the upper triangle of Y W_k^T
        const T* h = v;
        int p = 0;
#pragma unroll
        for (int c = 0; c < DE; ++c) {
          const T y0 = w[3 * c] * h[0] + w[3 * c + 1] * h[3] + w[3 * c + 2] * h[6];
          const T y1 = w[3 * c] * h[1] + w[3 * c + 1] * h[4] + w[3 * c + 2] * h[7];
          const T y2 = w[3 * c] * h[2] + w[3 * c + 1] * h[5] + w[3 * c + 2] * h[8];
#pragma unroll
          for (int b = c; b < DE; ++b)
            acc[p++] += y0 * w[3 * b] + y1 * w[3 * b + 1] + y2 * w[3 * b + 2];
        }
      } else {
        const T u0 = v[0], u1 = v[1], u2 = v[2];
#pragma unroll
        for (int c = 0; c < DE; ++c)
          acc[c] += w[3 * c] * u0 + w[3 * c + 1] * u1 + w[3 * c + 2] * u2;
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    T v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
    if (lane == 0) red[wid][j] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NA; j += kThreads) {
    T v = red[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][j];
    static_cast<T*>(a.part)[(long long)t * NA + j] = v;
  }
}

// One thread per (entity of the group, value): the sum of the entity's
// tiles' partials in tile order, added to the output (both triangles of
// Z's block from its upper one).
template <typename T, int DE, bool DIAG>
__global__ void __launch_bounds__(kFinalThreads) finalize(const Args a) {
  constexpr int NA = Sums<DE, DIAG>::kN;
  const long long idx = blockIdx.x * (long long)kFinalThreads + threadIdx.x;
  if (idx >= a.Eg * NA) return;
  const int g = int(idx / NA), j = int(idx % NA);
  const T* part = static_cast<const T*>(a.part);
  T v = T(0);
  for (int t = a.fin_off[g]; t < a.fin_off[g + 1]; ++t) v += part[(long long)t * NA + j];
  const long long e = a.fin_ent[g];
  T* o = static_cast<T*>(a.out);
  if constexpr (DIAG) {
    // pair j of the upper triangle, row-major
    int c = 0, rest = j;
    while (rest >= DE - c) {
      rest -= DE - c;
      ++c;
    }
    const int b = c + rest;
    o[(e * DE + c) * DE + b] += v;
    if (b != c) o[(e * DE + b) * DE + c] += v;
  } else {
    o[e * DE + j] += v;
  }
}

template <typename T, int DE, bool DIAG>
void camera_sums(const Args& a, cudaStream_t stream) {
  if (a.T == 0) return;
  camera_pass<T, DE, DIAG><<<(unsigned)a.T, kThreads, 0, stream>>>(a);
  const long long n = a.Eg * Sums<DE, DIAG>::kN;
  finalize<T, DE, DIAG><<<(unsigned)((n + kFinalThreads - 1) / kFinalThreads), kFinalThreads, 0,
                          stream>>>(a);
}

template <typename T, int DE>
cudaError_t launch(const Args& a, int op, cudaStream_t stream) {
  if (op == kWtX) {
    if (a.S > 0) {
      const long long runs_per_cta = (32 / a.width) * kWarps;
      long long ctas = (a.S + runs_per_cta - 1) / runs_per_cta;
      if (ctas > 1048576) ctas = 1048576;
      if (a.Hinv)
        landmark_pass<T, DE, true><<<(unsigned)ctas, kThreads, 0, stream>>>(a);
      else
        landmark_pass<T, DE, false><<<(unsigned)ctas, kThreads, 0, stream>>>(a);
    }
  } else if (op == kWU) {
    camera_sums<T, DE, false>(a, stream);
  } else {
    camera_sums<T, DE, true>(a, stream);
  }
  return cudaGetLastError();
}

template <typename T>
int run(const Args* a, int op, int de, int device, void* stream) {
  if ((de != 6 && de != 9) || op < kWtX || op > kDiag || a->width < 1 || a->width > 32 ||
      (a->width & (a->width - 1)) || a->T > 2147483647LL || (op == kDiag && !a->Hinv))
    return (int)cudaErrorInvalidValue;
  // this library's runtime has its own current device: set the tensors',
  // and put the caller's back
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = de == 9 ? launch<T, 9>(*a, op, (cudaStream_t)stream)
                : launch<T, 6>(*a, op, (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace

// C entry points for ctypes: one coupling group's pass on `stream`, `op` 0
// (wt_x), 1 (w_u) or 2 (diag), `de` = 9 or 6 the entity width. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int schur_apply_f64(const SchurApplyArgs* a, int op, int de, int device,
                               void* stream) {
  return run<double>(a, op, de, device, stream);
}

extern "C" int schur_apply_f32(const SchurApplyArgs* a, int op, int de, int device,
                               void* stream) {
  return run<float>(a, op, de, device, stream);
}
