// Batched symmetric inverse with the eigenvalues clamped to a positive floor,
// [B,n,n] -> [B,n,n], for Hopper (sm_90a).
//
// It computes apex_tpu/linalg/utils.py::spd_clamped_inv, a function the JAX
// package leaves to XLA (jnp.linalg.eigh, then V diag(1/w) V^T): with w the
// eigenvalues of a block, w is clamped to rel_floor * max(max|w|, 1)
// (rel_floor 1e-12 in f64, 1e-6 in f32). The port's plain version is the same
// eigh form in PyTorch (kernels/spd_inverse.py). torch.linalg.eigh on the
// card reads its error flag back after the factorization, so it cannot be
// captured in a CUDA graph; this kernel reads nothing back.
//
// As torch.linalg.eigh does, it reads the lower triangle of each block only.
//
// Where it runs: the Schur-Jacobi preconditioner of the implicit Schur solve
// ([cameras, De, De], De = 9 for BAL self-calibration, up to 15 with a full
// camera model; 257 to 1,778 cameras) and plain PCG's per-variable blocks
// ([n, d, d], d = 1-10; 65,132 x 3 x 3 for trafalgar's landmarks). Once per
// LM iteration.
//
// What bounds it: at these shapes, neither bytes nor the card's arithmetic
// rate but latency: each block is a chain of dependent Jacobi rotations
// (n (n-1) / 2 per sweep, a few sweeps), each rotation a square root and a
// division followed by two rank-2 updates. Bytes are 2 n^2 values per block
// (1.3 MB at 1,778 x 9 x 9 in f64, 4.7 MB at 65,132 x 3 x 3), which the
// card moves in microseconds.
//
// Design, n <= 32 (every per-camera entity and variable pool): one warp per
// block, the block and its eigenvector matrix V in the warp's shared
// memory, lane k owning row k and column k. Larger blocks (an entity that
// merges cameras sharing their intrinsics: 44 for six cameras) take one CTA
// each, spd_clamped_inv_cta_kernel below.
//   - Cyclic Jacobi: for each pair p < q with a_pq != 0, the rotation
//     (Golub & Van Loan's sym.schur2) tau = (a_qq - a_pp) / (2 a_pq),
//     t = sign(tau) / (|tau| + sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2),
//     s = t c; columns p and q of A and V are rotated by the lanes in
//     parallel, then rows p and q of A, then lane 0 writes a_pq = a_qp = 0,
//     a_pp -= t a_pq and a_qq += t a_pq. Every lane reads the same a_pp,
//     a_qq, a_pq, so the branches are uniform across the warp.
//   - A sweep starts with a warp sum of the squared off-diagonal entries
//     and of all entries (an xor butterfly, so every lane holds the same
//     sums bit for bit); the loop stops when off <= eps^2 * total, eps the
//     dtype's unit roundoff, or at a fixed cap of sweeps per dtype (kSweeps:
//     Jacobi converges quadratically, and a 15 x 15 block needs 6-8 sweeps
//     to f64 precision).
//   - Clamp w_k = max(a_kk, rel_floor * max(max_k |a_kk|, 1)) and write
//     out_ij = sum_k v_ik v_jk / w_k, element idx = lane + 32 m of the block,
//     so consecutive lanes store consecutive addresses.
//   - Several warps share a CTA, as many as kSharedBudget bytes of shared
//     memory hold; the grid walks the batch with a stride.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;        // the warp kernel's largest block
constexpr int kMaxCtaN = 1024;   // the CTA kernel's (kMaxPairs pairs)
constexpr int kCtaThreads = 256;
constexpr int kMaxWarps = 8;
constexpr int kSharedBudget = 40 * 1024;  // below the 48 KB static limit

template <typename T> struct Limits;
template <> struct Limits<double> {
  static constexpr int kSweeps = 15;
  static __device__ double eps2() { return 1.232595164407831e-32; }  // (2^-53)^2
};
template <> struct Limits<float> {
  static constexpr int kSweeps = 10;
  static __device__ float eps2() { return 3.5527137e-15f; }  // (2^-24)^2
};

__device__ inline double dsqrt(double x) { return sqrt(x); }
__device__ inline float dsqrt(float x) { return sqrtf(x); }

template <typename T>
__device__ inline T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T>
__global__ void spd_clamped_inv_kernel(const T* __restrict__ in, T* __restrict__ out,
                                       long long batch, int n, T rel_floor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nn = n * n;
  T* A = reinterpret_cast<T*>(smem_raw) + (size_t)warp * (2 * nn + n);
  T* V = A + nn;
  T* W = V + nn;

  for (long long b = (long long)blockIdx.x * warps + warp; b < batch;
       b += (long long)gridDim.x * warps) {
    const T* src = in + b * nn;
    // the lower triangle, mirrored
    for (int idx = lane; idx < nn; idx += 32) {
      const int i = idx / n, j = idx % n;
      A[idx] = i >= j ? src[idx] : src[j * n + i];
      V[idx] = i == j ? T(1) : T(0);
    }
    __syncwarp();

    for (int sweep = 0; sweep < Limits<T>::kSweeps; ++sweep) {
      T off = 0, total = 0;
      for (int idx = lane; idx < nn; idx += 32) {
        const T a = A[idx];
        total += a * a;
        if (idx / n != idx % n) off += a * a;
      }
      off = warp_sum(off);
      total = warp_sum(total);
      if (off <= Limits<T>::eps2() * total) break;

      for (int p = 0; p < n - 1; ++p) {
        for (int q = p + 1; q < n; ++q) {
          const T apq = A[p * n + q];
          if (apq == T(0)) continue;
          const T app = A[p * n + p], aqq = A[q * n + q];
          const T tau = (aqq - app) / (T(2) * apq);
          const T t = (tau >= T(0) ? T(1) : T(-1)) / (fabs(tau) + dsqrt(T(1) + tau * tau));
          const T c = T(1) / dsqrt(T(1) + t * t);
          const T s = t * c;
          __syncwarp();
          if (lane < n) {
            const int k = lane;
            const T akp = A[k * n + p], akq = A[k * n + q];
            A[k * n + p] = c * akp - s * akq;
            A[k * n + q] = s * akp + c * akq;
            const T vkp = V[k * n + p], vkq = V[k * n + q];
            V[k * n + p] = c * vkp - s * vkq;
            V[k * n + q] = s * vkp + c * vkq;
          }
          __syncwarp();
          if (lane < n) {
            const int k = lane;
            const T apk = A[p * n + k], aqk = A[q * n + k];
            A[p * n + k] = c * apk - s * aqk;
            A[q * n + k] = s * apk + c * aqk;
          }
          __syncwarp();
          if (lane == 0) {
            A[p * n + q] = T(0);
            A[q * n + p] = T(0);
            A[p * n + p] = app - t * apq;
            A[q * n + q] = aqq + t * apq;
          }
          __syncwarp();
        }
      }
    }

    // clamp the eigenvalues (the diagonal) and keep their reciprocals
    T wmax = 0;
    for (int k = lane; k < n; k += 32) wmax = fmax(wmax, fabs(A[k * n + k]));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) wmax = fmax(wmax, __shfl_xor_sync(0xffffffffu, wmax, m));
    const T floor_ = rel_floor * fmax(wmax, T(1));
    if (lane < n) W[lane] = T(1) / fmax(A[lane * n + lane], floor_);
    __syncwarp();

    T* dst = out + b * nn;
    for (int idx = lane; idx < nn; idx += 32) {
      const int i = idx / n, j = idx % n;
      T acc = 0;
      for (int k = 0; k < n; ++k) acc += V[i * n + k] * W[k] * V[j * n + k];
      dst[idx] = acc;
    }
    __syncwarp();
  }
}

// n > 32 (a shared-intrinsics entity: 6 per camera plus the intrinsics):
// one CTA per block, A, V and 1/w in the block's slice of `work`
// (2 n^2 + n values; L2 keeps them close). Parallel Jacobi in the
// round-robin order: each step rotates n/2 disjoint pairs at once, the
// n - 1 steps of a sweep meeting every pair once. Per step the pairs'
// rotations are formed, then every row's columns p, q of A and V are
// rotated, then every column's rows p, q of A, and then each pair's 2x2
// block is set as in the warp kernel. Disjoint pairs commute, so a step is
// the product of its rotations. Threads stride over the work items.
template <typename T>
__global__ void spd_clamped_inv_cta_kernel(const T* __restrict__ in, T* __restrict__ out,
                                           T* __restrict__ work, int n, T rel_floor) {
  constexpr int kMaxPairs = 512;  // n <= 1024
  __shared__ int P[kMaxPairs], Q[kMaxPairs];
  __shared__ T C[kMaxPairs], S[kMaxPairs], Tt[kMaxPairs], App[kMaxPairs], Aqq[kMaxPairs],
      Apq[kMaxPairs];
  __shared__ T red[2][32];
  __shared__ int done;
  const long long b = blockIdx.x;
  const int nn = n * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* A = work + b * (2 * (long long)nn + n);
  T* V = A + nn;
  T* W = V + nn;
  const T* src = in + b * nn;
  for (int idx = tid; idx < nn; idx += nt) {
    const int i = idx / n, j = idx % n;
    A[idx] = i >= j ? src[idx] : src[j * n + i];
    V[idx] = i == j ? T(1) : T(0);
  }
  const int m = n + (n & 1);  // a dummy index n pads an odd n
  const int pairs = m / 2;
  __syncthreads();
  for (int sweep = 0; sweep < Limits<T>::kSweeps; ++sweep) {
    T off = 0, total = 0;
    for (int idx = tid; idx < nn; idx += nt) {
      const T a = A[idx];
      total += a * a;
      if (idx / n != idx % n) off += a * a;
    }
    off = warp_sum(off);
    total = warp_sum(total);
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = off;
      red[1][tid >> 5] = total;
    }
    __syncthreads();
    if (tid == 0) {
      T o = 0, t = 0;
      for (int w = 0; w < (nt + 31) / 32; ++w) {
        o += red[0][w];
        t += red[1][w];
      }
      done = o <= Limits<T>::eps2() * t;
    }
    __syncthreads();
    if (done) break;
    for (int step = 0; step < m - 1; ++step) {
      for (int k = tid; k < pairs; k += nt) {
        // the round-robin schedule: position 0 fixed, the rest rotating
        const int a = k == 0 ? 0 : (k - 1 + step) % (m - 1) + 1;
        const int c = (m - 2 - k + step) % (m - 1) + 1;
        int p = a < c ? a : c, q = a < c ? c : a;
        T cc = 1, ss = 0, tt = 0, apq = 0, app = 0, aqq = 0;
        if (q < n) {
          apq = A[p * n + q];
          app = A[p * n + p];
          aqq = A[q * n + q];
          if (apq != T(0)) {
            const T tau = (aqq - app) / (T(2) * apq);
            tt = (tau >= T(0) ? T(1) : T(-1)) / (fabs(tau) + dsqrt(T(1) + tau * tau));
            cc = T(1) / dsqrt(T(1) + tt * tt);
            ss = tt * cc;
          }
        } else {
          q = p;  // the dummy's partner is left as it is
        }
        P[k] = p;
        Q[k] = q;
        C[k] = cc;
        S[k] = ss;
        Tt[k] = tt;
        App[k] = app;
        Aqq[k] = aqq;
        Apq[k] = apq;
      }
      __syncthreads();
      for (int item = tid; item < n * pairs; item += nt) {
        const int r = item / pairs, k = item % pairs;
        if (P[k] == Q[k] || S[k] == T(0)) continue;
        const int p = P[k], q = Q[k];
        const T cc = C[k], ss = S[k];
        const T arp = A[r * n + p], arq = A[r * n + q];
        A[r * n + p] = cc * arp - ss * arq;
        A[r * n + q] = ss * arp + cc * arq;
        const T vrp = V[r * n + p], vrq = V[r * n + q];
        V[r * n + p] = cc * vrp - ss * vrq;
        V[r * n + q] = ss * vrp + cc * vrq;
      }
      __syncthreads();
      for (int item = tid; item < n * pairs; item += nt) {
        const int k = item / n, col = item % n;
        if (P[k] == Q[k] || S[k] == T(0)) continue;
        const int p = P[k], q = Q[k];
        const T cc = C[k], ss = S[k];
        const T apc = A[p * n + col], aqc = A[q * n + col];
        A[p * n + col] = cc * apc - ss * aqc;
        A[q * n + col] = ss * apc + cc * aqc;
      }
      __syncthreads();
      for (int k = tid; k < pairs; k += nt) {
        if (P[k] == Q[k] || S[k] == T(0)) continue;
        const int p = P[k], q = Q[k];
        A[p * n + q] = T(0);
        A[q * n + p] = T(0);
        A[p * n + p] = App[k] - Tt[k] * Apq[k];
        A[q * n + q] = Aqq[k] + Tt[k] * Apq[k];
      }
      __syncthreads();
    }
  }
  T wmax = 0;
  for (int k = tid; k < n; k += nt) wmax = fmax(wmax, fabs(A[k * n + k]));
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) wmax = fmax(wmax, __shfl_xor_sync(0xffffffffu, wmax, sh));
  if ((tid & 31) == 0) red[0][tid >> 5] = wmax;
  __syncthreads();
  if (tid == 0) {
    T w = 0;
    for (int i = 0; i < (nt + 31) / 32; ++i) w = fmax(w, red[0][i]);
    red[1][0] = rel_floor * fmax(w, T(1));
  }
  __syncthreads();
  const T floor_ = red[1][0];
  for (int k = tid; k < n; k += nt) W[k] = T(1) / fmax(A[k * n + k], floor_);
  __syncthreads();
  T* dst = out + b * nn;
  for (int idx = tid; idx < nn; idx += nt) {
    const int i = idx / n, j = idx % n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += V[i * n + k] * W[k] * V[j * n + k];
    dst[idx] = acc;
  }
}

template <typename T>
int warps_per_cta(int n) {
  const int per_warp = (2 * n * n + n) * (int)sizeof(T);
  int w = kSharedBudget / per_warp;
  return w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
}

template <typename T>
int launch(const void* in, void* out, void* work, long long batch, int n, double rel_floor,
           int device, void* stream) {
  if (n < 1 || n > kMaxCtaN || (n > kMaxN && work == nullptr)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  // this library's runtime has its own current device: set the tensor's,
  // and put the caller's back
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  if (n <= kMaxN) {
    const int warps = warps_per_cta<T>(n);
    const size_t shared = (size_t)warps * (2 * n * n + n) * sizeof(T);
    long long ctas = (batch + warps - 1) / warps;
    if (ctas > 1048576) ctas = 1048576;
    spd_clamped_inv_kernel<T><<<(unsigned)ctas, warps * 32, shared, (cudaStream_t)stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), batch, n, (T)rel_floor);
  } else {
    spd_clamped_inv_cta_kernel<T><<<(unsigned)batch, kCtaThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), static_cast<T*>(work), n,
        (T)rel_floor);
  }
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace

extern "C" {

int spd_clamped_inv_f64(const void* in, void* out, void* work, long long batch, int n,
                        double rel_floor, int device, void* stream) {
  return launch<double>(in, out, work, batch, n, rel_floor, device, stream);
}

int spd_clamped_inv_f32(const void* in, void* out, void* work, long long batch, int n,
                        double rel_floor, int device, void* stream) {
  return launch<float>(in, out, work, batch, n, rel_floor, device, stream);
}

// Blocks per CTA, threads per CTA, dynamic shared bytes per CTA and the
// sweep cap for a block size n and a dtype (1 = f64): the launch
// configuration, for the record.
int spd_clamped_inv_config(int f64, int n, int* info) {
  if (n < 1 || n > kMaxCtaN) return (int)cudaErrorInvalidValue;
  const int warps = n > kMaxN ? 0 : (f64 ? warps_per_cta<double>(n) : warps_per_cta<float>(n));
  info[0] = n > kMaxN ? 1 : warps;
  info[1] = n > kMaxN ? kCtaThreads : 32 * warps;
  info[2] = warps * (2 * n * n + n) * (f64 ? 8 : 4);
  info[3] = f64 ? Limits<double>::kSweeps : Limits<float>::kSweeps;
  return 0;
}

}  // extern "C"
