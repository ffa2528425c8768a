// Eigenvalue-conditioned regularized inverse of symmetric 3x3 landmark
// Hessian blocks, [P,3,3] -> [P,3,3], for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel apex_tpu/kernels/landmark_blocks.py::
// invert_landmark_blocks_pallas (body _kernel). It is written from what that
// kernel computes, following the XLA formulation
// apex_tpu/linalg/schur.py::invert_landmark_blocks (sym3x3_eigvals + inv3x3),
// not from the Pallas lane planes:
//   1. closed-form trigonometric eigenvalue extrema with plain acos (the
//      Pallas kernel's Newton cos(acos(r)/3) exists only because Mosaic has
//      no acos); when p2 < 1e-30 the block is diagonal and the extrema are
//      its diagonal, taken by a real branch, so no NaN from p = 0 is ever
//      formed (the XLA 1e-300 floor underflows to 0 in f32);
//   2. if emin < floor or emax > cond_max * max(emin, floor * 1e-3), add
//      |emin| + rel * max(emax, 1) + floor to the diagonal;
//   3. adjugate / determinant inverse.
// Thresholds: f32 1e-5 / 1e6 / 1e-5, f64 1e-12 / 1e10 / 1e-8.
//
// Bound: memory. One thread per block reads the 6 unique entries of a
// contiguous [P,3,3] input and writes the full symmetric output: 72 B read
// and 72 B written per block in f64, ~9.4 MB per call at trafalgar scale
// (65,132 blocks), so a call there is bound by its launch. No padding: the
// ragged tail is masked by the thread index. The stride-9 loads are not
// coalesced; a structure-of-arrays layout is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// -Xcompiler -fPIC. -fmad=false keeps each product rounded as in the plain
// PyTorch version, so the regularization decision is taken on the same
// numbers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Per-dtype thresholds, computed as the JAX package computes them (the
// products in double, then rounded to T).
template <typename T> struct Thresholds {
  T eig_floor, cond_max, rel, floor_min;
};
inline Thresholds<float> thresholds(float) {
  return {float(1e-5), float(1e6), float(1e-5), float(1e-5 * 1e-3)};
}
inline Thresholds<double> thresholds(double) {
  return {1e-12, 1e10, 1e-8, 1e-12 * 1e-3};
}

template <typename T>
__global__ void invert_landmark_blocks_kernel(const T* __restrict__ H,
                                              T* __restrict__ out,
                                              long long P,
                                              Thresholds<T> C) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= P) return;
  const T* h = H + 9 * k;
  T a00 = h[0], a01 = h[1], a02 = h[2];
  T a11 = h[4], a12 = h[5], a22 = h[8];

  // --- eigenvalue extrema (trigonometric method) ---------------------------
  const T p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const T q = (a00 + a11 + a22) / T(3);
  const T d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const T p2 = d0 * d0 + d1 * d1 + d2 * d2 + T(2) * p1;
  T emin, emax;
  if (p2 < T(1e-30)) {
    emin = fmin(fmin(a00, a11), a22);
    emax = fmax(fmax(a00, a11), a22);
  } else {
    const T p = sqrt(p2 / T(6));
    const T b00 = d0 / p, b11 = d1 / p, b22 = d2 / p;
    const T b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
    const T detB = b00 * (b11 * b22 - b12 * b12)
                 - b01 * (b01 * b22 - b12 * b02)
                 + b02 * (b01 * b12 - b11 * b02);
    const T r = fmin(fmax(detB / T(2), T(-1)), T(1));
    const T phi = acos(r) / T(3);
    const T e1 = q + T(2) * p * cos(phi);
    const T e3 = q + T(2) * p * cos(phi + T(2.0 * 3.141592653589793 / 3.0));
    const T e2 = T(3) * q - e1 - e3;
    emin = fmin(fmin(e1, e2), e3);
    emax = fmax(fmax(e1, e2), e3);
  }

  // --- regularization ---------------------------------------------------------
  const bool bad = (emin < C.eig_floor) ||
                   (emax > C.cond_max * fmax(emin, C.floor_min));
  if (bad) {
    const T reg = fabs(emin) + C.rel * fmax(emax, T(1)) + C.eig_floor;
    a00 += reg;
    a11 += reg;
    a22 += reg;
  }

  // --- adjugate / determinant --------------------------------------------------
  const T A11 = a11 * a22 - a12 * a12;
  const T A12 = a02 * a12 - a01 * a22;
  const T A13 = a01 * a12 - a02 * a11;
  const T A22 = a00 * a22 - a02 * a02;
  const T A23 = a02 * a01 - a00 * a12;
  const T A33 = a00 * a11 - a01 * a01;
  const T inv_det = T(1) / (a00 * A11 + a01 * A12 + a02 * A13);
  T* o = out + 9 * k;
  const T i00 = A11 * inv_det, i01 = A12 * inv_det, i02 = A13 * inv_det;
  const T i11 = A22 * inv_det, i12 = A23 * inv_det, i22 = A33 * inv_det;
  o[0] = i00; o[1] = i01; o[2] = i02;
  o[3] = i01; o[4] = i11; o[5] = i12;
  o[6] = i02; o[7] = i12; o[8] = i22;
}

template <typename T>
int launch(const T* H, T* out, long long P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long blocks = (P + threads - 1) / threads;
  invert_landmark_blocks_kernel<T><<<(unsigned int)blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
      H, out, P, thresholds(T(0)));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points for ctypes. P >= 1; pointers are device pointers to
// contiguous [P,3,3] arrays; the stream is PyTorch's current stream.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int invert_landmark_blocks_f32(const float* H, float* out,
                                          long long P, int device,
                                          void* stream) {
  return launch<float>(H, out, P, device, stream);
}

extern "C" int invert_landmark_blocks_f64(const double* H, double* out,
                                          long long P, int device,
                                          void* stream) {
  return launch<double>(H, out, P, device, stream);
}
