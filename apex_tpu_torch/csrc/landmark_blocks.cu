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
// What bounds it: HBM bytes. Each block is read once (9 values) and written
// once (9 values): 72 B per block in f32 and 144 B in f64, so 71.6 MB and
// 143.1 MB at P = 993,923 (venice), 21.4 us and 42.7 us at 3.35 TB/s.
// The arithmetic is ~105 operations per block in the source (10 divisions,
// one sqrt, one acos, two cos); expanded by libdevice, at ~10 FP64
// instructions per division or sqrt and ~40 per acos or cos, it is ~330 FP64
// operations, 3.3e8 at venice: ~10 us at the 34 TFLOP/s FP64 rate, a quarter
// of the byte time. The f32 count against 67 TFLOP/s is lower still.
//
// What the design does about it: a persistent grid streams the blocks
// through shared memory with the Tensor Memory Accelerator's raw-bytes bulk
// copies, so every HBM transfer is a contiguous run of whole 128-B lines and
// many are in flight while the threads compute.
//   - A tile is kThreads consecutive blocks (9 * kThreads values: 18,432 B
//     in f64, 9,216 B in f32, both multiples of 16 as the bulk copy needs).
//   - The grid is min(#tiles, SMs * resident CTAs per SM); CTA b walks the
//     tiles b, b + grid, ... The occupancy query and the shared-memory
//     attribute are taken once per dtype and device and cached here.
//   - Loads: a ring of kInStages input tiles, one mbarrier each. Thread 0
//     arms a stage's barrier (arrive.expect_tx) and issues
//     cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes; the
//     CTA waits on the barrier's phase parity. Stage s is refilled with the
//     tile kInStages ahead as soon as every thread has read it, so
//     kInStages tiles are in flight while the CTA computes. Little's law
//     asks ~25 KB in flight per SM (3.35 TB/s / 132 SMs, ~1 us); each CTA
//     keeps two to three tiles (37-55 KB in f64) in flight, and several
//     CTAs share an SM.
//   - Compute: thread t reads its six unique entries at stride 9 values from
//     shared memory. That is free of bank conflicts in both dtypes: in f32,
//     9 is odd, so 9t mod 32 gives 32 distinct banks; in f64 a warp's 8-B
//     loads go in two half-warp phases, and 18t mod 32 over 16 threads
//     gives 16 distinct even banks, each taking its odd neighbour too.
//   - Stores: thread t writes its nine results into one of kOutStages
//     output tiles in shared memory (the same stride-9 pattern, again free
//     of conflicts); after fence.proxy.async.shared::cta and a CTA barrier,
//     thread 0 issues one bulk store cp.async.bulk.global.shared::cta.
//     bulk_group and commits it. Before an output tile is written again,
//     thread 0 waits (wait_group.read) until the store issued kOutStages
//     tiles earlier has read it. Two output tiles let one store drain while
//     the next tile is computed.
//   - The ragged edge: when P is not a multiple of kThreads, the last,
//     partial tile is done by the CTA whose turn it is, with ordinary masked
//     loads and stores from device memory, after its full tiles. It runs the
//     same per-block function. There is no other path.
//   - The bulk copies need 16-B aligned device addresses: the wrapper
//     raises for an input whose data pointer is not; tile offsets are
//     multiples of 16 B, and the caching allocator's outputs are aligned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
// -Xcompiler -fPIC. -fmad=false keeps each product rounded as in the plain
// PyTorch version, so the regularization decision is taken on the same
// numbers and the output equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // threads per CTA = blocks per tile
constexpr int kTileValues = 9 * kThreads;
constexpr int kInStages = 3;
constexpr int kOutStages = 2;
constexpr int kBarrierBytes = 128;    // the mbarriers, ahead of the tiles

template <typename T>
constexpr size_t shared_bytes() {
  return kBarrierBytes + size_t(kInStages + kOutStages) * kTileValues * sizeof(T);
}

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

// --- PTX wrappers: mbarriers and the bulk (TMA) copies ------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Arm the barrier for `bytes` and copy them from device to shared memory;
// the barrier's phase completes when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed bulk stores still have to read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes visible to the bulk copies.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- one block ----------------------------------------------------------------

// The regularized inverse of one symmetric block from its six unique
// entries, statement for statement the plain PyTorch version.
template <typename T>
__device__ __forceinline__ void invert_block(T a00, T a01, T a02, T a11,
                                             T a12, T a22,
                                             const Thresholds<T>& C, T* o) {
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
  const T i00 = A11 * inv_det, i01 = A12 * inv_det, i02 = A13 * inv_det;
  const T i11 = A22 * inv_det, i12 = A23 * inv_det, i22 = A33 * inv_det;
  o[0] = i00; o[1] = i01; o[2] = i02;
  o[3] = i01; o[4] = i11; o[5] = i12;
  o[6] = i02; o[7] = i12; o[8] = i22;
}

// --- the streaming kernel -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
invert_landmark_blocks_kernel(const T* __restrict__ H, T* __restrict__ out,
                              long long P, Thresholds<T> C) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  T* in_tiles = reinterpret_cast<T*>(smem + kBarrierBytes);
  T* out_tiles = in_tiles + kInStages * kTileValues;
  constexpr uint32_t kTileBytes = kTileValues * sizeof(T);

  const int t = threadIdx.x;
  const long long grid = gridDim.x;
  const long long b = blockIdx.x;
  const long long n_full = P / kThreads;
  // this CTA's full tiles: b, b + grid, b + 2 grid, ... below n_full
  const long long mine = b < n_full ? (n_full - 1 - b) / grid + 1 : 0;

  if (t == 0) {
    for (int s = 0; s < kInStages; ++s) mbarrier_init(&full[s], 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (t == 0) {
    for (long long k = 0; k < kInStages && k < mine; ++k)
      bulk_load(in_tiles + k * kTileValues, H + (b + k * grid) * kTileValues,
                kTileBytes, &full[k]);
  }

  for (long long k = 0; k < mine; ++k) {
    const int s = int(k % kInStages);
    const long long tile = b + k * grid;
    mbarrier_wait(&full[s], uint32_t((k / kInStages) & 1));
    const T* h = in_tiles + s * kTileValues + 9 * t;
    const T a00 = h[0], a01 = h[1], a02 = h[2];
    const T a11 = h[4], a12 = h[5], a22 = h[8];
    // the output tile about to be written was read by the store issued
    // kOutStages tiles ago
    if (t == 0) bulk_wait_read<kOutStages - 1>();
    __syncthreads();  // every thread has read stage s; the output tile is free
    if (t == 0 && k + kInStages < mine)
      bulk_load(in_tiles + s * kTileValues,
                H + (tile + kInStages * grid) * kTileValues, kTileBytes,
                &full[s]);
    T* o = out_tiles + int(k % kOutStages) * kTileValues;
    invert_block(a00, a01, a02, a11, a12, a22, C, o + 9 * t);
    fence_proxy_async_shared();
    __syncthreads();  // the whole output tile is written
    if (t == 0) bulk_store(out + tile * kTileValues, o, kTileBytes);
  }
  // shared memory must outlive the stores' reads
  if (t == 0) bulk_wait_all();

  // the ragged edge: tile n_full, partial, masked, by the CTA whose turn it is
  const long long first = n_full * kThreads;
  if (first < P && b == n_full % grid) {
    const long long k = first + t;
    if (k < P) {
      const T* h = H + 9 * k;
      invert_block(h[0], h[1], h[2], h[4], h[5], h[8], C, out + 9 * k);
    }
  }
}

// Launch configuration, taken once per dtype and device.
struct Config {
  int device = -1;
  int sms = 0;
  int ctas_per_sm = 0;
  int regs = 0;
  cudaError_t err = cudaSuccess;
};

template <typename T>
const Config& config(int device) {
  static Config c;
  if (c.device == device && c.err == cudaSuccess) return c;
  Config n;
  n.device = device;
  const size_t smem = shared_bytes<T>();
  n.err = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount, device);
  if (n.err == cudaSuccess)
    n.err = cudaFuncSetAttribute(invert_landmark_blocks_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(smem));
  if (n.err == cudaSuccess)
    n.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n.ctas_per_sm, invert_landmark_blocks_kernel<T>, kThreads, smem);
  cudaFuncAttributes attr;
  if (n.err == cudaSuccess)
    n.err = cudaFuncGetAttributes(&attr, invert_landmark_blocks_kernel<T>);
  if (n.err == cudaSuccess) n.regs = attr.numRegs;
  if (n.err == cudaSuccess && n.ctas_per_sm < 1) n.err = cudaErrorInvalidConfiguration;
  c = n;
  return c;
}

// Runs f with `device` current, and puts the caller's device back.
template <typename F>
int on_device(int device, F f) {
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return int(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return int(err);
  err = f();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return int(err);
}

template <typename T>
int launch(const T* H, T* out, long long P, int device, void* stream) {
  return on_device(device, [&]() -> cudaError_t {
    const Config& c = config<T>(device);
    if (c.err != cudaSuccess) return c.err;
    const long long tiles = (P + kThreads - 1) / kThreads;
    const long long cap = (long long)c.sms * c.ctas_per_sm;
    const unsigned int grid = (unsigned int)(tiles < cap ? tiles : cap);
    invert_landmark_blocks_kernel<T>
        <<<grid, kThreads, shared_bytes<T>(), (cudaStream_t)stream>>>(
            H, out, P, thresholds(T(0)));
    return cudaGetLastError();
  });
}

template <typename T>
int query(int device, int* info) {
  return on_device(device, [&]() -> cudaError_t {
    const Config& c = config<T>(device);
    info[0] = kThreads;
    info[1] = kInStages;
    info[2] = kOutStages;
    info[3] = int(shared_bytes<T>());
    info[4] = c.sms;
    info[5] = c.ctas_per_sm;
    info[6] = c.regs;
    return c.err;
  });
}

}  // namespace

// C entry points for ctypes. P >= 1; pointers are 16-byte aligned device
// pointers to contiguous [P,3,3] arrays; the stream is PyTorch's current
// stream. Returns cudaGetLastError() after the launch (0 = cudaSuccess).
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

// The launch configuration for one dtype (f64 != 0) on `device`, into
// info[7]: blocks per tile, input stages, output stages, shared bytes per
// CTA, SMs, resident CTAs per SM, registers per thread. Returns a CUDA error.
extern "C" int invert_landmark_blocks_config(int f64, int device, int* info) {
  return f64 ? query<double>(device, info) : query<float>(device, info);
}
