// One step of the Chebyshev-Jacobi smoother in one launch
// (lpfem_torch.multigrid.ChebyshevSmoother): the vector update around the
// level's apply A z, which the caller runs first. Three modes:
//
//   first, from zero:     d = (inv_diag r) / theta,         z = 0 + d
//   first, from z0:       d = (inv_diag (r - A z0)) / theta, z = z0 + d
//   recurrence:           d = c1 d + c2 (inv_diag (r - A z)), z = z + d
//
// with c1 = rho_new rho and c2 = 2 rho_new / delta the coefficients of
// lpfem_torch.kernels.coarse_cheb.chebyshev_coefficients. It replaces no
// TPU kernel: lpfem runs these as eager XLA operations (lpfem/multigrid.py),
// and the port ran them as six eager PyTorch operations a step, each one a
// pass over the level's vectors.
//
// What bounds it on an H100: bytes. A recurrence step reads r, A z,
// inv_diag, d and z once and writes d and z once: 7 passes of the vector,
// where the eager chain moved 16 (the first step 4 or 6 against 9 or 11).
// Nothing is computed that would show beside the bytes.
//
// The result equals the eager chain's bit for bit: each operation is
// rounded on its own, in the order the eager expression evaluates it (no
// contraction into fused multiply-adds), in the tensor's own precision.
// The scalars come as PyTorch's CUDA kernels take a Python float: c1 and c2
// cast to the tensor's type (round to nearest), and the division by theta
// as a multiplication by its reciprocal, 1 / theta taken in double on the
// host and then rounded to the tensor's type. (The reciprocal of theta
// rounded to float first, 1.0f / (float)theta, differs from it for some
// theta, 1.5121337882677715 among them, and there the eager float32
// division on the card gives the double reciprocal's bits.)
//
// Design: a grid-stride loop of 16-byte loads and stores (double2 /
// float4) over a grid of at most kBlocksPerSm blocks a multiprocessor, with
// the scalar elements before the first 16-byte boundary and after the last
// one done by the same loop's scalar form. Views that do not start 16-byte
// aligned take the vector form when every operand is off by the same bytes
// (a head of scalars first); operands off by different amounts take the
// scalar form throughout. 32-bit indices up to 2^30 elements, 64-bit above.
// No atomics and no reductions: a run repeats bit for bit.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// The launch returns cudaGetLastError(); it does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2,048 threads: a full multiprocessor
constexpr int kMaxDevices = 64;

enum Mode : int { kFirstZero = 0, kFirstStart = 1, kStep = 2 };

// One rounding per operation, as the eager elementwise tensors.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

template <typename T>
struct Vec;
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int width = 2;
};
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int width = 4;
};

// r, A z, inv_diag and z0 are only read, through the read-only data path
// (__ldg); d and z are read (kStep) and written in place, each element by
// the thread that reads it.
template <typename T>
struct Args {
  const T* r;
  const T* az;      // A z (A z0 in kFirstStart; unused from zero)
  const T* invd;
  const T* z0;      // kFirstStart only
  T* d;
  T* z;
  T s1;             // c1 (kStep)
  T s2;             // c2 (kStep), 1 / theta (first step)
};

// The update of one element, in the eager expression's order.
template <int M, typename T>
__device__ __forceinline__ void update(const Args<T>& a, T r, T az, T iv,
                                       T z0, T& d, T& z) {
  if (M == kStep) {
    const T t = mul_rn(a.s2, mul_rn(iv, sub_rn(r, az)));
    d = add_rn(mul_rn(a.s1, d), t);
    z = add_rn(z, d);
  } else {
    const T res = M == kFirstStart ? sub_rn(r, az) : r;
    d = mul_rn(mul_rn(iv, res), a.s2);
    z = add_rn(z0, d);
  }
}

// Element i, scalar loads and stores.
template <int M, typename T, typename I>
__device__ __forceinline__ void scalar_at(const Args<T>& a, I i) {
  const T r = __ldg(a.r + i);
  const T iv = __ldg(a.invd + i);
  const T az = M == kFirstZero ? T(0) : __ldg(a.az + i);
  const T z0 = M == kFirstStart ? __ldg(a.z0 + i) : T(0);
  T d = M == kStep ? a.d[i] : T(0);
  T z = M == kStep ? a.z[i] : T(0);
  update<M>(a, r, az, iv, z0, d, z);
  a.d[i] = d;
  a.z[i] = z;
}

// Elements [i, i + width), 16-byte loads and stores (i at a boundary).
template <int M, typename T, typename I>
__device__ __forceinline__ void vector_at(const Args<T>& a, I i) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::width;
  T r[W], az[W], iv[W], z0[W], d[W], z[W];
  *reinterpret_cast<V*>(r) = __ldg(reinterpret_cast<const V*>(a.r + i));
  *reinterpret_cast<V*>(iv) = __ldg(reinterpret_cast<const V*>(a.invd + i));
  if (M != kFirstZero)
    *reinterpret_cast<V*>(az) = __ldg(reinterpret_cast<const V*>(a.az + i));
  if (M == kFirstStart)
    *reinterpret_cast<V*>(z0) = __ldg(reinterpret_cast<const V*>(a.z0 + i));
  if (M == kStep) {
    *reinterpret_cast<V*>(d) = *reinterpret_cast<const V*>(a.d + i);
    *reinterpret_cast<V*>(z) = *reinterpret_cast<const V*>(a.z + i);
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (M == kFirstZero) az[k] = T(0);
    if (M != kFirstStart) z0[k] = T(0);
    if (M != kStep) d[k] = z[k] = T(0);
    update<M>(a, r[k], az[k], iv[k], z0[k], d[k], z[k]);
  }
  *reinterpret_cast<V*>(a.d + i) = *reinterpret_cast<const V*>(d);
  *reinterpret_cast<V*>(a.z + i) = *reinterpret_cast<const V*>(z);
}

// Elements [0, head) and [head + nvec * width, n) one by one, the nvec
// vectors from head on 16 bytes at a time; every thread strides the grid.
template <int M, typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    cheb_step_kernel(const Args<T> a, I n, I head, I nvec) {
  constexpr int W = Vec<T>::width;
  const I stride = (I)gridDim.x * kThreads;
  const I tid = (I)blockIdx.x * kThreads + threadIdx.x;
  for (I v = tid; v < nvec; v += stride) vector_at<M>(a, head + v * W);
  const I body = nvec * W;
  const I scalars = n - body;
  for (I s = tid; s < scalars; s += stride)
    scalar_at<M>(a, s < head ? s : s + body);
}

int sm_count() {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < kMaxDevices && counts[dev] > 0) return counts[dev];
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < kMaxDevices) counts[dev] = sms;
  return sms;
}

template <int M, typename T, typename I>
int launch_as(const Args<T>& a, int64_t n, int64_t head, int64_t nvec,
              int sms, cudaStream_t stream) {
  const int64_t work = nvec > n - nvec * Vec<T>::width
                           ? nvec
                           : n - nvec * Vec<T>::width;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (int64_t)sms * kBlocksPerSm) blocks = (int64_t)sms * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  cheb_step_kernel<M, T, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a, (I)n, (I)head, (I)nvec);
  return (int)cudaGetLastError();
}

template <int M, typename T>
int launch(const Args<T>& a, int64_t n, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  // every operand's offset from a 16-byte boundary; the vector form needs
  // one offset for all of them
  const void* ptrs[6] = {a.r, a.invd, a.d, a.z,
                         M == kFirstZero ? a.r : a.az,
                         M == kFirstStart ? a.z0 : a.r};
  const uintptr_t off = reinterpret_cast<uintptr_t>(ptrs[0]) % 16;
  bool same = true;
  for (const void* p : ptrs) {
    const uintptr_t o = reinterpret_cast<uintptr_t>(p);
    if (o % sizeof(T) != 0) return (int)cudaErrorMisalignedAddress;
    same = same && o % 16 == off;
  }
  constexpr int W = Vec<T>::width;
  int64_t head = 0, nvec = 0;
  if (same) {
    head = (int64_t)((16 - off) % 16 / sizeof(T));
    if (head > n) head = n;
    nvec = (n - head) / W;
  }
  const int sms = sm_count();
  if (sms <= 0) return sms == 0 ? (int)cudaErrorInvalidDevice : -sms;
  if (n <= (int64_t(1) << 30))
    return launch_as<M, T, int32_t>(a, n, head, nvec, sms, stream);
  return launch_as<M, T, int64_t>(a, n, head, nvec, sms, stream);
}

template <typename T>
int first_entry(const void* r, const void* az0, const void* invd,
                const void* z0, void* d, void* z, double theta, int64_t n,
                void* stream) {
  Args<T> a{static_cast<const T*>(r),   static_cast<const T*>(az0),
            static_cast<const T*>(invd), static_cast<const T*>(z0),
            static_cast<T*>(d),          static_cast<T*>(z),
            T(0),                        T(0)};
  // as the eager division by a Python float: times the reciprocal, taken
  // in double and rounded to T
  a.s2 = static_cast<T>(1.0 / theta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((az0 == nullptr) != (z0 == nullptr)) return (int)cudaErrorInvalidValue;
  if (z0 == nullptr) return launch<kFirstZero, T>(a, n, st);
  return launch<kFirstStart, T>(a, n, st);
}

template <typename T>
int step_entry(const void* r, const void* az, const void* invd, void* d,
               void* z, double c1, double c2, int64_t n, void* stream) {
  const Args<T> a{static_cast<const T*>(r),   static_cast<const T*>(az),
                  static_cast<const T*>(invd), nullptr,
                  static_cast<T*>(d),          static_cast<T*>(z),
                  static_cast<T>(c1),          static_cast<T>(c2)};
  return launch<kStep, T>(a, n, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The first step: d = (inv_diag (r - A z0)) / theta and z = z0 + d, or from
// zero (az0 and z0 both null) d = (inv_diag r) / theta and z = 0 + d.
extern "C" int cheb_first_f32(const void* r, const void* az0,
                              const void* invd, const void* z0, void* d,
                              void* z, double theta, int64_t n, void* stream) {
  return first_entry<float>(r, az0, invd, z0, d, z, theta, n, stream);
}

extern "C" int cheb_first_f64(const void* r, const void* az0,
                              const void* invd, const void* z0, void* d,
                              void* z, double theta, int64_t n, void* stream) {
  return first_entry<double>(r, az0, invd, z0, d, z, theta, n, stream);
}

// A recurrence step, d and z in place: d = c1 d + c2 (inv_diag (r - A z)),
// then z = z + d.
extern "C" int cheb_step_f32(const void* r, const void* az, const void* invd,
                             void* d, void* z, double c1, double c2,
                             int64_t n, void* stream) {
  return step_entry<float>(r, az, invd, d, z, c1, c2, n, stream);
}

extern "C" int cheb_step_f64(const void* r, const void* az, const void* invd,
                             void* d, void* z, double c1, double c2,
                             int64_t n, void* stream) {
  return step_entry<double>(r, az, invd, d, z, c1, c2, n, stream);
}
