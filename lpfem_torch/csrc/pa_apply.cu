// Element-form Laplace apply on hexes (partial assembly), per element:
//
//     ye[e] = Jr2^T ( G[e] o (Jr2 u[e]) )
//
// Replaces two Pallas TPU kernels of lpfem/kernels/pa_apply.py with one
// body (the metric is a template flag of it, element_body.cuh):
//
// - pa_apply_element_kernel (B3b), the full metric: G6 holds the symmetric
//   3x3 metric w|J|J^-1J^-T at the q^3 Gauss points in component-major layout
//   [ne, 6Q] with components (xx, xy, xz, yy, yz, zz);
// - pa_apply_affine_kernel (B3a), affine elements: G[e, k] = w3[k] C6[e] with
//   six constants per element, C6 [ne, 6], and the Gauss-weight products
//   w3 [Q].
//
// u[e] holds the element's (p+1)^3 dof values (z, y, x; x fastest), and
// Jr2 = [B(x)B(x)D; B(x)D(x)B; D(x)B(x)B] is the reference-gradient
// interpolation built from the 1D basis values B [q, p+1] and derivatives
// D [q, p+1] at the Gauss points.
//
// The TPU kernels form Jr2 densely and run two MXU matmuls per 256-element
// block ([256, L] x [L, 3Q]). Here the same function is sum-factorised, as
// MFEM's PA kernels are: three 1D contractions per direction forward (x, y,
// z), the metric at each point, three back, every intermediate in shared
// memory. At p = 4 that is 11,125 multiply-adds per element instead of the
// dense form's 93,750, and the only device-memory traffic is u, the metric
// and ye (B and D are a few hundred bytes).
//
// What bounds it on an H100. B3b: bytes. At p = 4 on the 4,224-element
// cylinder tank an f32 apply must move u 2.11 MB + G6 12.67 MB + ye 2.11 MB =
// 16.9 MB, 5.0 us at 3.35 TB/s, against 94 MFLOP = 1.4 us at 67 TFLOP/s
// (f64: 10.1 us of bytes, 2.8 us of flops at 34 TFLOP/s). B3a drops the
// largest stream: at p = 4 an element moves 250 values and does 11,125
// multiply-adds, 1.0 kB against 22 kFLOP in f32, which puts the two bounds
// within a tenth of each other (32,768 elements: 10.0 us of bytes, 10.9 us
// of flops), operations narrowly ahead. Design against that: the metric is
// read once, coalesced (the threads of an element read consecutive points of
// one component; the affine constants are a broadcast); u and ye are read and
// written once, coalesced; nothing else leaves shared memory.
//
// Exact in its dtype: plain fused multiply-adds in float or double, no
// tensor cores. The sums run in another order than the plain PyTorch versions
// (lpfem_torch.kernels.pa_apply: two dense matmuls as lpfem's "fused" mode),
// so the two agree to rounding.
//
// Plain C interface (one entry per metric and dtype), built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// Each entry launches on the given stream, does not synchronise, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "element_body.cuh"

namespace {

using namespace lpfem;

// The block's el-th element is e0 + el, while it exists.
struct Consecutive {
  long long e0;
  int ne;
  __device__ long long operator()(int el) const {
    const long long e = e0 + el;
    return e < ne ? e : -1;
  }
};

template <typename T, bool kAffine>
__device__ inline void pa_body(const T* __restrict__ u,
                               const T* __restrict__ metric,
                               const T* __restrict__ w3,
                               const T* __restrict__ bmat,
                               const T* __restrict__ dmat, T* __restrict__ y,
                               int ne, int p1, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims d = make_dims(p1, q);
  const Smem<T> s = carve<T, kAffine>(reinterpret_cast<T*>(smem_raw), d);
  const Consecutive elem{(long long)blockIdx.x * d.epb, ne};
  const int tid = threadIdx.x, nt = blockDim.x;

  load_tables<T, kAffine>(s, d, bmat, dmat, w3);
  for (int i = tid; i < d.epb * d.L; i += nt) {
    s.su[i] = elem(i / d.L) >= 0 ? u[elem.e0 * d.L + i] : T(0);
  }
  __syncthreads();

  element_stages<T, kAffine>(s, d, metric, elem);

  for (int i = tid; i < d.epb * d.L; i += nt) {
    if (elem(i / d.L) < 0) continue;
    y[elem.e0 * d.L + i] = element_out(s, d, i);
  }
}

// One kernel name per metric, so that a profile tells B3b from B3a. Four
// blocks of 256 threads per SM cap the registers at 64 a thread.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 4)
pa_element_kernel(const T* __restrict__ u, const T* __restrict__ g6,
                  const T* __restrict__ bmat, const T* __restrict__ dmat,
                  T* __restrict__ y, int ne, int p1, int q) {
  pa_body<T, false>(u, g6, nullptr, bmat, dmat, y, ne, p1, q);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pa_affine_kernel(const T* __restrict__ u, const T* __restrict__ c6,
                 const T* __restrict__ w3, const T* __restrict__ bmat,
                 const T* __restrict__ dmat, T* __restrict__ y, int ne,
                 int p1, int q) {
  pa_body<T, true>(u, c6, w3, bmat, dmat, y, ne, p1, q);
}

template <typename T, bool kAffine>
int launch(const void* u, const void* metric, const void* w3,
           const void* bmat, const void* dmat, void* y, int ne, int p1, int q,
           void* stream) {
  if (ne <= 0) return 0;
  if (!dims_ok(p1, q)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(p1, q);
  const size_t smem = sizeof(T) * smem_values(d, kAffine);
  const unsigned blocks = (unsigned)((ne + d.epb - 1) / d.epb);
  const int threads = block_threads(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* uu = static_cast<const T*>(u);
  const T* mm = static_cast<const T*>(metric);
  const T* bb = static_cast<const T*>(bmat);
  const T* dd = static_cast<const T*>(dmat);
  T* yy = static_cast<T*>(y);
  if constexpr (kAffine) {
    pa_affine_kernel<T><<<blocks, threads, smem, st>>>(
        uu, mm, static_cast<const T*>(w3), bb, dd, yy, ne, p1, q);
  } else {
    pa_element_kernel<T><<<blocks, threads, smem, st>>>(uu, mm, bb, dd, yy, ne,
                                                        p1, q);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pa_apply_element_f32(const void* u, const void* g6,
                                    const void* bmat, const void* dmat,
                                    void* y, int ne, int p1, int q,
                                    void* stream) {
  return launch<float, false>(u, g6, nullptr, bmat, dmat, y, ne, p1, q,
                              stream);
}

extern "C" int pa_apply_element_f64(const void* u, const void* g6,
                                    const void* bmat, const void* dmat,
                                    void* y, int ne, int p1, int q,
                                    void* stream) {
  return launch<double, false>(u, g6, nullptr, bmat, dmat, y, ne, p1, q,
                               stream);
}

extern "C" int pa_apply_affine_f32(const void* u, const void* c6,
                                   const void* w3, const void* bmat,
                                   const void* dmat, void* y, int ne, int p1,
                                   int q, void* stream) {
  return launch<float, true>(u, c6, w3, bmat, dmat, y, ne, p1, q, stream);
}

extern "C" int pa_apply_affine_f64(const void* u, const void* c6,
                                   const void* w3, const void* bmat,
                                   const void* dmat, void* y, int ne, int p1,
                                   int q, void* stream) {
  return launch<double, true>(u, c6, w3, bmat, dmat, y, ne, p1, q, stream);
}
