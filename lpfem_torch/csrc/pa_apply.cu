// Element-form Laplace apply on hexes (partial assembly), per element:
//
//     ye[e] = Jr2^T ( G[e] o (Jr2 u[e]) )
//
// Replaces two Pallas TPU kernels of lpfem/kernels/pa_apply.py:
//
// - pa_apply_element_kernel (B3b), the full metric: G6 holds the symmetric
//   3x3 metric w|J|J^-1J^-T at the q^3 Gauss points in component-major layout
//   [ne, 6Q] with components (xx, xy, xz, yy, yz, zz);
// - pa_apply_affine_kernel (B3a), affine elements: G[e, k] = w3[k] C6[e] with
//   six constants per element, C6 [ne, 6], and the Gauss-weight products
//   w3 [Q]. Both run the body of affine_body.cuh, each with its metric.
//
// u[e] holds the element's (p+1)^3 dof values (z, y, x; x fastest), and
// Jr2 = [B(x)B(x)D; B(x)D(x)B; D(x)B(x)B] is the reference-gradient
// interpolation built from the 1D basis values B [q, p+1] and derivatives
// D [q, p+1] at the Gauss points.
//
// The TPU kernels form Jr2 densely and run two MXU matmuls per 256-element
// block ([256, L] x [L, 3Q]). Here the same function is sum-factorised, as
// MFEM's PA kernels are: three 1D contractions per direction forward (x, y,
// z), the metric at each point, three back. At p = 4 that is 11,125
// multiply-adds per element instead of the dense form's 93,750, and the only
// device-memory traffic is u, the metric and ye (B and D are a few hundred
// bytes).
//
// What bounds it on an H100. B3b: bytes. At p = 4 on the 4,224-element
// cylinder tank an f32 apply must move u 2.11 MB + G6 12.67 MB + ye 2.11 MB =
// 16.9 MB, 5.0 us at 3.35 TB/s, against 94 MFLOP = 1.4 us at 67 TFLOP/s
// (f64: 10.1 us of bytes, 2.8 us of flops at 34 TFLOP/s). B3a drops the
// largest stream: at p = 4 an element moves 250 values and does 11,125
// multiply-adds, 1.0 kB against 22 kFLOP in f32, which puts the two bounds
// within a tenth of each other (32,768 elements: 10.0 us of bytes, 10.9 us
// of flops), operations narrowly ahead. In f64 the CUDA cores' 34 TFLOP/s
// make the operations 21.4 us, twice the bound counted at the tensor cores'
// 67 TFLOP/s, which an exact CUDA-core kernel cannot reach.
//
// Design against that. Both run the column body of affine_body.cuh: orders
// fixed at compile time (p = 1..4 with q = p+1, two general instantiations
// for the rest of 2 <= p+1 <= 11, 1 <= q <= 11), one thread per (x, y) column with
// z in registers, elements packed inside a warp with __syncwarp only; u and
// ye are read and written once, coalesced. B3a's metric is C6[e], a
// broadcast, times w3 in shared memory; B3b's is the full-metric policy,
// which streams G6 once, the lanes of an element reading consecutive Gauss
// points of one component at each qz.
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

#include "affine_body.cuh"

namespace {

using namespace lpfem;

// B3b: u[e] rows in, ye[e] rows out, the full metric.
template <typename T, int P1, int Q>
__global__ void __launch_bounds__(affine::kThreads)
pa_element_kernel(const T* __restrict__ u, const T* __restrict__ g6,
                  const T* __restrict__ bmat, const T* __restrict__ dmat,
                  T* __restrict__ y, int ne, int p1, int q) {
  const int L = p1 * p1 * p1;
  affine::apply_elements<T, P1, Q>(p1, q, ne,
                                   affine::FullMetric<T>{g6, q * q * q},
                                   bmat, dmat, affine::RowsIn<T>{u, L},
                                   affine::RowsOut<T>{y, L});
}

// B3a: the affine metric (kernel names kept, so that a profile tells B3a
// from B3b).
template <typename T, int P1, int Q>
__global__ void __launch_bounds__(affine::kThreads)
pa_affine_kernel(const T* __restrict__ u, const T* __restrict__ c6,
                 const T* __restrict__ w3, const T* __restrict__ bmat,
                 const T* __restrict__ dmat, T* __restrict__ y, int ne,
                 int p1, int q) {
  const int L = p1 * p1 * p1;
  affine::apply_elements<T, P1, Q>(p1, q, ne, affine::AffineMetric<T>{c6, w3},
                                   bmat, dmat, affine::RowsIn<T>{u, L},
                                   affine::RowsOut<T>{y, L});
}

template <typename T, int P1, int Q>
int launch_element(const T* u, const T* g6, const T* bmat, const T* dmat,
                   T* y, int ne, int p1, int q, cudaStream_t st) {
  const int epb = affine::elems_per_block(
      affine::warp_resident<P1, Q>(), p1, q);
  const unsigned blocks = (unsigned)((ne + epb - 1) / epb);
  const size_t smem = affine::smem_bytes(sizeof(T), p1, q, epb);
  const cudaError_t err = affine::launch_smem(pa_element_kernel<T, P1, Q>, smem);
  if (err != cudaSuccess) return (int)err;
  pa_element_kernel<T, P1, Q><<<blocks, affine::kThreads, smem, st>>>(
      u, g6, bmat, dmat, y, ne, p1, q);
  return (int)cudaGetLastError();
}

template <typename T, int P1, int Q>
int launch_affine(const T* u, const T* c6, const T* w3, const T* bmat,
                  const T* dmat, T* y, int ne, int p1, int q,
                  cudaStream_t st) {
  const int epb = affine::elems_per_block(
      affine::warp_resident<P1, Q>(), p1, q);
  const unsigned blocks = (unsigned)((ne + epb - 1) / epb);
  const size_t smem = affine::smem_bytes(sizeof(T), p1, q, epb);
  const cudaError_t err = affine::launch_smem(pa_affine_kernel<T, P1, Q>, smem);
  if (err != cudaSuccess) return (int)err;
  pa_affine_kernel<T, P1, Q><<<blocks, affine::kThreads, smem, st>>>(
      u, c6, w3, bmat, dmat, y, ne, p1, q);
  return (int)cudaGetLastError();
}

// The orders the port's paths run (p = 1..4, q = p+1) are compiled fixed;
// every other (p+1, q) takes the general instantiation that reaches it
// (affine::template_orders).
template <typename T>
int dispatch_element(const void* u, const void* g6, const void* bmat,
                     const void* dmat, void* y, int ne, int p1, int q,
                     void* stream) {
  if (ne <= 0) return 0;
  if (!affine::orders_ok(p1, q)) return (int)cudaErrorInvalidValue;
  const T* uu = static_cast<const T*>(u);
  const T* gg = static_cast<const T*>(g6);
  const T* bb = static_cast<const T*>(bmat);
  const T* dd = static_cast<const T*>(dmat);
  T* yy = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (affine::template_orders(p1, q)) {
    case 2: return launch_element<T, 2, 2>(uu, gg, bb, dd, yy, ne, p1, q, st);
    case 3: return launch_element<T, 3, 3>(uu, gg, bb, dd, yy, ne, p1, q, st);
    case 4: return launch_element<T, 4, 4>(uu, gg, bb, dd, yy, ne, p1, q, st);
    case 5: return launch_element<T, 5, 5>(uu, gg, bb, dd, yy, ne, p1, q, st);
    case affine::kGeneral:
      return launch_element<T, affine::kGeneral, affine::kGeneral>(uu, gg, bb, dd, yy, ne, p1, q, st);
    default: return launch_element<T, affine::kWide, affine::kWide>(uu, gg, bb, dd, yy, ne, p1, q, st);
  }
}

template <typename T>
int dispatch_affine(const void* u, const void* c6, const void* w3,
                  const void* bmat, const void* dmat, void* y, int ne, int p1,
                  int q, void* stream) {
  if (ne <= 0) return 0;
  if (!affine::orders_ok(p1, q)) return (int)cudaErrorInvalidValue;
  const T* uu = static_cast<const T*>(u);
  const T* cc = static_cast<const T*>(c6);
  const T* ww = static_cast<const T*>(w3);
  const T* bb = static_cast<const T*>(bmat);
  const T* dd = static_cast<const T*>(dmat);
  T* yy = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (affine::template_orders(p1, q)) {
    case 2: return launch_affine<T, 2, 2>(uu, cc, ww, bb, dd, yy, ne, p1, q, st);
    case 3: return launch_affine<T, 3, 3>(uu, cc, ww, bb, dd, yy, ne, p1, q, st);
    case 4: return launch_affine<T, 4, 4>(uu, cc, ww, bb, dd, yy, ne, p1, q, st);
    case 5: return launch_affine<T, 5, 5>(uu, cc, ww, bb, dd, yy, ne, p1, q, st);
    case affine::kGeneral:
      return launch_affine<T, affine::kGeneral, affine::kGeneral>(uu, cc, ww, bb, dd, yy, ne, p1, q, st);
    default: return launch_affine<T, affine::kWide, affine::kWide>(uu, cc, ww, bb, dd, yy, ne, p1, q, st);
  }
}

}  // namespace

extern "C" int pa_apply_element_f32(const void* u, const void* g6,
                                    const void* bmat, const void* dmat,
                                    void* y, int ne, int p1, int q,
                                    void* stream) {
  return dispatch_element<float>(u, g6, bmat, dmat, y, ne, p1, q, stream);
}

extern "C" int pa_apply_element_f64(const void* u, const void* g6,
                                    const void* bmat, const void* dmat,
                                    void* y, int ne, int p1, int q,
                                    void* stream) {
  return dispatch_element<double>(u, g6, bmat, dmat, y, ne, p1, q,
                                  stream);
}

extern "C" int pa_apply_affine_f32(const void* u, const void* c6,
                                   const void* w3, const void* bmat,
                                   const void* dmat, void* y, int ne, int p1,
                                   int q, void* stream) {
  return dispatch_affine<float>(u, c6, w3, bmat, dmat, y, ne, p1, q, stream);
}

extern "C" int pa_apply_affine_f64(const void* u, const void* c6,
                                   const void* w3, const void* bmat,
                                   const void* dmat, void* y, int ne, int p1,
                                   int q, void* stream) {
  return dispatch_affine<double>(u, c6, w3, bmat, dmat, y, ne, p1, q, stream);
}
