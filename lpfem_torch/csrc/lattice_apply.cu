// Fused element-form Laplace apply on an affine structured lattice:
//
//     y = A x,   A = sum_e  P_e^T  Jr2^T diag(w3) C6[e] Jr2  P_e
//
// Replaces the Pallas TPU kernel
// lpfem/kernels/lattice_apply.py::lattice_affine_apply (B2). x and y are dof
// vectors on the GLL lattice (index ix + Dx*(iy + Dy*iz), Dx = p*nex without
// the seam on a periodic x axis, else p*nex + 1; y and z never periodic),
// P_e picks element e's (p+1)^3 window, C6 [ne, 6] holds the six constants of
// the affine metric |J| J^-1 J^-T per element (lattice-major, components xx,
// xy, xz, yy, yz, zz), w3 [Q] the Gauss-weight products, B and D [q, p+1] the
// 1D basis tables. With ess_top the top z-plane is an essential boundary:
// read as zero on input, y's top plane set to x's (identity rows).
//
// The TPU kernel keeps the full lattice width as MXU columns (p-fold
// redundant, because Mosaic cannot deinterleave lanes at stride p), runs one
// grid step per z-layer in order, and carries the shared plane to the next
// step. None of that is carried over. Two launches per call, no atomics, no
// memset or copy on the stream, bitwise repeatable by construction:
//
// (a) lattice_affine_kernel: every element reads its (p+1)^3 window straight
//     from x by lattice index (x wraps at the periodic seam; the top plane
//     reads as zero under ess_top), runs the body of affine_body.cuh (orders
//     fixed at compile time, one thread per (x, y) column with z in
//     registers, elements packed inside a warp with __syncwarp only) and
//     writes its values, coalesced, to the E-vector scratch ye [ne, L] that
//     the wrapper allocates.
// (b) lattice_affine_fold: one thread per dof finds the 1, 2, 4 or 8
//     elements that hold it in closed form from (gx, gy, gz) (g % p == 0 is
//     a shared index; the seam wraps) and adds their values in ascending
//     element index; it writes every dof, so y needs no memset, and under
//     ess_top writes the top plane from x.
//
// What bounds it on an H100: at p = 4 on 32,768 elements (2,179,584 dofs) an
// f32 apply must move x and y once (17.4 MB) and C6 (0.8 MB), 5.4 us at
// 3.35 TB/s, and does 0.73 GFLOP, 10.9 us at 67 TFLOP/s: operations,
// narrowly. In f64 the bound counted at the tensor cores' 67 TFLOP/s is the
// same 10.9 us; an exact CUDA-core kernel runs at 34 TFLOP/s and cannot go
// below 21.4 us. The E-vector scratch (16.4 MB in f32, 32.8 MB in f64 at
// p = 4) stays in the 50 MB L2 between the two launches; the windows
// overlap, so a dof on an element boundary is fetched by up to 8 elements,
// from L2 as well.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// The entry enqueues the two launches on the given stream, does not
// synchronise, allocates nothing and returns the first CUDA error.

#include <cuda_runtime.h>

#include "affine_body.cuh"

namespace {

using namespace lpfem;

struct Lattice {
  int nex, ney, nez;   // elements per axis
  int Dx, Dy, Dz;      // dofs per axis
  int p;
  int px;              // x periodic
  int ess_top;
};

// One element's window of x: its first lattice index per axis.
template <typename T>
struct WindowAt {
  const T* __restrict__ x;
  int gx0, gy0, gz0, Dx, Dy, ztop;   // ztop: the top plane, or -1
  __device__ T operator()(int lx, int ly, int lz, int) const {
    int gx = gx0 + lx;
    if (gx >= Dx) gx -= Dx;                    // the periodic seam
    const int gz = gz0 + lz;
    if (gz == ztop) return T(0);
    return x[gx + Dx * (gy0 + ly + Dy * gz)];
  }
};

// Element e's window (lattice-major elements, x fastest); ne (p+1)^3 < 2^31
// keeps every index an int.
template <typename T>
struct Window {
  const T* __restrict__ x;
  Lattice lat;
  __device__ WindowAt<T> element(long long e) const {
    const int ei = (int)e;
    const int ex = ei % lat.nex, r = ei / lat.nex;
    const int ey = r % lat.ney, ez = r / lat.ney;
    return WindowAt<T>{x, ex * lat.p, ey * lat.p, ez * lat.p, lat.Dx, lat.Dy,
                       lat.ess_top ? lat.Dz - 1 : -1};
  }
};

template <typename T, int P1, int Q>
__global__ void __launch_bounds__(affine::kThreads)
lattice_affine_kernel(const T* __restrict__ x, const T* __restrict__ c6,
                      const T* __restrict__ w3, const T* __restrict__ bmat,
                      const T* __restrict__ dmat, T* __restrict__ ye,
                      Lattice lat, int q) {
  const int p1 = lat.p + 1;
  affine::apply_elements<T, P1, Q>(
      p1, q, (long long)lat.nex * lat.ney * lat.nez,
      affine::AffineMetric<T>{c6, w3}, bmat, dmat, Window<T>{x, lat},
      affine::RowsOut<T>{ye, p1 * p1 * p1});
}

// The elements along one axis that hold lattice index g, in ascending order,
// with g's local index in each: 1 inside an element, 2 on a shared face
// (1 on a finite axis's ends); on a periodic axis index 0 is shared by
// element 0 and element n - 1 across the seam.
__device__ __forceinline__ int axis_elems(int g, int p, int n, bool periodic,
                                          int e[2], int l[2]) {
  const int k = g / p, r = g - k * p;
  if (r != 0) {
    e[0] = k; l[0] = r;
    return 1;
  }
  if (periodic && k == 0) {
    e[0] = 0; l[0] = 0;
    e[1] = n - 1; l[1] = p;
    return 2;
  }
  int m = 0;
  if (k > 0) { e[m] = k - 1; l[m] = p; ++m; }
  if (k < n) { e[m] = k; l[m] = 0; ++m; }
  return m;
}

// One thread per dof: blockIdx.x covers (x block, gy), blockIdx.y strides
// over gz, so no thread divides by Dx or Dy; P1 = p+1 fixed (0: at run time).
constexpr int kFoldThreads = 256;

template <typename T, int P1>
__global__ void __launch_bounds__(kFoldThreads)
lattice_affine_fold(const T* __restrict__ ye, const T* __restrict__ x,
                    T* __restrict__ y, Lattice lat, int nbx) {
  const int p = P1 > 0 ? P1 - 1 : lat.p, p1 = p + 1, L = p1 * p1 * p1;
  const int gy = blockIdx.x / nbx;
  const int gx = (blockIdx.x - gy * nbx) * kFoldThreads + threadIdx.x;
  if (gx >= lat.Dx) return;
  int ex[2], lx[2], ey[2], ly[2], ez[2], lz[2];
  const int nx = axis_elems(gx, p, lat.nex, lat.px != 0, ex, lx);
  const int ny = axis_elems(gy, p, lat.ney, false, ey, ly);
  for (int gz = blockIdx.y; gz < lat.Dz; gz += gridDim.y) {
    const int g = gx + lat.Dx * (gy + lat.Dy * gz);
    if (lat.ess_top && gz == lat.Dz - 1) {
      y[g] = x[g];
      continue;
    }
    const int nz = axis_elems(gz, p, lat.nez, false, ez, lz);
    T acc = T(0);
    for (int kz = 0; kz < nz; ++kz) {
      for (int ky = 0; ky < ny; ++ky) {
        const int row = lat.nex * (ey[ky] + lat.ney * ez[kz]);
        const int node = (lz[kz] * p1 + ly[ky]) * p1;
        for (int kx = 0; kx < nx; ++kx) {
          acc += ye[(row + ex[kx]) * L + node + lx[kx]];
        }
      }
    }
    y[g] = acc;
  }
}

// The two launches for template orders (P1, Q).
template <typename T, int P1, int Q>
int launch_orders(const T* x, const T* c6, const T* w3, const T* bmat,
                  const T* dmat, T* ye, T* y, const Lattice& lat, int q,
                  cudaStream_t st) {
  const int p1 = lat.p + 1;
  const int epb = affine::elems_per_block(
      affine::warp_resident<P1, Q>(), p1, q);
  const long long ne = (long long)lat.nex * lat.ney * lat.nez;
  const unsigned blocks = (unsigned)((ne + epb - 1) / epb);
  lattice_affine_kernel<T, P1, Q>
      <<<blocks, affine::kThreads,
         affine::smem_bytes(sizeof(T), p1, q, epb), st>>>(
          x, c6, w3, bmat, dmat, ye, lat, q);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nbx = (lat.Dx + kFoldThreads - 1) / kFoldThreads;
  const dim3 grid(nbx * lat.Dy, lat.Dz < 65535 ? lat.Dz : 65535);
  lattice_affine_fold<T, P1><<<grid, kFoldThreads, 0, st>>>(ye, x, y, lat,
                                                             nbx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* c6, const void* w3, const void* bmat,
           const void* dmat, void* ye, void* y, int nex, int ney, int nez,
           int p, int q, int px, int ess_top, void* stream) {
  if (nex <= 0 || ney <= 0 || nez <= 0 || !affine::orders_ok(p + 1, q) ||
      (px && nex < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  Lattice lat;
  lat.nex = nex; lat.ney = ney; lat.nez = nez;
  lat.Dx = p * nex + (px ? 0 : 1);
  lat.Dy = p * ney + 1;
  lat.Dz = p * nez + 1;
  lat.p = p;
  lat.px = px;
  lat.ess_top = ess_top;
  const T* xx = static_cast<const T*>(x);
  const T* cc = static_cast<const T*>(c6);
  const T* ww = static_cast<const T*>(w3);
  const T* bb = static_cast<const T*>(bmat);
  const T* dd = static_cast<const T*>(dmat);
  T* ee = static_cast<T*>(ye);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // (a) the elements, then (b) the fold: the orders the port's paths run
  // (p = 1..4, q = p+1) are compiled fixed; every other (p+1, q) takes the
  // general instantiation
  T* yy = static_cast<T*>(y);
  switch (q == p + 1 ? q : 0) {
    case 2: return launch_orders<T, 2, 2>(xx, cc, ww, bb, dd, ee, yy, lat, q, st);
    case 3: return launch_orders<T, 3, 3>(xx, cc, ww, bb, dd, ee, yy, lat, q, st);
    case 4: return launch_orders<T, 4, 4>(xx, cc, ww, bb, dd, ee, yy, lat, q, st);
    case 5: return launch_orders<T, 5, 5>(xx, cc, ww, bb, dd, ee, yy, lat, q, st);
    default: return launch_orders<T, 0, 0>(xx, cc, ww, bb, dd, ee, yy, lat, q, st);
  }
}

}  // namespace

extern "C" int lattice_affine_apply_f32(const void* x, const void* c6,
                                        const void* w3, const void* bmat,
                                        const void* dmat, void* ye, void* y,
                                        int nex, int ney, int nez, int p,
                                        int q, int px, int ess_top,
                                        void* stream) {
  return launch<float>(x, c6, w3, bmat, dmat, ye, y, nex, ney, nez, p, q, px,
                       ess_top, stream);
}

extern "C" int lattice_affine_apply_f64(const void* x, const void* c6,
                                        const void* w3, const void* bmat,
                                        const void* dmat, void* ye, void* y,
                                        int nex, int ney, int nez, int p,
                                        int q, int px, int ess_top,
                                        void* stream) {
  return launch<double>(x, c6, w3, bmat, dmat, ye, y, nex, ney, nez, p, q,
                        px, ess_top, stream);
}
