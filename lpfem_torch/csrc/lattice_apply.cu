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
// 1D basis tables. A Dirichlet plane zt (the top z-plane under ess_top, -1
// for none) is an essential boundary: read as zero on input, y's plane zt set
// to x's (identity rows).
//
// Shard mode (the port of the TPU kernel's shard_scal / p0 mode, which
// lpfem.shard runs on the sheared lattices' z-slab windows): the two launches
// cover ndev stacked windows of nez element layers each, x and y rows of
// ys >= the window's dofs (lanes past it are written 0), C6 [ndev * ne, 6]
// with zero rows on a slab's padding layers, and per window a row of
// scal = (zt, own0). When own0 is 0 the window's plane 0 reads the exchanged
// halo plane p0 and its outputs go to yhalo, y's plane 0 being 0; otherwise
// yhalo is 0. On a padded slab zt lies below the window's top; the padding
// elements' zero metric makes the planes above it 0. The elements of every
// window form one launch, the fold's blockIdx.z is the window. Times:
// PERF.md section 6 (chip_smoke.py phase 9a).
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
  int nex, ney, nez;   // elements per axis (of one window in shard mode)
  int Dx, Dy, Dz;      // dofs per axis
  int p;
  int px;              // x periodic
  int zt;              // one lattice: the Dirichlet plane, or -1
  int ndev;            // stacked lattices
  const int* scal;     // [ndev][2] (zt, own0) on the device, or null
  long long xs, ys;    // row strides of x and y
  long long p0s;       // row stride of p0
};

// A window's Dirichlet plane and plane-0 source (null: x's own plane 0).
template <typename T>
struct ShardRow {
  int zt;
  const T* p0;
};

template <typename T>
__device__ __forceinline__ ShardRow<T> shard_row(const Lattice& lat,
                                                 const T* p0, int d) {
  if (lat.scal == nullptr) return ShardRow<T>{lat.zt, nullptr};
  const int zt = lat.scal[2 * d], own0 = lat.scal[2 * d + 1];
  return ShardRow<T>{zt, own0 ? nullptr : p0 + d * lat.p0s};
}

// One element's window of x: its first lattice index per axis.
template <typename T>
struct WindowAt {
  const T* __restrict__ x;
  const T* __restrict__ p0;          // plane 0's halo source, or null
  int gx0, gy0, gz0, Dx, Dy, zt;     // zt: the Dirichlet plane, or -1
  __device__ T operator()(int lx, int ly, int lz, int) const {
    int gx = gx0 + lx;
    if (gx >= Dx) gx -= Dx;                    // the periodic seam
    const int gz = gz0 + lz;
    if (gz == zt) return T(0);
    const int o = gx + Dx * (gy0 + ly);
    if (gz == 0 && p0 != nullptr) return p0[o];
    return x[o + Dx * Dy * gz];
  }
};

// Element e's window (lattice-major elements, x fastest, the windows of a
// stack one after another); ne (p+1)^3 < 2^31 keeps every index an int.
template <typename T>
struct Window {
  const T* __restrict__ x;
  const T* __restrict__ p0;
  Lattice lat;
  __device__ WindowAt<T> element(long long e) const {
    const int ne = lat.nex * lat.ney * lat.nez;
    const int d = (int)(e / ne), ei = (int)(e - (long long)d * ne);
    const int ex = ei % lat.nex, r = ei / lat.nex;
    const int ey = r % lat.ney, ez = r / lat.ney;
    const ShardRow<T> row = shard_row(lat, p0, d);
    return WindowAt<T>{x + d * lat.xs, row.p0, ex * lat.p, ey * lat.p,
                       ez * lat.p, lat.Dx, lat.Dy, row.zt};
  }
};

template <typename T, int P1, int Q>
__global__ void __launch_bounds__(affine::kThreads)
lattice_affine_kernel(const T* __restrict__ x, const T* __restrict__ p0,
                      const T* __restrict__ c6, const T* __restrict__ w3,
                      const T* __restrict__ bmat, const T* __restrict__ dmat,
                      T* __restrict__ ye, Lattice lat, int q) {
  const int p1 = lat.p + 1;
  affine::apply_elements<T, P1, Q>(
      p1, q, (long long)lat.ndev * lat.nex * lat.ney * lat.nez,
      affine::AffineMetric<T>{c6, w3}, bmat, dmat, Window<T>{x, p0, lat},
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
// over gz, blockIdx.z is the window, so no thread divides by Dx or Dy;
// P1 = p+1 fixed (0: at run time).
constexpr int kFoldThreads = 256;

template <typename T, int P1>
__global__ void __launch_bounds__(kFoldThreads)
lattice_affine_fold(const T* __restrict__ ye, const T* __restrict__ x,
                    const T* __restrict__ p0, T* __restrict__ y,
                    T* __restrict__ yhalo, Lattice lat, int nbx) {
  const int p = P1 > 0 ? P1 - 1 : lat.p, p1 = p + 1, L = p1 * p1 * p1;
  const int d = blockIdx.z;
  const long long n = (long long)lat.Dx * lat.Dy * lat.Dz;
  ye += (long long)d * lat.nex * lat.ney * lat.nez * L;
  x += d * lat.xs;
  y += d * lat.ys;
  const ShardRow<T> row = shard_row(lat, p0, d);
  // lanes of y's row past the lattice (the trash lane of a stacked vector)
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (long long k = n + threadIdx.x; k < lat.ys; k += kFoldThreads)
      y[k] = T(0);
  }
  const int gy = blockIdx.x / nbx;
  const int gx = (blockIdx.x - gy * nbx) * kFoldThreads + threadIdx.x;
  if (gx >= lat.Dx) return;
  int ex[2], lx[2], ey[2], ly[2], ez[2], lz[2];
  const int nx = axis_elems(gx, p, lat.nex, lat.px != 0, ex, lx);
  const int ny = axis_elems(gy, p, lat.ney, false, ey, ly);
  for (int gz = blockIdx.y; gz < lat.Dz; gz += gridDim.y) {
    const int g = gx + lat.Dx * (gy + lat.Dy * gz);
    if (gz == row.zt) {
      y[g] = x[g];                  // identity row (zt >= 1: x is its source)
      continue;
    }
    const int nz = axis_elems(gz, p, lat.nez, false, ez, lz);
    T acc = T(0);
    for (int kz = 0; kz < nz; ++kz) {
      for (int ky = 0; ky < ny; ++ky) {
        const int erow = lat.nex * (ey[ky] + lat.ney * ez[kz]);
        const int node = (lz[kz] * p1 + ly[ky]) * p1;
        for (int kx = 0; kx < nx; ++kx) {
          acc += ye[(erow + ex[kx]) * L + node + lx[kx]];
        }
      }
    }
    if (lat.scal != nullptr && gz == 0) {
      // plane 0: kept where the shard owns it, else routed to yhalo
      const bool own0 = row.p0 == nullptr;
      yhalo[(long long)d * lat.Dx * lat.Dy + g] = own0 ? T(0) : acc;
      y[g] = own0 ? acc : T(0);
    } else {
      y[g] = acc;
    }
  }
}

// The two launches for template orders (P1, Q).
template <typename T, int P1, int Q>
int launch_orders(const T* x, const T* p0, const T* c6, const T* w3,
                  const T* bmat, const T* dmat, T* ye, T* y, T* yhalo,
                  const Lattice& lat, int q, cudaStream_t st) {
  const int p1 = lat.p + 1;
  const int epb = affine::elems_per_block(
      affine::warp_resident<P1, Q>(), p1, q);
  const long long ne = (long long)lat.ndev * lat.nex * lat.ney * lat.nez;
  const unsigned blocks = (unsigned)((ne + epb - 1) / epb);
  const size_t smem = affine::smem_bytes(sizeof(T), p1, q, epb);
  cudaError_t err = affine::launch_smem(lattice_affine_kernel<T, P1, Q>, smem);
  if (err != cudaSuccess) return (int)err;
  lattice_affine_kernel<T, P1, Q><<<blocks, affine::kThreads, smem, st>>>(
      x, p0, c6, w3, bmat, dmat, ye, lat, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nbx = (lat.Dx + kFoldThreads - 1) / kFoldThreads;
  const dim3 grid(nbx * lat.Dy, lat.Dz < 65535 ? lat.Dz : 65535, lat.ndev);
  // the fold is the same code for both general instantiations
  lattice_affine_fold<T, (P1 > 0 ? P1 : 0)>
      <<<grid, kFoldThreads, 0, st>>>(ye, x, p0, y, yhalo, lat, nbx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* p0, const void* c6, const void* w3,
           const void* bmat, const void* dmat, void* ye, void* y, void* yhalo,
           Lattice lat, int q, void* stream) {
  const int p = lat.p;
  if (lat.nex <= 0 || lat.ney <= 0 || lat.nez <= 0 || p < 1 ||
      !affine::orders_ok(p + 1, q) || (lat.px && lat.nex < 2) ||
      lat.ndev < 1 || lat.ndev > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  lat.Dx = p * lat.nex + (lat.px ? 0 : 1);
  lat.Dy = p * lat.ney + 1;
  lat.Dz = p * lat.nez + 1;
  const long long n = (long long)lat.Dx * lat.Dy * lat.Dz;
  if (lat.xs < n || lat.ys < n || lat.zt >= lat.Dz ||
      (lat.scal != nullptr &&
       (p0 == nullptr || yhalo == nullptr ||
        lat.p0s < (long long)lat.Dx * lat.Dy))) {
    return (int)cudaErrorInvalidValue;
  }
  const T* xx = static_cast<const T*>(x);
  const T* pp = static_cast<const T*>(p0);
  const T* cc = static_cast<const T*>(c6);
  const T* ww = static_cast<const T*>(w3);
  const T* bb = static_cast<const T*>(bmat);
  const T* dd = static_cast<const T*>(dmat);
  T* ee = static_cast<T*>(ye);
  T* yy = static_cast<T*>(y);
  T* hh = static_cast<T*>(yhalo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // (a) the elements, then (b) the fold: the orders the port's paths run
  // (p = 1..4, q = p+1) are compiled fixed; every other (p+1, q) takes the
  // general instantiation that reaches it (affine::template_orders)
#define LPFEM_LAT_LAUNCH(A, B)                                                \
  launch_orders<T, A, B>(xx, pp, cc, ww, bb, dd, ee, yy, hh, lat, q, st)
  switch (affine::template_orders(p + 1, q)) {
    case 2: return LPFEM_LAT_LAUNCH(2, 2);
    case 3: return LPFEM_LAT_LAUNCH(3, 3);
    case 4: return LPFEM_LAT_LAUNCH(4, 4);
    case 5: return LPFEM_LAT_LAUNCH(5, 5);
    case affine::kGeneral:
      return LPFEM_LAT_LAUNCH(affine::kGeneral, affine::kGeneral);
    default: return LPFEM_LAT_LAUNCH(affine::kWide, affine::kWide);
  }
#undef LPFEM_LAT_LAUNCH
}

// One lattice: ess_top makes its top plane the Dirichlet plane.
template <typename T>
int one_lattice(const void* x, const void* c6, const void* w3,
                const void* bmat, const void* dmat, void* ye, void* y,
                int nex, int ney, int nez, int p, int q, int px, int ess_top,
                void* stream) {
  Lattice lat{};
  lat.nex = nex; lat.ney = ney; lat.nez = nez;
  lat.p = p;
  lat.px = px;
  lat.zt = ess_top ? p * nez : -1;
  lat.ndev = 1;
  lat.scal = nullptr;
  lat.xs = lat.ys = (long long)(p * nex + (px ? 0 : 1)) * (p * ney + 1) *
                    (p * nez + 1);
  lat.p0s = 0;
  return launch<T>(x, nullptr, c6, w3, bmat, dmat, ye, y, nullptr, lat, q,
                   stream);
}

// ndev stacked z-slab windows (shard mode; the header comment).
template <typename T>
int shard_windows(const void* x, const void* p0, const void* c6,
                  const void* w3, const void* bmat, const void* dmat,
                  void* ye, void* y, void* yhalo, int nex, int ney, int nez,
                  int p, int q, int px, const void* scal, int ndev,
                  long long xs, long long ys, long long p0s, void* stream) {
  if (scal == nullptr) return (int)cudaErrorInvalidValue;
  Lattice lat{};
  lat.nex = nex; lat.ney = ney; lat.nez = nez;
  lat.p = p;
  lat.px = px;
  lat.zt = -1;
  lat.ndev = ndev;
  lat.scal = static_cast<const int*>(scal);
  lat.xs = xs;
  lat.ys = ys;
  lat.p0s = p0s;
  return launch<T>(x, p0, c6, w3, bmat, dmat, ye, y, yhalo, lat, q, stream);
}

}  // namespace

extern "C" int lattice_affine_apply_f32(const void* x, const void* c6,
                                        const void* w3, const void* bmat,
                                        const void* dmat, void* ye, void* y,
                                        int nex, int ney, int nez, int p,
                                        int q, int px, int ess_top,
                                        void* stream) {
  return one_lattice<float>(x, c6, w3, bmat, dmat, ye, y, nex, ney, nez, p, q,
                            px, ess_top, stream);
}

extern "C" int lattice_affine_apply_f64(const void* x, const void* c6,
                                        const void* w3, const void* bmat,
                                        const void* dmat, void* ye, void* y,
                                        int nex, int ney, int nez, int p,
                                        int q, int px, int ess_top,
                                        void* stream) {
  return one_lattice<double>(x, c6, w3, bmat, dmat, ye, y, nex, ney, nez, p,
                             q, px, ess_top, stream);
}

// Shard mode: x / y rows of xs / ys values, p0 rows of p0s, c6
// [ndev * nex * ney * nez, 6], ye [ndev * nex * ney * nez, (p+1)^3] scratch,
// yhalo [ndev][Dx*Dy], scal [ndev][2] int on the device.
extern "C" int lattice_affine_apply_shard_f32(
    const void* x, const void* p0, const void* c6, const void* w3,
    const void* bmat, const void* dmat, void* ye, void* y, void* yhalo,
    int nex, int ney, int nez, int p, int q, int px, const void* scal,
    int ndev, long long xs, long long ys, long long p0s, void* stream) {
  return shard_windows<float>(x, p0, c6, w3, bmat, dmat, ye, y, yhalo, nex,
                              ney, nez, p, q, px, scal, ndev, xs, ys, p0s,
                              stream);
}

extern "C" int lattice_affine_apply_shard_f64(
    const void* x, const void* p0, const void* c6, const void* w3,
    const void* bmat, const void* dmat, void* ye, void* y, void* yhalo,
    int nex, int ney, int nez, int p, int q, int px, const void* scal,
    int ndev, long long xs, long long ys, long long p0s, void* stream) {
  return shard_windows<double>(x, p0, c6, w3, bmat, dmat, ye, y, yhalo, nex,
                               ney, nez, p, q, px, scal, ndev, xs, ys, p0s,
                               stream);
}
