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
// step. None of that is carried over. Here every element reads its window
// straight from x by lattice index (x wraps mod Dx), runs the sum-factorised
// body of element_body.cuh in shared memory, and adds its (p+1)^3 results
// into y. Neighbouring elements add into the dofs they share; to keep that
// free of atomics and bitwise repeatable the elements go in parity classes
// (even / odd in each axis: 8 classes, 12 when a periodic x has an odd number
// of elements and its last element needs a class of its own), one launch per
// class on the stream, in a fixed order. Inside a class no two elements share
// a dof, and the order of every dof's sum is the order of the classes.
//
// What bounds it on an H100: at p = 4 on 32,768 elements (2,179,584 dofs) an
// f32 apply must move x and y once (17.4 MB) and C6 (0.8 MB), 5.4 us at
// 3.35 TB/s, and does 0.73 GFLOP, 10.9 us at 67 TFLOP/s (f64: 10.9 / 21.4 us):
// operations, narrowly. The three-step route it fuses (index gather, B3a,
// fold) writes and reads both [ne, 125] E-vectors besides (65.5 MB more in
// f32). Design against that: x is read and y read-modified-written in place
// in rows of p+1 consecutive values, and nothing else touches device memory.
// The windows overlap, so a dof on an element boundary is fetched by up to 8
// elements; the 50 MB L2 serves those.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// The entry enqueues a memset, the class launches and (ess_top) one plane
// copy on the given stream, does not synchronise, allocates nothing and
// returns the first CUDA error.

#include <cuda_runtime.h>

#include "element_body.cuh"

namespace {

using namespace lpfem;

struct Lattice {
  int nex, ney, nez;   // elements per axis
  int Dx, Dy, Dz;      // dofs per axis
  int p;
  int ess_top;
};

// One parity class: along axis a the elements start[a] + step[a] * j,
// j < count[a].
struct ElemClass {
  int start[3], step[3], count[3];
};

// The block's el-th element of the class: its lattice position, or none.
struct ClassElems {
  Lattice lat;
  ElemClass cls;
  long long j0;

  __device__ bool coords(int el, int& ex, int& ey, int& ez) const {
    const long long j = j0 + el;
    const long long n =
        (long long)cls.count[0] * cls.count[1] * cls.count[2];
    if (j >= n) return false;
    ex = cls.start[0] + cls.step[0] * (int)(j % cls.count[0]);
    ey = cls.start[1] + cls.step[1] * (int)((j / cls.count[0]) % cls.count[1]);
    ez = cls.start[2] +
         cls.step[2] * (int)(j / ((long long)cls.count[0] * cls.count[1]));
    return true;
  }

  __device__ long long operator()(int el) const {
    int ex, ey, ez;
    if (!coords(el, ex, ey, ez)) return -1;
    return ex + (long long)lat.nex * (ey + (long long)lat.ney * ez);
  }

  // Lattice index of local node k of element el, or -1 for no element;
  // top is set where the node lies on the top z-plane.
  __device__ long long dof(int el, int k, int p1, bool& top) const {
    int ex, ey, ez;
    if (!coords(el, ex, ey, ez)) return -1;
    const int lx = k % p1, ly = (k / p1) % p1, lz = k / (p1 * p1);
    int gx = ex * lat.p + lx;
    if (gx >= lat.Dx) gx -= lat.Dx;            // the periodic seam
    const int gy = ey * lat.p + ly, gz = ez * lat.p + lz;
    top = gz == lat.Dz - 1;
    return gx + (long long)lat.Dx * (gy + (long long)lat.Dy * gz);
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
lattice_affine_kernel(const T* __restrict__ x, const T* __restrict__ c6,
                      const T* __restrict__ w3, const T* __restrict__ bmat,
                      const T* __restrict__ dmat, T* __restrict__ y,
                      Lattice lat, ElemClass cls, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims d = make_dims(lat.p + 1, q);
  const Smem<T> s = carve<T, true>(reinterpret_cast<T*>(smem_raw), d);
  const ClassElems elems{lat, cls, (long long)blockIdx.x * d.epb};
  const int tid = threadIdx.x, nt = blockDim.x;

  load_tables<T, true>(s, d, bmat, dmat, w3);
  for (int i = tid; i < d.epb * d.L; i += nt) {
    bool top = false;
    const long long g = elems.dof(i / d.L, i % d.L, d.p1, top);
    s.su[i] = (g < 0 || (lat.ess_top && top)) ? T(0) : x[g];
  }
  __syncthreads();

  element_stages<T, true>(s, d, c6, elems);

  for (int i = tid; i < d.epb * d.L; i += nt) {
    bool top = false;
    const long long g = elems.dof(i / d.L, i % d.L, d.p1, top);
    if (g < 0 || (lat.ess_top && top)) continue;
    y[g] += element_out(s, d, i);
  }
}

// The classes of one axis: even and odd elements; on a periodic axis with an
// odd count the last element, which meets element 0 across the seam, alone.
int axis_classes(int n, bool periodic, int start[3], int count[3]) {
  if (periodic && n % 2 == 1 && n > 1) {
    start[0] = 0; count[0] = (n - 1) / 2;
    start[1] = 1; count[1] = (n - 1) / 2;
    start[2] = n - 1; count[2] = 1;
    return 3;
  }
  start[0] = 0; count[0] = (n + 1) / 2;
  start[1] = 1; count[1] = n / 2;
  return 2;
}

template <typename T>
int launch(const void* x, const void* c6, const void* w3, const void* bmat,
           const void* dmat, void* y, int nex, int ney, int nez, int p, int q,
           int px, int ess_top, void* stream) {
  if (nex <= 0 || ney <= 0 || nez <= 0 || !dims_ok(p + 1, q) ||
      (px && nex < 2)) {
    return (int)cudaErrorInvalidValue;
  }
  Lattice lat;
  lat.nex = nex; lat.ney = ney; lat.nez = nez;
  lat.Dx = p * nex + (px ? 0 : 1);
  lat.Dy = p * ney + 1;
  lat.Dz = p * nez + 1;
  lat.p = p;
  lat.ess_top = ess_top;
  const size_t plane = (size_t)lat.Dx * lat.Dy;
  const size_t n = plane * lat.Dz;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, n * sizeof(T), st);
  if (err != cudaSuccess) return (int)err;

  const Dims d = make_dims(p + 1, q);
  const size_t smem = sizeof(T) * smem_values(d, true);
  const int threads = block_threads(d);
  int sx[3], cx[3], sy[3], cy[3], sz[3], cz[3];
  const int ncx = axis_classes(nex, px != 0, sx, cx);
  const int ncy = axis_classes(ney, false, sy, cy);
  const int ncz = axis_classes(nez, false, sz, cz);
  for (int kz = 0; kz < ncz; ++kz) {
    for (int ky = 0; ky < ncy; ++ky) {
      for (int kx = 0; kx < ncx; ++kx) {
        const long long count = (long long)cx[kx] * cy[ky] * cz[kz];
        if (count == 0) continue;
        ElemClass cls;
        cls.start[0] = sx[kx]; cls.step[0] = 2; cls.count[0] = cx[kx];
        cls.start[1] = sy[ky]; cls.step[1] = 2; cls.count[1] = cy[ky];
        cls.start[2] = sz[kz]; cls.step[2] = 2; cls.count[2] = cz[kz];
        const unsigned blocks = (unsigned)((count + d.epb - 1) / d.epb);
        lattice_affine_kernel<T><<<blocks, threads, smem, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(c6),
            static_cast<const T*>(w3), static_cast<const T*>(bmat),
            static_cast<const T*>(dmat), static_cast<T*>(y), lat, cls, q);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
      }
    }
  }
  if (ess_top) {
    const size_t off = plane * (lat.Dz - 1);
    err = cudaMemcpyAsync(static_cast<T*>(y) + off,
                          static_cast<const T*>(x) + off, plane * sizeof(T),
                          cudaMemcpyDeviceToDevice, st);
  }
  return (int)err;
}

}  // namespace

extern "C" int lattice_affine_apply_f32(const void* x, const void* c6,
                                        const void* w3, const void* bmat,
                                        const void* dmat, void* y, int nex,
                                        int ney, int nez, int p, int q,
                                        int px, int ess_top, void* stream) {
  return launch<float>(x, c6, w3, bmat, dmat, y, nex, ney, nez, p, q, px,
                       ess_top, stream);
}

extern "C" int lattice_affine_apply_f64(const void* x, const void* c6,
                                        const void* w3, const void* bmat,
                                        const void* dmat, void* y, int nex,
                                        int ney, int nez, int p, int q,
                                        int px, int ess_top, void* stream) {
  return launch<double>(x, c6, w3, bmat, dmat, y, nex, ney, nez, p, q, px,
                        ess_top, stream);
}
