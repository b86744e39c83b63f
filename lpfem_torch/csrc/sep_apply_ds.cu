// Double-single (two-float32) banded Kronecker Laplace apply.
//
// Replaces the Pallas TPU kernel
// lpfem/kernels/sep_apply_ds.py::lattice_sep_apply_ds: B1's operator
//
//     A = Mz (x) My (x) Kx  +  Mz (x) Ky (x) Mx  +  Kz (x) My (x) Mx
//
// (csrc/sep_apply.cu) on a double-single pair, value = hi + lo, every
// product and sum error-free, reproducing the float64 operator to ~2^-48
// relative. The band tables are DS pairs of the float64 1D factors in
// diagonal-offset form, band[p + s][i] = G[i][i + s] (shape [2p+1, D]):
// twelve tables (Kx, Mx, Ky, My, Kz, Mz, each hi and lo).
//
// Per band term, c = (ch, cl) the coefficient and (u, ulo) the operand:
//
//   pr  = ch * u                           (rounded)
//   err = fma(ch, u, -pr)                  exact: pr + err = ch * u
//   err = (err + ch * ulo) + cl * u        the cross terms; cl * ulo dropped
//   (acc_h, t) = two_sum(acc_h, pr)        exact running sum
//   acc_l = acc_l + (t + err)
//
// each accumulator starts at zero, takes its terms s = -p..p in order and
// ends with fast_two_sum(acc_h, acc_l). The fma gives the same exact error
// as the Dekker product of the TPU kernel and the plain version
// (lpfem_torch.kernels.sep_apply_ds.sep_apply_ds_reference), so the two
// agree bit for bit.
//
// Error-free transforms break if the compiler fuses a product into a sum:
// nvcc contracts a * b + c into one fma by default (--fmad=true), and one
// contracted add inside two_sum demotes the whole apply to float32 accuracy.
// So every product and sum here is an __fmul_rn / __fadd_rn / __fsub_rn
// intrinsic, which nvcc never contracts, or an explicit fmaf; the source is
// immune to --fmad without a flag of its own. Flush-to-zero and fast math
// stay off (nvcc's defaults): the lo streams sit ~2^-24 below hi and can be
// subnormal near zero.
//
// Structure is B1's: three passes, one thread per output dof with x fastest
// in the thread index, the global z bands (no sequential layer carry, no
// atomics, deterministic), every value in two separate float32 arrays (SoA),
// so that r.hi feeds the inner float32 CG without a copy:
//
//   pass x:  t1 = Kx u,            t2 = Mx u
//   pass y:  a  = My t1 (+) Ky t2, b  = My t2
//   pass z:  y  = Mz a  (+) Kz b
//
// with (+) the DS addition: (s, e) = two_sum(x.hi, y.hi), then
// fast_two_sum(s, (e + x.lo) + y.lo). ess_top: pass x reads the top plane
// of u as zero and pass z writes it as x (both streams). Periodic x wraps.
//
// What bounds it on an H100: operations. A term costs 15 float32 operations
// (the product 7 with the fma counted as 2, two_sum 6, the lo update 2), a
// normalisation 3, a DS addition 11; the passes hold 2, 3 and 2
// accumulators of 2p+1 terms, so a dof costs 105 (2p+1) + 43 operations,
// 988 at p = 4, against 16 bytes of input and output: ~62 operations per
// byte, three times the card's float32 balance point (67 TFLOP/s over
// 3.35 TB/s). Nothing here is tiled yet: the passes move ~20 float32
// vectors through L2 and device memory (the scratch of 8 vectors is
// allocated by the caller); shared-memory tiling of the passes is later
// work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// The entry launches on the given stream, does not synchronise, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void fast_two_sum(float a, float b, float& s,
                                             float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

struct Acc {
  float h = 0.0f, l = 0.0f;

  __device__ __forceinline__ void add(float ch, float cl, float u,
                                      float ulo) {
    const float pr = __fmul_rn(ch, u);
    float err = fmaf(ch, u, -pr);
    err = __fadd_rn(__fadd_rn(err, __fmul_rn(ch, ulo)), __fmul_rn(cl, u));
    float s, t;
    two_sum(h, pr, s, t);
    h = s;
    l = __fadd_rn(l, __fadd_rn(t, err));
  }

  __device__ __forceinline__ void norm() {
    float s, e;
    fast_two_sum(h, l, s, e);
    h = s;
    l = e;
  }
};

// (sh, sl) = x (+) y
__device__ __forceinline__ void ds_add(const Acc& x, const Acc& y, float& sh,
                                       float& sl) {
  float s, e;
  two_sum(x.h, y.h, s, e);
  fast_two_sum(s, __fadd_rn(__fadd_rn(e, x.l), y.l), sh, sl);
}

struct Bands {
  const float *kxh, *kxl, *mxh, *mxl, *kyh, *kyl, *myh, *myl, *kzh, *kzl,
      *mzh, *mzl;
};

// t1 = Kx u, t2 = Mx u (per x row); rows of the top plane are zero under
// ess_top.
__global__ void ds_pass_x(const float* __restrict__ uh,
                          const float* __restrict__ ul,
                          float* __restrict__ t1h, float* __restrict__ t1l,
                          float* __restrict__ t2h, float* __restrict__ t2l,
                          Bands c, int Dx, int Dy, int Dz, int p,
                          int periodic_x, int ess_top) {
  const long long n = (long long)Dx * Dy * Dz;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ix = (int)(i % Dx);
  const long long row = i - ix;
  const long long plane = (long long)Dx * Dy;
  Acc a1, a2;
  if (!(ess_top && i >= plane * (Dz - 1))) {
    for (int s = -p; s <= p; ++s) {
      int j = ix + s;
      if (periodic_x) {
        j = (j % Dx + Dx) % Dx;
      } else if (j < 0 || j >= Dx) {
        continue;
      }
      const float u = uh[row + j], ulo = ul[row + j];
      const int k = (p + s) * Dx + ix;
      a1.add(c.kxh[k], c.kxl[k], u, ulo);
      a2.add(c.mxh[k], c.mxl[k], u, ulo);
    }
  }
  a1.norm();
  a2.norm();
  t1h[i] = a1.h;
  t1l[i] = a1.l;
  t2h[i] = a2.h;
  t2l[i] = a2.l;
}

// a = My t1 (+) Ky t2, b = My t2 (y is never periodic).
__global__ void ds_pass_y(const float* __restrict__ t1h,
                          const float* __restrict__ t1l,
                          const float* __restrict__ t2h,
                          const float* __restrict__ t2l,
                          float* __restrict__ ah, float* __restrict__ al,
                          float* __restrict__ bh, float* __restrict__ bl,
                          Bands c, int Dx, int Dy, int Dz, int p) {
  const long long n = (long long)Dx * Dy * Dz;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int iy = (int)((i / Dx) % Dy);
  Acc a1, a2, b;
  for (int s = -p; s <= p; ++s) {
    const int j = iy + s;
    if (j < 0 || j >= Dy) continue;
    const long long m = i + (long long)s * Dx;
    const int k = (p + s) * Dy + iy;
    const float u1 = t1h[m], u1lo = t1l[m], u2 = t2h[m], u2lo = t2l[m];
    a1.add(c.myh[k], c.myl[k], u1, u1lo);
    a2.add(c.kyh[k], c.kyl[k], u2, u2lo);
    b.add(c.myh[k], c.myl[k], u2, u2lo);
  }
  a1.norm();
  a2.norm();
  b.norm();
  ds_add(a1, a2, ah[i], al[i]);
  bh[i] = b.h;
  bl[i] = b.l;
}

// y = Mz a (+) Kz b (z is never periodic); the top plane is x under ess_top.
__global__ void ds_pass_z(const float* __restrict__ ah,
                          const float* __restrict__ al,
                          const float* __restrict__ bh,
                          const float* __restrict__ bl,
                          const float* __restrict__ xh,
                          const float* __restrict__ xl,
                          float* __restrict__ yh, float* __restrict__ yl,
                          Bands c, int Dx, int Dy, int Dz, int p,
                          int ess_top) {
  const long long plane = (long long)Dx * Dy;
  const long long n = plane * Dz;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int iz = (int)(i / plane);
  if (ess_top && iz == Dz - 1) {
    yh[i] = xh[i];
    yl[i] = xl[i];
    return;
  }
  Acc ya, yb;
  for (int s = -p; s <= p; ++s) {
    const int j = iz + s;
    if (j < 0 || j >= Dz) continue;
    const long long m = i + (long long)s * plane;
    const int k = (p + s) * Dz + iz;
    ya.add(c.mzh[k], c.mzl[k], ah[m], al[m]);
    yb.add(c.kzh[k], c.kzl[k], bh[m], bl[m]);
  }
  ya.norm();
  yb.norm();
  ds_add(ya, yb, yh[i], yl[i]);
}

}  // namespace

extern "C" int sep_apply_ds_f32(
    const void* xh, const void* xl, void* yh, void* yl, void* scratch,
    const void* kxh, const void* kxl, const void* mxh, const void* mxl,
    const void* kyh, const void* kyl, const void* myh, const void* myl,
    const void* kzh, const void* kzl, const void* mzh, const void* mzl,
    int Dx, int Dy, int Dz, int p, int periodic_x, int ess_top,
    void* stream) {
  const long long n = (long long)Dx * Dy * Dz;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bands c{static_cast<const float*>(kxh), static_cast<const float*>(kxl),
                static_cast<const float*>(mxh), static_cast<const float*>(mxl),
                static_cast<const float*>(kyh), static_cast<const float*>(kyl),
                static_cast<const float*>(myh), static_cast<const float*>(myl),
                static_cast<const float*>(kzh), static_cast<const float*>(kzl),
                static_cast<const float*>(mzh),
                static_cast<const float*>(mzl)};
  float* s = static_cast<float*>(scratch);
  float *t1h = s, *t1l = s + n, *t2h = s + 2 * n, *t2l = s + 3 * n;
  float *ah = s + 4 * n, *al = s + 5 * n, *bh = s + 6 * n, *bl = s + 7 * n;
  const float* uh = static_cast<const float*>(xh);
  const float* ul = static_cast<const float*>(xl);
  ds_pass_x<<<blocks, kThreads, 0, st>>>(uh, ul, t1h, t1l, t2h, t2l, c, Dx,
                                         Dy, Dz, p, periodic_x, ess_top);
  ds_pass_y<<<blocks, kThreads, 0, st>>>(t1h, t1l, t2h, t2l, ah, al, bh, bl,
                                         c, Dx, Dy, Dz, p);
  ds_pass_z<<<blocks, kThreads, 0, st>>>(ah, al, bh, bl, uh, ul,
                                         static_cast<float*>(yh),
                                         static_cast<float*>(yl), c, Dx, Dy,
                                         Dz, p, ess_top);
  return (int)cudaGetLastError();
}
