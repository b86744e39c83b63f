// Element-form Laplace apply on curved hexes (partial assembly), per element:
//
//     ye[e] = Jr2^T ( G6[e] o (Jr2 u[e]) )
//
// Replaces the Pallas TPU kernel
// lpfem/kernels/pa_apply.py::pa_apply_element_kernel (B3b). u[e] holds the
// element's (p+1)^3 dof values (z, y, x; x fastest), G6 the symmetric 3x3
// metric w|J|J^-1J^-T at the q^3 Gauss points in component-major layout
// [ne, 6Q] with components (xx, xy, xz, yy, yz, zz), and Jr2 = [B(x)B(x)D;
// B(x)D(x)B; D(x)B(x)B] the reference-gradient interpolation built from the
// 1D basis values B [q, p+1] and derivatives D [q, p+1] at the Gauss points.
//
// The TPU kernel forms Jr2 densely and runs two MXU matmuls per 256-element
// block ([256, L] x [L, 3Q]). Here the same function is sum-factorised, as
// MFEM's PA kernels are: three 1D contractions per direction forward (x, y,
// z), the metric at each point, three back, every intermediate in shared
// memory. At p = 4 that is 11,125 multiply-adds per element instead of the
// dense form's 93,750, and the only device-memory traffic is u, G6 and ye
// (B and D are a few hundred bytes).
//
// What bounds it on an H100: bytes. At p = 4 on the 4,224-element cylinder
// tank an f32 apply must move u 2.11 MB + G6 12.67 MB + ye 2.11 MB =
// 16.9 MB, 5.0 us at 3.35 TB/s, against 94 MFLOP = 1.4 us at 67 TFLOP/s
// (f64: 10.1 us of bytes, 2.8 us of flops at 34 TFLOP/s). Design against
// that: G6, the largest stream, is read once, coalesced (the threads of an
// element read consecutive points of one component); u and ye are read and
// written once, coalesced; nothing else leaves shared memory. Each block
// holds a few elements (enough for ~256 threads at every order), one thread
// per output point of each stage, stages separated by __syncthreads.
//
// Exact in its dtype: plain fused multiply-adds in float or double, no
// tensor cores. The sums run in another order than the plain PyTorch version
// (lpfem_torch.kernels.pa_apply.pa_apply_element_reference, two dense
// matmuls as lpfem's "fused" mode), so the two agree to rounding.
//
// Plain C interface (one entry per dtype), built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// Each entry launches on the given stream, does not synchronise, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxP1 = 8;       // p <= 7 and q <= 8 keep a block under 48 KB

struct Dims {
  int p1, q, L, Q, na, nb, per_e, epb;
};

__host__ __device__ inline Dims make_dims(int p1, int q) {
  Dims d;
  d.p1 = p1;
  d.q = q;
  d.L = p1 * p1 * p1;
  d.Q = q * q * q;
  d.na = p1 * p1 * q;    // after the x stage: [z][y][qx]
  d.nb = p1 * q * q;     // after the y stage: [z][qy][qx]
  d.per_e = d.L + 2 * d.na + 3 * d.nb + 3 * d.Q;
  int nmax = d.L;
  if (d.Q > nmax) nmax = d.Q;
  if (d.na > nmax) nmax = d.na;
  if (d.nb > nmax) nmax = d.nb;
  d.epb = kMaxThreads / nmax > 0 ? kMaxThreads / nmax : 1;
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pa_element_kernel(const T* __restrict__ u, const T* __restrict__ g6,
                  const T* __restrict__ bmat, const T* __restrict__ dmat,
                  T* __restrict__ y, int ne, int p1, int q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Dims d = make_dims(p1, q);
  const int L = d.L, Q = d.Q, na = d.na, nb = d.nb, epb = d.epb;
  T* sB = sm;                    // [q][p1]
  T* sD = sB + q * p1;           // [q][p1]
  T* su = sD + q * p1;           // [epb][L]
  T* a0 = su + epb * L;          // [epb][na]  B in x       | back: D_x part
  T* a1 = a0 + epb * na;         // [epb][na]  D in x       | back: B_x part
  T* b0 = a1 + epb * na;         // [epb][nb]  B_y B_x      | back: B_z^T hx
  T* b1 = b0 + epb * nb;         // [epb][nb]  D_y B_x      | back: B_z^T hy
  T* b2 = b1 + epb * nb;         // [epb][nb]  B_y D_x      | back: D_z^T hz
  T* hx = b2 + epb * nb;         // [epb][Q]
  T* hy = hx + epb * Q;
  T* hz = hy + epb * Q;

  const long long e0 = (long long)blockIdx.x * epb;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < q * p1; i += nt) {
    sB[i] = bmat[i];
    sD[i] = dmat[i];
  }
  for (int i = tid; i < epb * L; i += nt) {
    const long long e = e0 + i / L;
    su[i] = e < ne ? u[e0 * L + i] : T(0);
  }
  __syncthreads();

  // x: a0 = B_x u, a1 = D_x u      (k = (z*p1 + y)*q + qx)
  for (int i = tid; i < epb * na; i += nt) {
    const int el = i / na, k = i % na;
    const int qx = k % q, zy = k / q;
    const T* ur = su + el * L + zy * p1;
    T s0 = T(0), s1 = T(0);
    for (int x = 0; x < p1; ++x) {
      s0 += sB[qx * p1 + x] * ur[x];
      s1 += sD[qx * p1 + x] * ur[x];
    }
    a0[i] = s0;
    a1[i] = s1;
  }
  __syncthreads();

  // y: b0 = B_y a0, b1 = D_y a0, b2 = B_y a1      (k = (z*q + qy)*q + qx)
  for (int i = tid; i < epb * nb; i += nt) {
    const int el = i / nb, k = i % nb;
    const int qx = k % q, qy = (k / q) % q, z = k / (q * q);
    const T* r0 = a0 + el * na + z * p1 * q + qx;
    const T* r1 = a1 + el * na + z * p1 * q + qx;
    T s0 = T(0), s1 = T(0), s2 = T(0);
    for (int yy = 0; yy < p1; ++yy) {
      const T bv = sB[qy * p1 + yy], dv = sD[qy * p1 + yy];
      const T v0 = r0[yy * q], v1 = r1[yy * q];
      s0 += bv * v0;
      s1 += dv * v0;
      s2 += bv * v1;
    }
    b0[i] = s0;
    b1[i] = s1;
    b2[i] = s2;
  }
  __syncthreads();

  // z and the metric: g = (B_z b2, B_z b1, D_z b0), h = G g
  for (int i = tid; i < epb * Q; i += nt) {
    const int el = i / Q, k = i % Q;
    const long long e = e0 + el;
    T h0 = T(0), h1 = T(0), h2 = T(0);
    if (e < ne) {
      const int qxy = k % (q * q), qz = k / (q * q);
      const T* c0 = b0 + el * nb + qxy;
      const T* c1 = b1 + el * nb + qxy;
      const T* c2 = b2 + el * nb + qxy;
      T gx = T(0), gy = T(0), gz = T(0);
      for (int z = 0; z < p1; ++z) {
        const T bv = sB[qz * p1 + z], dv = sD[qz * p1 + z];
        gx += bv * c2[z * q * q];
        gy += bv * c1[z * q * q];
        gz += dv * c0[z * q * q];
      }
      const T* G = g6 + e * 6 * Q + k;
      const T gxx = G[0], gxy = G[Q], gxz = G[2 * Q];
      const T gyy = G[3 * Q], gyz = G[4 * Q], gzz = G[5 * Q];
      h0 = gxx * gx + gxy * gy + gxz * gz;
      h1 = gxy * gx + gyy * gy + gyz * gz;
      h2 = gxz * gx + gyz * gy + gzz * gz;
    }
    hx[i] = h0;
    hy[i] = h1;
    hz[i] = h2;
  }
  __syncthreads();

  // z^T: b0 = B_z^T hx, b1 = B_z^T hy, b2 = D_z^T hz
  for (int i = tid; i < epb * nb; i += nt) {
    const int el = i / nb, k = i % nb;
    const int qxy = k % (q * q), z = k / (q * q);
    const T* c0 = hx + el * Q + qxy;
    const T* c1 = hy + el * Q + qxy;
    const T* c2 = hz + el * Q + qxy;
    T s0 = T(0), s1 = T(0), s2 = T(0);
    for (int qz = 0; qz < q; ++qz) {
      const T bv = sB[qz * p1 + z], dv = sD[qz * p1 + z];
      s0 += bv * c0[qz * q * q];
      s1 += bv * c1[qz * q * q];
      s2 += dv * c2[qz * q * q];
    }
    b0[i] = s0;
    b1[i] = s1;
    b2[i] = s2;
  }
  __syncthreads();

  // y^T: a0 = B_y^T b0 (then D_x), a1 = D_y^T b1 + B_y^T b2 (then B_x)
  for (int i = tid; i < epb * na; i += nt) {
    const int el = i / na, k = i % na;
    const int qx = k % q, yy = (k / q) % p1, z = k / (p1 * q);
    const T* r0 = b0 + el * nb + z * q * q + qx;
    const T* r1 = b1 + el * nb + z * q * q + qx;
    const T* r2 = b2 + el * nb + z * q * q + qx;
    T s0 = T(0), s1 = T(0);
    for (int qy = 0; qy < q; ++qy) {
      const T bv = sB[qy * p1 + yy], dv = sD[qy * p1 + yy];
      s0 += bv * r0[qy * q];
      s1 += dv * r1[qy * q] + bv * r2[qy * q];
    }
    a0[i] = s0;
    a1[i] = s1;
  }
  __syncthreads();

  // x^T: ye = D_x^T a0 + B_x^T a1
  for (int i = tid; i < epb * L; i += nt) {
    const long long e = e0 + i / L;
    if (e >= ne) continue;
    const int el = i / L, k = i % L;
    const int x = k % p1, zy = k / p1;
    const T* r0 = a0 + el * na + zy * q;
    const T* r1 = a1 + el * na + zy * q;
    T s = T(0);
    for (int qx = 0; qx < q; ++qx) {
      s += sD[qx * p1 + x] * r0[qx] + sB[qx * p1 + x] * r1[qx];
    }
    y[e0 * L + i] = s;
  }
}

template <typename T>
int launch(const void* u, const void* g6, const void* bmat, const void* dmat,
           void* y, int ne, int p1, int q, void* stream) {
  if (ne <= 0) return 0;
  if (p1 < 2 || p1 > kMaxP1 || q < 1 || q > kMaxP1) {
    return (int)cudaErrorInvalidValue;
  }
  const Dims d = make_dims(p1, q);
  int nmax = d.L;
  if (d.Q > nmax) nmax = d.Q;
  if (d.na > nmax) nmax = d.na;
  if (d.nb > nmax) nmax = d.nb;
  int threads = d.epb * nmax;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = sizeof(T) * (size_t)(2 * q * p1 + d.epb * d.per_e);
  const unsigned blocks = (unsigned)((ne + d.epb - 1) / d.epb);
  pa_element_kernel<T><<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(g6),
      static_cast<const T*>(bmat), static_cast<const T*>(dmat),
      static_cast<T*>(y), ne, p1, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pa_apply_element_f32(const void* u, const void* g6,
                                    const void* bmat, const void* dmat,
                                    void* y, int ne, int p1, int q,
                                    void* stream) {
  return launch<float>(u, g6, bmat, dmat, y, ne, p1, q, stream);
}

extern "C" int pa_apply_element_f64(const void* u, const void* g6,
                                    const void* bmat, const void* dmat,
                                    void* y, int ne, int p1, int q,
                                    void* stream) {
  return launch<double>(u, g6, bmat, dmat, y, ne, p1, q, stream);
}
