// The sum-factorised element body of B3b (pa_apply.cu, pa_element_kernel):
// for the elements of one block,
//
//     ye = Jr2^T ( G o (Jr2 u) ),   Jr2 = [B(x)B(x)D; B(x)D(x)B; D(x)B(x)B]
//
// with u [(p+1)^3] in shared memory (z, y, x; x fastest), B and D [q, p+1]
// the 1D basis values and derivatives at the Gauss points, and the full
// metric G: 6 values per Gauss point, component-major [ne, 6Q], components
// xx, xy, xz, yy, yz, zz. (The affine kernels B2 and B3a run
// affine_body.cuh.)
//
// Three 1D contractions forward (x, y, z), the metric at each point, three
// back; every intermediate stays in shared memory; one thread per output
// point of each stage, stages separated by __syncthreads. Each block holds a
// few elements (enough for ~256 threads at every order). The caller loads u,
// calls element_stages, and reads each output value with element_out (the
// last contraction), which it stores or accumulates as it needs.
//
// Exact in its dtype: plain fused multiply-adds in float or double, no
// tensor cores.

#pragma once

#include <cuda_runtime.h>

namespace lpfem {

constexpr int kMaxThreads = 256;
constexpr int kMaxP1 = 8;       // p <= 7 and q <= 8 keep a block under 48 KB

struct Dims {
  int p1, q, L, Q, na, nb, per_e, epb, nmax;
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
  d.nmax = d.L;
  if (d.Q > d.nmax) d.nmax = d.Q;
  if (d.na > d.nmax) d.nmax = d.na;
  if (d.nb > d.nmax) d.nmax = d.nb;
  d.epb = kMaxThreads / d.nmax > 0 ? kMaxThreads / d.nmax : 1;
  return d;
}

inline bool dims_ok(int p1, int q) {
  return p1 >= 2 && p1 <= kMaxP1 && q >= 1 && q <= kMaxP1;
}

// Threads of a block: one per point of the widest stage, a multiple of 32.
inline int block_threads(const Dims& d) {
  int threads = ((d.epb * d.nmax + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

// Values of type T a block keeps in shared memory.
inline size_t smem_values(const Dims& d) {
  return (size_t)(2 * d.q * d.p1 + d.epb * d.per_e);
}

template <typename T>
struct Smem {
  T *sB, *sD;            // [q][p1]
  T *su;                 // [epb][L]
  T *a0, *a1;            // [epb][na]
  T *b0, *b1, *b2;       // [epb][nb]
  T *hx, *hy, *hz;       // [epb][Q]
};

template <typename T>
__device__ inline Smem<T> carve(T* sm, const Dims& d) {
  Smem<T> s;
  s.sB = sm;
  s.sD = s.sB + d.q * d.p1;
  s.su = s.sD + d.q * d.p1;
  s.a0 = s.su + d.epb * d.L;     // B in x       | back: D_x part
  s.a1 = s.a0 + d.epb * d.na;    // D in x       | back: B_x part
  s.b0 = s.a1 + d.epb * d.na;    // B_y B_x      | back: B_z^T hx
  s.b1 = s.b0 + d.epb * d.nb;    // D_y B_x      | back: B_z^T hy
  s.b2 = s.b1 + d.epb * d.nb;    // B_y D_x      | back: D_z^T hz
  s.hx = s.b2 + d.epb * d.nb;
  s.hy = s.hx + d.epb * d.Q;
  s.hz = s.hy + d.epb * d.Q;
  return s;
}

// Copies B and D into shared memory; the caller synchronises.
template <typename T>
__device__ inline void load_tables(const Smem<T>& s, const Dims& d,
                                   const T* __restrict__ bmat,
                                   const T* __restrict__ dmat) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < d.q * d.p1; i += nt) {
    s.sB[i] = bmat[i];
    s.sD[i] = dmat[i];
  }
}

// From u in s.su (loaded and synchronised by the caller) to the inputs of
// the last contraction in s.a0, s.a1 (synchronised on return).
// elem_id(el) is the global id of the block's el-th element, whose metric
// is read, or -1 where the block has none (its h is zero).
template <typename T, typename ElemId>
__device__ inline void element_stages(const Smem<T>& s, const Dims& d,
                                      const T* __restrict__ metric,
                                      const ElemId& elem_id) {
  const int p1 = d.p1, q = d.q;
  const int L = d.L, Q = d.Q, na = d.na, nb = d.nb, epb = d.epb;
  const T *sB = s.sB, *sD = s.sD;
  const int tid = threadIdx.x, nt = blockDim.x;

  // x: a0 = B_x u, a1 = D_x u      (k = (z*p1 + y)*q + qx)
  for (int i = tid; i < epb * na; i += nt) {
    const int el = i / na, k = i % na;
    const int qx = k % q, zy = k / q;
    const T* ur = s.su + el * L + zy * p1;
    T s0 = T(0), s1 = T(0);
    for (int x = 0; x < p1; ++x) {
      s0 += sB[qx * p1 + x] * ur[x];
      s1 += sD[qx * p1 + x] * ur[x];
    }
    s.a0[i] = s0;
    s.a1[i] = s1;
  }
  __syncthreads();

  // y: b0 = B_y a0, b1 = D_y a0, b2 = B_y a1      (k = (z*q + qy)*q + qx)
  for (int i = tid; i < epb * nb; i += nt) {
    const int el = i / nb, k = i % nb;
    const int qx = k % q, qy = (k / q) % q, z = k / (q * q);
    const T* r0 = s.a0 + el * na + z * p1 * q + qx;
    const T* r1 = s.a1 + el * na + z * p1 * q + qx;
    T s0 = T(0), s1 = T(0), s2 = T(0);
    for (int yy = 0; yy < p1; ++yy) {
      const T bv = sB[qy * p1 + yy], dv = sD[qy * p1 + yy];
      const T v0 = r0[yy * q], v1 = r1[yy * q];
      s0 += bv * v0;
      s1 += dv * v0;
      s2 += bv * v1;
    }
    s.b0[i] = s0;
    s.b1[i] = s1;
    s.b2[i] = s2;
  }
  __syncthreads();

  // z and the metric: g = (B_z b2, B_z b1, D_z b0), h = G g
  for (int i = tid; i < epb * Q; i += nt) {
    const int el = i / Q, k = i % Q;
    const long long e = elem_id(el);
    T h0 = T(0), h1 = T(0), h2 = T(0);
    if (e >= 0) {
      const int qxy = k % (q * q), qz = k / (q * q);
      const T* c0 = s.b0 + el * nb + qxy;
      const T* c1 = s.b1 + el * nb + qxy;
      const T* c2 = s.b2 + el * nb + qxy;
      T gx = T(0), gy = T(0), gz = T(0);
      for (int z = 0; z < p1; ++z) {
        const T bv = sB[qz * p1 + z], dv = sD[qz * p1 + z];
        gx += bv * c2[z * q * q];
        gy += bv * c1[z * q * q];
        gz += dv * c0[z * q * q];
      }
      const T* G = metric + e * 6 * Q + k;
      const T gxx = G[0], gxy = G[Q], gxz = G[2 * Q];
      const T gyy = G[3 * Q], gyz = G[4 * Q], gzz = G[5 * Q];
      h0 = gxx * gx + gxy * gy + gxz * gz;
      h1 = gxy * gx + gyy * gy + gyz * gz;
      h2 = gxz * gx + gyz * gy + gzz * gz;
    }
    s.hx[i] = h0;
    s.hy[i] = h1;
    s.hz[i] = h2;
  }
  __syncthreads();

  // z^T: b0 = B_z^T hx, b1 = B_z^T hy, b2 = D_z^T hz
  for (int i = tid; i < epb * nb; i += nt) {
    const int el = i / nb, k = i % nb;
    const int qxy = k % (q * q), z = k / (q * q);
    const T* c0 = s.hx + el * Q + qxy;
    const T* c1 = s.hy + el * Q + qxy;
    const T* c2 = s.hz + el * Q + qxy;
    T s0 = T(0), s1 = T(0), s2 = T(0);
    for (int qz = 0; qz < q; ++qz) {
      const T bv = sB[qz * p1 + z], dv = sD[qz * p1 + z];
      s0 += bv * c0[qz * q * q];
      s1 += bv * c1[qz * q * q];
      s2 += dv * c2[qz * q * q];
    }
    s.b0[i] = s0;
    s.b1[i] = s1;
    s.b2[i] = s2;
  }
  __syncthreads();

  // y^T: a0 = B_y^T b0 (then D_x), a1 = D_y^T b1 + B_y^T b2 (then B_x)
  for (int i = tid; i < epb * na; i += nt) {
    const int el = i / na, k = i % na;
    const int qx = k % q, yy = (k / q) % p1, z = k / (p1 * q);
    const T* r0 = s.b0 + el * nb + z * q * q + qx;
    const T* r1 = s.b1 + el * nb + z * q * q + qx;
    const T* r2 = s.b2 + el * nb + z * q * q + qx;
    T s0 = T(0), s1 = T(0);
    for (int qy = 0; qy < q; ++qy) {
      const T bv = sB[qy * p1 + yy], dv = sD[qy * p1 + yy];
      s0 += bv * r0[qy * q];
      s1 += dv * r1[qy * q] + bv * r2[qy * q];
    }
    s.a0[i] = s0;
    s.a1[i] = s1;
  }
  __syncthreads();
}

// x^T: the output value ye[el][k] at block-local index i = el * L + k,
// D_x^T a0 + B_x^T a1.
template <typename T>
__device__ inline T element_out(const Smem<T>& s, const Dims& d, int i) {
  const int el = i / d.L, k = i % d.L;
  const int x = k % d.p1, zy = k / d.p1;
  const T* r0 = s.a0 + el * d.na + zy * d.q;
  const T* r1 = s.a1 + el * d.na + zy * d.q;
  T v = T(0);
  for (int qx = 0; qx < d.q; ++qx) {
    v += s.sD[qx * d.p1 + x] * r0[qx] + s.sB[qx * d.p1 + x] * r1[qx];
  }
  return v;
}

}  // namespace lpfem
