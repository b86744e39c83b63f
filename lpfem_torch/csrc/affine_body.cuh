// The column element body of the element kernels, B2 (lattice_apply.cu),
// B3a and B3b (pa_apply.cu): for every element e of a block,
//
//     ye = Jr2^T ( G[e] o (Jr2 u) ),   Jr2 = [B(x)B(x)D; B(x)D(x)B; D(x)B(x)B]
//
// with u [(p+1)^3] the element's values (z, y, x; x fastest), B and D
// [q, p+1] the 1D basis values and derivatives at the Gauss points, and G[e]
// the symmetric 3x3 metric at each Gauss point, components (xx, xy, xz, yy,
// yz, zz). The metric is a policy of apply_elements:
//
// - AffineMetric (B2, B3a): G[e] at point k is w3[k] C6[e], the six constants
//   of element e in registers and the Gauss-weight products w3 in shared
//   memory;
// - FullMetric (B3b): the six values G6q[e, c*Q + k] (Q = q^3, k = (qz*q +
//   qy)*q + qx) read per point from device memory. The lanes of an element
//   read consecutive (qy, qx) of one component, so each read is coalesced and
//   the metric, the bytes that bound B3b, is streamed exactly once.
//
// Designed for Hopper, after MFEM's 3-D partial-assembly diffusion kernels:
//
// - Fixed orders. P1 = p+1 and Q = q are template parameters; every loop
//   unrolls and every shared-memory index is a compile-time stride. P1 = Q =
//   kGeneral (n = max(p+1, q) <= 8) and P1 = Q = kWide (9 <= n <= 11, the
//   orders p = 8..10) are the general instantiations: the orders come at run
//   time, the loops unroll to the instantiation's reach (extent<P>()) with a
//   guard, so the register arrays keep compile-time indices there too. Two
//   of them, so that the orders up to 8 keep the register budget they had;
//   at n = 11 the column's 11-value arrays spill in double (nvcc -Xptxas -v,
//   chip_smoke.py phase 1), and the tiles of a double block need more than
//   48 KB of shared memory (launch_smem).
// - Columns, with z in registers. One thread owns one (x, y) column of an
//   element, n = max(p+1, q) by n threads per element. The z contractions,
//   forward and back, and the metric at every Gauss point run in registers;
//   only the x and y contractions exchange values, through five small
//   shared-memory tiles per element.
// - An element inside one warp. Where n^2 <= 32 (every fixed order, p <= 4)
//   floor(32 / n^2) elements share a warp (1 at p = 4, 3 at p = 2, 8 at
//   p = 1) and every exchange needs only __syncwarp: the body has no block
//   barrier. The general instantiations give an element one to four whole
//   warps and sync the block.
// - Tables. B, D and w3 (a few hundred bytes) are loaded into shared memory
//   once per block, behind the block's only __syncthreads, and read as
//   broadcasts.
//
// Exact in its dtype: plain fused multiply-adds in float or double, no
// tensor cores. The caller gives a loader, load.element(e) -> u with
// u(x, y, z, i) the element's value at local node i = (z*(p+1) + y)*(p+1)
// + x, and a storer, store.element(e) -> out with out(i, value). The lanes
// of an element load and store consecutive i (coalesced where the E-vector
// is).

#pragma once

#include <cuda_runtime.h>

namespace lpfem {
namespace affine {

constexpr int kThreads = 128;   // threads per block
constexpr int kMaxN = 11;       // p+1 <= 11 and q <= 11 (p <= 10)
constexpr int kGeneralN = 8;    // the reach of the first general instantiation
constexpr int kBufs = 5;        // exchange tiles per element

// Template orders (P1 = Q) of the two general instantiations.
constexpr int kGeneral = 0;     // max(p+1, q) <= kGeneralN
constexpr int kWide = -1;       // kGeneralN < max(p+1, q) <= kMaxN

// The register extent of template order P.
template <int P>
__host__ __device__ constexpr int extent() {
  return P > 0 ? P : (P == kGeneral ? kGeneralN : kMaxN);
}

inline bool orders_ok(int p1, int q) {
  return p1 >= 2 && p1 <= kMaxN && q >= 1 && q <= kMaxN;
}

// The template orders a launch of (p+1, q) takes: fixed (P1 = Q = p+1) for
// q = p+1 <= 5, else the general instantiation whose reach holds them.
inline int template_orders(int p1, int q) {
  if (q == p1 && p1 >= 2 && p1 <= 5) return p1;
  return (p1 > q ? p1 : q) <= kGeneralN ? kGeneral : kWide;
}

// Whether template orders (P1, Q) keep an element inside one warp.
template <int P1, int Q>
__host__ __device__ constexpr bool warp_resident() {
  return P1 > 0 && Q > 0 && (P1 > Q ? P1 : Q) * (P1 > Q ? P1 : Q) <= 32;
}

// Elements per block: warp-resident, floor(32 / n^2) per warp; else one
// element per 32 * ceil(n^2 / 32) threads.
__host__ __device__ inline int elems_per_block(bool warp, int p1, int q) {
  const int n = p1 > q ? p1 : q;
  if (warp) return (kThreads / 32) * (32 / (n * n));
  return kThreads / (((n * n + 31) / 32) * 32);
}

// Dynamic shared memory of one block: the tables and the element tiles.
inline size_t smem_bytes(size_t value_bytes, int p1, int q, int epb) {
  const int n = p1 > q ? p1 : q;
  return value_bytes *
         (size_t)(2 * q * p1 + q * q * q + epb * kBufs * p1 * n * n);
}

// Allow `kernel` the dynamic shared memory `bytes` (above the default 48 KB
// only after this call: one double element at p+1 = q = 11 takes 65,824
// bytes); returns the CUDA error.
template <typename Kernel>
inline cudaError_t launch_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// An E-vector [ne, L] (L = (p+1)^3) as a loader or a storer of
// apply_elements: element e's row.
template <typename T>
struct RowIn {
  const T* __restrict__ u;
  __device__ T operator()(int, int, int, int i) const { return u[i]; }
};

template <typename T>
struct RowsIn {
  const T* __restrict__ u;
  int L;
  __device__ RowIn<T> element(long long e) const {
    return RowIn<T>{u + e * L};
  }
};

template <typename T>
struct RowOut {
  T* __restrict__ y;
  __device__ void operator()(int i, T v) const { y[i] = v; }
};

template <typename T>
struct RowsOut {
  T* __restrict__ y;
  int L;
  __device__ RowOut<T> element(long long e) const {
    return RowOut<T>{y + e * L};
  }
};

// The metric policies: element(e, valid) gives a functor that maps the
// reference gradient (gx, gy, gz) at Gauss point k = (qz*q + qy)*q + qx to
// h = G g; weights() is the table apply_elements copies into shared memory
// (sW, passed back to the functor), or nullptr.
template <typename T>
struct AffineAt {
  T C[6];
  __device__ __forceinline__ void operator()(int k, const T* sW, T gx, T gy,
                                             T gz, T& h0, T& h1,
                                             T& h2) const {
    const T w = sW[k];
    h0 = (C[0] * gx + C[1] * gy + C[2] * gz) * w;
    h1 = (C[1] * gx + C[3] * gy + C[4] * gz) * w;
    h2 = (C[2] * gx + C[4] * gy + C[5] * gz) * w;
  }
};

template <typename T>
struct AffineMetric {
  const T* __restrict__ c6;   // [ne, 6]
  const T* __restrict__ w3;   // [q^3]
  __device__ const T* weights() const { return w3; }
  __device__ AffineAt<T> element(long long e, bool valid) const {
    AffineAt<T> at;
#pragma unroll
    for (int k = 0; k < 6; ++k) at.C[k] = valid ? c6[e * 6 + k] : T(0);
    return at;
  }
};

template <typename T>
struct FullAt {
  const T* __restrict__ g;    // element e's row of G6q
  int nq;                      // q^3
  bool valid;
  __device__ __forceinline__ void operator()(int k, const T*, T gx, T gy,
                                             T gz, T& h0, T& h1,
                                             T& h2) const {
    if (!valid) {
      h0 = h1 = h2 = T(0);
      return;
    }
    const T gxx = __ldg(g + k), gxy = __ldg(g + nq + k);
    const T gxz = __ldg(g + 2 * nq + k), gyy = __ldg(g + 3 * nq + k);
    const T gyz = __ldg(g + 4 * nq + k), gzz = __ldg(g + 5 * nq + k);
    h0 = gxx * gx + gxy * gy + gxz * gz;
    h1 = gxy * gx + gyy * gy + gyz * gz;
    h2 = gxz * gx + gyz * gy + gzz * gz;
  }
};

template <typename T>
struct FullMetric {
  const T* __restrict__ g6;   // [ne, 6 q^3], component-major
  int nq;                      // q^3
  __device__ const T* weights() const { return nullptr; }
  __device__ FullAt<T> element(long long e, bool valid) const {
    return FullAt<T>{valid ? g6 + e * 6 * nq : g6, nq, valid};
  }
};

template <bool kWarp>
__device__ __forceinline__ void sync_element() {
  if constexpr (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The block's elements blockIdx.x * epb + el, el < epb, while e < ne.
// Launch with kThreads threads and smem_bytes(sizeof(T), ...) of dynamic
// shared memory.
template <typename T, int P1, int Q, typename Metric, typename Load,
          typename Store>
__device__ __forceinline__ void apply_elements(
    int p1_, int q_, long long ne, const Metric& metric,
    const T* __restrict__ bmat, const T* __restrict__ dmat, const Load& load,
    const Store& store) {
  constexpr bool kWarp = warp_resident<P1, Q>();
  constexpr int MP = extent<P1>();             // register extents
  constexpr int MQ = extent<Q>();
  const int p1 = P1 > 0 ? P1 : p1_;
  const int q = Q > 0 ? Q : q_;
  const int n = p1 > q ? p1 : q;
  const int nc = n * n;                        // columns per element
  const int L = p1 * p1 * p1;
  const int tid = threadIdx.x;

  int el, c;
  bool active;
  if constexpr (kWarp) {
    constexpr int kNC = (P1 > Q ? P1 : Q) * (P1 > Q ? P1 : Q);
    constexpr int kEPW = 32 / kNC;
    const int lane = tid & 31, slot = lane / kNC;
    el = (tid >> 5) * kEPW + slot;
    c = lane - slot * kNC;
    active = slot < kEPW;
  } else {
    const int tpe = ((nc + 31) / 32) * 32;
    el = tid / tpe;
    c = tid - el * tpe;
    // at n = 9 a block holds one element of 96 threads: the last warp idles
    active = c < nc && el < kThreads / tpe;
  }
  const long long e =
      (long long)blockIdx.x * elems_per_block(kWarp, p1, q) + el;
  const bool valid = active && e < ne;
  const int tx = c % n, ty = c / n;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);      // [q][p1]
  T* sD = sB + q * p1;                          // [q][p1]
  T* sW = sD + q * p1;                          // [q][q][q]
  const int tile = p1 * nc;
  T* s0 = sW + q * q * q + (active ? el : 0) * kBufs * tile;
  T* s1 = s0 + tile;
  T* s2 = s1 + tile;
  T* s3 = s2 + tile;
  T* s4 = s3 + tile;

  for (int i = tid; i < q * p1; i += blockDim.x) {
    sB[i] = bmat[i];
    sD[i] = dmat[i];
  }
  if (const T* w3 = metric.weights()) {
    for (int i = tid; i < q * q * q; i += blockDim.x) sW[i] = w3[i];
  }
  const auto at = metric.element(e, valid);
  __syncthreads();

  // u -> s0 [z][y][x]
  if (valid) {
    const auto u = load.element(e);
    for (int i = c; i < L; i += nc) {
      const int x = i % p1, y = (i / p1) % p1, z = i / (p1 * p1);
      s0[i] = u(x, y, z, i);
    }
  } else if (active) {
    for (int i = c; i < L; i += nc) s0[i] = T(0);
  }
  sync_element<kWarp>();

  // x: s1 = B_x u, s2 = D_x u      [z][y][qx], thread (qx, y)
  if (active && tx < q && ty < p1) {
    T bx[MP], dx[MP];
#pragma unroll
    for (int x = 0; x < MP; ++x) {
      if (x < p1) {
        bx[x] = sB[tx * p1 + x];
        dx[x] = sD[tx * p1 + x];
      }
    }
#pragma unroll
    for (int z = 0; z < MP; ++z) {
      if (z < p1) {
        const T* ur = s0 + (z * p1 + ty) * p1;
        T v0 = T(0), v1 = T(0);
#pragma unroll
        for (int x = 0; x < MP; ++x) {
          if (x < p1) {
            v0 += bx[x] * ur[x];
            v1 += dx[x] * ur[x];
          }
        }
        s1[(z * p1 + ty) * q + tx] = v0;
        s2[(z * p1 + ty) * q + tx] = v1;
      }
    }
  }
  sync_element<kWarp>();

  // Thread (qx, qy): y forward, then z forward, the metric and z back in
  // registers; the results to s0, s3, s4 [z][qy][qx] (s0 is free since the
  // last sync, s3 and s4 unused so far).
  if (active && tx < q && ty < q) {
    T a0[MP], a1[MP], a2[MP], by[MP], dy[MP];
#pragma unroll
    for (int y = 0; y < MP; ++y) {
      if (y < p1) {
        by[y] = sB[ty * p1 + y];
        dy[y] = sD[ty * p1 + y];
      }
    }
#pragma unroll
    for (int z = 0; z < MP; ++z) {
      if (z < p1) {
        T g0 = T(0), g1 = T(0), g2 = T(0);
#pragma unroll
        for (int y = 0; y < MP; ++y) {
          if (y < p1) {
            const T vb = s1[(z * p1 + y) * q + tx];    // B_x u
            const T vd = s2[(z * p1 + y) * q + tx];    // D_x u
            g0 += by[y] * vd;                          // B_y D_x
            g1 += dy[y] * vb;                          // D_y B_x
            g2 += by[y] * vb;                          // B_y B_x
          }
        }
        a0[z] = g0;
        a1[z] = g1;
        a2[z] = g2;
      }
    }
    T b0[MP], b1[MP], b2[MP];
#pragma unroll
    for (int z = 0; z < MP; ++z) {
      b0[z] = T(0);
      b1[z] = T(0);
      b2[z] = T(0);
    }
#pragma unroll
    for (int qz = 0; qz < MQ; ++qz) {
      if (qz < q) {
        T bz[MP], dz[MP];          // row qz of B and D, read once
        T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
        for (int z = 0; z < MP; ++z) {
          if (z < p1) {
            bz[z] = sB[qz * p1 + z];
            dz[z] = sD[qz * p1 + z];
            gx += bz[z] * a0[z];
            gy += bz[z] * a1[z];
            gz += dz[z] * a2[z];
          }
        }
        T h0, h1, h2;
        at((qz * q + ty) * q + tx, sW, gx, gy, gz, h0, h1, h2);
#pragma unroll
        for (int z = 0; z < MP; ++z) {
          if (z < p1) {
            b0[z] += bz[z] * h0;
            b1[z] += bz[z] * h1;
            b2[z] += dz[z] * h2;
          }
        }
      }
    }
#pragma unroll
    for (int z = 0; z < MP; ++z) {
      if (z < p1) {
        s0[(z * q + ty) * q + tx] = b0[z];
        s3[(z * q + ty) * q + tx] = b1[z];
        s4[(z * q + ty) * q + tx] = b2[z];
      }
    }
  }
  sync_element<kWarp>();

  // y back: s1 = B_y^T s0 (then D_x), s2 = D_y^T s3 + B_y^T s4 (then B_x)
  // [z][y][qx], thread (qx, y); s1 and s2 were last read before the last
  // sync.
  if (active && tx < q && ty < p1) {
    T by[MQ], dy[MQ];
#pragma unroll
    for (int qy = 0; qy < MQ; ++qy) {
      if (qy < q) {
        by[qy] = sB[qy * p1 + ty];
        dy[qy] = sD[qy * p1 + ty];
      }
    }
#pragma unroll
    for (int z = 0; z < MP; ++z) {
      if (z < p1) {
        T t0 = T(0), t1 = T(0);
#pragma unroll
        for (int qy = 0; qy < MQ; ++qy) {
          if (qy < q) {
            const int k = (z * q + qy) * q + tx;
            t0 += by[qy] * s0[k];
            t1 += dy[qy] * s3[k] + by[qy] * s4[k];
          }
        }
        s1[(z * p1 + ty) * q + tx] = t0;
        s2[(z * p1 + ty) * q + tx] = t1;
      }
    }
  }
  sync_element<kWarp>();

  // x back: ye = D_x^T s1 + B_x^T s2 -> s0 [z][y][x], thread (x, y)
  if (active && tx < p1 && ty < p1) {
    T bx[MQ], dx[MQ];
#pragma unroll
    for (int qx = 0; qx < MQ; ++qx) {
      if (qx < q) {
        bx[qx] = sB[qx * p1 + tx];
        dx[qx] = sD[qx * p1 + tx];
      }
    }
#pragma unroll
    for (int z = 0; z < MP; ++z) {
      if (z < p1) {
        const T* r0 = s1 + (z * p1 + ty) * q;
        const T* r1 = s2 + (z * p1 + ty) * q;
        T v = T(0);
#pragma unroll
        for (int qx = 0; qx < MQ; ++qx) {
          if (qx < q) v += dx[qx] * r0[qx] + bx[qx] * r1[qx];
        }
        s0[(z * p1 + ty) * p1 + tx] = v;
      }
    }
  }
  sync_element<kWarp>();

  if (valid) {
    const auto out = store.element(e);
    for (int i = c; i < L; i += nc) out(i, s0[i]);
  }
}

}  // namespace affine
}  // namespace lpfem
