// The p-multigrid's Chebyshev coarse solve in one launch: z ~= A^-1 r on a
// p = 1 level of curved hexes (full metric, q = 2), from zero, degree k:
//
//     z = inv_diag r / theta,  d = z
//     k - 1 times:  y = A z  (identity rows and columns on the free surface)
//                   d = c1 d + c2 (inv_diag (r - y)),  z = z + d
//
// with c1 = rho_new rho and c2 = 2 rho_new / delta the coefficients of
// lpfem_torch.multigrid.ChebyshevSmoother, computed on the host in the same
// order. It replaces no TPU kernel: lpfem runs the coarse solve as eager
// XLA operations (lpfem/multigrid.py), and the port ran it as eager
// PyTorch, about 200 launches a solve (15 applies of gather, mask, B3b,
// fold and the essential copy, and the recurrence's elementwise operations).
//
// What bounds it on an H100: neither bytes nor operations. The cylinder's
// p = 1 level (4,224 elements, 8,730 dofs) moves 1.6 MB of float64 metric
// and does 15 x 4,224 x ~330 multiply-adds a solve; its eager form was set by
// the host's ~200 launches. Here it is one launch, and the limit is the
// latency of the 31 barriers and of the reads between blocks.
//
// Design: one thread-block cluster of C = 16 blocks (the non-portable size;
// the host checks at set-up that the card schedules it and raises where it
// does not). The host partitions the level once
// (lpfem_torch.kernels.coarse_cheb.partition): block b owns a contiguous
// range of elements and a set of dofs, the dofs ordered by their first
// holder element and cut into C equal ranges. Each block keeps in its shared
// memory, for every step:
//
// - z, r, d and inv_diag of its dofs;
// - its elements' E-vector ev [8][ne_max] (node-major, so that the lanes of
//   a warp touch consecutive words);
// - its elements' node addresses ea [8][ne_max] (owner rank << 20 | slot in
//   the owner's z; -1 on the free surface, which the constrained apply reads
//   as zero);
// - its dofs' fold table ft [m][nd_max] (holder rank << 20 | slot in the
//   holder's ev, in ascending element order as operators._fold_table; -1
//   pads; kEss in row 0 marks a free-surface dof, whose output is its input);
// - its elements' metric G6q [48][ne_max].
//
// A step is two phases with a cluster barrier after each. Elements: every
// thread takes one element, reads z at its 8 nodes from the owners' shared
// memory (distributed shared memory), applies the p = 1 element operator with
// the column body's sums (csrc/affine_body.cuh, FullMetric, P1 = Q = 2) in
// registers, and writes the element's ev. Dofs: every thread takes one dof,
// sums its copies from the holders' ev in ascending element order (no
// atomics: the result does not depend on scheduling), takes z on the free
// surface, and updates d and z with the smoother's expression, each
// operation rounded on its own as the eager tensors are (no contraction).
// z goes to device memory once, at the end. Nothing is allocated.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// The launch returns cudaGetLastError(); it does not synchronise.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;     // one element / one dof per thread
constexpr int kMaxSteps = 31;     // degree <= 32
constexpr int kNodes = 8;         // (p+1)^3 at p = 1
constexpr int kMetric = 48;       // 6 components x q^3 at q = 2
constexpr int kEss = -2;          // fold-table mark of a free-surface dof
constexpr int kRankShift = 20;    // address = rank << kRankShift | slot
constexpr int kSlotMask = (1 << kRankShift) - 1;

struct Coefs {
  double theta;
  double c1[kMaxSteps];
  double c2[kMaxSteps];
  int steps;                      // degree - 1
};

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
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
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
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}

// Bytes of one block's shared memory (lpfem_torch.kernels.coarse_cheb.
// smem_bytes computes the same): z, r, d, inv_diag [nd_max], ev [8][ne_max],
// the metric [48][ne_max], then ea [8][ne_max] and ft [m][nd_max]. nd_max is
// a multiple of 4, so every array starts 16-byte aligned.
inline size_t smem_bytes(size_t value_bytes, int ne_max, int nd_max, int m) {
  return value_bytes * ((size_t)4 * nd_max + (size_t)(kNodes + kMetric) *
                                                 ne_max) +
         sizeof(int) * ((size_t)kNodes * ne_max + (size_t)m * nd_max);
}

// Copy n bytes (a multiple of 16, both ends 16-byte aligned) from device to
// shared memory with cp.async, the block's threads in turn.
__device__ __forceinline__ void copy16(void* dst, const void* src, size_t n) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (size_t i = (size_t)threadIdx.x * 16; i < n; i += (size_t)kThreads * 16)
    __pipeline_memcpy_async(d + i, s + i, 16);
}

// The p = 1, q = 2 element operator with the full metric: ye = Jr2^T
// (G o (Jr2 u)), u and ye [z][y][x], g the element's metric at
// g[(c * 8 + k) * stride] (component c, Gauss point k = (qz*2 + qy)*2 + qx).
// The sums of affine_body.cuh's column body at P1 = Q = 2, in its order:
// x forward; per (qy, qx) column y forward, z forward, the metric, z back;
// y back; x back.
template <typename T>
__device__ __forceinline__ void element_p1(const T (&u)[kNodes],
                                           const T* __restrict__ g,
                                           int stride, const T (&B)[2][2],
                                           const T (&D)[2][2],
                                           T (&ye)[kNodes]) {
  T s1[2][2][2], s2[2][2][2];               // [z][y][qx]: B_x u, D_x u
#pragma unroll
  for (int z = 0; z < 2; ++z) {
#pragma unroll
    for (int y = 0; y < 2; ++y) {
#pragma unroll
      for (int qx = 0; qx < 2; ++qx) {
        T v0 = T(0), v1 = T(0);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          v0 += B[qx][x] * u[(z * 2 + y) * 2 + x];
          v1 += D[qx][x] * u[(z * 2 + y) * 2 + x];
        }
        s1[z][y][qx] = v0;
        s2[z][y][qx] = v1;
      }
    }
  }
  T c0[2][2][2], c1[2][2][2], c2[2][2][2];  // [z][qy][qx] after z back
#pragma unroll
  for (int qy = 0; qy < 2; ++qy) {
#pragma unroll
    for (int qx = 0; qx < 2; ++qx) {
      T a0[2], a1[2], a2[2];
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        T g0 = T(0), g1 = T(0), g2 = T(0);
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const T vb = s1[z][y][qx];
          const T vd = s2[z][y][qx];
          g0 += B[qy][y] * vd;                   // B_y D_x
          g1 += D[qy][y] * vb;                   // D_y B_x
          g2 += B[qy][y] * vb;                   // B_y B_x
        }
        a0[z] = g0;
        a1[z] = g1;
        a2[z] = g2;
      }
      T b0[2] = {T(0), T(0)}, b1[2] = {T(0), T(0)}, b2[2] = {T(0), T(0)};
#pragma unroll
      for (int qz = 0; qz < 2; ++qz) {
        T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          gx += B[qz][z] * a0[z];
          gy += B[qz][z] * a1[z];
          gz += D[qz][z] * a2[z];
        }
        const int k = (qz * 2 + qy) * 2 + qx;
        const T gxx = g[(0 * 8 + k) * stride], gxy = g[(1 * 8 + k) * stride];
        const T gxz = g[(2 * 8 + k) * stride], gyy = g[(3 * 8 + k) * stride];
        const T gyz = g[(4 * 8 + k) * stride], gzz = g[(5 * 8 + k) * stride];
        const T h0 = gxx * gx + gxy * gy + gxz * gz;
        const T h1 = gxy * gx + gyy * gy + gyz * gz;
        const T h2 = gxz * gx + gyz * gy + gzz * gz;
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          b0[z] += B[qz][z] * h0;
          b1[z] += B[qz][z] * h1;
          b2[z] += D[qz][z] * h2;
        }
      }
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        c0[z][qy][qx] = b0[z];
        c1[z][qy][qx] = b1[z];
        c2[z][qy][qx] = b2[z];
      }
    }
  }
#pragma unroll
  for (int z = 0; z < 2; ++z) {
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      T t0[2], t1[2];                            // [qx]
#pragma unroll
      for (int qx = 0; qx < 2; ++qx) {
        T v0 = T(0), v1 = T(0);
#pragma unroll
        for (int qy = 0; qy < 2; ++qy) {
          v0 += B[qy][y] * c0[z][qy][qx];
          v1 += D[qy][y] * c1[z][qy][qx] + B[qy][y] * c2[z][qy][qx];
        }
        t0[qx] = v0;
        t1[qx] = v1;
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        T v = T(0);
#pragma unroll
        for (int qx = 0; qx < 2; ++qx)
          v += D[qx][x] * t0[qx] + B[qx][x] * t1[qx];
        ye[(z * 2 + y) * 2 + x] = v;
      }
    }
  }
}

// Block b's slices: g6b [C][48][ne_max], ea [C][8][ne_max], ft [C][m][nd_max],
// gdof and invd [C][nd_max], counts [C][2] (elements, dofs); r, z [n_dofs].
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
coarse_cheb_kernel(const T* __restrict__ g6b, const int* __restrict__ eaddr,
                   const int* __restrict__ ftab, const int* __restrict__ gdof,
                   const T* __restrict__ invd, const int* __restrict__ counts,
                   const T* __restrict__ r, const T* __restrict__ bmat,
                   const T* __restrict__ dmat, T* __restrict__ z_out,
                   int ne_max, int nd_max, int m, Coefs cf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int ne = counts[2 * b], nd = counts[2 * b + 1];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);
  T* rs = zs + nd_max;
  T* ds = rs + nd_max;
  T* is = ds + nd_max;
  T* ev = is + nd_max;
  T* gs = ev + kNodes * ne_max;
  int* ea = reinterpret_cast<int*>(gs + kMetric * ne_max);
  int* ft = ea + kNodes * ne_max;

  copy16(ea, eaddr + (size_t)b * kNodes * ne_max,
         sizeof(int) * kNodes * ne_max);
  copy16(ft, ftab + (size_t)b * m * nd_max, sizeof(int) * m * nd_max);
  copy16(is, invd + (size_t)b * nd_max, sizeof(T) * nd_max);
  copy16(gs, g6b + (size_t)b * kMetric * ne_max, sizeof(T) * kMetric * ne_max);
  __pipeline_commit();

  T B[2][2], D[2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    B[i / 2][i % 2] = __ldg(bmat + i);
    D[i / 2][i % 2] = __ldg(dmat + i);
  }
  const int* gd = gdof + (size_t)b * nd_max;
  for (int i = tid; i < nd; i += kThreads) rs[i] = __ldg(r + gd[i]);
  __pipeline_wait_prior(0);
  __syncthreads();
  // the first step: z = inv_diag r / theta, d = z
  const T theta = T(cf.theta);
  for (int i = tid; i < nd; i += kThreads) {
    const T z0 = div_rn(mul_rn(is[i], rs[i]), theta);
    zs[i] = z0;
    ds[i] = z0;
  }
  cluster.sync();      // every block's z written, every block running

  for (int step = 0; step < cf.steps; ++step) {
    // elements: ev = the element operator on z at the element's nodes,
    // zero on the free surface
    for (int el = tid; el < ne; el += kThreads) {
      T u[kNodes], ye[kNodes];
#pragma unroll
      for (int j = 0; j < kNodes; ++j) {
        const int a = ea[j * ne_max + el];
        if (a < 0) {
          u[j] = T(0);
        } else {
          const int rank = a >> kRankShift, slot = a & kSlotMask;
          u[j] = rank == b ? zs[slot]
                           : cluster.map_shared_rank(zs, rank)[slot];
        }
      }
      element_p1<T>(u, gs + el, ne_max, B, D, ye);
#pragma unroll
      for (int j = 0; j < kNodes; ++j) ev[j * ne_max + el] = ye[j];
    }
    cluster.sync();    // every ev written; z no longer read this step

    // dofs: y = the fold of the holders' ev (z on the free surface), then
    // d = c1 d + c2 (inv_diag (r - y)), z = z + d
    const T c1 = T(cf.c1[step]), c2 = T(cf.c2[step]);
    for (int i = tid; i < nd; i += kThreads) {
      T y;
      if (ft[i] == kEss) {
        y = zs[i];
      } else {
        y = T(0);
        for (int j = 0; j < m; ++j) {
          const int a = ft[j * nd_max + i];
          if (a < 0) break;
          const int rank = a >> kRankShift, slot = a & kSlotMask;
          y = add_rn(y, rank == b ? ev[slot]
                                  : cluster.map_shared_rank(ev, rank)[slot]);
        }
      }
      const T dn = add_rn(mul_rn(c1, ds[i]),
                          mul_rn(c2, mul_rn(is[i], sub_rn(rs[i], y))));
      ds[i] = dn;
      zs[i] = add_rn(zs[i], dn);
    }
    cluster.sync();    // every z updated; ev no longer read this step
  }
  for (int i = tid; i < nd; i += kThreads) z_out[gd[i]] = zs[i];
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                    int cluster, size_t smem, cudaStream_t st) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <typename T>
int active_clusters(int cluster, size_t smem, int* out) {
  auto kernel = coarse_cheb_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, cluster, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

template <typename T>
int launch(const void* g6b, const void* eaddr, const void* ftab,
           const void* gdof, const void* invd, const void* counts,
           const void* r, const void* bmat, const void* dmat, void* z,
           const Coefs& cf, int cluster, int ne_max, int nd_max, int m,
           size_t smem, cudaStream_t st) {
  auto kernel = coarse_cheb_kernel<T>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, cluster, smem, st);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(g6b), static_cast<const int*>(eaddr),
      static_cast<const int*>(ftab), static_cast<const int*>(gdof),
      static_cast<const T*>(invd), static_cast<const int*>(counts),
      static_cast<const T*>(r), static_cast<const T*>(bmat),
      static_cast<const T*>(dmat), static_cast<T*>(z), ne_max, nd_max, m, cf);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool shape_ok(int cluster, int ne_max, int nd_max, int m) {
  return cluster >= 1 && cluster <= 16 && ne_max >= 1 && nd_max >= 4 &&
         nd_max % 4 == 0 && m >= 1 && (size_t)kNodes * ne_max <= kSlotMask &&
         nd_max <= kSlotMask;
}

template <typename T>
int clusters_entry(int cluster, int ne_max, int nd_max, int m, int* out) {
  *out = 0;
  if (!shape_ok(cluster, ne_max, nd_max, m)) return (int)cudaErrorInvalidValue;
  return active_clusters<T>(cluster, smem_bytes(sizeof(T), ne_max, nd_max, m),
                            out);
}

template <typename T>
int solve_entry(const void* g6b, const void* eaddr, const void* ftab,
                const void* gdof, const void* invd, const void* counts,
                const void* r, const void* bmat, const void* dmat, void* z,
                const double* coefs, int steps, int cluster, int ne_max,
                int nd_max, int m, void* stream) {
  if (!shape_ok(cluster, ne_max, nd_max, m) || steps < 0 ||
      steps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  Coefs cf{};
  cf.theta = coefs[0];
  cf.steps = steps;
  for (int k = 0; k < steps; ++k) {
    cf.c1[k] = coefs[1 + k];
    cf.c2[k] = coefs[1 + steps + k];
  }
  return launch<T>(g6b, eaddr, ftab, gdof, invd, counts, r, bmat, dmat, z, cf,
                   cluster, ne_max, nd_max, m,
                   smem_bytes(sizeof(T), ne_max, nd_max, m),
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// How many clusters of `cluster` blocks of this layout the card can hold at
// once (0: it cannot schedule one); returns the CUDA error.
extern "C" int coarse_cheb_clusters_f32(int cluster, int ne_max, int nd_max,
                                        int m, int* out) {
  return clusters_entry<float>(cluster, ne_max, nd_max, m, out);
}

extern "C" int coarse_cheb_clusters_f64(int cluster, int ne_max, int nd_max,
                                        int m, int* out) {
  return clusters_entry<double>(cluster, ne_max, nd_max, m, out);
}

// One coarse solve: coefs = (theta, c1[0..steps), c2[0..steps)) on the host.
extern "C" int coarse_cheb_f32(const void* g6b, const void* eaddr,
                               const void* ftab, const void* gdof,
                               const void* invd, const void* counts,
                               const void* r, const void* bmat,
                               const void* dmat, void* z, const double* coefs,
                               int steps, int cluster, int ne_max, int nd_max,
                               int m, void* stream) {
  return solve_entry<float>(g6b, eaddr, ftab, gdof, invd, counts, r, bmat,
                            dmat, z, coefs, steps, cluster, ne_max, nd_max, m,
                            stream);
}

extern "C" int coarse_cheb_f64(const void* g6b, const void* eaddr,
                               const void* ftab, const void* gdof,
                               const void* invd, const void* counts,
                               const void* r, const void* bmat,
                               const void* dmat, void* z, const double* coefs,
                               int steps, int cluster, int ne_max, int nd_max,
                               int m, void* stream) {
  return solve_entry<double>(g6b, eaddr, ftab, gdof, invd, counts, r, bmat,
                             dmat, z, coefs, steps, cluster, ne_max, nd_max,
                             m, stream);
}
