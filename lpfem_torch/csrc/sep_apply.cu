// Banded Kronecker (separable) Laplace apply on the structured dof lattice.
//
// Replaces the Pallas TPU kernel lpfem/kernels/sep_apply.py::lattice_sep_apply
// (B1). On an axis-aligned tensor grid the assembled stiffness is exactly
//
//     A = Mz (x) My (x) Kx  +  Mz (x) Ky (x) Mx  +  Kz (x) My (x) Mx
//
// with 1D stiffness/mass factors of bandwidth p stored in diagonal-offset
// form, band[p + s][i] = G[i][i + s] (shape [2p+1, D], zero past the ends of a
// non-periodic axis, wrapping mod Dx on a periodic x axis). y = A x is seven
// banded axis contractions on the [Dz, Dy, Dx] lattice (x fastest):
//
//   x:  t1 = Kx u,            t2 = Mx u
//   y:  a  = My t1 + Ky t2,   b  = My t2
//   z:  y  = Mz a  + Kz b
//
// ess_top gives identity rows and columns on the top z-plane (the free-surface
// Dirichlet set): the x contraction reads that plane of u as zero, and y's top
// plane is x's.
//
// One launch per apply, no scratch in device memory, no atomics. A block owns
// the outputs of a Tx x Ty tile of (x, y) columns over the z-chunk
// [z0, z0 + Tz). It streams the chunk's input planes z0-p .. z0+Tz-1+p (the z
// halo is recomputed by the neighbouring chunk, not exchanged) and for each:
//
//   1. copies the plane's u rows (Ty+2p) x (Tx+2p) into shared memory with
//      cp.async, three planes in flight (plane z+2 is fetched while plane z
//      is contracted; 16-byte vectors where the tile's rows lie inside the
//      lattice and x is 16-byte aligned). x wraps on a periodic axis and reads zero past the ends
//      otherwise; y reads zero past the ends; under ess_top the top plane
//      reads zero;
//   2. contracts x into t1, t2 [(Ty+2p) x Tx] in shared memory;
//   3. contracts y: each thread owns one output column (x, y) and pushes its
//      a, b into a ring of the last 2p+1 planes held in its registers;
//   4. emits y for plane z-p from the ring (the z contraction).
//
// Every sum runs s = -p..p in order, as the plain PyTorch version
// (lpfem_torch.kernels.sep_apply.sep_apply_reference) does; nvcc's default
// FMA contraction makes the two differ in the last bits only. Two calls on
// one input give the same bits. Indices are 32-bit (the wrapper checks
// numel < 2^31); each thread decomposes its position once, not per tap.
//
// Orders. P is a template parameter for p = 1, 2, 4, the orders the port's
// paths run: the tap loops unroll, and each thread keeps the x bands of its
// column, the y bands of its row and the ring in registers. P = 0 is the
// general instantiation for 1 <= p <= 10: the same kernel with the loops
// unrolled to 21 taps under a guard, the x and y bands read through L1.
//
// Tiles (chosen by lpfem_torch.kernels.sep_apply.choose_tiles and passed in,
// with the block's shared-memory bytes; the entry refuses tiles past the
// launch bounds below, p past kMaxP, and bytes other than its own layout's):
// Tx = 8 columns in float, 4 in double (blocks of at most 288 / 160 threads,
// three per SM: the registers are capped at 75 / 136), Ty = the whole y axis
// where that fits (so the y halo is past the ends and never loaded),
// and Tz such that the grid has at least 264 blocks, two per SM. On the
// ss.cpp fine lattice (129 x 33 x 512, p = 4): float 8 x 33 x 26, 320
// blocks of 264 threads, 25 kB of shared memory per block (z halo
// recomputed: 1.31x the x and y work); double 4 x 33 x 43, 384 blocks of 132
// threads (1.19x), 25 kB. At p = 10 in double a block stays under 100 kB.
// The u row stride S is padded so that the rows a warp reads fall in
// distinct banks.
//
// What bounds it on an H100: an f32 apply at 2.18M dofs must move x and y
// once (17.4 MB, 5.2 us at 3.35 TB/s); its 7(2p+1) multiply-adds per dof are
// 0.27 GFLOP (4.1 us at 67 TFLOP/s). The kernel does not reach either: each
// block walks its ~34 planes in order, and each plane costs a round of
// copies, two barriers and three dependent chains of 2p+1 multiply-adds,
// with only ~27 warps per SM to hide them (more blocks per SM spill the
// ring and band registers). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 2): 0.0625 ms float, 0.1010 ms double at p = 4
// (the three passes it replaces: 0.1138 / 0.1296). PERF.md section 6.
//
// Plain C interface (one entry per dtype), built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// Each entry launches one kernel on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxP = 10;          // the general instantiation's reach

// Threads per block at most (Tx * Ty), and the blocks an SM must hold at
// once, which caps the registers: 3 x 288 float threads at <= 75, 3 x 160
// double threads at <= 136.
template <typename T>
constexpr int max_threads() { return sizeof(T) == 4 ? 288 : 160; }
constexpr int kMinBlocks = 3;
constexpr int kStages = 3;         // u planes in shared memory

// A block's shared memory, as byte offsets from its start: u [kStages][H][S],
// t1 and t2 [H][Tx] and the z bands [kStages][Mz | Kz][R] in T, then the row
// offsets [H] and the load offsets [H*W] in int. The wrapper's
// tile_smem_bytes computes the same total and passes it in.
template <typename T>
struct TileSmem {
  int t1, t2, zb, rowoff, src, total;
  __host__ __device__ TileSmem(int p, int Tx, int Ty, int S) {
    const int H = Ty + 2 * p, W = Tx + 2 * p;
    t1 = (int)sizeof(T) * kStages * H * S;
    t2 = t1 + (int)sizeof(T) * H * Tx;
    zb = t2 + (int)sizeof(T) * H * Tx;
    rowoff = zb + (int)sizeof(T) * kStages * 2 * (2 * p + 1);
    src = rowoff + (int)sizeof(int) * H;
    total = src + (int)sizeof(int) * H * W;
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(max_threads<T>(), kMinBlocks)
sep_tile_kernel(const T* __restrict__ x, T* __restrict__ y,
                const T* __restrict__ kx, const T* __restrict__ mx,
                const T* __restrict__ ky, const T* __restrict__ my,
                const T* __restrict__ kz, const T* __restrict__ mz, int Dx,
                int Dy, int Dz, int p_, int periodic_x, int ess_top, int Tx,
                int Ty, int Tz, int S) {
  constexpr int MR = P > 0 ? 2 * P + 1 : 2 * kMaxP + 1;   // register extents
  const int p = P > 0 ? P : p_;
  const int R = 2 * p + 1;
  const int W = Tx + 2 * p;            // u tile columns
  const int H = Ty + 2 * p;            // u and t tile rows
  const int plane = Dx * Dy;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = tid % Tx, ty = tid / Tx;
  const int x0 = blockIdx.x * Tx, y0 = blockIdx.y * Ty, z0 = blockIdx.z * Tz;
  const int gx = x0 + c, gy = y0 + ty;
  const bool col = ty < Ty && gx < Dx;        // runs the x contraction
  const bool out = col && gy < Dy;            // owns an output column
  const int zend = min(z0 + Tz, Dz);          // output planes [z0, zend)
  const int zlo = max(0, z0 - p), zhi = zend - 1 + p;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem<T> lay(p, Tx, Ty, S);
  T* ub = reinterpret_cast<T*>(smem_raw);            // u
  T* t1 = reinterpret_cast<T*>(smem_raw + lay.t1);
  T* t2 = reinterpret_cast<T*>(smem_raw + lay.t2);
  T* zb = reinterpret_cast<T*>(smem_raw + lay.zb);   // z bands
  int* rowoff = reinterpret_cast<int*>(smem_raw + lay.rowoff);
  int* src = reinterpret_cast<int*>(smem_raw + lay.src);  // plane offset or -1
  // whether the tile's rows lie inside the lattice (no wrap, no edge) and
  // are whole 16-byte vectors from a 16-byte aligned x: then they are
  // copied as such
  constexpr int kV = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && x0 - p >= 0 &&
                   x0 + Tx + p <= Dx && (x0 - p) % kV == 0 && W % kV == 0 &&
                   S % kV == 0 && Dx % kV == 0;

  // The tile's u values i = r * W + j (row r, column j): their offset in a
  // plane, or -1 outside the lattice (x wraps on a periodic axis).
  for (int i = tid; i < kStages * H * S + 2 * H * Tx; i += nt) ub[i] = T(0);
  for (int r = tid; r < H; r += nt) {
    const int g = y0 - p + r;
    rowoff[r] = (g >= 0 && g < Dy) ? g * Dx : -1;
  }
  for (int i = tid; i < H * W; i += nt) {
    const int r = i / W, j = i - r * W;
    const int gyr = y0 - p + r;
    int g = x0 - p + j;
    if (periodic_x) {
      g %= Dx;
      if (g < 0) g += Dx;
    } else if (g < 0 || g >= Dx) {
      g = -1;
    }
    src[i] = (g >= 0 && gyr >= 0 && gyr < Dy) ? gyr * Dx + g : -1;
  }
  // this thread's bands: x of its column, y of its row (fixed orders)
  T bkx[P > 0 ? MR : 1], bmx[P > 0 ? MR : 1];
  T bky[P > 0 ? MR : 1], bmy[P > 0 ? MR : 1];
  if constexpr (P > 0) {
#pragma unroll
    for (int k = 0; k < MR; ++k) {
      bkx[k] = col ? kx[k * Dx + gx] : T(0);
      bmx[k] = col ? mx[k * Dx + gx] : T(0);
      bky[k] = out ? ky[k * Dy + gy] : T(0);
      bmy[k] = out ? my[k * Dy + gy] : T(0);
    }
  }
  T ra[MR], rb[MR];                 // a, b of planes zo-p .. zo+p
#pragma unroll
  for (int k = 0; k < MR; ++k) {
    ra[k] = T(0);
    rb[k] = T(0);
  }

  // Asynchronous copies (cp.async) of plane z's u rows into stage buf, and
  // of the z bands of output plane z - p where the chunk emits it; one
  // commit group per plane, also when it copies nothing. The positions
  // outside the lattice keep the zeros written above; the top plane under
  // ess_top is filled with zeros.
  auto fetch = [&](int z, int buf) {
    if (z <= zhi && z < Dz && vec) {
      // interior tile: each u row is W/kV aligned 16-byte vectors
      const size_t zfill = (ess_top && z == Dz - 1) ? 16 : 0;
      T* dst = ub + buf * H * S;
      const T* xz = x + z * plane + x0 - p;
      const int nv = W / kV;
      for (int i = tid; i < H * nv; i += nt) {
        const int r = i / nv, v = i - r * nv;
        const int ro = rowoff[r];
        if (ro >= 0)
          __pipeline_memcpy_async(dst + r * S + v * kV, xz + ro + v * kV, 16,
                                  zfill);
      }
    } else if (z <= zhi && z < Dz) {
      const size_t zfill = (ess_top && z == Dz - 1) ? sizeof(T) : 0;
      T* dst = ub + buf * H * S;
      const T* xz = x + z * plane;
      int r = tid / W, j = tid - r * W;          // i = r * W + j
      const int dr = nt / W, dj = nt - dr * W;
      for (int i = tid; i < H * W; i += nt) {
        const int o = src[i];
        if (o >= 0)
          __pipeline_memcpy_async(dst + r * S + j, xz + o, sizeof(T), zfill);
        r += dr;
        j += dj;
        if (j >= W) {
          j -= W;
          ++r;
        }
      }
    }
    const int zo = z - p;
    if (zo >= z0 && zo < zend) {
      for (int k = tid; k < 2 * R; k += nt) {
        const T* band = (k < R ? mz + k * Dz : kz + (k - R) * Dz) + zo;
        __pipeline_memcpy_async(zb + buf * 2 * R + k, band, sizeof(T));
      }
    }
    __pipeline_commit();
  };

  __syncthreads();                  // zeros and offsets before any copy
  // planes zlo, zlo+1 in flight before the loop; plane z+2 is fetched while
  // plane z is contracted
  fetch(zlo, 0);
  fetch(zlo + 1, 1);
  __pipeline_wait_prior(1);
  __syncthreads();
  int cur = 0;
  for (int z = zlo; z <= zhi; ++z) {
    fetch(z + 2, cur == 0 ? 2 : cur - 1);
    T a = T(0), b = T(0);
    if (z < Dz) {                               // block-uniform
      const T* u = ub + cur * H * S;
      // x: t1 = Kx u, t2 = Mx u on the tile rows that lie in the lattice
      if (col) {
        for (int r = ty; r < H; r += Ty) {
          if (rowoff[r] < 0) continue;
          const T* ur = u + r * S + c;
          T s1 = T(0), s2 = T(0);
#pragma unroll
          for (int k = 0; k < MR; ++k) {
            if (k < R) {
              const T v = ur[k];
              if constexpr (P > 0) {
                s1 += bkx[k] * v;
                s2 += bmx[k] * v;
              } else {
                s1 += kx[k * Dx + gx] * v;
                s2 += mx[k * Dx + gx] * v;
              }
            }
          }
          t1[r * Tx + c] = s1;
          t2[r * Tx + c] = s2;
        }
      }
      __syncthreads();
      // y: a = My t1 + Ky t2, b = My t2 at this thread's column
      if (out) {
        T a1 = T(0), a2 = T(0);
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          if (k < R) {
            const T v1 = t1[(ty + k) * Tx + c], v2 = t2[(ty + k) * Tx + c];
            T cm, ck;
            if constexpr (P > 0) {
              cm = bmy[k];
              ck = bky[k];
            } else {
              cm = my[k * Dy + gy];
              ck = ky[k * Dy + gy];
            }
            a1 += cm * v1;
            a2 += ck * v2;
            b += cm * v2;
          }
        }
        a = a1 + a2;
      }
    }
    // push plane z (zero past the top) into the ring
#pragma unroll
    for (int k = 0; k < MR - 1; ++k) {
      if (k < R - 1) {
        ra[k] = ra[k + 1];
        rb[k] = rb[k + 1];
      }
    }
#pragma unroll
    for (int k = 0; k < MR; ++k) {
      if (k == R - 1) {
        ra[k] = a;
        rb[k] = b;
      }
    }
    // z: y = Mz a + Kz b for plane zo = z - p
    const int zo = z - p;
    if (zo >= z0 && out) {
      const int i = zo * plane + gy * Dx + gx;
      if (ess_top && zo == Dz - 1) {
        y[i] = x[i];
      } else {
        const T* bz = zb + cur * 2 * R;
        T ya = T(0), yb = T(0);
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          if (k < R) {
            ya += bz[k] * ra[k];
            yb += bz[R + k] * rb[k];
          }
        }
        y[i] = ya + yb;
      }
    }
    __pipeline_wait_prior(1);        // plane z+1 has landed
    __syncthreads();
    cur = cur == kStages - 1 ? 0 : cur + 1;
  }
}

template <typename T, int P>
int launch(const T* x, T* y, const T* kx, const T* mx, const T* ky,
           const T* my, const T* kz, const T* mz, int Dx, int Dy, int Dz,
           int p, int periodic_x, int ess_top, int Tx, int Ty, int Tz, int S,
           int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sep_tile_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Dx + Tx - 1) / Tx, (Dy + Ty - 1) / Ty, (Dz + Tz - 1) / Tz);
  const int threads = ((Tx * Ty + 31) / 32) * 32;
  sep_tile_kernel<T, P><<<grid, threads, smem, st>>>(
      x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p, periodic_x, ess_top, Tx,
      Ty, Tz, S);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* y, const void* kx, const void* mx,
             const void* ky, const void* my, const void* kz, const void* mz,
             int Dx, int Dy, int Dz, int p, int periodic_x, int ess_top,
             int Tx, int Ty, int Tz, int S, int smem, void* stream) {
  if (p < 1 || p > kMaxP || Tx < 1 || Ty < 1 || Tz < 1 ||
      Tx * Ty > max_threads<T>() || S < Tx + 2 * p ||
      (periodic_x && Dx <= 2 * p) || smem != TileSmem<T>(p, Tx, Ty, S).total)
    return (int)cudaErrorInvalidValue;
  if ((long long)Dx * Dy * Dz <= 0) return 0;
  const T* a[6] = {static_cast<const T*>(kx), static_cast<const T*>(mx),
                   static_cast<const T*>(ky), static_cast<const T*>(my),
                   static_cast<const T*>(kz), static_cast<const T*>(mz)};
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LPFEM_SEP_LAUNCH(PP)                                                 \
  launch<T, PP>(xx, yy, a[0], a[1], a[2], a[3], a[4], a[5], Dx, Dy, Dz, p,  \
                periodic_x, ess_top, Tx, Ty, Tz, S, smem, st)
  switch (p) {
    case 1: return LPFEM_SEP_LAUNCH(1);
    case 2: return LPFEM_SEP_LAUNCH(2);
    case 4: return LPFEM_SEP_LAUNCH(4);
    default: return LPFEM_SEP_LAUNCH(0);
  }
#undef LPFEM_SEP_LAUNCH
}

}  // namespace

extern "C" int sep_apply_f32(const void* x, void* y, const void* kx,
                             const void* mx, const void* ky, const void* my,
                             const void* kz, const void* mz, int Dx, int Dy,
                             int Dz, int p, int periodic_x, int ess_top,
                             int Tx, int Ty, int Tz, int S, int smem,
                             void* stream) {
  return dispatch<float>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p,
                         periodic_x, ess_top, Tx, Ty, Tz, S, smem, stream);
}

extern "C" int sep_apply_f64(const void* x, void* y, const void* kx,
                             const void* mx, const void* ky, const void* my,
                             const void* kz, const void* mz, int Dx, int Dy,
                             int Dz, int p, int periodic_x, int ess_top,
                             int Tx, int Ty, int Tz, int S, int smem,
                             void* stream) {
  return dispatch<double>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p,
                          periodic_x, ess_top, Tx, Ty, Tz, S, smem, stream);
}
