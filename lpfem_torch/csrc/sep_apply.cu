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
// A Dirichlet plane zt (the top z-plane of one lattice under ess_top, -1 for
// none) gives identity rows and columns there: the x contraction reads that
// plane of u as zero, and y's plane zt is x's.
//
// Shard mode (the port of the TPU kernel's shard_scal / p0 mode, which
// lpfem.shard runs on every window level): the launch covers ndev z-slab
// windows stacked on a leading axis, x and y rows of ys >= Dz*Dx*Dy values
// (lanes past the window are written 0), each window with its own z bands
// (assembled from the slab's own element layers, zero on padding layers)
// and its row of scal = (zt, own0): zt the local Dirichlet plane or -1, own0
// whether the shard owns its window's plane 0. When own0 is 0, plane 0 reads
// the exchanged halo plane p0 instead of x, and its outputs go to yhalo with
// y's plane 0 set to 0; otherwise yhalo is 0. On a padded slab zt lies below
// the window's top: the planes above it have zero bands and produce 0. The
// windows' blocks form one grid (the z-chunks sized for all of them), so an
// apply over every shard is one launch; rows of N_max+1 values leave shards
// 1..ndev-1 off 16-byte alignment, and their tiles take the 4- or 8-byte
// copies. Times: PERF.md section 6 (chip_smoke.py phase 9a).
//
// One launch per apply, no scratch in device memory, no atomics. A block owns
// the outputs of a Tx x Ty tile of (x, y) columns over the z-chunk
// [z0, z0 + Tz). It streams the chunk's input planes z0-p .. z0+Tz-1+p (the z
// halo is recomputed by the neighbouring chunk, not exchanged) and for each:
//
//   1. copies the plane's u rows (Ty+2p) x (Tx+2p) into shared memory with
//      cp.async, three planes in flight (plane z+2 is fetched while plane z
//      is contracted; 16-byte vectors where the tile's rows lie inside the
//      lattice and the plane is 16-byte aligned). x wraps on a periodic axis
//      and reads zero past the ends otherwise; y reads zero past the ends;
//      the Dirichlet plane reads zero;
//   2. contracts x into t1, t2 [(Ty+2p) x Tx] in shared memory;
//   3. contracts y: each thread owns one output column (x, y) and pushes its
//      a, b into a ring of the last 2p+1 planes held in its registers;
//   4. emits y for plane z-p from the ring (the z contraction).
//
// Every sum runs s = -p..p in order, as the plain PyTorch version
// (lpfem_torch.kernels.sep_apply.sep_apply_reference) does; nvcc's default
// FMA contraction makes the two differ in the last bits only (the
// tensor-core route: DMMA's order). Two calls on one input give the same
// bits. Indices are 32-bit (the wrapper checks numel < 2^31); each thread
// decomposes its position once, not per tap.
//
// Orders. P is a template parameter for p = 1, 2, 4 and 8, the orders the
// port's paths run (the tanks' p-multigrid 4 -> 2 -> 1 and 8 -> 4 -> 2 ->
// 1): the tap loops unroll, and each thread keeps the x bands of its
// column, the y bands of its row and the ring in registers. P = 0 is the
// general instantiation for 1 <= p <= 10 (3, 5..7, 9, 10): the same kernel
// with the loops unrolled to 21 taps under a guard, the x and y bands read
// through L1. p = 8 in float runs two blocks of at most 160 threads per SM
// and 8-column tiles. p = 8 in double is the tensor-core route (tc_tile,
// below): its x, y and z contractions are m16n8k4 DMMA products with the
// bands as dense banded tiles, the x and y bands in registers, (a, b) in a
// window of 24 planes in shared memory and no ring; one block of 8 warps
// per SM, 240 registers and none spilled.
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
// threads (1.19x), 25 kB. At p = 8 Tx = 8 in either dtype and at most 160
// threads in float: on the order-8 tank's top lattice (1024 x 65 x 257) 8
// x 17 x 257, 512 blocks of 136 threads. The tensor-core route: a fixed 16
// x 8 tile of 256 threads, Tz a multiple of 8 for the fewest batches in a
// row of one-block-an-SM waves (1024 x 65 x 257: 16 x 8 x 136, 1,152
// blocks, 171 kB each). At p = 10 in double a block stays under 100 kB.
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
// At p = 8 in double the 7 x 17 multiply-adds a dof are 4.07 GFLOP at 1024
// x 65 x 257, 0.12 ms at the CUDA cores' 34 TFLOP/s, 0.06 ms at the FP64
// tensor cores' 67; the register design reached 2.02 ms, latency-bound
// with 10 warps an SM and 392 bytes spilled a thread. The tensor-core
// route issues 78 m16n8k4 a warp a batch, 312 multiply-adds a dof with
// the padded bands and the y halo recomputed (~0.2 ms at 67 TFLOP/s), and
// ran in 0.47 ms.
//
// Plain C interface (one entry per dtype for one lattice, one per dtype for
// shard mode), built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// Each entry launches one kernel on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxP = 10;          // the general instantiation's reach

// The tensor-core route: p = 8 in double runs its x, y and z contractions
// as m16n8k4 DMMA products (tc_tile below).
__host__ __device__ constexpr bool tc_route(int itemsize, int p) {
  return p == 8 && itemsize == 8;
}

// Threads per block at most (Tx * Ty), and the blocks an SM must hold at
// once, which caps the registers: 3 x 288 float threads at <= 75, 3 x 160
// double threads at <= 136. At p = 8 in float, whose x and y bands and
// ring hold 6 x 17 values a thread, 2 x 160 threads at <= 204 (three
// blocks, or the bands read through L1, were slower on the order-8 tank,
// PERF.md section 6). The tensor-core route: one block of 8 warps.
template <typename T, int P>
__host__ __device__ constexpr int max_threads() {
  return tc_route(sizeof(T), P) ? 256 : P == 8 || sizeof(T) == 8 ? 160 : 288;
}
template <typename T, int P>
__host__ __device__ constexpr int min_blocks() {
  return tc_route(sizeof(T), P) ? 1 : P == 8 ? 2 : 3;
}
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

// The launch's lattices: one (scal null: zt from the caller, own0 = 1) or
// ndev stacked z-slab windows (blockIdx.z = shard * nzc + z-chunk).
template <typename T>
struct Shards {
  const int* scal;     // [ndev][2] (zt, own0) on the device, or null
  const T* p0;         // halo planes, row stride p0s (read where own0 == 0)
  T* yhalo;            // [ndev][Dx*Dy] plane-0 outputs (shard mode)
  long long xs, ys;    // row strides of x and y
  long long p0s, zbs;  // row strides of p0 and of the z bands (0: shared)
  int nzc;             // z-chunks per lattice
  int zt;              // the Dirichlet plane when scal is null (-1: none)
};

// The body of every instantiation but the tensor-core route's: one output
// column a thread, the bands and the ring of 2p+1 planes in registers.
template <typename T, int P>
__device__ __forceinline__ void fma_tile(
    const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ kx,
    const T* __restrict__ mx, const T* __restrict__ ky,
    const T* __restrict__ my, const T* __restrict__ kz,
    const T* __restrict__ mz, int Dx, int Dy, int Dz, int p_, int periodic_x,
    int Tx, int Ty, int Tz, int S, Shards<T> sh) {
  constexpr int MR = P > 0 ? 2 * P + 1 : 2 * kMaxP + 1;   // register extents
  const int p = P > 0 ? P : p_;
  const int R = 2 * p + 1;
  const int W = Tx + 2 * p;            // u tile columns
  const int H = Ty + 2 * p;            // u and t tile rows
  const int plane = Dx * Dy;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = tid % Tx, ty = tid / Tx;
  const int d = blockIdx.z / sh.nzc, zc = blockIdx.z - d * sh.nzc;
  const int x0 = blockIdx.x * Tx, y0 = blockIdx.y * Ty, z0 = zc * Tz;
  x += d * sh.xs;
  y += d * sh.ys;
  kz += d * sh.zbs;
  mz += d * sh.zbs;
  int zt = sh.zt, own0 = 1;
  if (sh.scal != nullptr) {
    zt = sh.scal[2 * d];
    own0 = sh.scal[2 * d + 1];
  }
  // plane 0's source: the exchanged halo plane where the shard does not own it
  const T* x0src = own0 ? x : sh.p0 + d * sh.p0s;
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
  // are whole 16-byte vectors from a 16-byte aligned plane: then they are
  // copied as such
  constexpr int kV = 16 / sizeof(T);
  const bool vec = x0 - p >= 0 && x0 + Tx + p <= Dx && (x0 - p) % kV == 0 &&
                   W % kV == 0 && S % kV == 0 && Dx % kV == 0;
  const bool vec_x = vec && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_0 = vec && reinterpret_cast<uintptr_t>(x0src) % 16 == 0;
  // lanes of y's row past the lattice (the trash lane of a stacked vector)
  if (blockIdx.x == 0 && blockIdx.y == 0 && zc == 0) {
    for (long long k = (long long)Dz * plane + tid; k < sh.ys; k += nt)
      y[k] = T(0);
  }

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
  // outside the lattice keep the zeros written above; the Dirichlet plane
  // is filled with zeros.
  auto fetch = [&](int z, int buf) {
    const T* xsrc = z == 0 ? x0src : x + z * plane;
    if (z <= zhi && z < Dz && (z == 0 ? vec_0 : vec_x)) {
      // interior tile: each u row is W/kV aligned 16-byte vectors
      const size_t zfill = z == zt ? 16 : 0;
      T* dst = ub + buf * H * S;
      const T* xz = xsrc + x0 - p;
      const int nv = W / kV;
      for (int i = tid; i < H * nv; i += nt) {
        const int r = i / nv, v = i - r * nv;
        const int ro = rowoff[r];
        if (ro >= 0)
          __pipeline_memcpy_async(dst + r * S + v * kV, xz + ro + v * kV, 16,
                                  zfill);
      }
    } else if (z <= zhi && z < Dz) {
      const size_t zfill = z == zt ? sizeof(T) : 0;
      T* dst = ub + buf * H * S;
      const T* xz = xsrc;
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
      const int j = gy * Dx + gx, i = zo * plane + j;
      T v;
      if (zo == zt) {
        v = x[i];                   // identity row (zt >= 1: x is its source)
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
        v = ya + yb;
      }
      if (sh.scal != nullptr && zo == 0) {
        // plane 0: kept where the shard owns it, else routed to yhalo
        sh.yhalo[d * plane + j] = own0 ? T(0) : v;
        y[i] = own0 ? v : T(0);
      } else {
        y[i] = v;
      }
    }
    __pipeline_wait_prior(1);        // plane z+1 has landed
    __syncthreads();
    cur = cur == kStages - 1 ? 0 : cur + 1;
  }
}

// ---- The tensor-core route: p = 8 in double on DMMA ------------------------
//
// A block owns a tile of 16 x-columns by 8 y-rows over its z-chunk, as 8
// warps. The chunk's input planes z0-8 .. go in batches of 8, one plane a
// warp; each warp streams its planes through two slots of its own in shared
// memory (cp.async, the next batch's plane in flight while it works) and
// takes its plane from u to (a, b) in registers:
//
//   x:  t1^T [16 x 24] = Kx^T [16 x 32] . u^T [32 x 24]   (Mx: t2^T)
//   y:  a^T [16 x 8] = t1^T . My^T [24 x 8] + t2^T . Ky^T,  b^T = t2^T . My^T
//
// as m16n8k4 products (M = the tile's x columns): the x product's
// accumulators are the y product's A fragments as they stand (the y
// product's k index runs through the tile rows in the order those
// accumulators hold them, and its B fragments, the y bands, are loaded in
// that order). The x bands (A) and the y bands (B) are dense banded tiles
// in registers, zero off the band, past the ends of a finite x axis and
// past Dy; the u tile wraps on a periodic x axis and is zero past the ends.
// Each warp writes its plane's (a, b) into a window of the last 24 planes
// in shared memory; after each batch the block emits 8 output planes, warp
// w its y-row w, as one more product over the window:
//
//   z:  y^T [16 x 8] = a^T [16 x 24] . Mz^T [24 x 8] + b^T . Kz^T
//
// with the z bands of the 8 output planes as B fragments. Planes outside
// the lattice, or past the last one the chunk's outputs read, are zero in
// the window. Two barriers a batch of 8 planes, none a plane. Sums run in
// DMMA's order (four products at a time, the padded bands' zeros added), so
// the route differs from the plain version in the last bits; two calls on
// one input give the same bits.
namespace tc {
constexpr int kP = 8;
constexpr int kTx = 16;                 // tile x columns: M of every product
constexpr int kTy = 8;                  // tile y rows: one n8 tile
constexpr int kH = kTy + 2 * kP;        // u and t rows: 24
constexpr int kW = kTx + 2 * kP;        // u columns: 32
constexpr int kWarps = 8;               // = planes of a batch = kTy
constexpr int kThreads = 32 * kWarps;
constexpr int kWin = 3;                 // batches of (a, b) in the window
constexpr int kYS = 18;                 // window row stride: no bank conflict
constexpr int kPS = kTy * kYS + 4;      // window plane stride
}  // namespace tc

// The tensor-core route's shared memory, as byte offsets: u [2 * kWarps]
// [kH][S] (two slots a warp), the window's a and b [kWin * kWarps][kPS] in
// double, the row offsets [kH] and the load offsets [kH * kW] in int.
struct TcSmem {
  int win_a, win_b, rowoff, src, total;
  __host__ __device__ explicit TcSmem(int S) {
    using namespace tc;
    win_a = 8 * 2 * kWarps * kH * S;
    win_b = win_a + 8 * kWin * kWarps * kPS;
    rowoff = win_b + 8 * kWin * kWarps * kPS;
    src = rowoff + 4 * kH;
    total = src + 4 * kH * kW;
  }
};

// A block's shared-memory bytes at order p with its tiles.
template <typename T>
__host__ __device__ int smem_total(int p, int Tx, int Ty, int S) {
  return tc_route(sizeof(T), p) ? TcSmem(S).total
                                : TileSmem<T>(p, Tx, Ty, S).total;
}

// d += A . B on the FP64 tensor cores: A 16 x 4 (a0 = A[g][t], a1 =
// A[g+8][t]), B 4 x 8 (b = B[t][g]), d 16 x 8 (d0, d1 = D[g][2t, 2t+1],
// d2, d3 = D[g+8][2t, 2t+1]), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ void tc_tile(
    const double* __restrict__ x, double* __restrict__ y,
    const double* __restrict__ kx, const double* __restrict__ mx,
    const double* __restrict__ ky, const double* __restrict__ my,
    const double* __restrict__ kz, const double* __restrict__ mz, int Dx,
    int Dy, int Dz, int periodic_x, int Tz, int S, Shards<double> sh) {
  using namespace tc;
  constexpr int p = kP, R = 2 * kP + 1;
  const int plane = Dx * Dy;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int d = blockIdx.z / sh.nzc, zc = blockIdx.z - d * sh.nzc;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy, z0 = zc * Tz;
  x += d * sh.xs;
  y += d * sh.ys;
  kz += d * sh.zbs;
  mz += d * sh.zbs;
  int zt = sh.zt, own0 = 1;
  if (sh.scal != nullptr) {
    zt = sh.scal[2 * d];
    own0 = sh.scal[2 * d + 1];
  }
  const double* x0src = own0 ? x : sh.p0 + d * sh.p0s;
  const int zend = min(z0 + Tz, Dz);           // output planes [z0, zend)
  const int zhi = zend - 1 + p;                // the last input plane read
  const int nb = (zend - z0 + kWarps - 1) / kWarps + 2;   // input batches

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcSmem lay(S);
  double* ub = reinterpret_cast<double*>(smem_raw);
  double* win_a = reinterpret_cast<double*>(smem_raw + lay.win_a);
  double* win_b = reinterpret_cast<double*>(smem_raw + lay.win_b);
  int* rowoff = reinterpret_cast<int*>(smem_raw + lay.rowoff);
  int* src = reinterpret_cast<int*>(smem_raw + lay.src);
  const bool vec = x0 - p >= 0 && x0 + kTx + p <= Dx && (x0 - p) % 2 == 0 &&
                   S % 2 == 0 && Dx % 2 == 0;
  const bool vec_x = vec && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_0 = vec && reinterpret_cast<uintptr_t>(x0src) % 16 == 0;
  if (blockIdx.x == 0 && blockIdx.y == 0 && zc == 0) {
    for (long long k = (long long)Dz * plane + tid; k < sh.ys; k += kThreads)
      y[k] = 0.0;
  }
  for (int i = tid; i < 2 * kWarps * kH * S; i += kThreads) ub[i] = 0.0;
  for (int r = tid; r < kH; r += kThreads) {
    const int gy = y0 - p + r;
    rowoff[r] = (gy >= 0 && gy < Dy) ? gy * Dx : -1;
  }
  for (int i = tid; i < kH * kW; i += kThreads) {
    const int r = i / kW, j = i - r * kW;
    const int gyr = y0 - p + r;
    int gx = x0 - p + j;
    if (periodic_x) {
      gx %= Dx;
      if (gx < 0) gx += Dx;
    } else if (gx < 0 || gx >= Dx) {
      gx = -1;
    }
    src[i] = (gx >= 0 && gyr >= 0 && gyr < Dy) ? gyr * Dx + gx : -1;
  }
  // x bands as A fragments of K^T [16 x 32], K^T[c][j] = K[j - c][x0 + c]
  double akx[8][2], amx[8][2];
#pragma unroll
  for (int k4 = 0; k4 < 8; ++k4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = g + 8 * h, k = 4 * k4 + t - c;
      const bool in = k >= 0 && k < R && x0 + c < Dx;
      akx[k4][h] = in ? kx[k * Dx + x0 + c] : 0.0;
      amx[k4][h] = in ? mx[k * Dx + x0 + c] : 0.0;
    }
  }
  // y bands as B fragments of M^T [24 x 8], M^T[r][yy] = M[r - yy][y0 + yy];
  // k-step 2n + i holds the tile rows r = 8n + 2t + i, as the x product's
  // accumulators of its n-tile n do
  double bmy[6], bky[6];
#pragma unroll
  for (int k4 = 0; k4 < 6; ++k4) {
    const int r = 8 * (k4 >> 1) + 2 * t + (k4 & 1), k = r - g;
    const bool in = k >= 0 && k < R && y0 + g < Dy;
    bmy[k4] = in ? my[k * Dy + y0 + g] : 0.0;
    bky[k4] = in ? ky[k * Dy + y0 + g] : 0.0;
  }
  // the x n-tiles (8 tile rows each) that hold a lattice row
  bool live[3];
#pragma unroll
  for (int n = 0; n < 3; ++n)
    live[n] = y0 - p + 8 * n + 7 >= 0 && y0 - p + 8 * n < Dy;

  // plane z's u tile into a slot of this warp (cp.async, one commit group
  // per call, also when it copies nothing); positions outside the lattice
  // keep their zeros, the Dirichlet plane is filled with zeros
  auto fetch = [&](int z, double* dst) {
    if (z >= 0 && z <= zhi && z < Dz) {
      const double* xsrc = z == 0 ? x0src : x + z * plane;
      if (z == 0 ? vec_0 : vec_x) {
        const size_t zfill = z == zt ? 16 : 0;
        const double* xz = xsrc + x0 - p;
        for (int i = lane; i < kH * kW / 2; i += 32) {
          const int r = i / (kW / 2), v = i - r * (kW / 2);
          const int ro = rowoff[r];
          if (ro >= 0)
            __pipeline_memcpy_async(dst + r * S + 2 * v, xz + ro + 2 * v, 16,
                                    zfill);
        }
      } else {
        const size_t zfill = z == zt ? 8 : 0;
        for (int i = lane; i < kH * kW; i += 32) {
          const int o = src[i];
          if (o >= 0)
            __pipeline_memcpy_async(dst + (i / kW) * S + i % kW, xsrc + o, 8,
                                    zfill);
        }
      }
    }
    __pipeline_commit();
  };

  __syncthreads();                  // zeros and offsets before any copy
  const int zin0 = z0 - p;          // the first plane of input batch 0
  double* mine = ub + w * 2 * kH * S;
  fetch(zin0 + w, mine);
  fetch(zin0 + kWarps + w, mine + kH * S);
  for (int bt = 0; bt < nb; ++bt) {
    const int z = zin0 + bt * kWarps + w;      // this warp's plane
    double* u = mine + (bt & 1) * kH * S;
    // the z bands of output batch bt - 2 (planes zb .. zb+7) as B fragments
    // of Z^T [24 x 8], Z^T[kk][n] = Z[kk - n][zb + n], read ahead of the x
    // and y work
    const int zb = z0 + (bt - 2) * kWarps;
    double bzm[6], bzk[6];
#pragma unroll
    for (int k4 = 0; k4 < 6; ++k4) {
      const int k = 4 * k4 + t - g;
      const bool in = bt >= 2 && k >= 0 && k < R && zb + g < Dz;
      bzm[k4] = in ? mz[k * Dz + zb + g] : 0.0;
      bzk[k4] = in ? kz[k * Dz + zb + g] : 0.0;
    }
    __pipeline_wait_prior(1);       // this warp's plane has landed
    __syncwarp();
    double ca[4] = {0.0, 0.0, 0.0, 0.0}, cb[4] = {0.0, 0.0, 0.0, 0.0};
    if (z >= 0 && z <= zhi && z < Dz) {        // warp-uniform
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        if (!live[n]) continue;                // block-uniform
        double t1[4] = {0.0, 0.0, 0.0, 0.0}, t2[4] = {0.0, 0.0, 0.0, 0.0};
        const double* ur = u + (8 * n + g) * S + t;
#pragma unroll
        for (int k4 = 0; k4 < 8; ++k4) {
          const double b = ur[4 * k4];
          dmma(t1, akx[k4][0], akx[k4][1], b);
          dmma(t2, amx[k4][0], amx[k4][1], b);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dmma(ca, t1[i], t1[2 + i], bmy[2 * n + i]);
          dmma(ca, t2[i], t2[2 + i], bky[2 * n + i]);
          dmma(cb, t2[i], t2[2 + i], bmy[2 * n + i]);
        }
      }
    }
    // (a, b) of plane z into the window: a^T[c][yy] at [yy][c]
    double* wa = win_a + ((bt % kWin) * kWarps + w) * kPS;
    double* wb = win_b + ((bt % kWin) * kWarps + w) * kPS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wa[(2 * t + i) * kYS + g] = ca[i];
      wa[(2 * t + i) * kYS + g + 8] = ca[2 + i];
      wb[(2 * t + i) * kYS + g] = cb[i];
      wb[(2 * t + i) * kYS + g + 8] = cb[2 + i];
    }
    __syncwarp();                   // the warp is done with this slot
    fetch(z + 2 * kWarps, u);
    __syncthreads();                // batch bt is in the window
    if (bt >= 2) {
      // z: output planes zb .. zb+7 of y-row w from the window's planes
      // zb-8 .. zb+15, i.e. batches bt-2, bt-1 and bt
      double co[4] = {0.0, 0.0, 0.0, 0.0};
      const int s0 = (bt + 1) % kWin;          // = (bt - 2) % kWin
#pragma unroll
      for (int k4 = 0; k4 < 6; ++k4) {
        const int pl = ((s0 + (k4 >> 1)) % kWin) * kWarps + 4 * (k4 & 1) + t;
        const double* ra = win_a + pl * kPS + w * kYS;
        const double* rb = win_b + pl * kPS + w * kYS;
        dmma(co, ra[g], ra[g + 8], bzm[k4]);
        dmma(co, rb[g], rb[g + 8], bzk[k4]);
      }
      const int gy = y0 + w;
      if (gy < Dy) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gx = x0 + g + 8 * h;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int zo = zb + 2 * t + i;
            if (gx >= Dx || zo >= zend) continue;
            const int j = gy * Dx + gx, o = zo * plane + j;
            const double v = zo == zt ? x[o] : co[2 * h + i];
            if (sh.scal != nullptr && zo == 0) {
              // plane 0: kept where the shard owns it, else routed to yhalo
              sh.yhalo[d * plane + j] = own0 ? 0.0 : v;
              y[o] = own0 ? v : 0.0;
            } else {
              y[o] = v;
            }
          }
        }
      }
    }
    __syncthreads();                // the window's next slot is free
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(max_threads<T, P>(), min_blocks<T, P>())
sep_tile_kernel(const T* __restrict__ x, T* __restrict__ y,
                const T* __restrict__ kx, const T* __restrict__ mx,
                const T* __restrict__ ky, const T* __restrict__ my,
                const T* __restrict__ kz, const T* __restrict__ mz, int Dx,
                int Dy, int Dz, int p_, int periodic_x, int Tx, int Ty, int Tz,
                int S, Shards<T> sh) {
  if constexpr (tc_route(sizeof(T), P))
    tc_tile(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, periodic_x, Tz, S, sh);
  else
    fma_tile<T, P>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p_, periodic_x,
                   Tx, Ty, Tz, S, sh);
}

template <typename T, int P>
int launch(const T* x, T* y, const T* kx, const T* mx, const T* ky,
           const T* my, const T* kz, const T* mz, int Dx, int Dy, int Dz,
           int p, int periodic_x, int Tx, int Ty, int Tz, int S, int smem,
           int ndev, Shards<T> sh, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sep_tile_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sh.nzc = (Dz + Tz - 1) / Tz;
  const dim3 grid((Dx + Tx - 1) / Tx, (Dy + Ty - 1) / Ty, ndev * sh.nzc);
  const int threads =
      tc_route(sizeof(T), P) ? tc::kThreads : ((Tx * Ty + 31) / 32) * 32;
  sep_tile_kernel<T, P><<<grid, threads, smem, st>>>(
      x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p, periodic_x, Tx, Ty, Tz, S,
      sh);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* y, const void* kx, const void* mx,
             const void* ky, const void* my, const void* kz, const void* mz,
             int Dx, int Dy, int Dz, int p, int periodic_x, int Tx, int Ty,
             int Tz, int S, int smem, int ndev, const Shards<T>& sh,
             void* stream) {
  const long long n = (long long)Dx * Dy * Dz;
  const bool tc = tc_route(sizeof(T), p);
  if (p < 1 || p > kMaxP || Tx < 1 || Ty < 1 || Tz < 1 ||
      Tx * Ty > (p == 8 ? max_threads<T, 8>() : max_threads<T, 0>()) ||
      (tc && (Tx != tc::kTx || Ty != tc::kTy)) || S < Tx + 2 * p ||
      (periodic_x && Dx <= 2 * p) || smem != smem_total<T>(p, Tx, Ty, S) ||
      ndev < 1 || sh.xs < n || sh.ys < n || sh.zt >= Dz ||
      (sh.scal != nullptr && (sh.p0 == nullptr || sh.yhalo == nullptr ||
                              sh.p0s < (long long)Dx * Dy)) ||
      (long long)ndev * ((Dz + Tz - 1) / Tz) > 65535)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const T* a[6] = {static_cast<const T*>(kx), static_cast<const T*>(mx),
                   static_cast<const T*>(ky), static_cast<const T*>(my),
                   static_cast<const T*>(kz), static_cast<const T*>(mz)};
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LPFEM_SEP_LAUNCH(PP)                                                 \
  launch<T, PP>(xx, yy, a[0], a[1], a[2], a[3], a[4], a[5], Dx, Dy, Dz, p,  \
                periodic_x, Tx, Ty, Tz, S, smem, ndev, sh, st)
  switch (p) {
    case 1: return LPFEM_SEP_LAUNCH(1);
    case 2: return LPFEM_SEP_LAUNCH(2);
    case 4: return LPFEM_SEP_LAUNCH(4);
    case 8: return LPFEM_SEP_LAUNCH(8);
    default: return LPFEM_SEP_LAUNCH(0);
  }
#undef LPFEM_SEP_LAUNCH
}

// One lattice: ess_top makes its top plane the Dirichlet plane.
template <typename T>
int one_lattice(const void* x, void* y, const void* kx, const void* mx,
                const void* ky, const void* my, const void* kz,
                const void* mz, int Dx, int Dy, int Dz, int p, int periodic_x,
                int ess_top, int Tx, int Ty, int Tz, int S, int smem,
                void* stream) {
  const long long n = (long long)Dx * Dy * Dz;
  const Shards<T> sh{nullptr, nullptr, nullptr, n, n, 0, 0, 1,
                     ess_top ? Dz - 1 : -1};
  return dispatch<T>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p, periodic_x,
                     Tx, Ty, Tz, S, smem, 1, sh, stream);
}

// ndev stacked z-slab windows (shard mode; the header comment).
template <typename T>
int shard_windows(const void* x, void* y, const void* kx, const void* mx,
                  const void* ky, const void* my, const void* kz,
                  const void* mz, int Dx, int Dy, int Dz, int p,
                  int periodic_x, int Tx, int Ty, int Tz, int S, int smem,
                  const void* scal, const void* p0, void* yhalo, int ndev,
                  long long xs, long long ys, long long p0s, void* stream) {
  const Shards<T> sh{static_cast<const int*>(scal),
                     static_cast<const T*>(p0), static_cast<T*>(yhalo), xs,
                     ys, p0s, (long long)(2 * p + 1) * Dz, 1, -1};
  if (scal == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<T>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p, periodic_x,
                     Tx, Ty, Tz, S, smem, ndev, sh, stream);
}

}  // namespace

extern "C" int sep_apply_f32(const void* x, void* y, const void* kx,
                             const void* mx, const void* ky, const void* my,
                             const void* kz, const void* mz, int Dx, int Dy,
                             int Dz, int p, int periodic_x, int ess_top,
                             int Tx, int Ty, int Tz, int S, int smem,
                             void* stream) {
  return one_lattice<float>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p,
                            periodic_x, ess_top, Tx, Ty, Tz, S, smem, stream);
}

extern "C" int sep_apply_f64(const void* x, void* y, const void* kx,
                             const void* mx, const void* ky, const void* my,
                             const void* kz, const void* mz, int Dx, int Dy,
                             int Dz, int p, int periodic_x, int ess_top,
                             int Tx, int Ty, int Tz, int S, int smem,
                             void* stream) {
  return one_lattice<double>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p,
                             periodic_x, ess_top, Tx, Ty, Tz, S, smem, stream);
}

// Shard mode: kz, mz are [ndev][2p+1][Dz] (one band table per window),
// scal [ndev][2] int on the device, x / y / p0 rows of xs / ys / p0s values,
// yhalo [ndev][Dx*Dy].
extern "C" int sep_apply_shard_f32(
    const void* x, void* y, const void* kx, const void* mx, const void* ky,
    const void* my, const void* kz, const void* mz, int Dx, int Dy, int Dz,
    int p, int periodic_x, int Tx, int Ty, int Tz, int S, int smem,
    const void* scal, const void* p0, void* yhalo, int ndev, long long xs,
    long long ys, long long p0s, void* stream) {
  return shard_windows<float>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p,
                              periodic_x, Tx, Ty, Tz, S, smem, scal, p0,
                              yhalo, ndev, xs, ys, p0s, stream);
}

extern "C" int sep_apply_shard_f64(
    const void* x, void* y, const void* kx, const void* mx, const void* ky,
    const void* my, const void* kz, const void* mz, int Dx, int Dy, int Dz,
    int p, int periodic_x, int Tx, int Ty, int Tz, int S, int smem,
    const void* scal, const void* p0, void* yhalo, int ndev, long long xs,
    long long ys, long long p0s, void* stream) {
  return shard_windows<double>(x, y, kx, mx, ky, my, kz, mz, Dx, Dy, Dz, p,
                               periodic_x, Tx, Ty, Tz, S, smem, scal, p0,
                               yhalo, ndev, xs, ys, p0s, stream);
}
