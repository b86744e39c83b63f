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
// agree bit for bit. A term whose operand is a zero of the halo is a term
// of the plain version's zero padding, in the same place of the same sum.
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
//   x:  t1 = Kx u,             t2 = Mx u
//   y:  a  = My t1 (+) Ky t2,  b  = My t2
//   z:  y  = Mz a  (+) Kz b
//
// with (+) the DS addition: (s, e) = two_sum(x.hi, y.hi), then
// fast_two_sum(s, (e + x.lo) + y.lo). ess_top: the top plane of u reads as
// zero (both streams) and y's top plane is x's. Periodic x wraps.
//
// One launch per apply, B1's design: no scratch in device memory, no
// atomics. A block owns the outputs of a Tx x Ty tile of (x, y) columns over
// the z-chunk [z0, z0 + Tz) and streams the chunk's input planes
// z0-p .. z0+Tz-1+p (the z halo is recomputed, not exchanged). Per plane:
//
//   1. cp.async copies the plane's u.hi and u.lo rows (Ty+2p) x (Tx+2p)
//      into shared memory, three planes in flight, from a table of copies
//      that the block builds once (16-byte vectors where the tile's rows lie
//      inside the lattice and both streams are 16-byte aligned; else value
//      by value, zero past the ends, wrapped on a periodic x);
//   2. x: t = (t1.h, t1.l, t2.h, t2.l) per tile row and column, normalised,
//      one float4 in shared memory;
//   3. y: each thread owns one output column and pushes (a.h, a.l, b.h,
//      b.l) of the plane into a ring of the last 2p+1 planes;
//   4. z: the output plane z-p from the ring and that plane's z bands.
//
// The loop is software-pipelined with one barrier per plane: the iteration
// of plane z fetches plane z+3, contracts x of plane z+1 into one of two t
// buffers and y of plane z from the other, and emits plane z-p. Every value
// a term reads is in shared memory as one float4: t, the y bands of the
// thread's row (My.h, My.l, Ky.h, Ky.l), the x bands of its column (Kx.h,
// Kx.l, Mx.h, Mx.l) and the z bands of the output plane (Mz.h, Mz.l, Kz.h,
// Kz.l); the DS bands would take 72 registers at p = 4 and the ring takes
// 36. P is a template parameter for p = 1, 2, 4, the orders the port's paths
// run, with the tap loops unrolled and the ring in registers; P = 0 is the
// general instantiation for 1 <= p <= 10, unrolled to 21 taps under a
// guard, with the ring in shared memory (84 registers otherwise). Tx = 8 is
// fixed, so the tap offsets are constants. Indices are 32-bit (the wrapper
// checks numel < 2^31).
//
// Tiles (lpfem_torch.kernels.sep_apply_ds.choose_ds_tiles, passed in with
// the block's shared-memory bytes, which the entry checks against its own
// layout, TileSmem): Tx = 8, Ty the whole y axis where 288 threads hold it,
// Tz such that the grid is one wave of 2 blocks per SM. On the ss.cpp fine
// lattice (512 x 33 x 129, p = 4): 8 x 33 x 33, 256 blocks of 264 threads,
// 60 kB of shared memory per block; the z halo recomputed is 1.24x the x
// and y work.
//
// What bounds it on an H100: float32 instructions. A band term is 14 of
// them (13 adds and multiplies and one fma), a normalisation 3, a DS
// addition 11; x holds 2 accumulators of 2p+1 terms per dof, y 3, z 2: at
// p = 4 on the fine lattice with ess_top 1.94e9 instructions, against
// 34.9 MB of input and output. An FADD or FMUL takes the issue slot of an
// FFMA (128 per SM per clock), so the floor is 1.94e9 / 33.5e12/s =
// 0.058 ms (bytes: 0.010 ms). The kernel does not come near it: each thread
// issues 925 float32 instructions per plane at p = 4 and, beside them, the
// shared loads, its share of the copies, the ring's moves and the loop's
// control; it recomputes the z halo (1.24x the x and y work); and with 9
// warps a block, 2 blocks an SM, the busiest of an SM's four schedulers
// issues for 5 warps where 4.1 would do. Measured on an NVIDIA H100 80GB
// HBM3 at 700.00 W (chip_smoke.py phase 2): 0.1392 ms at p = 4 with
// ess_top, against 0.2044 ms for the three passes it replaces (PERF.md
// section 6). Exploratory variants, all bit for bit, were slower: one loop
// over the terms of the x, y and z contractions (seven accumulators in
// flight), the ring in shared memory for the fixed orders, 3 blocks per SM,
// other chunk depths, and Tx = 4.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// The entry launches one kernel on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxP = 10;          // the general instantiation's reach
constexpr int kMaxThreads = 288;   // Tx * Ty at most
constexpr int kMinBlocks = 2;      // per SM: <= 113 registers a thread
constexpr int kStages = 3;         // u planes in shared memory
constexpr int kZSlots = 4;         // output planes' z bands in shared memory
constexpr int kTx = 8;             // tile columns

__host__ __device__ constexpr bool fixed_order(int p) {
  return p == 1 || p == 2 || p == 4;
}

__host__ __device__ inline int up16(int b) { return (b + 15) & ~15; }

// A block's shared memory, as byte offsets from its start: u
// [kStages][hi | lo][H][S] in float; then in float4 t [H][Tx], the ring
// [2p+1][threads] (general orders only), the x bands [2p+1][Tx], the y
// bands [Ty][2p+1] and the z bands [kZSlots][2p+1]; then the copy table
// [H*W] in int2 and the row offsets [H] in int. The wrapper's
// ds_tile_smem_bytes computes the same total and passes it in.
struct TileSmem {
  int t, ring, xb, yb, zb, copies, rowoff, total;
  __host__ __device__ TileSmem(int p, int Ty, int S) {
    const int Tx = kTx, H = Ty + 2 * p, W = Tx + 2 * p, R = 2 * p + 1;
    const int threads = (Tx * Ty + 31) / 32 * 32;
    t = up16(4 * kStages * 2 * H * S);
    ring = t + 2 * 16 * H * Tx;
    xb = ring + (fixed_order(p) ? 0 : 16 * R * threads);
    yb = xb + 16 * R * Tx;
    zb = yb + 16 * R * Ty;
    copies = zb + 16 * kZSlots * R;
    rowoff = copies + 8 * H * W;
    total = rowoff + 4 * H;
  }
};

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

template <int P>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
ds_tile_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
               float* __restrict__ yh, float* __restrict__ yl, Bands c,
               int Dx, int Dy, int Dz, int p_, int periodic_x, int ess_top,
               int Ty, int Tz, int S) {
  constexpr int Tx = kTx;
  constexpr int MR = P > 0 ? 2 * P + 1 : 2 * kMaxP + 1;   // unrolled taps
  constexpr bool kRegRing = P > 0;                         // else shared
  const int p = P > 0 ? P : p_;
  const int R = 2 * p + 1;
  const int W = Tx + 2 * p;            // u tile columns
  const int H = Ty + 2 * p;            // u and t tile rows
  const int plane = Dx * Dy;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cx = tid % Tx, ty = tid / Tx;
  const int x0 = blockIdx.x * Tx, y0 = blockIdx.y * Ty, z0 = blockIdx.z * Tz;
  const int gx = x0 + cx, gy = y0 + ty;
  const bool col = ty < Ty && gx < Dx;        // runs the x contraction
  const bool out = col && gy < Dy;            // owns an output column
  const int zend = min(z0 + Tz, Dz);          // output planes [z0, zend)
  const int zlo = max(0, z0 - p), zhi = zend - 1 + p;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem lay(p, Ty, S);
  float* ub = reinterpret_cast<float*>(smem_raw);    // u, both streams
  float4* t = reinterpret_cast<float4*>(smem_raw + lay.t);
  float4* ring = reinterpret_cast<float4*>(smem_raw + lay.ring);
  float4* xb = reinterpret_cast<float4*>(smem_raw + lay.xb);
  float4* yb = reinterpret_cast<float4*>(smem_raw + lay.yb);
  float* zb = reinterpret_cast<float*>(smem_raw + lay.zb);
  int2* copies = reinterpret_cast<int2*>(smem_raw + lay.copies);
  int* rowoff = reinterpret_cast<int*>(smem_raw + lay.rowoff);
  const int HS = H * S;
  // whether the tile's rows lie inside the lattice (no wrap, no edge) and
  // are whole 16-byte vectors of two 16-byte aligned streams: then they are
  // copied as such
  const bool vec = reinterpret_cast<uintptr_t>(xh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xl) % 16 == 0 && x0 - p >= 0 &&
                   x0 + Tx + p <= Dx && (x0 - p) % 4 == 0 && W % 4 == 0 &&
                   S % 4 == 0 && Dx % 4 == 0;

  // zeros in u, t and the ring: the halo past the lattice and the planes
  // below 0 stay zero
  for (int i = tid; i < lay.xb / 4; i += nt) ub[i] = 0.0f;
  for (int r = tid; r < H; r += nt) {
    const int g = y0 - p + r;
    rowoff[r] = (g >= 0 && g < Dy) ? g * Dx : -1;
  }
  // The copy table, one entry per copy of a plane (the same for every
  // plane): (offset in a stage's u tile, offset in the plane, or -1 outside
  // the lattice). Vectors of 4 on an interior tile (rows r, vectors v),
  // else single values (x wraps on a periodic axis).
  const int nv = W / 4;
  const int ncopy = vec ? H * nv : H * W;
  for (int i = tid; i < ncopy; i += nt) {
    int r, j, g;
    if (vec) {
      r = i / nv;
      j = (i - r * nv) * 4;
      g = x0 - p + j;
    } else {
      r = i / W;
      j = i - r * W;
      g = x0 - p + j;
      if (periodic_x) {
        g %= Dx;
        if (g < 0) g += Dx;
      } else if (g < 0 || g >= Dx) {
        g = -1;
      }
    }
    const int gyr = y0 - p + r;
    copies[i] = make_int2(r * S + j, (g >= 0 && gyr >= 0 && gyr < Dy)
                                         ? gyr * Dx + g : -1);
  }
  // the x bands of the tile's columns, the y bands of its rows
  for (int i = tid; i < R * Tx; i += nt) {
    const int k = i / Tx, g = x0 + i - k * Tx, o = k * Dx + g;
    xb[i] = g < Dx ? make_float4(c.kxh[o], c.kxl[o], c.mxh[o], c.mxl[o])
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int i = tid; i < R * Ty; i += nt) {
    const int r = i / R, k = i - r * R, g = y0 + r, o = k * Dy + g;
    yb[i] = g < Dy ? make_float4(c.myh[o], c.myl[o], c.kyh[o], c.kyl[o])
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // the ring of (a.h, a.l, b.h, b.l), planes zo-p .. zo+p (fixed orders)
  float rah[kRegRing ? MR : 1], ral[kRegRing ? MR : 1];
  float rbh[kRegRing ? MR : 1], rbl[kRegRing ? MR : 1];
#pragma unroll
  for (int k = 0; k < (kRegRing ? MR : 1); ++k) {
    rah[k] = ral[k] = rbh[k] = rbl[k] = 0.0f;
  }

  // z band copy i = q * R + k of this thread, and the step nt in (q, k)
  const int zq = tid / R, zk = tid - zq * R, zdq = nt / R, zdk = nt - zdq * R;
  // Asynchronous copies (cp.async) of plane z's u rows (both streams) into
  // stage z % 3, and of the z bands of output plane z - p into slot z % 4
  // where the chunk emits it; one commit group per plane, also when it
  // copies nothing. The positions outside the lattice keep the zeros
  // written above; the top plane under ess_top is filled with zeros.
  auto fetch = [&](int z) {
    float* dh = ub + (z % kStages) * 2 * HS;
    if (z <= zhi && z < Dz) {
      const float* gh = xh + z * plane;
      const float* gl = xl + z * plane;
      if (vec) {
        const size_t zfill = (ess_top && z == Dz - 1) ? 16 : 0;
        for (int i = tid; i < ncopy; i += nt) {
          const int2 e = copies[i];
          if (e.y >= 0) {
            __pipeline_memcpy_async(dh + e.x, gh + e.y, 16, zfill);
            __pipeline_memcpy_async(dh + HS + e.x, gl + e.y, 16, zfill);
          }
        }
      } else {
        const size_t zfill = (ess_top && z == Dz - 1) ? sizeof(float) : 0;
        for (int i = tid; i < ncopy; i += nt) {
          const int2 e = copies[i];
          if (e.y >= 0) {
            __pipeline_memcpy_async(dh + e.x, gh + e.y, sizeof(float),
                                    zfill);
            __pipeline_memcpy_async(dh + HS + e.x, gl + e.y, sizeof(float),
                                    zfill);
          }
        }
      }
    }
    const int zo = z - p;
    if (zo >= z0 && zo < zend) {
      // zb[slot][k] = (Mz.h, Mz.l, Kz.h, Kz.l) at output plane zo
      float* slot = zb + (z % kZSlots) * 4 * R;
      for (int i = tid, q = zq, k = zk; i < 4 * R; i += nt) {
        const float* band = q == 0 ? c.mzh : q == 1 ? c.mzl
                                   : q == 2 ? c.kzh : c.kzl;
        __pipeline_memcpy_async(slot + k * 4 + q, band + k * Dz + zo,
                                sizeof(float));
        q += zdq;
        k += zdk;
        if (k >= R) {
          k -= R;
          ++q;
        }
      }
    }
    __pipeline_commit();
  };

  // x: t = (Kx u, Mx u) of plane z on the tile rows inside the lattice,
  // into t's buffer z % 2
  auto xpass = [&](int z) {
    if (z > zhi || z >= Dz || !col) return;
    const float* uh = ub + (z % kStages) * 2 * HS;
    const float* ul = uh + HS;
    float4* tz = t + (z & 1) * H * Tx;
    for (int r = ty; r < H; r += Ty) {
      if (rowoff[r] < 0) continue;
      const int o = r * S + cx;
      Acc s1, s2;
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        if (k < R) {
          const float u = uh[o + k], ulo = ul[o + k];
          const float4 b = xb[k * Tx + cx];
          s1.add(b.x, b.y, u, ulo);
          s2.add(b.z, b.w, u, ulo);
        }
      }
      s1.norm();
      s2.norm();
      tz[r * Tx + cx] = make_float4(s1.h, s1.l, s2.h, s2.l);
    }
  };

  // Software pipeline, one barrier per plane: the iteration of plane z
  // fetches plane z+3 (into the stage that x left at plane z), contracts x
  // of plane z+1 and y of plane z (two t buffers), and emits plane z-p
  // (its z bands in slot z % kZSlots, which fetch(z+3) does not touch).
  __syncthreads();                  // zeros and offsets before any copy
  fetch(zlo);
  fetch(zlo + 1);
  fetch(zlo + 2);
  __pipeline_wait_prior(2);         // plane zlo has landed
  __syncthreads();
  xpass(zlo);
  __pipeline_wait_prior(1);         // plane zlo+1 has landed
  __syncthreads();
  for (int z = zlo; z <= zhi; ++z) {
    fetch(z + 3);
    xpass(z + 1);
    // y: a = My t1 (+) Ky t2, b = My t2 of plane z at this thread's column
    float ah = 0.0f, al = 0.0f, bh = 0.0f, bl = 0.0f;
    if (z < Dz && out) {
      const float4* tz = t + (z & 1) * H * Tx;
      Acc a1, a2, b;
#pragma unroll
      for (int k = 0; k < MR; ++k) {
        if (k < R) {
          const float4 v = tz[(ty + k) * Tx + cx];
          const float4 cy = yb[ty * R + k];
          a1.add(cy.x, cy.y, v.x, v.y);
          a2.add(cy.z, cy.w, v.z, v.w);
          b.add(cy.x, cy.y, v.z, v.w);
        }
      }
      a1.norm();
      a2.norm();
      b.norm();
      ds_add(a1, a2, ah, al);
      bh = b.h;
      bl = b.l;
    }
    // push plane z (zero past the top) into the ring
    if constexpr (kRegRing) {
#pragma unroll
      for (int k = 0; k < MR - 1; ++k) {
        rah[k] = rah[k + 1];
        ral[k] = ral[k + 1];
        rbh[k] = rbh[k + 1];
        rbl[k] = rbl[k + 1];
      }
      rah[MR - 1] = ah;
      ral[MR - 1] = al;
      rbh[MR - 1] = bh;
      rbl[MR - 1] = bl;
    } else {
      ring[(z % R) * nt + tid] = make_float4(ah, al, bh, bl);
    }
    // z: y = Mz a (+) Kz b for plane zo = z - p
    const int zo = z - p;
    if (zo >= z0 && out) {
      const int i = zo * plane + gy * Dx + gx;
      if (ess_top && zo == Dz - 1) {
        yh[i] = xh[i];
        yl[i] = xl[i];
      } else {
        const float4* bz =
            reinterpret_cast<const float4*>(zb) + (z % kZSlots) * R;
        const int base = zo - p + R;            // ring slot of plane zo - p
        Acc ya, yb_;
#pragma unroll
        for (int k = 0; k < MR; ++k) {
          if (k < R) {
            const float4 cz = bz[k];
            float a_h, a_l, b_h, b_l;
            if constexpr (kRegRing) {
              a_h = rah[k];
              a_l = ral[k];
              b_h = rbh[k];
              b_l = rbl[k];
            } else {
              const float4 v = ring[((base + k) % R) * nt + tid];
              a_h = v.x;
              a_l = v.y;
              b_h = v.z;
              b_l = v.w;
            }
            ya.add(cz.x, cz.y, a_h, a_l);
            yb_.add(cz.z, cz.w, b_h, b_l);
          }
        }
        ya.norm();
        yb_.norm();
        ds_add(ya, yb_, yh[i], yl[i]);
      }
    }
    __pipeline_wait_prior(1);        // plane z+2 has landed
    __syncthreads();
  }
}

template <int P>
int launch(const float* xh, const float* xl, float* yh, float* yl,
           const Bands& c, int Dx, int Dy, int Dz, int p, int periodic_x,
           int ess_top, int Ty, int Tz, int S, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ds_tile_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Dx + kTx - 1) / kTx, (Dy + Ty - 1) / Ty,
                  (Dz + Tz - 1) / Tz);
  const int threads = (kTx * Ty + 31) / 32 * 32;
  ds_tile_kernel<P><<<grid, threads, smem, st>>>(xh, xl, yh, yl, c, Dx, Dy,
                                                 Dz, p, periodic_x, ess_top,
                                                 Ty, Tz, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sep_apply_ds_f32(
    const void* xh, const void* xl, void* yh, void* yl, const void* kxh,
    const void* kxl, const void* mxh, const void* mxl, const void* kyh,
    const void* kyl, const void* myh, const void* myl, const void* kzh,
    const void* kzl, const void* mzh, const void* mzl, int Dx, int Dy,
    int Dz, int p, int periodic_x, int ess_top, int Tx, int Ty, int Tz,
    int S, int smem, void* stream) {
  if (p < 1 || p > kMaxP || Tx != kTx || Ty < 1 || Tz < 1 ||
      Tx * Ty > kMaxThreads || S < Tx + 2 * p ||
      (periodic_x && Dx <= 2 * p) || smem != TileSmem(p, Ty, S).total)
    return (int)cudaErrorInvalidValue;
  if ((long long)Dx * Dy * Dz <= 0) return 0;
  const Bands c{static_cast<const float*>(kxh), static_cast<const float*>(kxl),
                static_cast<const float*>(mxh), static_cast<const float*>(mxl),
                static_cast<const float*>(kyh), static_cast<const float*>(kyl),
                static_cast<const float*>(myh), static_cast<const float*>(myl),
                static_cast<const float*>(kzh), static_cast<const float*>(kzl),
                static_cast<const float*>(mzh),
                static_cast<const float*>(mzl)};
  const float* uh = static_cast<const float*>(xh);
  const float* ul = static_cast<const float*>(xl);
  float* oh = static_cast<float*>(yh);
  float* ol = static_cast<float*>(yl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LPFEM_DS_LAUNCH(PP)                                                  \
  launch<PP>(uh, ul, oh, ol, c, Dx, Dy, Dz, p, periodic_x, ess_top, Ty, Tz, \
             S, smem, st)
  switch (p) {
    case 1: return LPFEM_DS_LAUNCH(1);
    case 2: return LPFEM_DS_LAUNCH(2);
    case 4: return LPFEM_DS_LAUNCH(4);
    default: return LPFEM_DS_LAUNCH(0);
  }
#undef LPFEM_DS_LAUNCH
}
