// The persistent-cluster blind rotation for Hopper (sm_90a): one kernel
// body, rotate_tiles, for the five blind-rotation kernels of the port.
// Each includes this header and instantiates the body on four template
// axes, its word source, epilogue, transform and monomial source:
//   blind_rotate_mb.cu  K1  multi-bit, additive-identity CMux (g = 1, 2, 4)
//                           <AccQuarter, Garner, RegisterPasses, Lookup>
//   blind_rotate_ps.cu  K6  K1's function, CRT partial-sum fold
//                           <AccQuarter, CrtFold, RegisterPasses, Lookup>
//   blind_rotate_sb.cu  K2  single-bit, rotated-difference CMux
//                           <RotDiffQuarter, Garner, RegisterPasses, Lookup>
//   blind_rotate_ts.cu  K4  K1's function, four-step tensor-core NTT
//                           <AccQuarter, Garner, FourStepTC, Lookup>
//   blind_rotate_gm.cu  K3  K1's function, bit-ladder monomials
//                           <AccQuarter, Garner, RegisterPasses, Ladder>
//
// One launch per rotation. A thread-block cluster of NP = 4 blocks (one
// per CRT prime, 512 threads, one block per SM) owns a tile of gt gates (a
// power of two; the host's tile_plan in ops/mb_pbs.py picks it from the
// shared-memory budget, the width and the clusters the card holds at once)
// and keeps, across all the rotation's steps, its accumulators in shared
// memory: block pi holds the quarter of coefficients [pi N/4, (pi+1) N/4)
// of every (gate, component). A step is a group of g mask elements (K1,
// K6, K4, K3) or one mask element (K2, g = 1). Per step, each block
//   1. decomposes the tile's words (the word source reads them from the
//      four blocks' quarters through distributed shared memory), reduces
//      the digits mod its prime, and runs the forward NTT's first register
//      pass on them before they reach shared memory; then the rest of the
//      forward transform (rows [rows, gt, N] u32 in shared memory: F never
//      leaves the SM);
//   2. forms the products per frequency, chunk by chunk against its
//      prime's slab of the step's BSK, which streams through a 2-stage
//      ring by cp.async.bulk on mbarriers (the next chunk, also the next
//      step's first ones, loads while the current one is multiplied and
//      while the NTTs run). A thread takes one (frequency, component) and
//      holds its (2^g-1) x rows BSK words in registers across the tile's
//      gates, so each word is read from the ring once per tile. The
//      products overwrite rows 0..k of the tile in place once the chunk's
//      gadget rows are read;
//   3. runs the inverse transforms of the k+1 components;
// then, after a cluster barrier, block pi reads the four primes' residues
// of its quarter through distributed shared memory, applies N^-1, folds
// them to u32 with the epilogue and adds the result into its quarter; a
// second cluster barrier ends the step. The accumulators reach device
// memory twice per rotation: loaded at the start, stored at the end. Gates
// never read each other's accumulators, so the clusters need no grid-wide
// barrier.
//
// Word sources (step 1) and what follows from them in step 2:
//   AccQuarter      word x of the bare accumulator, from its owner quarter:
//                   one ld_cluster a word. K1's CMux acc += dec(acc) (.)
//                   sum_v P_v (.) BSK_v: the product is S_c = sum_v P_v (.)
//                   (sum_r F_r (.) BSK_v[r, c]), P_v = prod_{i in v}
//                   (NTT(X^{a_i}) - 1) from the monomial source.
//   RotDiffQuarter  word x of X^a acc - acc (fhe/pbs.py blind_rotate): acc[y]
//                   for y = (x - a) mod 2N, negated when y >= N, minus
//                   acc[x]; two ld_cluster a word, the first from whichever
//                   block owns y. The CMux was applied before the
//                   decomposition, so the product is S_c = sum_r F_r (.)
//                   BSK_i[r, c], reduced once: no P_v, no power table. (K1's
//                   function at g = 1 decomposes acc and scales by P_1 =
//                   X^a - 1 after the product: a blind rotation of the same
//                   input with other noise, so other words, as signed
//                   decomposition is not linear.)
// Epilogues (step 4), on the N^-1-scaled residues r_i of one coefficient:
//   Garner   pbs_common.cuh garner, the balanced lift.
//   CrtFold  the CRT partial-sum fold (fhe/ntt.py crt_fold), the same word.
// Transforms (steps 1 and 3):
//   RegisterPasses  the register passes (pbs_common.cuh fwd_radix /
//                   inv_radix / ntt_pass): 8 words a thread, up to 3
//                   radix-2 stages per pass, one shared-memory exchange per
//                   pass (3 at N = 512, 4 at 1024 and 2048), the twiddles
//                   staged in shared memory once per launch in the order the
//                   passes read them, rows bank-swizzled so that no pass
//                   conflicts. Frequencies in the standard (bit-reversed)
//                   order; N^-1 in the epilogue.
//   FourStepTC      the four-step NTT of fhe/ntt.py (N = 8 x N2). Forward:
//                   the 8-point stages are the first register pass (the
//                   same gather of 8 words at stride N2, the standard
//                   transform's first three twiddles), then the twist, the
//                   split into signed 8-bit limb planes [M, N2] in shared
//                   memory (M = 8 x rows x gt), and the N2-point stage as an
//                   int8 tensor-core product (mma.sync m16n8k32) against the
//                   N2 x N2 matrix's two limbs, the limb shifts recombined
//                   as sum_s acc_s (256^s c^-1 mod p) (c: the matrix's scale,
//                   3 for p = 65537, whose matrices take two limbs only in
//                   fhe/ntt.py's window, 1 otherwise). The product writes F
//                   in the four-step frequency order, which the BSK
//                   (ts_pbs.ts_server_key) and the monomials (ef4) follow;
//                   the products go straight to limb planes, and the
//                   inverse is the product against the inverse matrix, the
//                   inverse twist and the 8-point inverse stages, N^-1
//                   folded into both (no scale in the epilogue). The
//                   matrices are staged in shared memory by bulk copy where
//                   the plan's budget holds them (both directions at N =
//                   512, one or both at 1024, none at 2048: mb_pbs.py
//                   staged_mats), else read from L2; a warp holds one column
//                   block's B fragments in registers while it walks the
//                   product's rows.
// Monomial sources (step 2, NTT(X^a)[f] for P_v):
//   Lookup   the power table: psi^(a e_f mod 2N), e_f = 2 bitrev(f) + 1 (or
//            ef4[f] in the four-step order), staged in shared memory.
//   Ladder   the bit ladder of the TPU kernel K3 replaces: the Shoup product
//            of T[b][f] = NTT(X^(2^b))[f] over the set bits b of a
//            (pbs.monomial_tables), T read through the read-only path; the
//            step's NTT(X^a_i) - 1 of the tile's gates are built once per
//            (gate, i, frequency) before the forward passes, into [gt, g,
//            N] u16 after the body's layout (the power table stays staged,
//            unread, so that K3's layout is K1's plus that).
//
// What bounds it. Integer throughput: the products' multiply-adds and
// Barrett reductions, then the butterflies (tools/k1_phases.py splits K1's
// clocks by phase; PERF.md); FourStepTC trades the later register passes
// for limb splits, shared-memory fragment loads and recombinations, the
// tensor cores a small part of their peak. The intermediates F and S never
// reach device memory. Each tile reads its step's BSK slab from L2 once
// per step; device memory sees the BSK about once per wave of clusters. An
// H100 holds about 30 clusters of 4 blocks at once
// (cudaOccupancyMaxActiveClusters), so the tile plan counts waves: narrow
// widths (a circuit vector's levels) take tiles of one or two gates, and
// then the chain of barriers of one step sets the time.
//
// Exactness: u32 sums where every sum of products fits 32 bits (fits_u32:
// PRIMES_512, and then the BSK streams as u16), 64-bit sums otherwise;
// Barrett reductions per prime; the limb products in s32, every sum below
// 2^23 in magnitude.

#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TPB = 512;        // threads per block (ops/mb_pbs.py THREADS)
constexpr int STAGES = 2;       // BSK ring stages (STAGES)
constexpr int MAX_TILE = 8;     // gates per tile (MAX_TILE)
constexpr size_t SMEM_LIMIT = 232448;

// One launch's shape
struct Plan {
  int gt, lgt;  // gates per tile (a power of two) and its log
  int cf, lcf;  // frequencies per BSK chunk and its log
  int nch;      // chunks per step
  int gs;       // gate strides of the product items
  int chunk;    // BSK words per chunk
};

__host__ __device__ __forceinline__ size_t up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// The geometry of FourStepTC's N2-point products (N = 8 x N2) for a tile
// of gt gates: the limb planes hold rows of the product (8 per gadget row
// and gate; Mp, padded to the mma's 16) of N2 signed bytes, padded to the
// mma depth Kp (zeros) and 16 more (AS bytes a row: a fragment's 8 rows in
// distinct banks); a direction's matrices, both window limbs as B
// fragments [2, KK, NT, 32] of 8 bytes, take `mat` bytes per prime
struct TcGeo {
  int N2, logN2, KK, NT, AS, Mp;
  size_t plane, mat;
  __host__ __device__ TcGeo(const Shape& S, int gt) {
    N2 = S.N >> 3;
    logN2 = S.logN - 3;
    const int kp = (N2 + 31) & ~31;
    KK = kp >> 5;
    NT = N2 >> 3;
    AS = kp + 16;
    Mp = (S.rows * gt * 8 + 15) & ~15;
    plane = (size_t)Mp * AS;
    mat = (size_t)2 * kp * N2;
  }
};

// Dynamic shared memory of one block (ops/mb_pbs.py smem_bytes); the power
// table only where the word source scales by P_v (Src::kSubsets: K1 at
// every grouping, g = 1 too)
struct SmemLayout {
  size_t ring, bar, rows, accq, twf, twi, pw, swz, ab, total;
  __host__ __device__ SmemLayout(const Shape& S, int gt, int chunk, size_t elt, bool subsets) {
    ring = 0;
    bar = up((size_t)STAGES * chunk * elt, 128);
    rows = bar + up(STAGES * 8, 16);
    accq = rows + (size_t)S.rows * gt * S.N * 4;
    twf = accq + (size_t)S.kp1 * gt * (S.N / 4) * 4;
    twi = twf + (size_t)S.N * 8;
    pw = twi + (size_t)S.N * 8;
    swz = pw + (subsets ? (size_t)2 * S.N * 4 : 0);
    ab = swz + up(S.N, 16);
    total = ab + MAX_TILE * 4 * 4;
  }
};

// FourStepTC's shared memory after the body's (from SmemLayout::total):
// its two mbarriers, the 8-point stages' twiddle pairs, the staged
// directions of its limb matrices and nlmax limb planes
struct TcLayout {
  size_t tcbar, stw, mats, planes, total;
  __host__ __device__ TcLayout(const SmemLayout& lay, const TcGeo& T, int nlmax, int staged) {
    tcbar = lay.total;
    stw = tcbar + 16;
    mats = stw + 16 * 8;
    planes = mats + staged * T.mat;
    total = planes + nlmax * T.plane;
  }
};

struct Args {
  uint32_t* acc;          // [G, k+1, N]
  const int* abar;        // [G, n]
  const void* bsk;        // [n/g, NP, N/cf, 2^g-1, rows, k+1, cf] u16 or u32
  const uint2* twf;       // [NP, N] (w, w_sh), forward pass order (FourStepTC: its twist)
  const uint2* twi;       // [NP, N] inverse pass order (FourStepTC: its inverse twist)
  const uint32_t* pw;     // [NP, 2N]; read by Lookup where P_v scales the products
  const uint8_t* swz;     // [N]
};

// the lowest set bit of v > 0 (constant-folded in unrolled loops, so that
// register arrays stay registers)
__host__ __device__ constexpr int low_bit(int v) { return (v & 1) ? 0 : 1 + low_bit(v >> 1); }

// The word sources of step 1, for the task (component c, gate gi, column
// jj): word k (of 8) is coefficient x_k = jj + k N/8, whose owner quarter
// is k >> 1. peer: the four blocks' quarters (shared::cluster addresses);
// off: (c gt + gi) N/4 + jj; a: the step's mask element of the gate (read
// only by RotDiffQuarter).

// K1, K6: the bare accumulator
struct AccQuarter {
  static constexpr bool kSubsets = true;  // P_v scales the products
  const uint32_t (&peer)[NP];
  int off, N8;
  __device__ __forceinline__ AccQuarter(const uint32_t (&peer_acc)[NP], int off_, int N8_, int, int)
      : peer(peer_acc), off(off_), N8(N8_) {}
  __device__ __forceinline__ uint32_t operator()(int k) const {
    return ld_cluster(peer[k >> 1] + 4 * (off + (k & 1) * N8));
  }
};

// K2: X^a acc - acc, a = abar[gate, step] in [0, 2N) (fhe/ops.py
// negacyclic_rotate: coefficient x of X^a acc is acc[y] for y = (x - a)
// mod 2N < N, else -acc[y - N])
struct RotDiffQuarter {
  static constexpr bool kSubsets = false;  // one BSK product per row, no P_v
  const uint32_t (&peer)[NP];
  int off, N8, logN, a;
  __device__ __forceinline__ RotDiffQuarter(const uint32_t (&peer_acc)[NP], int off_, int N8_,
                                            int logN_, int a_)
      : peer(peer_acc), off(off_), N8(N8_), logN(logN_), a(a_) {}
  __device__ __forceinline__ uint32_t operator()(int k) const {
    const int N = 1 << logN, N4 = N >> 2;
    const int jj = off & (N8 - 1), base = off - jj;  // (c gt + gi) N/4
    const uint32_t own = ld_cluster(peer[k >> 1] + 4 * (off + (k & 1) * N8));
    int y = (jj + k * N8 - a) & (2 * N - 1);
    const bool neg = y >= N;
    y &= N - 1;
    const int q = y >> (logN - 2);  // y's owner quarter
    const uint32_t pq = q < 2 ? (q == 0 ? peer[0] : peer[1]) : (q == 2 ? peer[2] : peer[3]);
    const uint32_t rot = ld_cluster(pq + 4 * (base + (y & (N4 - 1))));
    return (neg ? 0u - rot : rot) - own;
  }
};

// The epilogues of step 4: the four N^-1-scaled residues of one
// coefficient -> the u32 word
struct Garner {
  __device__ __forceinline__ uint32_t operator()(const uint32_t (&r)[NP], const Consts& K) const {
    return garner(r[0], r[1], r[2], r[3], K);
  }
};

// x = sum_i r_i W_i - kq P (mod 2^32), the u32 sum wrapping, with kq =
// floor(s + 0.5), s = sum_i r_i (W_i / P) in double precision. That kq is
// exact: for every parameter set |x| <= conv_bound <= 0.389 P (GATES_128_K3
// with PRIMES_512 is the largest share), so s lies at least 0.11 from a
// half-integer, and the double sum of four products r_i < 2^17 by
// fractions rounded to 53 bits errs by under 2^-32. The result is
// Garner's balanced lift.
struct CrtFold {
  uint32_t w_mod[NP];  // W_i mod 2^32, W_i = (P/p_i) ((P/p_i)^-1 mod p_i)
  double frac[NP];     // W_i / P
  __device__ __forceinline__ uint32_t operator()(const uint32_t (&r)[NP], const Consts& K) const {
    uint32_t sum = 0;
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      sum += r[i] * w_mod[i];  // wrapping == mod 2^32
      s += (double)r[i] * frac[i];
    }
    const uint32_t kq = (uint32_t)(long long)floor(s + 0.5);  // s in [0, 2^19)
    return sum - kq * K.prod_mod_q;
  }
};

// The transforms of steps 1 and 3 and the monomial sources of step 2 (the
// header's note). A choice that carries data (FourStepTC: its tables and
// constants, ops/ts_pbs.py TsKernelKey, and the plan's staged matrices and
// limb planes; Ladder: its tables) is a kernel parameter after the
// epilogue; one that carries nothing (RegisterPasses, Lookup) is not, so
// that K1's parameters are as they were.
struct RegisterPasses {
  static constexpr bool kTensor = false;
};

struct FourStepTC {
  static constexpr bool kTensor = true;
  const uint2* bf;          // [NP, 2, KK, NT, 32] the forward matrix's B fragments
  const uint2* bi;          // the inverse matrix's
  const uint2* stw;         // [NP, 16] the 8-point stages' pairs: forward 1..7, inverse 9..15
  const int* ef4;           // [N] e_f at four-step position f
  const uint32_t* consts;   // [NP, 9]: the data's limbs, then 256^s c^-1 mod p, forward and inverse
  int nlmax, staged;        // limb planes; matrices in shared memory (0: none, 1: forward, 2: both)
};

// The monomial sources of step 2
struct Lookup {
  static constexpr bool kLadder = false;
};

struct Ladder {
  static constexpr bool kLadder = true;
  const uint32_t* t;     // [log2(2N), NP, N]: T[b][f] = NTT(X^(2^b))[f]
  const uint32_t* t_sh;  // their Shoup companions
  // NTT(X^a)[f] of prime pi, a in [0, 2N): T[b][f] multiplied over the set
  // bits b of a, lowest first (the branch is uniform: a warp's items share
  // their gates)
  __device__ __forceinline__ uint32_t operator()(int a, int f, int pi, int N, uint32_t p) const {
    uint32_t m = 1;
    for (unsigned bits = (unsigned)a; bits; bits &= bits - 1) {
      const size_t ti = ((size_t)(__ffs(bits) - 1) * NP + pi) * N + f;
      m = mul_shoup_min(m, __ldg(t + ti), __ldg(t_sh + ti), p);
    }
    return m;
  }
};

// FourStepTC's forward 8-point stages and twist of one column (the words
// jj + k N2 of one polynomial in v, k < 8), split into limbs at rows
// 0..7 (from planes) of the limb planes, column jj; tw: the prime's twist
__device__ __forceinline__ void tc_fwd_column(uint32_t (&v)[8], const uint2* stw, const uint2* tw,
                                              int jj, const TcGeo& T, int8_t* planes, uint32_t p,
                                              int nl) {
  fwd_radix<3>(v, stw, 0, 0, p);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint2 w = tw[k * T.N2 + jj];
    put_limbs(planes + k * T.AS + jj, T.plane, mul_shoup_min(v[k], w.x, w.y, p), p, nl);
  }
}

// FourStepTC's inverse twist and 8-point stages of one column, in place
__device__ __forceinline__ void tc_inv_column(uint32_t (&v)[8], const uint2* stw, const uint2* twi,
                                              int jj, const TcGeo& T, uint32_t p) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint2 w = twi[k * T.N2 + jj];
    v[k] = mul_shoup_min(v[k], w.x, w.y, p);
  }
  inv_radix<3>(v, stw + 8, 0, 0, 3, p);
}

// FourStepTC's N2-point product: rows [0, M) of the limb planes (nl <=
// MAXL of them) times this prime's matrix B (the B fragments of its two
// window limbs, N2 <= 32 MAXKK, in shared or device memory) on the tensor
// cores, the limb shifts recombined as sum_s acc_s rc[s] mod p, into the
// tile's rows: output (m, col) is word m N2 + col of the [rows, gt, N]
// rows, at its swizzled address. Each warp takes a run of 16 x 8 output
// tiles, column block-major, and holds a column block's B fragments in
// registers while it walks the rows. The caller synchronises.
template <int MAXKK, int MAXL>
__device__ __forceinline__ void tc_product(const int8_t* planes, const TcGeo& T, int M, int nl,
                                           const uint2* B, const uint32_t (&rc)[4], uint32_t p,
                                           unsigned long long mu, uint32_t* rows,
                                           const RowSwizzle& sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3, N = 1 << sw.logN;
  const int MT = (M + 15) >> 4, tiles = MT * T.NT, per = (tiles + nw - 1) / nw;  // per warp
  const int t1 = min(tiles, (warp + 1) * per);
  // |acc_s| <= 2 x 256 x 2^14 = 2^23, so acc_s + 2^24 is a positive u32 and
  // sum_s (acc_s + 2^24) rc_s + off = sum_s acc_s rc_s (mod p), off = p
  // 2^31 - 2^24 sum_s rc_s > 0 (s <= MAXL, rc_s < 2^17): u32 x u32
  // multiply-adds, the sum below 2^45
  uint32_t rcs = 0;
#pragma unroll
  for (int s = 0; s <= MAXL; ++s) rcs += rc[s];
  const unsigned long long off = ((unsigned long long)p << 31) - ((unsigned long long)rcs << 24);
  uint2 b[2][MAXKK];
  int cur = -1;
  for (int tile = warp * per; tile < t1; ++tile) {
    const int nt = tile / MT, mt = tile - nt * MT;
    if (nt != cur) {
      cur = nt;
#pragma unroll
      for (int kk = 0; kk < MAXKK; ++kk)
        if (kk < T.KK) {
          b[0][kk] = B[((size_t)kk * T.NT + nt) * 32 + lane];
          b[1][kk] = B[((size_t)(T.KK + kk) * T.NT + nt) * 32 + lane];
        }
    }
    int acc[MAXL + 1][4] = {};
    // ldmatrix.x4: lanes 8j..8j+7 give the rows of the j-th 8 x 16-byte
    // matrix (rows +8 for odd j, bytes +16 for j >= 2): a0..a3 in one load
    const int8_t* A =
        planes + (size_t)(mt * 16 + (lane & 7) + (lane & 8)) * T.AS + (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < MAXKK; ++kk) {
      if (kk >= T.KK) break;
#pragma unroll
      for (int la = 0; la < MAXL; ++la) {
        if (la >= nl) break;
        uint32_t a[4];
        ldsm_x4(a, A + la * T.plane + kk * 32);
        mma_s8(acc[la], a[0], a[1], a[2], a[3], b[0][kk].x, b[0][kk].y);
        mma_s8(acc[la + 1], a[0], a[1], a[2], a[3], b[1][kk].x, b[1][kk].y);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mt * 16 + g + (e >> 1) * 8, col = nt * 8 + 2 * t + (e & 1);
      if (row < M) {
        unsigned long long v = off;
#pragma unroll
        for (int s = 0; s <= MAXL; ++s)
          v += (unsigned long long)(uint32_t)(acc[s][e] + (1 << 24)) * rc[s];
        const int w = row * T.N2 + col;
        rows[sw.at(w >> sw.logN, w & (N - 1))] = reduce64(v, p, mu);
      }
    }
  }
}

// The choice of type T among the kernel's carried parameters, or T{} (a
// choice that carries nothing) when none is of type T
template <class T>
__device__ __forceinline__ T carried_or_empty() {
  return T{};
}

template <class T, class A, class... R>
__device__ __forceinline__ T carried_or_empty(const A& a, const R&... r) {
  if constexpr (std::is_same<T, A>::value) return a;
  else return carried_or_empty<T>(r...);
}

// One rotation of a tile of gates per cluster; GB: the grouping g, ROWS:
// the gadget rows (compile-time, so that the product loop's registers and
// addresses fold), NARROW: u32 sums and a u16 BSK; Src: the word source,
// Epi: the epilogue; Xf: the transform, Mono: the monomial source, and
// `carried` the parameters of those that carry data. K1's choices
// (RegisterPasses, Lookup) carry nothing, and every other choice's code is
// a block behind `if constexpr` that leaves K1's statements as they were:
// K1's instantiations keep their machine code (tools/kernel_ab.py sass)
template <int GB, int ROWS, bool NARROW, class Src, class Epi, class Xf = RegisterPasses,
          class Mono = Lookup, class... Carried>
__global__ void __launch_bounds__(TPB, 1) rotate_tiles(Args a, Shape S, Consts K, Plan L, Epi E,
                                                       Carried... carried) {
  using BT = typename std::conditional<NARROW, uint16_t, uint32_t>::type;
  using AT = typename std::conditional<NARROW, uint32_t, unsigned long long>::type;
  constexpr int NV1 = (1 << GB) - 1;  // non-empty subsets
  static_assert(Src::kSubsets || GB == 1, "the rotated difference is a single-bit CMux");
  cg::cluster_group cluster = cg::this_cluster();
  const int pi = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int gt = L.gt, lgt = L.lgt;
  const int g0 = blockIdx.y * gt, ng = min(gt, S.G - g0);
  const int N = S.N, logN = S.logN, N4 = N >> 2, N8 = N >> 3, kp1 = S.kp1;
  const uint32_t p = K.p[pi], mu32 = K.mu32[pi];
  const unsigned long long mu = K.mu[pi];
  auto reduce = [&](AT x) -> uint32_t {
    if constexpr (NARROW) return reduce32_min(x, p, mu32);
    else return reduce64(x, p, mu);
  };

  const SmemLayout lay(S, gt, L.chunk, sizeof(BT), Src::kSubsets);
  BT* ring = reinterpret_cast<BT*>(smem_raw + lay.ring);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + lay.bar);
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem_raw + lay.rows);  // [rows, gt, N]
  uint32_t* accq = reinterpret_cast<uint32_t*>(smem_raw + lay.accq);  // [k+1, gt, N/4]
  uint2* twf = reinterpret_cast<uint2*>(smem_raw + lay.twf);
  uint2* twi = reinterpret_cast<uint2*>(smem_raw + lay.twi);
  uint32_t* pws = reinterpret_cast<uint32_t*>(smem_raw + lay.pw);
  uint8_t* swz = smem_raw + lay.swz;
  int* abs = reinterpret_cast<int*>(smem_raw + lay.ab);  // the group's a_i [gt, g]
  const RowSwizzle sw{swz, logN};

  // the BSK ring: chunk q of the rotation is step q / nch, chunk q % nch
  const int ngroups = S.n / GB, nq = ngroups * L.nch;
  const uint32_t cbytes = (uint32_t)(L.chunk * sizeof(BT));
  const BT* bsk = reinterpret_cast<const BT*>(a.bsk);
  auto chunk_src = [&](int q) {
    const int j = q / L.nch, ch = q % L.nch;
    return bsk + (((size_t)j * NP + pi) * L.nch + ch) * L.chunk;
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
    for (int q = 0; q < STAGES && q < nq; ++q)
      bulk_load(ring + (size_t)q * L.chunk, chunk_src(q), cbytes, &bar[q]);
    if constexpr (Xf::kTensor) {  // the limb matrices the plan stages, once per launch
      const Xf X = carried_or_empty<Xf>(carried...);
      const TcGeo T(S, gt);
      const TcLayout tl(lay, T, X.nlmax, X.staged);
      uint64_t* tcbar = reinterpret_cast<uint64_t*>(smem_raw + tl.tcbar);
      for (int d = 0; d < X.staged; ++d) mbar_init(&tcbar[d], 1);
      mbar_fence_init();
      for (int d = 0; d < X.staged; ++d)
        bulk_load(smem_raw + tl.mats + d * T.mat,
                  reinterpret_cast<const char*>(d ? X.bi : X.bf) + pi * T.mat, (uint32_t)T.mat,
                  &tcbar[d]);
    }
  }
  // this prime's tables, and this block's quarter of the accumulators
  for (int i = tid; i < N; i += TPB) {
    twf[i] = a.twf[pi * N + i];
    twi[i] = a.twi[pi * N + i];
  }
  if constexpr (Src::kSubsets)
    for (int i = tid; i < 2 * N; i += TPB) pws[i] = a.pw[pi * 2 * N + i];
  for (int i = tid; i < N; i += TPB) swz[i] = a.swz[i];
  if constexpr (Xf::kTensor) {  // the 8-point stages' pairs; the planes' zero padding to Kp
    const Xf X = carried_or_empty<Xf>(carried...);
    const TcGeo T(S, gt);
    const TcLayout tl(lay, T, X.nlmax, X.staged);
    int8_t* planes = reinterpret_cast<int8_t*>(smem_raw + tl.planes);
    const int pad = T.AS - 16 - T.N2, cells = T.Mp * pad;
    if (tid < 16) reinterpret_cast<uint2*>(smem_raw + tl.stw)[tid] = X.stw[pi * 16 + tid];
    for (int i = tid; i < X.nlmax * cells; i += TPB) {
      const int l = i / cells, r = i - l * cells;
      planes[l * T.plane + (size_t)(r / pad) * T.AS + T.N2 + r % pad] = 0;
    }
  }
  const int nacc = kp1 * gt * N4;
  for (int it = tid; it < nacc; it += TPB) {
    const int xq = it & (N4 - 1), cgi = it >> (logN - 2);
    const int gi = cgi & (gt - 1), c = cgi >> lgt;
    if (gi < ng) accq[it] = a.acc[((size_t)(g0 + gi) * kp1 + c) * N + pi * N4 + xq];
  }
  __syncthreads();
  cluster.sync();  // every block's quarter is in place

  // the four blocks' quarters and rows, as shared::cluster addresses
  uint32_t peer_acc[NP], peer_rows[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    peer_acc[i] = cluster_addr(smem_u32(accq), i);
    peer_rows[i] = cluster_addr(smem_u32(rows), i);
  }
  const int items = kp1 * L.cf * L.gs;  // product items, <= TPB

  int q = 0;  // chunks consumed
  for (int j = 0; j < ngroups; ++j) {
    // 1. decomposition fused with the first forward pass: one task per
    //    (component c, gate gi, column jj), words x_k = jj + k N/8, whose
    //    owner quarter is k >> 1
    uint32_t hk[8];  // the swizzle of the first pass's strides k N/8
#pragma unroll
    for (int k = 0; k < 8; ++k) hk[k] = sw.hx[k << (logN - 3)];
    if constexpr (Src::kSubsets)
      if (tid < ng * GB) abs[tid] = __ldg(a.abar + (size_t)(g0 + tid / GB) * S.n + j * GB + tid % GB);
    for (int tk = tid; tk < kp1 * gt * N8; tk += TPB) {
      const int jj = tk & (N8 - 1), cgi = tk >> (logN - 3);
      const int gi = cgi & (gt - 1), c = cgi >> lgt;
      if (gi >= ng) continue;
      int bl, lv, row0;
      if (c < S.k) {
        bl = S.mask_bl; lv = S.mask_lv; row0 = c * S.mask_lv;
      } else {
        bl = S.bl; lv = S.lv; row0 = S.k * S.mask_lv;
      }
      const int total = bl * lv;  // < 32 (checked on the host)
      const uint32_t b = 1u << bl, half = b >> 1;
      const int off = ((c * gt + gi) << (logN - 2)) + jj;
      const Src src(peer_acc, off, N8, logN,
                    Src::kSubsets ? 0 : __ldg(a.abar + (size_t)(g0 + gi) * S.n + j));
      uint32_t r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // fhe/ops.py signed_decompose: round to the top bl*lv bits
        const uint32_t w = src(k);
        r[k] = (((w >> (32 - total - 1)) + 1u) >> 1) & ((1u << total) - 1u);
      }
      // least significant level first; level 0 (weight q/B) is row0
      for (int lvl = lv - 1; lvl >= 0; --lvl) {
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          int d = (int)(r[k] & (b - 1u));
          const uint32_t carry = (uint32_t)d >= half;
          if (carry) d -= (int)b;
          r[k] = (r[k] >> bl) + carry;
          // floor-mod: |d| <= B/2 < p (checked on the host), so d + p or d
          const uint32_t dp = (uint32_t)(d + (int)p);
          v[k] = min(dp, dp - p);
        }
        if constexpr (Xf::kTensor) {  // the 8-point stages, the twist, the limb planes
          const Xf X = carried_or_empty<Xf>(carried...);
          const TcGeo T(S, gt);
          const TcLayout tl(lay, T, X.nlmax, X.staged);
          tc_fwd_column(v, reinterpret_cast<const uint2*>(smem_raw + tl.stw), twf, jj, T,
                        reinterpret_cast<int8_t*>(smem_raw + tl.planes) +
                            (size_t)((row0 + lvl) * gt + gi) * 8 * T.AS,
                        p, (int)__ldg(X.consts + pi * 9));
          continue;
        }
        fwd_radix<3>(v, twf, 0, 0, p);
        const int rr = (row0 + lvl) * gt + gi;
        const int ub = (rr << logN) | jj, hb = sw.hx[jj];
#pragma unroll
        for (int k = 0; k < 8; ++k) rows[(ub | (k << (logN - 3))) ^ hb ^ hk[k]] = v[k];
      }
    }
    __syncthreads();
    if constexpr (Mono::kLadder) {  // the step's NTT(X^a_i) - 1 by the ladder, [ng, g, N] u16
      const Mono M = carried_or_empty<Mono>(carried...);
      uint16_t* mono = reinterpret_cast<uint16_t*>(smem_raw + lay.total);
      for (int it = tid; it < ng * GB * N; it += TPB)  // psi^t >= 1 so no wrap; < 2^16
        mono[it] = (uint16_t)(M(abs[it >> logN], it & (N - 1), pi, N, p) - 1u);
    }
    if constexpr (Xf::kTensor) {  // the N2-point stage on the tensor cores -> F, four-step order
      const Xf X = carried_or_empty<Xf>(carried...);
      const TcGeo T(S, gt);
      const TcLayout tl(lay, T, X.nlmax, X.staged);
      if (X.staged > 0) mbar_wait(reinterpret_cast<uint64_t*>(smem_raw + tl.tcbar), 0);
      uint32_t rc[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) rc[s] = __ldg(X.consts + pi * 9 + 1 + s);
      tc_product<NARROW ? 2 : 8, NARROW ? 2 : 3>(
          reinterpret_cast<const int8_t*>(smem_raw + tl.planes), T, S.rows * gt * 8,
          (int)__ldg(X.consts + pi * 9),
          X.staged > 0 ? reinterpret_cast<const uint2*>(smem_raw + tl.mats) : X.bf + pi * T.mat / 8,
          rc, p, mu, rows, sw);
      __syncthreads();
    } else
    ntt_passes<false>(rows, S.rows * gt, gt, ng, 1, twf, sw, p);

    // 2. the products, one BSK chunk at a time
    for (int ch = 0; ch < L.nch; ++ch, ++q) {
      const int st = q % STAGES;
      mbar_wait(&bar[st], (q / STAGES) & 1);
      const BT* bs = ring + (size_t)st * L.chunk;
      uint32_t out[MAX_TILE];
      int c = 0, gs = 0, fx = 0;
      if (tid < items) {
        const int fl = tid & (L.cf - 1), cgs = tid >> L.lcf;
        c = cgs % kp1;
        gs = cgs / kp1;
        const int f = ch * L.cf + fl;
        fx = f ^ sw.hx[f];  // the frequency's swizzled offset in every row
        uint32_t B[NV1][ROWS];
        const BT* bc = bs + c * L.cf + fl;
        const int bstride = kp1 * L.cf;  // between (v, r) pairs
#pragma unroll
        for (int v = 0; v < NV1; ++v)
#pragma unroll
          for (int r = 0; r < ROWS; ++r) B[v][r] = bc[(v * ROWS + r) * bstride];
        const int e = 2 * (int)(__brev((unsigned)f) >> (32 - logN)) + 1, mask2n = 2 * N - 1;
#pragma unroll
        for (int u = 0; u < MAX_TILE; ++u) {
          const int gi = gs + u * L.gs;
          if (gi >= ng) break;
          if constexpr (Src::kSubsets) {
            uint32_t d[GB];
            if constexpr (Mono::kLadder) {  // the step's ladder monomials (before the passes)
              const uint16_t* mono = reinterpret_cast<const uint16_t*>(smem_raw + lay.total) +
                                     ((size_t)(gi * GB) << logN) + f;
#pragma unroll
              for (int i = 0; i < GB; ++i) d[i] = mono[i << logN];
            } else if constexpr (Xf::kTensor) {  // the power table at e_f of the four-step order
              const int e4 = __ldg(carried_or_empty<Xf>(carried...).ef4 + f);
#pragma unroll
              for (int i = 0; i < GB; ++i) d[i] = pws[(abs[gi * GB + i] * e4) & mask2n] - 1u;
            } else {
#pragma unroll
            for (int i = 0; i < GB; ++i)  // NTT(X^a_i) - 1; psi^t >= 1 so no wrap
              d[i] = pws[(abs[gi * GB + i] * e) & mask2n] - 1u;
            }
            uint32_t P[NV1 + 1];
            P[0] = 1;
#pragma unroll
            for (int v = 1; v <= NV1; ++v) {
              const int lo = low_bit(v);
              P[v] = (v == (1 << lo)) ? d[lo] : reduce((AT)P[v & (v - 1)] * d[lo]);
            }
            uint32_t F[ROWS];
            const uint32_t* fr = rows + (gi << logN) + fx;
#pragma unroll
            for (int r = 0; r < ROWS; ++r, fr += gt << logN) F[r] = *fr;
            AT s = 0;
#pragma unroll
            for (int v = 0; v < NV1; ++v) {
              AT t = 0;
#pragma unroll
              for (int r = 0; r < ROWS; ++r) t += (AT)F[r] * B[v][r];
              s += (AT)P[v + 1] * reduce(t);
            }
            out[u] = reduce(s);
          } else {
            uint32_t F[ROWS];
            const uint32_t* fr = rows + (gi << logN) + fx;
#pragma unroll
            for (int r = 0; r < ROWS; ++r, fr += gt << logN) F[r] = *fr;
            AT t = 0;
#pragma unroll
            for (int r = 0; r < ROWS; ++r) t += (AT)F[r] * B[0][r];
            out[u] = reduce(t);
          }
        }
      }
      __syncthreads();  // the chunk's gadget rows are read; its ring stage is free
      if (tid == 0 && q + STAGES < nq)
        bulk_load(ring + (size_t)st * L.chunk, chunk_src(q + STAGES), cbytes, &bar[st]);
      if constexpr (Xf::kTensor) {  // S straight into the limb planes: row (c gt + gi) 8 + fA_s
        if (tid < items) {
          const Xf X = carried_or_empty<Xf>(carried...);
          const TcGeo T(S, gt);
          const TcLayout tl(lay, T, X.nlmax, X.staged);
          const int f = ch * L.cf + (tid & (L.cf - 1)), nl = (int)__ldg(X.consts + pi * 9);
          int8_t* dst = reinterpret_cast<int8_t*>(smem_raw + tl.planes) +
                        (size_t)(c * gt * 8 + (f >> T.logN2)) * T.AS + (f & (T.N2 - 1));
#pragma unroll
          for (int u = 0; u < MAX_TILE; ++u) {
            const int gi = gs + u * L.gs;
            if (gi >= ng) break;
            put_limbs(dst + (size_t)gi * 8 * T.AS, T.plane, out[u], p, nl);
          }
        }
        continue;
      }
      if (tid < items) {
#pragma unroll
        for (int u = 0; u < MAX_TILE; ++u) {
          const int gi = gs + u * L.gs;
          if (gi >= ng) break;
          rows[((c * gt + gi) << logN) + fx] = out[u];
        }
      }
    }
    __syncthreads();

    // 3. the inverse NTTs of the k+1 products
    if constexpr (Xf::kTensor) {  // the inverse product; per column the twist and 8-point stages
      const Xf X = carried_or_empty<Xf>(carried...);
      const TcGeo T(S, gt);
      const TcLayout tl(lay, T, X.nlmax, X.staged);
      if (X.staged > 1) mbar_wait(reinterpret_cast<uint64_t*>(smem_raw + tl.tcbar) + 1, 0);
      uint32_t rc[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) rc[s] = __ldg(X.consts + pi * 9 + 5 + s);
      tc_product<NARROW ? 2 : 8, NARROW ? 2 : 3>(
          reinterpret_cast<const int8_t*>(smem_raw + tl.planes), T, kp1 * gt * 8,
          (int)__ldg(X.consts + pi * 9),
          X.staged > 1 ? reinterpret_cast<const uint2*>(smem_raw + tl.mats + T.mat)
                       : X.bi + pi * T.mat / 8,
          rc, p, mu, rows, sw);
      __syncthreads();
      const uint2* stw = reinterpret_cast<const uint2*>(smem_raw + tl.stw);
      for (int tk = tid; tk < kp1 * gt * N8; tk += TPB) {
        const int jj = tk & (N8 - 1), cgi = tk >> (logN - 3);
        if ((cgi & (gt - 1)) >= ng) continue;
        const int ub = (cgi << logN) | jj, hb = sw.hx[jj];
        uint32_t v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = rows[(ub | (k << (logN - 3))) ^ hb ^ sw.hx[k << (logN - 3)]];
        tc_inv_column(v, stw, twi, jj, T, p);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          rows[(ub | (k << (logN - 3))) ^ hb ^ sw.hx[k << (logN - 3)]] = v[k];
      }
    } else
    ntt_passes<true>(rows, kp1 * gt, gt, ng, 0, twi, sw, p);
    cluster.sync();  // every prime's residues are in its block

    // 4. the epilogue on this block's quarter, acc += result
    for (int it = tid; it < nacc; it += TPB) {
      const int xq = it & (N4 - 1), cgi = it >> (logN - 2);
      const int gi = cgi & (gt - 1), c = cgi >> lgt;
      if (gi >= ng) continue;
      const int ad = sw.at(c * gt + gi, pi * N4 + xq);
      uint32_t res[NP];
      if constexpr (Xf::kTensor) {  // N^-1 is folded into the inverse twist and matrix
#pragma unroll
        for (int i = 0; i < NP; ++i) res[i] = ld_cluster(peer_rows[i] + 4 * ad);
        accq[it] += E(res, K);
        continue;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i)
        res[i] = mul_shoup(ld_cluster(peer_rows[i] + 4 * ad), K.n_inv[i], K.n_inv_sh[i], K.p[i]);
      accq[it] += E(res, K);
    }
    cluster.sync();  // the quarters are updated, and no peer reads our rows
  }

  for (int it = tid; it < nacc; it += TPB) {
    const int xq = it & (N4 - 1), cgi = it >> (logN - 2);
    const int gi = cgi & (gt - 1), c = cgi >> lgt;
    if (gi < ng) a.acc[((size_t)(g0 + gi) * kp1 + c) * N + pi * N4 + xq] = accq[it];
  }
}

// ---------------------------------------------------------------------
// Host side, shared by the five C interfaces

// The kernel type of a build: the carried choices C (none for K1, K6, K2;
// FourStepTC for K4; Ladder for K3) are its parameters after the epilogue
template <class Epi, class... C>
using Kernel = void (*)(Args, Shape, Consts, Plan, Epi, C...);

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// the signed 8-bit limbs of a prime's balanced residues (fhe/ntt.py limb_count)
int limb_count(uint32_t p) { return p / 2 <= 32639 ? 2 : 3; }

// The launch configuration of `tiles` clusters with `smem` bytes a block
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(int tiles, size_t smem, cudaStream_t st) {
    cfg.gridDim = dim3(NP, tiles);
    cfg.blockDim = dim3(TPB);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = NP;  // the grid's prime axis is exactly one cluster
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Checks the arguments and fills S, K, L and the kernel (select(S,
// narrow): the file's build for the shape, or nullptr); false when the
// kernels cannot take them, or when the BSK's element size elt is not the
// one the shape's sums call for. The layout stages the power table where
// the file's word source Src scales by P_v (AccQuarter, g = 1 too), not for
// RotDiffQuarter. For a build that
// carries FourStepTC, *staged is the most directions of its matrices (2,
// 1, 0) whose layout fits (ops/mb_pbs.py staged_mats) and *nlmax its limb
// planes: the largest prime's limb_count. A build that carries Ladder adds
// its step's monomials.
template <class Src, class Epi, class... C>
bool prepare(Shape& S, Consts& K, Plan& L, Kernel<Epi, C...>& kern, size_t& smem,
             Kernel<Epi, C...> (*select)(const Shape&, bool), const uint32_t* consts, int G,
             int n, int N, int k, int g, int mask_bl, int mask_lv, int bl, int lv, int gt, int cf,
             int elt, int* staged = nullptr, int* nlmax = nullptr) {
  if (!make_shape(S, G, n, N, k, g, mask_bl, mask_lv, bl, lv) || n % g != 0 ||
      !load_consts(K, consts) || gt < 1 || gt > MAX_TILE || (gt & (gt - 1)) != 0 || cf < 32 ||
      cf > N || (cf & (cf - 1)) != 0 || S.kp1 * cf > TPB || S.logN < 6 ||
      (1u << (S.bl - 1)) >= K.p[0] || (1u << (S.mask_bl - 1)) >= K.p[0])
    return false;  // the digits' floor-mod takes |d| <= B/2 < p
  const int nv1 = (1 << g) - 1;
  const bool narrow = fits_u32(K, S.rows) && fits_u32(K, nv1);
  if (elt != (narrow ? 2 : 4)) return false;
  kern = select(S, narrow);
  L.gt = gt;
  L.lgt = ilog2(gt);
  L.cf = cf;
  L.lcf = ilog2(cf);
  L.nch = N / cf;
  L.gs = 1;
  while (L.gs < gt && S.kp1 * cf * L.gs * 2 <= TPB) L.gs *= 2;
  L.chunk = nv1 * S.rows * S.kp1 * cf;
  const SmemLayout lay(S, gt, L.chunk, narrow ? 2 : 4, Src::kSubsets);
  smem = lay.total;
  if constexpr ((std::is_same<C, Ladder>::value || ...))
    smem += (size_t)gt * g * N * 2;  // the step's monomials [gt, g, N] u16 after the rest
  if constexpr ((std::is_same<C, FourStepTC>::value || ...)) {
    const TcGeo T(S, gt);
    *nlmax = limb_count(K.p[NP - 1]);
    if (narrow && (T.KK > 2 || *nlmax > 2)) return false;  // the narrow build's fragments
    for (*staged = 2; *staged > 0; --*staged)
      if (TcLayout(lay, T, *nlmax, *staged).total <= SMEM_LIMIT) break;
    smem = TcLayout(lay, T, *nlmax, *staged).total;
  }
  return kern != nullptr && smem <= SMEM_LIMIT &&
         cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) ==
             cudaSuccess;
}

// One launch of the tiles of G gates, with the build's carried choices.
// Returns a cudaError_t.
template <class Epi, class... C>
int launch_tiles(Kernel<Epi, C...> kern, size_t smem, const Args& args, const Shape& S,
                 const Consts& K, const Plan& L, const Epi& E, void* stream, const C&... carried) {
  Launch la((S.G + L.gt - 1) / L.gt, smem, (cudaStream_t)stream);
  const cudaError_t e = cudaLaunchKernelEx(&la.cfg, kern, args, S, K, L, E, carried...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The clusters of `kern` the card holds at once (cudaOccupancyMaxActiveClusters),
// into *clusters, and its dynamic shared memory, into *smem_bytes. Returns
// a cudaError_t.
template <class Epi, class... C>
int active_clusters(Kernel<Epi, C...> kern, size_t smem, int* clusters, int* smem_bytes) {
  *smem_bytes = (int)smem;
  Launch la(1, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &la.cfg);
}

}  // namespace
