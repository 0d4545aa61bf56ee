// The persistent-cluster blind rotation for Hopper (sm_90a): one kernel
// body, rotate_tiles, for three kernels of the port. Each includes this
// header and instantiates the body with its word source and epilogue:
//   blind_rotate_mb.cu  K1  multi-bit, additive-identity CMux   <AccQuarter, Garner>
//   blind_rotate_ps.cu  K6  K1's function, CRT partial-sum fold  <AccQuarter, CrtFold>
//   blind_rotate_sb.cu  K2  single-bit, rotated-difference CMux  <RotDiffQuarter, Garner>
//
// One launch per rotation. A thread-block cluster of NP = 4 blocks (one
// per CRT prime, 512 threads, one block per SM) owns a tile of gt gates (a
// power of two; the host's tile_plan in ops/mb_pbs.py picks it from the
// shared-memory budget, the width and the clusters the card holds at once)
// and keeps, across all the rotation's steps, its accumulators in shared
// memory: block pi holds the quarter of coefficients [pi N/4, (pi+1) N/4)
// of every (gate, component). A step is a group of g mask elements (K1,
// K6) or one mask element (K2, g = 1). Per step, each block
//   1. decomposes the tile's words (the word source reads them from the
//      four blocks' quarters through distributed shared memory), reduces
//      the digits mod its prime, and runs the forward NTT's first register
//      pass on them before they reach shared memory; then the other passes
//      (rows [rows, gt, N] u32 in shared memory: F never leaves the SM);
//   2. forms the products per frequency, chunk by chunk against its
//      prime's slab of the step's BSK, which streams through a 2-stage
//      ring by cp.async.bulk on mbarriers (the next chunk, also the next
//      step's first ones, loads while the current one is multiplied and
//      while the NTTs run). A thread takes one (frequency, component) and
//      holds its (2^g-1) x rows BSK words in registers across the tile's
//      gates, so each word is read from the ring once per tile. The
//      products overwrite rows 0..k of the tile in place once the chunk's
//      gadget rows are read;
//   3. runs the inverse NTTs of the k+1 components;
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
//                   (X^{a_i} - 1) by direct lookup in the power table
//                   (NTT(X^a)[f] = psi^(a e_f mod 2N), e_f = 2 bitrev(f) + 1).
//   RotDiffQuarter  word x of X^a acc - acc (fhe/pbs.py blind_rotate): acc[y]
//                   for y = (x - a) mod 2N, negated when y >= N, minus
//                   acc[x]; two ld_cluster a word, the first from whichever
//                   block owns y. The CMux was applied before the
//                   decomposition, so the product is S_c = sum_r F_r (.)
//                   BSK_i[r, c], reduced once: no P_v, no power table. (K1's
//                   function at g = 1 decomposes acc and scales by X^a - 1
//                   after the product: other words, as signed decomposition
//                   is not linear.)
// Epilogues (step 4), on the N^-1-scaled residues r_i of one coefficient:
//   Garner   pbs_common.cuh garner, the balanced lift.
//   CrtFold  the CRT partial-sum fold (fhe/ntt.py crt_fold), the same word.
//
// The NTTs run in register passes (pbs_common.cuh fwd_radix / inv_radix /
// ntt_pass): 8 words a thread, up to 3 radix-2 stages per pass, one
// shared-memory exchange per pass (3 at N = 512, 4 at 1024 and 2048),
// the twiddles staged in shared memory once per launch in the order the
// passes read them, rows bank-swizzled so that no pass conflicts.
//
// What bounds it. Integer throughput: the products' multiply-adds and
// Barrett reductions, then the butterflies (tools/k1_phases.py splits K1's
// clocks by phase; PERF.md). The intermediates F and S never reach device
// memory, and shared memory is touched once per register pass, not per
// stage. Each tile reads its step's BSK slab from L2 once per step; device
// memory sees the BSK about once per wave of clusters. An H100 holds about
// 30 clusters of 4 blocks at once (cudaOccupancyMaxActiveClusters), so the
// tile plan counts waves: narrow widths (a circuit vector's levels) take
// tiles of one or two gates, and then the chain of barriers of one step
// sets the time.
//
// No tensor cores: the products are per-frequency [gt, rows] x [rows,
// (2^g-1)(k+1)] with rows = 4-9, far below mma's depth of 32, and the
// int8-limb NTT on the tensor cores (K4, blind_rotate_ts.cu) measured
// 0.91-3.6x K1's three-launch predecessor at these ring sizes.
//
// Exactness: u32 sums where every sum of products fits 32 bits (fits_u32:
// PRIMES_512, and then the BSK streams as u16), 64-bit sums otherwise;
// Barrett reductions per prime.

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

// Dynamic shared memory of one block (ops/mb_pbs.py smem_bytes); the power
// table only where the word source scales by P_v (g > 1)
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

struct Args {
  uint32_t* acc;          // [G, k+1, N]
  const int* abar;        // [G, n]
  const void* bsk;        // [n/g, NP, N/cf, 2^g-1, rows, k+1, cf] u16 or u32
  const uint2* twf;       // [NP, N] (w, w_sh), forward pass order
  const uint2* twi;       // [NP, N] inverse pass order
  const uint32_t* pw;     // [NP, 2N]; not read by RotDiffQuarter
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

// One rotation of a tile of gates per cluster; GB: the grouping g, ROWS:
// the gadget rows (compile-time, so that the product loop's registers and
// addresses fold), NARROW: u32 sums and a u16 BSK; Src: the word source,
// Epi: the epilogue
template <int GB, int ROWS, bool NARROW, class Src, class Epi>
__global__ void __launch_bounds__(TPB, 1) rotate_tiles(Args a, Shape S, Consts K, Plan L, Epi E) {
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
  }
  // this prime's tables, and this block's quarter of the accumulators
  for (int i = tid; i < N; i += TPB) {
    twf[i] = a.twf[pi * N + i];
    twi[i] = a.twi[pi * N + i];
  }
  if constexpr (Src::kSubsets)
    for (int i = tid; i < 2 * N; i += TPB) pws[i] = a.pw[pi * 2 * N + i];
  for (int i = tid; i < N; i += TPB) swz[i] = a.swz[i];
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
        fwd_radix<3>(v, twf, 0, 0, p);
        const int rr = (row0 + lvl) * gt + gi;
        const int ub = (rr << logN) | jj, hb = sw.hx[jj];
#pragma unroll
        for (int k = 0; k < 8; ++k) rows[(ub | (k << (logN - 3))) ^ hb ^ hk[k]] = v[k];
      }
    }
    __syncthreads();
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
#pragma unroll
            for (int i = 0; i < GB; ++i)  // NTT(X^a_i) - 1; psi^t >= 1 so no wrap
              d[i] = pws[(abs[gi * GB + i] * e) & mask2n] - 1u;
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
    ntt_passes<true>(rows, kp1 * gt, gt, ng, 0, twi, sw, p);
    cluster.sync();  // every prime's residues are in its block

    // 4. the epilogue on this block's quarter, acc += result
    for (int it = tid; it < nacc; it += TPB) {
      const int xq = it & (N4 - 1), cgi = it >> (logN - 2);
      const int gi = cgi & (gt - 1), c = cgi >> lgt;
      if (gi >= ng) continue;
      const int ad = sw.at(c * gt + gi, pi * N4 + xq);
      uint32_t res[NP];
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
// Host side, shared by the three C interfaces

template <class Epi>
using Kernel = void (*)(Args, Shape, Consts, Plan, Epi);

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

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
// one the shape's sums call for. The layout stages the power table for
// g > 1 (AccQuarter), not for g = 1 (RotDiffQuarter).
template <class Epi>
bool prepare(Shape& S, Consts& K, Plan& L, Kernel<Epi>& kern, size_t& smem,
             Kernel<Epi> (*select)(const Shape&, bool), const uint32_t* consts, int G, int n,
             int N, int k, int g, int mask_bl, int mask_lv, int bl, int lv, int gt, int cf,
             int elt) {
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
  smem = SmemLayout(S, gt, L.chunk, narrow ? 2 : 4, g > 1).total;
  return kern != nullptr && smem <= SMEM_LIMIT &&
         cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) ==
             cudaSuccess;
}

// One launch of the tiles of G gates. Returns a cudaError_t.
template <class Epi>
int launch_tiles(Kernel<Epi> kern, size_t smem, const Args& args, const Shape& S,
                 const Consts& K, const Plan& L, const Epi& E, void* stream) {
  Launch la((S.G + L.gt - 1) / L.gt, smem, (cudaStream_t)stream);
  const cudaError_t e = cudaLaunchKernelEx(&la.cfg, kern, args, S, K, L, E);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The clusters of `kern` the card holds at once (cudaOccupancyMaxActiveClusters),
// into *clusters, and its dynamic shared memory, into *smem_bytes. Returns
// a cudaError_t.
template <class Epi>
int active_clusters(Kernel<Epi> kern, size_t smem, int* clusters, int* smem_bytes) {
  *smem_bytes = (int)smem;
  Launch la(1, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &la.cfg);
}

}  // namespace
