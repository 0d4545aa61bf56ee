// Multi-bit blind rotation for Hopper (sm_90a), plain C interface: K1 of
// the port.
//
// Replaces the TPU kernel helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_mb
// (:2706; Pallas body _make_kernel_fs_mb :834, call :2795). Computes the
// same function as helm_tpu/fhe/pbs_jnp.py::blind_rotate_multibit and its
// torch twin helm_tpu_torch/fhe/pbs.py::blind_rotate_multibit, word for
// word: for each of the n/g groups of mask elements, the additive-identity
// CMux
//     acc += INTT( sum_r NTT(dec(acc))_r (.) sum_v P_v (.) BSK_v )
// with P_v = prod_{i in v} (X^{a_i} - 1), over the 4 CRT primes, then
// Garner back to u32.
//
// Design. The TPU kernel walks the groups along a sequential grid axis
// with a tile of gates' accumulators in VMEM and reads each BSK slab once
// per tile. Here that loop runs inside the kernel: one launch per rotation.
// A thread-block cluster of NP = 4 blocks (one per CRT prime, 512 threads,
// one block per SM) owns a tile of gt gates (a power of two; the host's
// tile_plan in ops/mb_pbs.py picks it from the shared-memory budget, the
// width and the clusters the card holds at once) and keeps, across all n/g groups, its accumulators in shared
// memory: block pi holds the quarter of coefficients [pi N/4, (pi+1) N/4)
// of every (gate, component). Per group, each block
//   1. decomposes the tile's accumulator words (read from the four
//      blocks' quarters through distributed shared memory), reduces the
//      digits mod its prime, and runs the forward NTT's first register
//      pass on them before they reach shared memory; then the other
//      passes (rows [rows, gt, N] u32 in shared memory: F never leaves the
//      SM);
//   2. forms S_c = sum_v P_v (.) (sum_r F_r (.) BSK_v[r, c]) per frequency,
//      chunk by chunk against its prime's slab of the group's BSK, which
//      streams through a 2-stage ring by cp.async.bulk on mbarriers (the
//      next chunk, also the next group's first ones, loads while the
//      current one is multiplied and while the NTTs run). A thread takes
//      one (frequency, component) and holds its (2^g-1) x rows BSK words in
//      registers across the tile's gates, so each word is read from the
//      ring once per tile. P_v by direct lookup in the power table
//      (NTT(X^a)[f] = psi^(a e_f mod 2N), e_f = 2 bitrev(f) + 1). The
//      products overwrite rows 0..k of the tile in place once the chunk's
//      gadget rows are read;
//   3. runs the inverse NTTs of the k+1 components;
// then, after a cluster barrier, block pi reads the four primes' residues
// of its quarter through distributed shared memory, applies N^-1 and
// Garner with the balanced lift (pbs_common.cuh garner) and adds the
// result into its quarter; a second cluster barrier ends the group. The
// accumulators reach device memory twice per rotation: loaded at the
// start, stored at the end. Gates never read each other's accumulators,
// so the clusters need no grid-wide barrier.
//
// The NTTs run in register passes (pbs_common.cuh fwd_radix / inv_radix /
// ntt_pass): 8 words a thread, up to 3 radix-2 stages per pass, one
// shared-memory exchange per pass (3 at N = 512, 4 at 1024 and 2048),
// the twiddles staged in shared memory once per launch in the order the
// passes read them, rows bank-swizzled so that no pass conflicts.
//
// What bounds it. Integer throughput: the products' multiply-adds and Barrett
// reductions, then the butterflies
// (tools/k1_phases.py splits a group's clocks by phase; PERF.md). The
// intermediates F and S (67 and 33.5 MB per step at GATES_128_K3, G =
// 1024, in the three-launch design this replaces) never reach device
// memory, and shared memory is touched once per register pass, not per
// stage. Each tile reads its group's BSK slab from L2 once per step (0.39
// MB as u16 at GATES_128_K3); device memory sees the BSK about once per
// wave of clusters. An H100 holds 30 clusters of 4 blocks at once
// (cudaOccupancyMaxActiveClusters), so the tile plan counts waves: narrow
// widths (a circuit vector's levels) take tiles of one or two gates, and
// then the chain of barriers of one group sets the time.
//
// No tensor cores: the products are per-frequency [gt, rows] x [rows,
// (2^g-1)(k+1)] with rows = 6-9, far below mma's depth of 32, and the
// int8-limb NTT on the tensor cores (K4, blind_rotate_ts.cu) measured
// 0.91-3.6x this kernel's three-launch predecessor at these ring sizes.
//
// Exactness as before: u32 sums where every sum of products fits 32 bits
// (fits_u32: PRIMES_512, and then the BSK streams as u16), 64-bit sums
// otherwise; Barrett reductions per prime; Garner's balanced lift.
// Every entry point returns the first launch error or cudaGetLastError();
// nothing is allocated here and nothing synchronises.

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
  int nch;      // chunks per group
  int gs;       // gate strides of the product items
  int chunk;    // BSK words per chunk
};

__host__ __device__ __forceinline__ size_t up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// Dynamic shared memory of one block (ops/mb_pbs.py smem_bytes)
struct SmemLayout {
  size_t ring, bar, rows, accq, twf, twi, pw, swz, ab, total;
  __host__ __device__ SmemLayout(const Shape& S, int gt, int chunk, size_t elt) {
    ring = 0;
    bar = up((size_t)STAGES * chunk * elt, 128);
    rows = bar + up(STAGES * 8, 16);
    accq = rows + (size_t)S.rows * gt * S.N * 4;
    twf = accq + (size_t)S.kp1 * gt * (S.N / 4) * 4;
    twi = twf + (size_t)S.N * 8;
    pw = twi + (size_t)S.N * 8;
    swz = pw + (size_t)2 * S.N * 4;
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
  const uint32_t* pw;     // [NP, 2N]
  const uint8_t* swz;     // [N]
};

// the lowest set bit of v > 0 (constant-folded in unrolled loops, so that
// register arrays stay registers)
__host__ __device__ constexpr int low_bit(int v) { return (v & 1) ? 0 : 1 + low_bit(v >> 1); }

// One rotation of a tile of gates per cluster; GB: the grouping g, ROWS: the gadget rows (compile-time, so
// that the product loop's registers and addresses fold), NARROW: u32 sums
// and a u16 BSK
template <int GB, int ROWS, bool NARROW>
__global__ void __launch_bounds__(TPB, 1) rotate_tiles(Args a, Shape S, Consts K, Plan L) {
  using BT = typename std::conditional<NARROW, uint16_t, uint32_t>::type;
  using AT = typename std::conditional<NARROW, uint32_t, unsigned long long>::type;
  constexpr int NV1 = (1 << GB) - 1;  // non-empty subsets
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

  const SmemLayout lay(S, gt, L.chunk, sizeof(BT));
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

  // the BSK ring: chunk q of the rotation is group q / nch, chunk q % nch
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
      uint32_t r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // fhe/ops.py signed_decompose: round to the top bl*lv bits
        const uint32_t w = ld_cluster(peer_acc[k >> 1] + 4 * (off + (k & 1) * N8));
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

    // 4. Garner on this block's quarter, acc += result
    for (int it = tid; it < nacc; it += TPB) {
      const int xq = it & (N4 - 1), cgi = it >> (logN - 2);
      const int gi = cgi & (gt - 1), c = cgi >> lgt;
      if (gi >= ng) continue;
      const int ad = sw.at(c * gt + gi, pi * N4 + xq);
      uint32_t res[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i)
        res[i] = mul_shoup(ld_cluster(peer_rows[i] + 4 * ad), K.n_inv[i], K.n_inv_sh[i], K.p[i]);
      accq[it] += garner(res[0], res[1], res[2], res[3], K);
    }
    cluster.sync();  // the quarters are updated, and no peer reads our rows
  }

  for (int it = tid; it < nacc; it += TPB) {
    const int xq = it & (N4 - 1), cgi = it >> (logN - 2);
    const int gi = cgi & (gt - 1), c = cgi >> lgt;
    if (gi < ng) a.acc[((size_t)(g0 + gi) * kp1 + c) * N + pi * N4 + xq] = accq[it];
  }
}

using Kernel = void (*)(Args, Shape, Consts, Plan);

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The build of rotate_tiles for a shape, or nullptr when there is none:
// grouping 2 with 4, 6, 8 or 9 gadget rows, grouping 4 with 4 (whose sums
// never fit u32) — every multi-bit set of params.py (ops/mb_pbs.py
// K1_BUILDS)
template <int GB, int ROWS>
Kernel build_of(bool narrow) {
  return narrow ? rotate_tiles<GB, ROWS, true> : rotate_tiles<GB, ROWS, false>;
}

Kernel select_kernel(const Shape& S, bool narrow) {
  if (S.g == 2 && S.rows == 4) return build_of<2, 4>(narrow);
  if (S.g == 2 && S.rows == 6) return build_of<2, 6>(narrow);
  if (S.g == 2 && S.rows == 8) return build_of<2, 8>(narrow);
  if (S.g == 2 && S.rows == 9) return build_of<2, 9>(narrow);
  if (S.g == 4 && S.rows == 4 && !narrow) return rotate_tiles<4, 4, false>;
  return nullptr;
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

// Checks the arguments and fills S, K, L and the kernel; false when the
// kernels cannot take them, or when the BSK's element size elt is not the
// one the shape's sums call for
bool prepare(Shape& S, Consts& K, Plan& L, Kernel& kern, size_t& smem, const uint32_t* consts,
             int G, int n, int N, int k, int g, int mask_bl, int mask_lv, int bl, int lv, int gt,
             int cf, int elt) {
  if (!make_shape(S, G, n, N, k, g, mask_bl, mask_lv, bl, lv) || n % g != 0 ||
      !load_consts(K, consts) || gt < 1 || gt > MAX_TILE || (gt & (gt - 1)) != 0 || cf < 32 ||
      cf > N || (cf & (cf - 1)) != 0 || S.kp1 * cf > TPB || S.logN < 6 ||
      (1u << (S.bl - 1)) >= K.p[0] || (1u << (S.mask_bl - 1)) >= K.p[0])
    return false;  // the digits' floor-mod takes |d| <= B/2 < p
  const int nv1 = (1 << g) - 1;
  const bool narrow = fits_u32(K, S.rows) && fits_u32(K, nv1);
  if (elt != (narrow ? 2 : 4)) return false;
  kern = select_kernel(S, narrow);
  L.gt = gt;
  L.lgt = ilog2(gt);
  L.cf = cf;
  L.lcf = ilog2(cf);
  L.nch = N / cf;
  L.gs = 1;
  while (L.gs < gt && S.kp1 * cf * L.gs * 2 <= TPB) L.gs *= 2;
  L.chunk = nv1 * S.rows * S.kp1 * cf;
  smem = SmemLayout(S, gt, L.chunk, narrow ? 2 : 4).total;
  return kern != nullptr && smem <= SMEM_LIMIT &&
         cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) ==
             cudaSuccess;
}

}  // namespace

// consts (host, 26 words): see load_consts in pbs_common.cuh.
// acc: u32 [G, k+1, N], in/out. abar: i32 [G, n] in [0, 2N).
// bsk: [n/g, NP, N/cf, 2^g-1, rows, k+1, cf], u16 when every sum of
// products fits u32 (fits_u32), else u32 (ops/mb_pbs.py tiled_bsk).
// twf, twi: u32 pairs [NP, N, 2] (twiddles_by_pass). pw: u32 [NP, 2N].
// swz: u8 [N] (bank_swizzle). gt: gates per tile, a power of two
// <= 8; cf: frequencies per BSK chunk, a power of two in [32, N]; elt: the
// bytes of one BSK word, checked against the shape's choice of u16 or u32.
// One launch. Returns a cudaError_t.
extern "C" int helm_blind_rotate_mb(
    void* acc, const void* abar, const void* bsk, const void* twf, const void* twi,
    const void* pw, const void* swz, const uint32_t* consts, int G, int n, int N, int k,
    int g, int mask_bl, int mask_lv, int bl, int lv, int gt, int cf, int elt, void* stream) {
  Shape S;
  Consts K;
  Plan L;
  Kernel kern;
  size_t smem;
  if (!prepare(S, K, L, kern, smem, consts, G, n, N, k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  Launch la((G + gt - 1) / gt, smem, (cudaStream_t)stream);
  const Args args{(uint32_t*)acc,       (const int*)abar,     bsk,
                  (const uint2*)twf,    (const uint2*)twi,    (const uint32_t*)pw,
                  (const uint8_t*)swz};
  const cudaError_t e = cudaLaunchKernelEx(&la.cfg, kern, args, S, K, L);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The clusters of K1 the card holds at once for tiles of gt gates
// (cudaOccupancyMaxActiveClusters), into *clusters: the tile plan's
// wave size; and the dynamic shared memory of one block (SmemLayout),
// into *smem, for the host's plan to be held against. Arguments as
// helm_blind_rotate_mb's. Returns a cudaError_t.
extern "C" int helm_blind_rotate_mb_clusters(const uint32_t* consts, int n, int N, int k, int g,
                                             int mask_bl, int mask_lv, int bl, int lv, int gt,
                                             int cf, int elt, int* clusters, int* smem_bytes) {
  Shape S;
  Consts K;
  Plan L;
  Kernel kern;
  size_t smem;
  if (!prepare(S, K, L, kern, smem, consts, gt, n, N, k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  Launch la(1, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &la.cfg);
}
