// Device code of the blind-rotation kernels (sm_90a): blind_rotate_mb.cu
// (K1, multi-bit), blind_rotate_ps.cu (K6, prime-split), blind_rotate_sb.cu
// (K2, single-bit), blind_rotate_ts.cu (K4, transposed) and
// blind_rotate_gm.cu (K3, gate-major), all five through their common
// body, rotate_tiles.cuh. Each .cu builds into its own library, so
// everything here sits in an anonymous namespace and is compiled once per
// kernel file.
//
// What the kernels share:
//   - the modular arithmetic of helm_tpu_torch/fhe/ntt.py (Shoup
//     multiplies, Barrett reductions, Garner recombination);
//   - the register-pass NTTs (fwd_radix / inv_radix / RowSwizzle): a
//     thread holds 8 words and runs up to 3 radix-2 stages on them in
//     registers; shared memory only between passes, through a bank
//     swizzle, with the twiddles in pass order. K4's four-step transform
//     runs their first forward pass and last inverse stages as its 8-point
//     stages;
//   - the signed 8-bit limbs and the int8 tensor-core product of K4's
//     N2-point stages (put_limbs, mma_s8);
//   - the asynchronous copies (mbarrier, cp.async.bulk) and distributed
//     shared memory of rotate_tiles (the bulk copies also feed the probes'
//     rings: probe_splat.cu, probe_ptw.cu);
//   - the host-side unpacking and checking of the shape and the constants.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NP = 4;         // CRT primes (fhe/modring.py NUM_PRIMES)
constexpr int MAX_ROWS = 16;  // gadget rows k*l_mask + l

struct Consts {
  uint32_t p[NP];
  unsigned long long mu[NP];  // floor((2^64 - 1) / p): Barrett constant
  uint32_t mu32[NP];          // floor(2^32 / p)
  uint32_t n_inv[NP], n_inv_sh[NP];
  uint32_t inv_p0_mod_p1, inv_p0_mod_p1_sh;
  uint32_t p0_mod_p2, p0_mod_p2_sh;
  uint32_t inv_p01_mod_p2, inv_p01_mod_p2_sh;
  uint32_t p0_mod_p3, p0_mod_p3_sh;
  uint32_t p01_mod_p3, p01_mod_p3_sh;
  uint32_t inv_p012_mod_p3, inv_p012_mod_p3_sh;
  uint32_t prod_mod_q, half_p3;
};

struct Shape {
  int G, n, N, logN, k, kp1, g, rows;
  int mask_bl, mask_lv, bl, lv;
};

// (a * w) mod p with w_sh = floor(w * 2^16 / p); a <= 2^16 (fhe/ntt.py mul_shoup)
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
  uint32_t q = (a * w_sh) >> 16;
  uint32_t r = a * w - q * p;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  uint32_t r = a + b;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  uint32_t r = a - b;
  return a < b ? r + p : r;
}

// x mod p for any u64 x: q = floor(x mu / 2^64) is floor(x/p) or one
// less (mu = floor((2^64 - 1) / p) errs by under 1, so x mu / 2^64 by
// under x / 2^64 < 1), so one correction
__device__ __forceinline__ uint32_t reduce64(unsigned long long x, uint32_t p,
                                             unsigned long long mu) {
  unsigned long long q = __umul64hi(x, mu);
  uint32_t r = (uint32_t)(x - q * p);
  return r >= p ? r - p : r;
}

extern __shared__ __align__(16) unsigned char smem_raw[];

__device__ __forceinline__ uint32_t garner(uint32_t r0, uint32_t r1, uint32_t r2,
                                           uint32_t r3, const Consts& K) {
  const uint32_t p0 = K.p[0], p1 = K.p[1], p2 = K.p[2], p3 = K.p[3];
  // v0 = r0 < p0 < p1 < p2 < p3 (ascending, checked on the host), so the
  // reference's v0 % p_i (fhe/ntt.py garner_to_u32) is v0 itself
  uint32_t v0 = r0;
  uint32_t t1 = sub_mod(r1, v0, p1);
  uint32_t v1 = mul_shoup(t1, K.inv_p0_mod_p1, K.inv_p0_mod_p1_sh, p1);
  uint32_t m2 = add_mod(v0, mul_shoup(v1, K.p0_mod_p2, K.p0_mod_p2_sh, p2), p2);
  uint32_t t2 = sub_mod(r2, m2, p2);
  uint32_t v2 = mul_shoup(t2, K.inv_p01_mod_p2, K.inv_p01_mod_p2_sh, p2);
  uint32_t m3 = add_mod(v0, mul_shoup(v1, K.p0_mod_p3, K.p0_mod_p3_sh, p3), p3);
  m3 = add_mod(m3, mul_shoup(v2, K.p01_mod_p3, K.p01_mod_p3_sh, p3), p3);
  uint32_t t3 = sub_mod(r3, m3, p3);
  uint32_t v3 = mul_shoup(t3, K.inv_p012_mod_p3, K.inv_p012_mod_p3_sh, p3);
  uint32_t x = v0 + p0 * (v1 + p1 * (v2 + p2 * v3));  // wrapping == mod 2^32
  return v3 > K.half_p3 ? x - K.prod_mod_q : x;        // balanced lift
}

// ---------------------------------------------------------------------
// Register-pass NTTs (rotate_tiles). A pass runs R <= 3
// radix-2 stages on the 2^R words of a block a thread holds in registers,
// so a transform of N = 2^logN words is ceil(logN / 3) passes with a
// shared-memory exchange between them (3 at N = 512, 4 at N = 1024 and
// 2048) in place of one per stage. The stages of pass P are R = min(3,
// logN - 3P) (pass_stages in ops/mb_pbs.py).
//   forward (merged-psi Cooley-Tukey, natural -> bit-reversed), pass at
//   stage s0: block (i0, j), words x_k = i0 * (N >> s0) + k * tl + j with
//   tl = N >> (s0 + R); stage s0 + r pairs the k that differ in bit
//   R-1-r, twiddle psi[2^(s0+r) + i0 * 2^r + (k >> (R - r))];
//   inverse (Gentleman-Sande, bit-reversed -> natural, no N^-1), pass at
//   stride t0 = 2^s: words x_k = i0 * (t0 << R) + k * t0 + j; stage r
//   pairs the k that differ in bit r, twiddle psi_inv[(N >> (s + r + 1)) +
//   i0 * 2^(R-r-1) + (k >> (r + 1))].
// The host stores both twiddle tables in the order these passes read them
// (twiddles_by_pass: the lanes of a warp, consecutive i0, read consecutive
// words) as (w, w_sh) pairs.

// The modular add, subtract and Shoup multiply of the register passes:
// the same values as add_mod / sub_mod / mul_shoup, the correction as an
// unsigned min (a wrapped difference is larger than any residue), one
// instruction fewer each
__device__ __forceinline__ uint32_t add_mod_min(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t r = a + b;
  return min(r, r - p);
}

__device__ __forceinline__ uint32_t sub_mod_min(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t r = a - b;
  return min(r, r + p);
}

__device__ __forceinline__ uint32_t mul_shoup_min(uint32_t a, uint32_t w, uint32_t w_sh,
                                                  uint32_t p) {
  const uint32_t q = (a * w_sh) >> 16;
  const uint32_t r = a * w - q * p;
  return min(r, r - p);
}

// x mod p for any u32 x: q is floor(x/p) or one less, so one correction,
// as a min
__device__ __forceinline__ uint32_t reduce32_min(uint32_t x, uint32_t p, uint32_t mu32) {
  const uint32_t r = x - __umulhi(x, mu32) * p;
  return min(r, r - p);
}

// forward stages of one block of 2^R words; twf: pass-ordered pairs
template <int R>
__device__ __forceinline__ void fwd_radix(uint32_t* v, const uint2* twf, int s0, int i0,
                                          uint32_t p) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int half = 1 << (R - 1 - r);
#pragma unroll
    for (int q = 0; q < (1 << r); ++q) {
      const uint2 w = twf[(1 << (s0 + r)) + (q << s0) + i0];
#pragma unroll
      for (int kk = 0; kk < half; ++kk) {
        const int a = q * 2 * half + kk, b = a + half;
        const uint32_t u = v[a], t = mul_shoup_min(v[b], w.x, w.y, p);
        v[a] = add_mod_min(u, t, p);
        v[b] = sub_mod_min(u, t, p);
      }
    }
  }
}

// inverse stages of one block of 2^R words at stride 2^s; twi: pass-
// ordered pairs
template <int R>
__device__ __forceinline__ void inv_radix(uint32_t* v, const uint2* twi, int s, int i0,
                                          int logN, uint32_t p) {
  const int ni = 1 << (logN - s - R);  // blocks per row: i0's range
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int dist = 1 << r;
    const int h = 1 << (logN - s - r - 1);
#pragma unroll
    for (int q = 0; q < (1 << (R - 1 - r)); ++q) {
      const uint2 w = twi[h + q * ni + i0];
#pragma unroll
      for (int kk = 0; kk < dist; ++kk) {
        const int a = q * 2 * dist + kk, b = a + dist;
        const uint32_t u = v[a], t = v[b];
        v[a] = add_mod_min(u, t, p);
        v[b] = mul_shoup_min(sub_mod_min(u, t, p), w.x, w.y, p);
      }
    }
  }
}

// The bank swizzle of rows of N words in shared memory: word x of row
// `row` lives at (row << logN) + (x ^ hx[x]), where hx is linear over
// GF(2) and touches only the 5 bank bits (the host's bank_swizzle). Being
// linear, hx[base + k * stride] = hx[base] ^ hx[k * stride] when the two
// share no bits, so a pass looks up hx[k * stride] once and each block
// hx[base] once. (From N = 256 on a warp stays in one row; below, where
// only the tiny test sets live, rows of a warp may share banks.)
struct RowSwizzle {
  const uint8_t* hx;  // [N]
  int logN;
  __device__ __forceinline__ int at(int row, int x) const { return (row << logN) + (x ^ hx[x]); }
};

// One register pass over `nrows` rows of buf (row rr's gate rr & (gt-1)
// skipped when >= ng): forward at stage s0, or inverse at stride 2^s0
template <int R, bool INV>
__device__ __forceinline__ void ntt_pass(uint32_t* buf, int nrows, int gt, int ng, int s0,
                                         const uint2* tw, const RowSwizzle& sw, uint32_t p) {
  constexpr int B = 8 >> R;  // blocks of 2^R words per thread
  const int logN = sw.logN, N8 = 1 << (logN - 3);
  // stride between a block's words, and its log
  const int lstr = INV ? s0 : logN - s0 - R;
  uint32_t hk[1 << R];
#pragma unroll
  for (int k = 0; k < (1 << R); ++k) hk[k] = sw.hx[k << lstr];
  const int ntask = nrows << (logN - 3);
  for (int tk = threadIdx.x; tk < ntask; tk += blockDim.x) {
    const int rr = tk >> (logN - 3), tr = tk & (N8 - 1);
    if ((rr & (gt - 1)) >= ng) continue;
    uint32_t v[8];
    int ub[B], hb[B], i0s[B];  // per block: unswizzled base, its h, i0
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int b = tr + u * N8;
      const int j = b & ((1 << lstr) - 1), i0 = b >> lstr;
      const int xb = (INV ? (i0 << (s0 + R)) : (i0 << (logN - s0))) + j;
      ub[u] = (rr << logN) | xb;
      hb[u] = sw.hx[xb];
      i0s[u] = i0;
#pragma unroll
      for (int k = 0; k < (1 << R); ++k)
        v[u * (1 << R) + k] = buf[(ub[u] | (k << lstr)) ^ hb[u] ^ hk[k]];
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if constexpr (INV) inv_radix<R>(v + u * (1 << R), tw, s0, i0s[u], logN, p);
      else fwd_radix<R>(v + u * (1 << R), tw, s0, i0s[u], p);
    }
#pragma unroll
    for (int u = 0; u < B; ++u)
#pragma unroll
      for (int k = 0; k < (1 << R); ++k)
        buf[(ub[u] | (k << lstr)) ^ hb[u] ^ hk[k]] = v[u * (1 << R) + k];
  }
}

// The passes of a transform after `first` passes already done (the
// forward transform's first pass is fused with the decomposition),
// barriers between them. Ends with a barrier.
template <bool INV>
__device__ __forceinline__ void ntt_passes(uint32_t* buf, int nrows, int gt, int ng, int first,
                                           const uint2* tw, const RowSwizzle& sw, uint32_t p) {
  for (int s0 = 3 * first; s0 < sw.logN; s0 += 3) {
    const int R = min(3, sw.logN - s0);
    if (R == 3) ntt_pass<3, INV>(buf, nrows, gt, ng, s0, tw, sw, p);
    else if (R == 2) ntt_pass<2, INV>(buf, nrows, gt, ng, s0, tw, sw, p);
    else ntt_pass<1, INV>(buf, nrows, gt, ng, s0, tw, sw, p);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// Signed 8-bit limbs and the int8 tensor-core product (K4's N2-point
// stages, rotate_tiles.cuh FourStepTC)

// The balanced value of residue x mod p (in [-(p/2), p/2]) as nl <= 3
// signed 8-bit limbs (fhe/ntt.py split_limbs), limb l at dst[l * plane]
__device__ __forceinline__ void put_limbs(int8_t* dst, size_t plane, uint32_t x, uint32_t p,
                                          int nl) {
  int b = x > (p >> 1) ? (int)x - (int)p : (int)x;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    if (l >= nl) break;
    const int lo = ((b + 128) & 255) - 128;
    dst[l * plane] = (int8_t)lo;
    b = (b - lo) >> 8;
  }
}

// c += A B for one 16 x 8 x 32 tile: s8 x s8 -> s32 (the PTX ISA's
// fragment layouts: a0-a3 rows g and g + 8, bytes 4t.. and 16 + 4t..;
// b0, b1 column g, the same bytes)
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four 8 x 16-byte matrices whose rows the lanes address (lanes 8j ..
// 8j + 7: matrix j) into r[j], in the mma fragment layout: lane (g, t)
// gets bytes 4t..4t+3 of row g (ldmatrix .b16, int8 pairs as 16-bit)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

// ---------------------------------------------------------------------
// Asynchronous bulk copies into shared memory, completed on an mbarrier
// (rotate_tiles' BSK ring and K4's staged limb matrices)

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make mbarrier inits visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one arrival on bar that also expects `bytes` more of asynchronous copies
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// copy `bytes` from global src to dst, completing them on bar
__device__ __forceinline__ void copy_bulk(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one thread: expect `bytes` on bar and copy them from global src to dst
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  expect_bytes(bar, bytes);
  copy_bulk(dst, src, bytes, bar);
}

// distributed shared memory by 32-bit addresses: the shared::cluster
// address of this block's shared::cta address `addr` in block `rank`, and
// a load from it
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// one arrival on bar (release: this thread's earlier reads of the slot it
// frees are done)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Host: the shape of one rotation; false when the kernels cannot take it
// (N a power of two in [64, 2048], rows <= MAX_ROWS, digits of at most 16
// bits, bl*lv < 32 as signed_decompose asserts).
bool make_shape(Shape& S, int G, int n, int N, int k, int g, int mask_bl,
                int mask_lv, int bl, int lv) {
  S.G = G; S.n = n; S.N = N; S.k = k; S.kp1 = k + 1; S.g = g;
  S.mask_bl = mask_bl; S.mask_lv = mask_lv; S.bl = bl; S.lv = lv;
  S.rows = k * mask_lv + lv;
  S.logN = 0;
  while ((1 << S.logN) < N) ++S.logN;
  return G > 0 && n > 0 && k >= 1 && (1 << S.logN) == N && N >= 64 && N <= 2048 &&
         S.rows <= MAX_ROWS && bl >= 1 && bl <= 16 && mask_bl >= 1 && mask_bl <= 16 &&
         lv >= 1 && mask_lv >= 1 && bl * lv < 32 && mask_bl * mask_lv < 32;
}

// Host: consts (26 words) = p[4], n_inv[4], n_inv_sh[4], then the 14
// Garner constants in GarnerConstants field order (fhe/modring.py).
// False unless the primes ascend and are at most 2^16 + 1.
bool load_consts(Consts& K, const uint32_t* consts) {
  for (int i = 0; i < NP; ++i) {
    K.p[i] = consts[i];
    if (consts[i] < 3 || consts[i] > 65537 || (i > 0 && consts[i] <= consts[i - 1]))
      return false;
    K.mu[i] = ~0ull / consts[i];
    K.mu32[i] = (uint32_t)((1ull << 32) / consts[i]);
    K.n_inv[i] = consts[4 + i];
    K.n_inv_sh[i] = consts[8 + i];
  }
  const uint32_t* gc = consts + 12;
  K.inv_p0_mod_p1 = gc[0]; K.inv_p0_mod_p1_sh = gc[1];
  K.p0_mod_p2 = gc[2]; K.p0_mod_p2_sh = gc[3];
  K.inv_p01_mod_p2 = gc[4]; K.inv_p01_mod_p2_sh = gc[5];
  K.p0_mod_p3 = gc[6]; K.p0_mod_p3_sh = gc[7];
  K.p01_mod_p3 = gc[8]; K.p01_mod_p3_sh = gc[9];
  K.inv_p012_mod_p3 = gc[10]; K.inv_p012_mod_p3_sh = gc[11];
  K.prod_mod_q = gc[12]; K.half_p3 = gc[13];
  return true;
}

// Host: the largest sum of products a kernel accumulates is
// terms * (p_max - 1)^2; u32 accumulation is exact when that fits 32 bits.
bool fits_u32(const Consts& K, unsigned long long terms) {
  const unsigned long long pm = K.p[NP - 1] - 1ull;
  return terms * pm * pm < (1ull << 32);
}

}  // namespace
