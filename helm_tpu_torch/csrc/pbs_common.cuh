// Device code shared by the blind-rotation kernels (sm_90a):
// blind_rotate_mb.cu (K1, multi-bit), blind_rotate_sb.cu (K2,
// single-bit) and blind_rotate_ps.cu (K6, prime-split multi-bit). Each .cu
// builds into its own library, so everything here sits in an anonymous
// namespace and is compiled once per kernel file.
//
// What the kernels share:
//   - the modular arithmetic of helm_tpu_torch/fhe/ntt.py (Shoup
//     multiplies, Barrett reductions, Garner recombination);
//   - decompose_rows: signed gadget decomposition of the k+1 GLWE
//     components of one gate (params.component_gadgets), digit residues
//     mod one prime, into shared memory. The words it decomposes come
//     from a source functor: the bare accumulator for K1 and K6,
//     (X^{a_i} - 1) * acc for K2;
//   - ntt_fwd_rows / ntt_inv_rows: the forward and inverse NTTs of rows
//     in shared memory;
//   - decompose_fwd (K1, K2): decompose_rows + the forward NTT of every
//     gadget row, one (gate, prime) per block;
//   - inverse_garner (K1, K2): inverse NTT over the NP primes, Garner with
//     the balanced lift, acc += result;
//   - the host-side unpacking and checking of the shape and the constants.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NP = 4;         // CRT primes (fhe/modring.py NUM_PRIMES)
constexpr int MAX_ROWS = 16;  // gadget rows k*l_mask + l
constexpr int THREADS = 256;  // decompose_fwd and inverse_garner

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

// x mod p for x < 2^40: q is floor(x/p) or one less, so one correction
__device__ __forceinline__ uint32_t reduce64(unsigned long long x, uint32_t p,
                                             unsigned long long mu) {
  unsigned long long q = __umul64hi(x, mu);
  uint32_t r = (uint32_t)(x - q * p);
  return r >= p ? r - p : r;
}

// x mod p for any u32 x: q is floor(x/p) or one less, so one correction
__device__ __forceinline__ uint32_t reduce32(uint32_t x, uint32_t p, uint32_t mu32) {
  uint32_t r = x - __umulhi(x, mu32) * p;
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

// The source of the words decompose_rows decomposes for K1 and K6: the
// bare accumulator, acc [G, k+1, N]
struct AccWords {
  const uint32_t* acc;
  __device__ __forceinline__ uint32_t operator()(const Shape& S, int gate, int c,
                                                 int coef) const {
    return acc[((size_t)gate * S.kp1 + c) * S.N + coef];
  }
};

// Which prime a row of an NTT over several rows is reduced by: the row
// itself (inverse_garner: one row per prime), or one prime for every row
struct RowPrime {
  __device__ __forceinline__ int operator()(int row) const { return row; }
};
struct FixedPrime {
  int pi;
  __device__ __forceinline__ int operator()(int) const { return pi; }
};

// Signed gadget decomposition of one gate's k+1 components
// (params.component_gadgets), the digits reduced mod prime pi, into
// buf [rows, N] in shared memory. Src(S, gate, c, coef) yields the u32
// word of component c to decompose. The caller synchronises.
template <class Src>
__device__ __forceinline__ void decompose_rows(const Src& src, uint32_t* buf, int gate,
                                               int pi, const Shape& S, const Consts& K) {
  const int N = S.N, logN = S.logN;
  const uint32_t p = K.p[pi], mu32 = K.mu32[pi];
  for (int idx = threadIdx.x; idx < S.kp1 * N; idx += blockDim.x) {
    const int c = idx >> logN, coef = idx & (N - 1);
    int bl, lv, row0;
    if (c < S.k) {
      bl = S.mask_bl; lv = S.mask_lv; row0 = c * S.mask_lv;
    } else {
      bl = S.bl; lv = S.lv; row0 = S.k * S.mask_lv;
    }
    const int total = bl * lv;  // < 32 (checked on the host)
    const uint32_t b = 1u << bl, half = b >> 1;
    // fhe/ops.py signed_decompose: round to the top bl*lv bits
    uint32_t r = ((src(S, gate, c, coef) >> (32 - total - 1)) + 1u) >> 1;
    r &= (1u << total) - 1u;
    // least significant level first; level 0 (weight q/B) is row0
    for (int j = lv - 1; j >= 0; --j) {
      int d = (int)(r & (b - 1u));
      const uint32_t carry = (uint32_t)d >= half;
      if (carry) d -= (int)b;
      r = (r >> bl) + carry;
      // floor-mod (fhe/ntt.py digits_to_residues): |d| <= 2^15 < 4p
      // (base_log <= 16, checked on the host), so d + 4p is a
      // non-negative u32 with the same residue
      buf[(row0 + j) * N + coef] = reduce32((uint32_t)(d + 4 * (int)p), p, mu32);
    }
  }
}

// Forward NTT of rows [0, nrows) of buf [.., N] in shared memory, every
// row mod prime pi: merged-psi Cooley-Tukey (fhe/ntt.py ntt_fwd), natural
// -> bit-reversed. Starts and ends with a barrier.
__device__ __forceinline__ void ntt_fwd_rows(uint32_t* buf, int nrows, int pi,
                                             const uint32_t* __restrict__ psi,
                                             const uint32_t* __restrict__ psi_sh,
                                             const Shape& S, const Consts& K) {
  __syncthreads();
  const int N = S.N, logN = S.logN;
  const uint32_t p = K.p[pi];
  const uint32_t* w_t = psi + pi * N;
  const uint32_t* ws_t = psi_sh + pi * N;
  const int half_n = N >> 1, total = nrows * half_n;
  int logt = logN;
  for (int m = 1; m < N; m <<= 1) {
    --logt;
    const int t = 1 << logt;
    for (int bi = threadIdx.x; bi < total; bi += blockDim.x) {
      const int row = bi >> (logN - 1), bb = bi & (half_n - 1);
      const int i = bb >> logt, j = bb & (t - 1);
      const int base = row * N + (i << (logt + 1)) + j;
      const uint32_t u = buf[base];
      const uint32_t v = mul_shoup(buf[base + t], __ldg(w_t + m + i), __ldg(ws_t + m + i), p);
      buf[base] = add_mod(u, v, p);
      buf[base + t] = sub_mod(u, v, p);
    }
    __syncthreads();
  }
}

// Inverse NTT of rows [0, nrows) of buf [.., N] in shared memory, row r
// mod prime prime_of(r): Gentleman-Sande (fhe/ntt.py ntt_inv),
// bit-reversed -> natural, without the final N^-1 scale (the callers
// apply it as they read the residues). Starts and ends with a barrier.
template <class PrimeOf>
__device__ __forceinline__ void ntt_inv_rows(uint32_t* buf, int nrows, PrimeOf prime_of,
                                             const uint32_t* __restrict__ psi_inv,
                                             const uint32_t* __restrict__ psi_inv_sh,
                                             const Shape& S, const Consts& K) {
  __syncthreads();
  const int N = S.N, logN = S.logN;
  const int half_n = N >> 1, total = nrows * half_n;
  int logt = 0;
  for (int m = N; m > 1; m >>= 1) {
    const int h = m >> 1, t = 1 << logt;
    for (int bi = threadIdx.x; bi < total; bi += blockDim.x) {
      const int row = bi >> (logN - 1), bb = bi & (half_n - 1);
      const int i = bb >> logt, j = bb & (t - 1);
      const int base = row * N + (i << (logt + 1)) + j;
      const int pi = prime_of(row);
      const uint32_t p = K.p[pi];
      const uint32_t u = buf[base], w = buf[base + t];
      buf[base] = add_mod(u, w, p);
      buf[base + t] = mul_shoup(sub_mod(u, w, p), __ldg(psi_inv + pi * N + h + i),
                                __ldg(psi_inv_sh + pi * N + h + i), p);
    }
    ++logt;
    __syncthreads();
  }
}

// 1. gadget decomposition + forward NTT of every row, one (gate, prime)
//    per block -> F [G, rows, NP, N].
template <class Src>
__global__ void decompose_fwd(Src src, uint32_t* __restrict__ fbuf,
                              const uint32_t* __restrict__ psi,
                              const uint32_t* __restrict__ psi_sh, Shape S,
                              Consts K) {
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem_raw);  // [rows, N]
  const int gate = blockIdx.x, pi = blockIdx.y;
  const int N = S.N, logN = S.logN;
  decompose_rows(src, buf, gate, pi, S, K);
  ntt_fwd_rows(buf, S.rows, pi, psi, psi_sh, S, K);
  uint32_t* out = fbuf + (size_t)gate * S.rows * NP * N + (size_t)pi * N;
  for (int idx = threadIdx.x; idx < S.rows * N; idx += blockDim.x) {
    const int r = idx >> logN, coef = idx & (N - 1);
    out[(size_t)r * NP * N + coef] = buf[idx];
  }
}

// 3. inverse NTT over the NP primes of one (gate, component), Garner,
//    accumulate into acc
__global__ void inverse_garner(uint32_t* __restrict__ acc,
                               const uint32_t* __restrict__ sbuf,
                               const uint32_t* __restrict__ psi_inv,
                               const uint32_t* __restrict__ psi_inv_sh,
                               Shape S, Consts K) {
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem_raw);  // [NP, N]
  const int gate = blockIdx.x, c = blockIdx.y;
  const int N = S.N, NPN = NP * N;
  const uint32_t* src = sbuf + ((size_t)gate * S.kp1 + c) * NPN;
  for (int idx = threadIdx.x; idx < NPN; idx += blockDim.x) buf[idx] = src[idx];
  ntt_inv_rows(buf, NP, RowPrime{}, psi_inv, psi_inv_sh, S, K);
  uint32_t* dst = acc + ((size_t)gate * S.kp1 + c) * N;
  for (int coef = threadIdx.x; coef < N; coef += blockDim.x) {
    uint32_t r[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i)
      r[i] = mul_shoup(buf[i * N + coef], K.n_inv[i], K.n_inv_sh[i], K.p[i]);
    dst[coef] += garner(r[0], r[1], r[2], r[3], K);
  }
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

// Host: the largest sum of products a pointwise kernel accumulates is
// terms * (p_max - 1)^2; u32 accumulation is exact when that fits 32 bits.
bool fits_u32(const Consts& K, unsigned long long terms) {
  const unsigned long long pm = K.p[NP - 1] - 1ull;
  return terms * pm * pm < (1ull << 32);
}

}  // namespace
