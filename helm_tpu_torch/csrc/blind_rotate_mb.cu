// Multi-bit blind rotation for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_mb
// (Pallas body _make_kernel_fs_mb). Computes the same function as
// helm_tpu/fhe/pbs_jnp.py::blind_rotate_multibit and its torch twin
// helm_tpu_torch/fhe/pbs.py::blind_rotate_multibit, word for word: for
// each of the n/g groups of mask elements, the additive-identity CMux
//     acc += INTT( sum_r NTT(dec(acc))_r (.) sum_v P_v (.) BSK_v )
// with P_v = prod_{i in v} (X^{a_i} - 1), over the 4 CRT primes, then
// Garner back to u32. Only what K1 computes is ported; its TPU layout
// (frequency-in-sublanes tiles, bf16 limb matmul NTTs, one-hot monomial
// matmuls) is not.
//
// Design. The TPU walks the groups along a sequential grid axis with the
// accumulator in VMEM; Hopper blocks carry nothing between them, so the
// host loop below launches three kernels per group on one stream and the
// accumulator acc [G, k+1, N] stays in device memory (8 MB at G=1024,
// N=512, k=3: L2-resident):
//   1. decompose_fwd  grid (G, NP): one block per (gate, prime) decomposes
//      the gate's accumulator into gadget rows, reduces the signed digits
//      mod p and runs the forward NTTs of all rows in shared memory
//      -> F [G, rows, NP, N];
//   2. pointwise      grid (NP*N / T, gate chunks): one thread per
//      (prime, frequency) stages that column of the group's BSK slab in
//      shared memory once and loops over the block's gates, building P_v
//      by direct lookup (NTT(X^a)[f] = psi^(a*e_f mod 2N),
//      e_f = 2*bitrev(f)+1) -> S [G, k+1, NP, N];
//   3. inverse_garner grid (G, k+1): inverse NTT of the NP residue polys in
//      shared memory, Garner with the balanced lift, acc += result.
//
// What bounds it. At GATES_128_K3 the BSK is 352 x 3 x 8 x 4 x 4 x 512 u32
// = 277 MB; read per gate it would be 284 GB per G=1024 batch. Here each
// BSK word is loaded once per chunk of gates (and the 0.79 MB slab of a
// group stays in L2 across chunks), so device memory sees the BSK about
// once per launch. The Shoup companion (bsk_ntt_sh, another 277 MB) is not
// read: sums of products are accumulated exactly (in 32 bits when the
// primes are small enough, as PRIMES_512 is: 8 x 18432^2 < 2^32; else in
// 64 bits) and reduced once with a Barrett constant per prime, which gives
// the same residues. What remains is integer arithmetic (NTT butterflies
// and the rows x (2^g-1) x (k+1) multiply-adds per frequency per gate), so
// wide batches are bound by the SMs' integer throughput; narrow batches
// (a single circuit vector: 8-32 gates) by the latency of the 3 x n/g
// small launches.
//
// Every entry point returns cudaGetLastError(); nothing is allocated here
// (the wrapper passes acc, F and S) and nothing synchronises.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int NP = 4;         // CRT primes (helm_tpu.fhe.modring.NUM_PRIMES)
constexpr int MAX_ROWS = 16;  // gadget rows k*l_mask + l
constexpr int THREADS = 256;  // kernels 1 and 3

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

// (a * w) mod p with w_sh = floor(w * 2^16 / p); a <= 2^16 (ntt.py:27)
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
  // reference's v0 % p_i (ntt.py:160-167) is v0 itself
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

// 1. gadget decomposition + forward NTT of every row, one prime per block
__global__ void decompose_fwd(const uint32_t* __restrict__ acc,
                              uint32_t* __restrict__ fbuf,
                              const uint32_t* __restrict__ psi,
                              const uint32_t* __restrict__ psi_sh, Shape S,
                              Consts K) {
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem_raw);  // [rows, N]
  const int gate = blockIdx.x, pi = blockIdx.y;
  const int N = S.N, logN = S.logN;
  const uint32_t p = K.p[pi], mu32 = K.mu32[pi];
  const uint32_t* a = acc + (size_t)gate * S.kp1 * N;
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
    uint32_t r = ((a[idx] >> (32 - total - 1)) + 1u) >> 1;
    r &= (1u << total) - 1u;
    // least significant level first; level 0 (weight q/B) is row0
    for (int j = lv - 1; j >= 0; --j) {
      int d = (int)(r & (b - 1u));
      const uint32_t carry = (uint32_t)d >= half;
      if (carry) d -= (int)b;
      r = (r >> bl) + carry;
      // floor-mod (ntt.py:134): |d| <= 2^15 < 4p (base_log <= 16, checked
      // on the host), so d + 4p is a non-negative u32 with the same residue
      buf[(row0 + j) * N + coef] = reduce32((uint32_t)(d + 4 * (int)p), p, mu32);
    }
  }
  __syncthreads();
  // merged-psi Cooley-Tukey (ntt.py:65): natural -> bit-reversed
  const uint32_t* w_t = psi + pi * N;
  const uint32_t* ws_t = psi_sh + pi * N;
  const int half_n = N >> 1, total = S.rows * half_n;
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
  uint32_t* out = fbuf + (size_t)gate * S.rows * NP * N + (size_t)pi * N;
  for (int idx = threadIdx.x; idx < S.rows * N; idx += blockDim.x) {
    const int r = idx >> logN, coef = idx & (N - 1);
    out[(size_t)r * NP * N + coef] = buf[idx];
  }
}

// 2. pointwise products against the group's BSK slab; one thread per
//    (prime, frequency), looping over a chunk of gates. NARROW (every
//    prime small enough that rows * (p-1)^2 and (2^g-1) * (p-1)^2 fit in
//    32 bits, as PRIMES_512 does) accumulates in u32 and stages the slab
//    as u16; otherwise sums are exact in 64 bits.
template <int GB, bool NARROW>
__global__ void pointwise(const uint32_t* __restrict__ fbuf,
                          uint32_t* __restrict__ sbuf,
                          const uint32_t* __restrict__ bsk_j,
                          const int* __restrict__ abar, int group,
                          const uint32_t* __restrict__ pw,
                          const int* __restrict__ ef, Shape S, Consts K,
                          int gates_per_block) {
  using BT = typename std::conditional<NARROW, uint16_t, uint32_t>::type;
  using AT = typename std::conditional<NARROW, uint32_t, unsigned long long>::type;
  constexpr int NV1 = (1 << GB) - 1;  // non-empty subsets
  BT* bs = reinterpret_cast<BT*>(smem_raw);  // [NV1 * rows * kp1][blockDim.x]
  const int N = S.N, NPN = NP * N, T = blockDim.x;
  const int pf = blockIdx.x * T + threadIdx.x;  // pi * N + f
  const int pi = pf >> S.logN, f = pf & (N - 1);
  const int W = NV1 * S.rows * S.kp1;
  for (int w = 0; w < W; ++w)  // each thread reads back only its own column
    bs[w * T + threadIdx.x] = (BT)__ldg(bsk_j + (size_t)w * NPN + pf);
  const uint32_t p = K.p[pi], mu32 = K.mu32[pi];
  const unsigned long long mu = K.mu[pi];
  auto reduce = [&](AT x) -> uint32_t {
    if constexpr (NARROW) return reduce32(x, p, mu32);
    else return reduce64(x, p, mu);
  };
  const int e = __ldg(ef + f), mask2n = 2 * N - 1;
  const uint32_t* pwp = pw + pi * 2 * N;
  const int g0 = blockIdx.y * gates_per_block;
  const int g1 = min(S.G, g0 + gates_per_block);
  for (int gate = g0; gate < g1; ++gate) {
    const int* ag = abar + (size_t)gate * S.n + group * GB;
    uint32_t d[GB];
#pragma unroll
    for (int i = 0; i < GB; ++i)  // NTT(X^a_i) - 1; psi^t >= 1 so no wrap
      d[i] = __ldg(pwp + ((__ldg(ag + i) * e) & mask2n)) - 1u;
    uint32_t P[NV1 + 1];
    P[0] = 1;
#pragma unroll
    for (int v = 1; v <= NV1; ++v) {
      const int lo = __ffs(v) - 1;
      P[v] = (v == (1 << lo)) ? d[lo] : reduce((AT)P[v & (v - 1)] * d[lo]);
    }
    uint32_t F[MAX_ROWS];
    const uint32_t* fg = fbuf + (size_t)gate * S.rows * NPN + pf;
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < S.rows) F[r] = fg[(size_t)r * NPN];
    uint32_t* sg = sbuf + (size_t)gate * S.kp1 * NPN + pf;
    for (int c = 0; c < S.kp1; ++c) {
      AT s = 0;
#pragma unroll
      for (int v = 1; v <= NV1; ++v) {
        const BT* bv = bs + (((v - 1) * S.rows) * S.kp1 + c) * T + threadIdx.x;
        AT t = 0;
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r)
          if (r < S.rows) t += (AT)F[r] * bv[r * S.kp1 * T];
        s += (AT)P[v] * reduce(t);
      }
      sg[(size_t)c * NPN] = reduce(s);
    }
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
  const int N = S.N, logN = S.logN, NPN = NP * N;
  const uint32_t* src = sbuf + ((size_t)gate * S.kp1 + c) * NPN;
  for (int idx = threadIdx.x; idx < NPN; idx += blockDim.x) buf[idx] = src[idx];
  __syncthreads();
  // Gentleman-Sande (ntt.py:87): bit-reversed -> natural; row = prime
  const int half_n = N >> 1, total = NP * half_n;
  int logt = 0;
  for (int m = N; m > 1; m >>= 1) {
    const int h = m >> 1, t = 1 << logt;
    for (int bi = threadIdx.x; bi < total; bi += blockDim.x) {
      const int row = bi >> (logN - 1), bb = bi & (half_n - 1);
      const int i = bb >> logt, j = bb & (t - 1);
      const int base = row * N + (i << (logt + 1)) + j;
      const uint32_t p = K.p[row];
      const uint32_t u = buf[base], w = buf[base + t];
      buf[base] = add_mod(u, w, p);
      buf[base + t] = mul_shoup(sub_mod(u, w, p), __ldg(psi_inv + row * N + h + i),
                                __ldg(psi_inv_sh + row * N + h + i), p);
    }
    ++logt;
    __syncthreads();
  }
  uint32_t* dst = acc + ((size_t)gate * S.kp1 + c) * N;
  for (int coef = threadIdx.x; coef < N; coef += blockDim.x) {
    uint32_t r[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i)
      r[i] = mul_shoup(buf[i * N + coef], K.n_inv[i], K.n_inv_sh[i], K.p[i]);
    dst[coef] += garner(r[0], r[1], r[2], r[3], K);
  }
}

template <int GB, bool NARROW>
cudaError_t launch_pointwise(const Shape& S, const Consts& K, int threads,
                             size_t smem, int gpb, const uint32_t* fbuf,
                             uint32_t* sbuf, const uint32_t* bsk_j,
                             const int* abar, int group, const uint32_t* pw,
                             const int* ef, cudaStream_t st) {
  if (group == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        pointwise<GB, NARROW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(NP * S.N / threads, (S.G + gpb - 1) / gpb);
  pointwise<GB, NARROW><<<grid, threads, smem, st>>>(fbuf, sbuf, bsk_j, abar, group,
                                                     pw, ef, S, K, gpb);
  return cudaSuccess;
}

}  // namespace

// consts (host, 26 words): p[4], n_inv[4], n_inv_sh[4], then the 14 Garner
// constants in GarnerConstants field order (helm_tpu/fhe/modring.py).
// acc: u32 [G, k+1, N], in/out. abar: i32 [G, n] in [0, 2N).
// bsk: u32 [n/g, 2^g-1, rows, k+1, NP, N]. psi*: u32 [NP, N]. pw: u32
// [NP, 2N]. ef: i32 [N]. fbuf: u32 [G, rows, NP, N]. sbuf: u32
// [G, k+1, NP, N]. Returns a cudaError_t.
extern "C" int helm_blind_rotate_mb(
    void* acc, const void* abar, const void* bsk, const void* psi,
    const void* psi_sh, const void* psi_inv, const void* psi_inv_sh,
    const void* pw, const void* ef, void* fbuf, void* sbuf,
    const uint32_t* consts, int G, int n, int N, int k, int g, int mask_bl,
    int mask_lv, int bl, int lv, void* stream) {
  Shape S;
  S.G = G; S.n = n; S.N = N; S.k = k; S.kp1 = k + 1; S.g = g;
  S.mask_bl = mask_bl; S.mask_lv = mask_lv; S.bl = bl; S.lv = lv;
  S.rows = k * mask_lv + lv;
  S.logN = 0;
  while ((1 << S.logN) < N) ++S.logN;
  if (G <= 0 || (1 << S.logN) != N || N < 64 || N > 2048 || g < 1 || g > 4 ||
      n % g != 0 || S.rows > MAX_ROWS || bl > 16 || mask_bl > 16 ||
      bl * lv >= 32 || mask_bl * mask_lv >= 32)
    return (int)cudaErrorInvalidValue;
  Consts K;
  for (int i = 0; i < NP; ++i) {
    K.p[i] = consts[i];
    K.mu[i] = ~0ull / consts[i];
    K.mu32[i] = (uint32_t)((1ull << 32) / consts[i]);
    K.n_inv[i] = consts[4 + i];
    K.n_inv_sh[i] = consts[8 + i];
    if (consts[i] < 3 || consts[i] > 65537 || (i > 0 && consts[i] <= consts[i - 1]))
      return (int)cudaErrorInvalidValue;  // ascending primes <= 2^16 + 1
  }
  const uint32_t* gc = consts + 12;
  K.inv_p0_mod_p1 = gc[0]; K.inv_p0_mod_p1_sh = gc[1];
  K.p0_mod_p2 = gc[2]; K.p0_mod_p2_sh = gc[3];
  K.inv_p01_mod_p2 = gc[4]; K.inv_p01_mod_p2_sh = gc[5];
  K.p0_mod_p3 = gc[6]; K.p0_mod_p3_sh = gc[7];
  K.p01_mod_p3 = gc[8]; K.p01_mod_p3_sh = gc[9];
  K.inv_p012_mod_p3 = gc[10]; K.inv_p012_mod_p3_sh = gc[11];
  K.prod_mod_q = gc[12]; K.half_p3 = gc[13];

  // u32 accumulation is exact when every sum of products fits 32 bits
  const unsigned long long pm = consts[NP - 1] - 1ull, sq = pm * pm;
  const int nv1 = (1 << g) - 1;
  const bool narrow = (unsigned long long)S.rows * sq < (1ull << 32) &&
                      (unsigned long long)nv1 * sq < (1ull << 32);

  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem1 = (size_t)S.rows * N * sizeof(uint32_t);
  const size_t smem3 = (size_t)NP * N * sizeof(uint32_t);
  const int W = nv1 * S.rows * S.kp1;
  const size_t elt = narrow ? sizeof(uint16_t) : sizeof(uint32_t);
  int t2 = 128;
  while (t2 > 32 && (size_t)W * t2 * elt > 160 * 1024) t2 >>= 1;
  const size_t smem2 = (size_t)W * t2 * elt;
  if (smem2 > 227 * 1024) return (int)cudaErrorInvalidValue;
  // gates per pointwise block: enough to reuse each staged BSK column,
  // few enough to keep the grid wide at narrow batches
  const int gpb = G >= 1024 ? 16 : (G >= 64 ? G / 64 : 1);
  using Launch = cudaError_t (*)(const Shape&, const Consts&, int, size_t, int,
                                 const uint32_t*, uint32_t*, const uint32_t*,
                                 const int*, int, const uint32_t*, const int*,
                                 cudaStream_t);
  const Launch wide_fns[4] = {launch_pointwise<1, false>, launch_pointwise<2, false>,
                              launch_pointwise<3, false>, launch_pointwise<4, false>};
  const Launch narrow_fns[4] = {launch_pointwise<1, true>, launch_pointwise<2, true>,
                                launch_pointwise<3, true>, launch_pointwise<4, true>};
  const Launch pointwise_launch = (narrow ? narrow_fns : wide_fns)[g - 1];
  cudaError_t e;
  e = cudaFuncSetAttribute(decompose_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(inverse_garner, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (e != cudaSuccess) return (int)e;

  const uint32_t* bsk_u = (const uint32_t*)bsk;
  const size_t slab = (size_t)W * NP * N;
  for (int j = 0; j < n / g; ++j) {
    decompose_fwd<<<dim3(G, NP), THREADS, smem1, st>>>(
        (const uint32_t*)acc, (uint32_t*)fbuf, (const uint32_t*)psi,
        (const uint32_t*)psi_sh, S, K);
    e = pointwise_launch(S, K, t2, smem2, gpb, (const uint32_t*)fbuf, (uint32_t*)sbuf,
                         bsk_u + slab * j, (const int*)abar, j, (const uint32_t*)pw,
                         (const int*)ef, st);
    if (e != cudaSuccess) return (int)e;
    inverse_garner<<<dim3(G, S.kp1), THREADS, smem3, st>>>(
        (uint32_t*)acc, (const uint32_t*)sbuf, (const uint32_t*)psi_inv,
        (const uint32_t*)psi_inv_sh, S, K);
    if (j == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaGetLastError();
}
