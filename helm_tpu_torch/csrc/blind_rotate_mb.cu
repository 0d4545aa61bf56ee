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
// (a single circuit vector: 8-32 gates) by the latency of each step's
// chain of three small launches (the prime-split K6, one launch per step,
// is slower there: its one block per (gate, prime) does the whole chain).
//
// Kernels 1 and 3 and the modular arithmetic live in pbs_common.cuh,
// shared with the single-bit kernel K2 (blind_rotate_sb.cu). Every entry
// point returns cudaGetLastError(); nothing is allocated here (the wrapper
// passes acc, F and S) and nothing synchronises.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace {

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

// consts (host, 26 words): see load_consts in pbs_common.cuh.
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
  Consts K;
  if (!make_shape(S, G, n, N, k, g, mask_bl, mask_lv, bl, lv) || g < 1 || g > 4 ||
      n % g != 0 || !load_consts(K, consts))
    return (int)cudaErrorInvalidValue;
  // u32 accumulation is exact when every sum of products fits 32 bits
  const int nv1 = (1 << g) - 1;
  const bool narrow = fits_u32(K, S.rows) && fits_u32(K, nv1);

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
  e = cudaFuncSetAttribute(decompose_fwd<AccWords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(inverse_garner, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (e != cudaSuccess) return (int)e;

  const uint32_t* bsk_u = (const uint32_t*)bsk;
  const size_t slab = (size_t)W * NP * N;
  for (int j = 0; j < n / g; ++j) {
    decompose_fwd<<<dim3(G, NP), THREADS, smem1, st>>>(
        AccWords{(const uint32_t*)acc}, (uint32_t*)fbuf, (const uint32_t*)psi,
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
