// Gate-major multi-bit blind rotation for Hopper (sm_90a), plain C
// interface: K3 of the port.
//
// Replaces the TPU kernel helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu_mb
// (Pallas body _make_kernel_mb, BSK layout mxu_server_key and its Shoup
// companion). Computes the same function as K1 (blind_rotate_mb.cu) and as
// helm_tpu_torch/fhe/pbs.py::blind_rotate_ladder, word for word: for each
// of the n/g groups of mask elements, the additive-identity CMux
//     acc += INTT( sum_v P_v (.) sum_r NTT(dec(acc))_r (.) BSK_v[r] )
// with P_v = prod_{i in v} (NTT(X^{a_i}) - 1), over the 4 CRT primes, then
// Garner back to u32. What sets K3 apart: its tiles are gate-major, with
// every prime of a tile in one grid step; NTT(X^a) is built by a bit
// ladder over the tables T[b] = NTT(X^(2^b)) (pbs.monomial_tables); and
// the products against the BSK are Shoup products with its companion.
//
// Design. One launch per group, one block per gate that holds all NP
// primes: the TPU kernel's gate-major step, whose primes never leave the
// step (K1 walks every group in one launch, K6 a cluster per gate). In
// shared memory, [NP, rows, N] words (64 KB at GATES_128_K3, 144 KB at
// LUT_128_K2, 192 KB at ARITH_128_MB2), the block
//   1. decomposes the gate's accumulator into gadget rows, the digits mod
//      each prime (decompose_rows, shared with K2, K4 and K6);
//   2. runs the forward NTTs of the rows x NP polynomials;
//   3. per (prime, frequency): the monomials by the bit ladder (one Shoup
//      product per set bit of a_i), the subset polynomials P_v, and
//      S_c = sum_v P_v (.) sum_r Shoup(F_r, BSK_v[r, c], BSK_sh_v[r, c]),
//      into rows 0..k of its prime's buffer (each thread owns its
//      (prime, frequency) column and holds the column's rows in registers
//      before it writes);
//   4. runs the inverse NTTs of the k+1 components of every prime, then
//      Garner with the balanced lift, acc += result.
//
// What bounds it. Each block reads its group's BSK slab and companion,
// 2 x (2^g-1) x rows x (k+1) x NP x N words (1.5 MB at GATES_128_K3), once
// per gate: the slab stays in L2, so device memory sees the BSK and its
// companion about once per rotation and L2 sees them G times; the integer
// work is K1's plus the ladder's log2(2N) Shoup products per monomial.
// Every entry point returns cudaGetLastError(); nothing is allocated here
// and nothing synchronises.

#include <cstdint>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace {

#define ROTATE_GM_PARAMS                                                                  \
  uint32_t *__restrict__ acc, const int *__restrict__ abar,                              \
      const uint32_t *__restrict__ bsk_j, const uint32_t *__restrict__ bsk_sh_j,         \
      int group, const uint32_t *__restrict__ mono, const uint32_t *__restrict__ mono_sh, \
      const uint32_t *__restrict__ psi, const uint32_t *__restrict__ psi_sh,             \
      const uint32_t *__restrict__ psi_inv, const uint32_t *__restrict__ psi_inv_sh,     \
      Shape S, Consts K

// One group of the rotation for gate blockIdx.x. bsk_j / bsk_sh_j: this
// group's slab [2^g-1, rows, k+1, NP, N] (the BSK's natural order).
// mono / mono_sh: [log2(2N), NP, N].
template <int GB>
__global__ void __launch_bounds__(THREADS) rotate_group_gm(ROTATE_GM_PARAMS) {
  constexpr int NV1 = (1 << GB) - 1;
  const int N = S.N, logN = S.logN, rows = S.rows, kp1 = S.kp1;
  const int gate = blockIdx.x;
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem_raw);  // [NP, rows, N]

  for (int pi = 0; pi < NP; ++pi)
    decompose_rows(AccWords{acc}, buf + (size_t)pi * rows * N, gate, pi, S, K);
  for (int pi = 0; pi < NP; ++pi)
    ntt_fwd_rows(buf + (size_t)pi * rows * N, rows, pi, psi, psi_sh, S, K);

  int a[GB];
  const int* ag = abar + (size_t)gate * S.n + group * GB;
#pragma unroll
  for (int i = 0; i < GB; ++i) a[i] = __ldg(ag + i);
  const int l2n = logN + 1;  // exponents live in [0, 2N)
  for (int idx = threadIdx.x; idx < NP * N; idx += blockDim.x) {
    const int pi = idx >> logN, f = idx & (N - 1);
    const uint32_t p = K.p[pi];
    const unsigned long long mu = K.mu[pi];
    uint32_t d[GB];
#pragma unroll
    for (int i = 0; i < GB; ++i) {  // NTT(X^a_i) by the bit ladder, minus 1
      uint32_t m = 1;
      for (int b = 0; b < l2n; ++b) {
        if ((a[i] >> b) & 1) {
          const size_t ti = ((size_t)b * NP + pi) * N + f;
          m = mul_shoup(m, __ldg(mono + ti), __ldg(mono_sh + ti), p);
        }
      }
      d[i] = sub_mod(m, 1u, p);
    }
    uint32_t P[NV1 + 1];
    P[0] = 1;
#pragma unroll
    for (int v = 1; v <= NV1; ++v) {
      const int lo = __ffs(v) - 1;
      P[v] = (v == (1 << lo)) ? d[lo] : reduce64((unsigned long long)P[v & (v - 1)] * d[lo], p, mu);
    }
    uint32_t F[MAX_ROWS];
    uint32_t* col = buf + (size_t)pi * rows * N + f;
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < rows) F[r] = col[(size_t)r * N];
    for (int c = 0; c < kp1; ++c) {
      unsigned long long s = 0;  // < (2^g-1) p^2 < 2^38
#pragma unroll
      for (int v = 1; v <= NV1; ++v) {
        const size_t b0 = ((size_t)((v - 1) * rows) * kp1 + c) * NP * N + (size_t)pi * N + f;
        uint32_t t = 0;  // < rows x p < 2^21
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r) {
          if (r < rows) {
            const size_t bi = b0 + (size_t)r * kp1 * NP * N;
            t += mul_shoup(F[r], __ldg(bsk_j + bi), __ldg(bsk_sh_j + bi), p);
          }
        }
        s += (unsigned long long)P[v] * reduce32(t, p, K.mu32[pi]);
      }
      col[(size_t)c * N] = reduce64(s, p, mu);
    }
  }

  for (int pi = 0; pi < NP; ++pi)
    ntt_inv_rows(buf + (size_t)pi * rows * N, kp1, FixedPrime{pi}, psi_inv, psi_inv_sh, S, K);
  uint32_t* dst = acc + (size_t)gate * kp1 * N;
  for (int idx = threadIdx.x; idx < kp1 * N; idx += blockDim.x) {
    const int c = idx >> logN, coef = idx & (N - 1);
    uint32_t r[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i)
      r[i] = mul_shoup(buf[((size_t)i * rows + c) * N + coef], K.n_inv[i], K.n_inv_sh[i], K.p[i]);
    dst[idx] += garner(r[0], r[1], r[2], r[3], K);
  }
}

template <int GB>
cudaError_t rotate(const Shape& S, const Consts& K, size_t smem, uint32_t* acc, const int* abar,
                   const uint32_t* bsk, const uint32_t* bsk_sh, const uint32_t* mono,
                   const uint32_t* mono_sh, const uint32_t* psi, const uint32_t* psi_sh,
                   const uint32_t* psi_inv, const uint32_t* psi_inv_sh, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(rotate_group_gm<GB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const size_t slab = (size_t)((1 << GB) - 1) * S.rows * S.kp1 * NP * S.N;
  for (int j = 0; j < S.n / GB; ++j) {
    rotate_group_gm<GB><<<S.G, THREADS, smem, st>>>(acc, abar, bsk + slab * j, bsk_sh + slab * j,
                                                    j, mono, mono_sh, psi, psi_sh, psi_inv,
                                                    psi_inv_sh, S, K);
    if (j == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

}  // namespace

// consts (host, 26 words): see load_consts in pbs_common.cuh.
// acc: u32 [G, k+1, N], in/out. abar: i32 [G, n] in [0, 2N).
// bsk, bsk_sh: u32 [n/g, 2^g-1, rows, k+1, NP, N] (the BSK and its Shoup
// companion). mono, mono_sh: u32 [log2(2N), NP, N]. psi*: u32 [NP, N].
// Returns a cudaError_t.
extern "C" int helm_blind_rotate_gm(void* acc, const void* abar, const void* bsk,
                                    const void* bsk_sh, const void* mono, const void* mono_sh,
                                    const void* psi, const void* psi_sh, const void* psi_inv,
                                    const void* psi_inv_sh, const uint32_t* consts, int G, int n,
                                    int N, int k, int g, int mask_bl, int mask_lv, int bl, int lv,
                                    void* stream) {
  Shape S;
  Consts K;
  if (!make_shape(S, G, n, N, k, g, mask_bl, mask_lv, bl, lv) || g < 2 || g > 4 || n % g != 0 ||
      !load_consts(K, consts))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NP * S.rows * N * sizeof(uint32_t);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  using Rotate = cudaError_t (*)(const Shape&, const Consts&, size_t, uint32_t*, const int*,
                                 const uint32_t*, const uint32_t*, const uint32_t*,
                                 const uint32_t*, const uint32_t*, const uint32_t*,
                                 const uint32_t*, const uint32_t*, cudaStream_t);
  const Rotate fns[3] = {rotate<2>, rotate<3>, rotate<4>};
  return (int)fns[g - 2](S, K, smem, (uint32_t*)acc, (const int*)abar, (const uint32_t*)bsk,
                         (const uint32_t*)bsk_sh, (const uint32_t*)mono, (const uint32_t*)mono_sh,
                         (const uint32_t*)psi, (const uint32_t*)psi_sh, (const uint32_t*)psi_inv,
                         (const uint32_t*)psi_inv_sh, (cudaStream_t)stream);
}
