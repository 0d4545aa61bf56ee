// Single-bit blind rotation for Hopper (sm_90a), plain C interface.
//
// Replaces both TPU kernels of the single-bit (grouping 1) blind rotation:
// helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu (K2a, Pallas body _make_kernel)
// and helm_tpu/ops/pallas_pbs.py::blind_rotate_pallas (K2b, Pallas body
// _make_kernel). Computes the same function as
// helm_tpu/fhe/pbs_jnp.py::blind_rotate and its torch twin
// helm_tpu_torch/fhe/pbs.py::blind_rotate, word for word: for each of the
// n mask elements a_i,
//     acc += INTT( sum_r NTT(dec(X^{a_i} * acc - acc))_r (.) BSK_i[r, c] )
// over the 4 CRT primes, then Garner back to u32. The CMux is applied to
// the rotated difference BEFORE the decomposition, which is not K1's
// function at grouping 1 (K1 decomposes the bare accumulator and
// multiplies by X^a - 1 after the product: other words). Neither TPU
// layout is carried over (K2a: gate-major lanes, 8-wide frequency split,
// bf16 limb-matmul NTTs; K2b: roll-form radix-2 NTTs).
//
// Design: three kernels per step, on one stream, the accumulator
// acc [G, k+1, N] in device memory:
//   1. decompose_fwd (pbs_common.cuh) grid (G, NP): one block per (gate,
//      prime) reads the gate's accumulator, forms X^{a_i} * acc - acc by
//      the negacyclic index (coef - a_i) mod 2N (RotDiffWords below),
//      decomposes it into the gadget rows, reduces the digits mod p and
//      runs the forward NTTs of all rows in dynamic shared memory
//      (rows x N words: 48 KB at LUT_PARAMS' 6 rows x 2048, so the
//      launch raises the block's dynamic shared-memory limit first);
//   2. pointwise grid (NP*N / T, gate chunks): one thread per (prime,
//      frequency) stages its column of step i's BSK slab [rows, k+1] in
//      shared memory once and loops over the block's gates, summing
//      rows products per component exactly (in 32 bits when
//      rows * (p-1)^2 < 2^32, as PRIMES_512 allows; in 64 bits for
//      PRIMES_1024 and PRIMES) and reducing once with Barrett;
//   3. inverse_garner (pbs_common.cuh) grid (G, k+1): inverse NTT of the
//      NP residue polys, Garner with the balanced lift, acc += result.
//
// What bounds it. Integer operations: per gate and step, (rows + k+1) x
// NP forward / inverse NTTs of N/2 log2 N butterflies each (a Shoup
// multiply, a modular add and a modular subtract) and rows x (k+1) x NP
// x N multiply-adds, against a BSK slab of rows x (k+1) x NP x N words
// that every gate of a batch shares (67 MB per rotation at GATES_TPU,
// 0.02 ms of device bandwidth). So a wide batch is bound by the SMs'
// integer throughput, and a narrow one (a circuit level of 8-32 gates)
// by latency: its 3 x n launches run G x NP or G x (k+1) blocks on 132
// SMs, so one block's chain of NTT stages and barriers sets each
// launch's time (inverse_garner, with its Garner epilogue, took half the
// device time of a GATES_TPU c880-like vector on an H100 80GB HBM3 at
// 700 W). The design keeps every transform in shared memory and reads
// each BSK word once per chunk of gates; spreading a narrow batch's NTTs
// over more threads, fusing the three kernels of a step, or capturing
// the n steps in a CUDA graph is the next step for narrow batches.
//
// Every entry point returns cudaGetLastError(); nothing is allocated here
// (the wrapper passes acc, F and S) and nothing synchronises.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace {

// decompose_fwd's source for step `step`: (X^{a} - 1) * acc with
// a = abar[gate, step] in [0, 2N): coefficient coef of X^a * acc is
// acc[j] for j = (coef - a) mod 2N < N, else -acc[j - N]
// (fhe/ops.py negacyclic_rotate)
struct RotDiffWords {
  const uint32_t* acc;
  const int* abar;
  int step;
  __device__ __forceinline__ uint32_t operator()(const Shape& S, int gate, int c,
                                                 int coef) const {
    const uint32_t* a = acc + ((size_t)gate * S.kp1 + c) * S.N;
    const int r = __ldg(abar + (size_t)gate * S.n + step);
    const int j = (coef - r) & (2 * S.N - 1);
    const uint32_t rot = j < S.N ? a[j] : 0u - a[j - S.N];
    return rot - a[coef];
  }
};

// 2. pointwise products against step i's BSK slab [rows, k+1, NP, N]; one
//    thread per (prime, frequency), looping over a chunk of gates
template <bool NARROW>
__global__ void pointwise_sb(const uint32_t* __restrict__ fbuf,
                             uint32_t* __restrict__ sbuf,
                             const uint32_t* __restrict__ bsk_i, Shape S, Consts K,
                             int gates_per_block) {
  using BT = typename std::conditional<NARROW, uint16_t, uint32_t>::type;
  using AT = typename std::conditional<NARROW, uint32_t, unsigned long long>::type;
  BT* bs = reinterpret_cast<BT*>(smem_raw);  // [rows * kp1][blockDim.x]
  const int N = S.N, NPN = NP * N, T = blockDim.x;
  const int pf = blockIdx.x * T + threadIdx.x;  // pi * N + f
  const int pi = pf >> S.logN;
  const int W = S.rows * S.kp1;
  for (int w = 0; w < W; ++w)  // each thread reads back only its own column
    bs[w * T + threadIdx.x] = (BT)__ldg(bsk_i + (size_t)w * NPN + pf);
  const uint32_t p = K.p[pi], mu32 = K.mu32[pi];
  const unsigned long long mu = K.mu[pi];
  const int g0 = blockIdx.y * gates_per_block;
  const int g1 = min(S.G, g0 + gates_per_block);
  for (int gate = g0; gate < g1; ++gate) {
    uint32_t F[MAX_ROWS];
    const uint32_t* fg = fbuf + (size_t)gate * S.rows * NPN + pf;
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < S.rows) F[r] = fg[(size_t)r * NPN];
    uint32_t* sg = sbuf + (size_t)gate * S.kp1 * NPN + pf;
    for (int c = 0; c < S.kp1; ++c) {
      const BT* bc = bs + c * T + threadIdx.x;
      AT t = 0;
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
        if (r < S.rows) t += (AT)F[r] * bc[r * S.kp1 * T];
      if constexpr (NARROW) sg[(size_t)c * NPN] = reduce32(t, p, mu32);
      else sg[(size_t)c * NPN] = reduce64(t, p, mu);
    }
  }
}

}  // namespace

// consts (host, 26 words): see load_consts in pbs_common.cuh.
// acc: u32 [G, k+1, N], in/out. abar: i32 [G, n] in [0, 2N).
// bsk: u32 [n, rows, k+1, NP, N]. psi*: u32 [NP, N]. fbuf: u32
// [G, rows, NP, N]. sbuf: u32 [G, k+1, NP, N]. Returns a cudaError_t.
extern "C" int helm_blind_rotate_sb(
    void* acc, const void* abar, const void* bsk, const void* psi,
    const void* psi_sh, const void* psi_inv, const void* psi_inv_sh,
    void* fbuf, void* sbuf, const uint32_t* consts, int G, int n, int N, int k,
    int mask_bl, int mask_lv, int bl, int lv, void* stream) {
  Shape S;
  Consts K;
  if (!make_shape(S, G, n, N, k, 1, mask_bl, mask_lv, bl, lv) || !load_consts(K, consts))
    return (int)cudaErrorInvalidValue;
  const bool narrow = fits_u32(K, S.rows);

  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem1 = (size_t)S.rows * N * sizeof(uint32_t);
  const size_t smem3 = (size_t)NP * N * sizeof(uint32_t);
  const int W = S.rows * S.kp1;
  const size_t elt = narrow ? sizeof(uint16_t) : sizeof(uint32_t);
  const int t2 = 128;  // NP * N >= 256 is a multiple of it
  const size_t smem2 = (size_t)W * t2 * elt;
  if (smem2 > 227 * 1024) return (int)cudaErrorInvalidValue;
  // gates per pointwise block: enough to reuse each staged BSK column,
  // few enough to keep the grid wide at narrow batches
  const int gpb = G >= 1024 ? 16 : (G >= 64 ? G / 64 : 1);
  const dim3 grid2(NP * N / t2, (G + gpb - 1) / gpb);

  cudaError_t e;
  e = cudaFuncSetAttribute(decompose_fwd<RotDiffWords>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(inverse_garner, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(narrow ? pointwise_sb<true> : pointwise_sb<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (e != cudaSuccess) return (int)e;

  const uint32_t* bsk_u = (const uint32_t*)bsk;
  const size_t slab = (size_t)W * NP * N;
  for (int i = 0; i < n; ++i) {
    decompose_fwd<<<dim3(G, NP), THREADS, smem1, st>>>(
        RotDiffWords{(const uint32_t*)acc, (const int*)abar, i}, (uint32_t*)fbuf,
        (const uint32_t*)psi, (const uint32_t*)psi_sh, S, K);
    if (narrow)
      pointwise_sb<true><<<grid2, t2, smem2, st>>>((const uint32_t*)fbuf, (uint32_t*)sbuf,
                                                   bsk_u + slab * i, S, K, gpb);
    else
      pointwise_sb<false><<<grid2, t2, smem2, st>>>((const uint32_t*)fbuf, (uint32_t*)sbuf,
                                                    bsk_u + slab * i, S, K, gpb);
    inverse_garner<<<dim3(G, S.kp1), THREADS, smem3, st>>>(
        (uint32_t*)acc, (const uint32_t*)sbuf, (const uint32_t*)psi_inv,
        (const uint32_t*)psi_inv_sh, S, K);
    if (i == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaGetLastError();
}
