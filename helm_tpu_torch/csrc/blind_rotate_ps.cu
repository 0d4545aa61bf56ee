// Prime-split multi-bit blind rotation for Hopper (sm_90a), plain C
// interface: K6 of the port.
//
// Replaces the TPU kernel helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_ps
// (Pallas body _make_kernel_fs_ps, BSK layout mxu_server_key_ps). Computes
// the same function as K1 (blind_rotate_mb.cu) and as
// helm_tpu_torch/fhe/pbs.py::blind_rotate_prime_split, word for word: for
// each of the n/g groups of mask elements, the additive-identity CMux
//     acc += INTT( sum_r NTT(dec(acc))_r (.) sum_v P_v (.) BSK_v )
// with P_v = prod_{i in v} (X^{a_i} - 1), each CRT prime's external
// product on its own, the primes then folded by CRT partial sums
// (fhe/ntt.py crt_fold) in place of Garner.
//
// Design. The TPU kernel puts the prime on the grid and folds the primes
// through running partial sums in scratch memory. Here a group is ONE
// launch, grid (G, NP), with a thread-block cluster of NP = 4 blocks along
// the prime axis: one cluster per gate, one block per (gate, prime). Each
// block
//   1. decomposes the gate's accumulator into gadget rows and reduces the
//      digits mod its prime (decompose_rows, shared with K2, K3 and K4);
//   2. runs the forward NTTs of the rows in shared memory;
//   3. forms S_c = sum_r F_r (.) sum_v P_v (.) BSK_v[r, c] per frequency,
//      P_v by K1's direct monomial lookup (NTT(X^a)[f] = psi^(a*e_f mod
//      2N)), into rows 0..k of the same buffer (each thread owns its
//      frequency column and holds the column's rows in registers before it
//      writes);
//   4. runs the inverse NTTs of the k+1 components, leaving its residues
//      in its shared memory.
// After cluster.sync(), block pi folds the pi-th quarter of the gate's
// (k+1)*N coefficients: it reads the four primes' residues through
// distributed shared memory (cluster.map_shared_rank), folds them and adds
// the result into acc in device memory. A second cluster.sync() keeps
// every block's shared memory alive until its peers have read it. So a
// rotation is n/g launches, where K1 makes one.
//
// The fold. x = sum_i r_i W_i - k P (mod 2^32) with k = floor(s + 0.5),
// s = sum_i r_i * (W_i / P) in double precision. That k is exact: for
// every parameter set |x| <= conv_bound <= 0.389 P (GATES_128_K3 with
// PRIMES_512 is the largest share), so s lies at least 0.11 from a
// half-integer, and the double sum of four products r_i < 2^17 by
// fractions rounded to 53 bits errs by under 2^-32. The result is
// Garner's balanced lift.
//
// What bounds it. Each block reads its prime's slab of the group's BSK,
// (2^g-1) x rows x (k+1) x N words (196 KB at GATES_128_K3), once per
// gate: the group's slab stays in L2 (0.79 MB), so device memory sees the
// BSK about once per rotation and L2 sees it G times; the integer work is
// K1's. Narrow batches are bound by the latency of one block's chain
// (NTT stages, barriers, the L2 reads of its BSK slab) per launch, now one
// launch per group; wide ones by how much of that latency other blocks
// hide. So each rotation picks one of two register budgets for the same
// code by the number of clusters it launches (rotate, below).
//
// Every entry point returns the first launch error (cudaLaunchKernelEx
// returns it per launch) or cudaGetLastError(); nothing is allocated here
// and nothing synchronises.

#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace cg = cooperative_groups;

namespace {

// the CRT fold's constants (fhe/ntt.py CrtConstants)
struct Crt {
  uint32_t w_mod[NP];  // W_i mod 2^32
  double frac[NP];     // W_i / P
};

#define ROTATE_GROUP_PARAMS                                                              \
  uint32_t *__restrict__ acc, const int *__restrict__ abar,                              \
      const uint32_t *__restrict__ bsk_j, int group, const uint32_t *__restrict__ psi,   \
      const uint32_t *__restrict__ psi_sh, const uint32_t *__restrict__ psi_inv,         \
      const uint32_t *__restrict__ psi_inv_sh, const uint32_t *__restrict__ pw,          \
      const int *__restrict__ ef, Shape S, Consts K, Crt C
#define ROTATE_GROUP_ARGS acc, abar, bsk_j, group, psi, psi_sh, psi_inv, psi_inv_sh, pw, ef, S, K, C

// One group of the rotation: a cluster of NP blocks per gate, block rank
// = prime (cluster dims (1, NP, 1) over grid (G, NP)).
// bsk_j: this group's slab [NP, 2^g-1, rows, k+1, N] (ps_server_key).
template <int GB, bool NARROW>
__device__ __forceinline__ void rotate_group(ROTATE_GROUP_PARAMS) {
  using AT = typename std::conditional<NARROW, uint32_t, unsigned long long>::type;
  constexpr int NV1 = (1 << GB) - 1;  // non-empty subsets
  cg::cluster_group cluster = cg::this_cluster();
  // [rows, N]: the gadget rows, then rows 0..k hold the k+1 components
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem_raw);
  const int gate = blockIdx.x, pi = blockIdx.y;
  const int N = S.N;

  decompose_rows(AccWords{acc}, buf, gate, pi, S, K);
  ntt_fwd_rows(buf, S.rows, pi, psi, psi_sh, S, K);

  const uint32_t p = K.p[pi], mu32 = K.mu32[pi];
  const unsigned long long mu = K.mu[pi];
  auto reduce = [&](AT x) -> uint32_t {
    if constexpr (NARROW) return reduce32(x, p, mu32);
    else return reduce64(x, p, mu);
  };
  int a[GB];
  const int* ag = abar + (size_t)gate * S.n + group * GB;
#pragma unroll
  for (int i = 0; i < GB; ++i) a[i] = __ldg(ag + i);
  const uint32_t* pwp = pw + pi * 2 * N;
  const uint32_t* bp = bsk_j + (size_t)pi * NV1 * S.rows * S.kp1 * N;
  const int mask2n = 2 * N - 1;
  for (int f = threadIdx.x; f < N; f += blockDim.x) {
    const int e = __ldg(ef + f);
    uint32_t d[GB];
#pragma unroll
    for (int i = 0; i < GB; ++i)  // NTT(X^a_i) - 1; psi^t >= 1 so no wrap
      d[i] = __ldg(pwp + ((a[i] * e) & mask2n)) - 1u;
    uint32_t P[NV1 + 1];
    P[0] = 1;
#pragma unroll
    for (int v = 1; v <= NV1; ++v) {
      const int lo = __ffs(v) - 1;
      P[v] = (v == (1 << lo)) ? d[lo] : reduce((AT)P[v & (v - 1)] * d[lo]);
    }
    uint32_t F[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r)
      if (r < S.rows) F[r] = buf[r * N + f];
    for (int c = 0; c < S.kp1; ++c) {
      AT s = 0;
#pragma unroll
      for (int v = 1; v <= NV1; ++v) {
        const uint32_t* bv = bp + ((size_t)((v - 1) * S.rows) * S.kp1 + c) * N + f;
        AT t = 0;
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r)
          if (r < S.rows) t += (AT)F[r] * __ldg(bv + (size_t)r * S.kp1 * N);
        s += (AT)P[v] * reduce(t);
      }
      buf[c * N + f] = reduce(s);
    }
  }

  ntt_inv_rows(buf, S.kp1, FixedPrime{pi}, psi_inv, psi_inv_sh, S, K);
  cluster.sync();  // every prime's residues are in its block's shared memory

  const uint32_t* peer[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) peer[i] = cluster.map_shared_rank(buf, i);
  const int chunk = S.kp1 * N / NP;  // N >= 64, so a multiple of the 4 primes
  uint32_t* dst = acc + (size_t)gate * S.kp1 * N;
  for (int idx = pi * chunk + threadIdx.x; idx < (pi + 1) * chunk; idx += blockDim.x) {
    uint32_t sum = 0;
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const uint32_t r = mul_shoup(peer[i][idx], K.n_inv[i], K.n_inv_sh[i], K.p[i]);
      sum += r * C.w_mod[i];  // wrapping == mod 2^32
      s += (double)r * C.frac[i];
    }
    const uint32_t kq = (uint32_t)(long long)floor(s + 0.5);  // s in [0, 2^19)
    dst[idx] += sum - kq * K.prod_mod_q;
  }
  cluster.sync();  // no block leaves while a peer may still read its residues
}

// The same code under two register budgets (see rotate): as the compiler
// likes it, and held to two blocks per SM
template <int GB, bool NARROW>
__global__ void rotate_group_ps(ROTATE_GROUP_PARAMS) {
  rotate_group<GB, NARROW>(ROTATE_GROUP_ARGS);
}
template <int GB, bool NARROW>
__global__ void __launch_bounds__(THREADS, 2) rotate_group_ps_bounded(ROTATE_GROUP_PARAMS) {
  rotate_group<GB, NARROW>(ROTATE_GROUP_ARGS);
}

// The device pointers of one rotation
struct Args {
  uint32_t* acc;
  const int* abar;
  const uint32_t *bsk, *psi, *psi_sh, *psi_inv, *psi_inv_sh, *pw;
  const int* ef;
};

// Every group of one rotation, one launch each, with the variant of
// rotate_group_ps that suits the width. At most two waves of clusters of
// the unbounded variant (one block per SM at g=2: 176 registers, its 2^g-1
// x rows BSK loads of a frequency all in flight) beat the variant held to
// 128 registers (two blocks per SM, its loads in turn); wider batches go
// to the latter, whose extra blocks hide the latency (GATES_128_K3 on an
// H100 80GB HBM3 at 700 W: 19.2 against 36.1 ms at G=8, 46.1 against
// 37.6 at G=64, 476 against 244 at G=1024; chip_smoke.py phase k6).
template <int GB, bool NARROW>
cudaError_t rotate(const Shape& S, const Consts& K, const Crt& C, size_t smem, const Args& a,
                   cudaStream_t st) {
  auto unbounded = rotate_group_ps<GB, NARROW>;
  auto bounded = rotate_group_ps_bounded<GB, NARROW>;
  for (auto kern : {unbounded, bounded}) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S.G, NP);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = NP;  // the grid's prime axis is exactly one cluster
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;  // clusters of the unbounded variant resident at once
  cudaError_t e = cudaOccupancyMaxActiveClusters(&fit, unbounded, &cfg);
  if (e != cudaSuccess) return e;
  const auto kern = S.G <= 2 * fit ? unbounded : bounded;
  const int nv1 = (1 << GB) - 1;
  const size_t slab = (size_t)NP * nv1 * S.rows * S.kp1 * S.N;
  for (int j = 0; j < S.n / GB; ++j) {
    e = cudaLaunchKernelEx(&cfg, kern, a.acc, a.abar, a.bsk + slab * j, j, a.psi, a.psi_sh,
                           a.psi_inv, a.psi_inv_sh, a.pw, a.ef, S, K, C);
    if (e != cudaSuccess) return e;
    if (j == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

}  // namespace

// consts (host, 26 words): see load_consts in pbs_common.cuh. crt_w: u32
// [4], crt_frac: f64 [4] (fhe/ntt.py crt_constants).
// acc: u32 [G, k+1, N], in/out. abar: i32 [G, n] in [0, 2N).
// bsk: u32 [n/g, NP, 2^g-1, rows, k+1, N] (ops/ps_pbs.py ps_server_key).
// psi*: u32 [NP, N]. pw: u32 [NP, 2N]. ef: i32 [N]. Returns a cudaError_t.
extern "C" int helm_blind_rotate_ps(
    void* acc, const void* abar, const void* bsk, const void* psi,
    const void* psi_sh, const void* psi_inv, const void* psi_inv_sh,
    const void* pw, const void* ef, const uint32_t* consts, const uint32_t* crt_w,
    const double* crt_frac, int G, int n, int N, int k, int g, int mask_bl,
    int mask_lv, int bl, int lv, void* stream) {
  Shape S;
  Consts K;
  if (!make_shape(S, G, n, N, k, g, mask_bl, mask_lv, bl, lv) || g < 2 || g > 4 ||
      n % g != 0 || !load_consts(K, consts))
    return (int)cudaErrorInvalidValue;
  Crt C;
  for (int i = 0; i < NP; ++i) {
    C.w_mod[i] = crt_w[i];
    C.frac[i] = crt_frac[i];
  }
  const bool narrow = fits_u32(K, S.rows) && fits_u32(K, (1 << g) - 1);
  const size_t smem = (size_t)S.rows * N * sizeof(uint32_t);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const Args a{(uint32_t*)acc, (const int*)abar, (const uint32_t*)bsk, (const uint32_t*)psi,
               (const uint32_t*)psi_sh, (const uint32_t*)psi_inv,
               (const uint32_t*)psi_inv_sh, (const uint32_t*)pw, (const int*)ef};
  using Rotate = cudaError_t (*)(const Shape&, const Consts&, const Crt&, size_t, const Args&,
                                 cudaStream_t);
  const Rotate wide_fns[3] = {rotate<2, false>, rotate<3, false>, rotate<4, false>};
  const Rotate narrow_fns[3] = {rotate<2, true>, rotate<3, true>, rotate<4, true>};
  return (int)(narrow ? narrow_fns : wide_fns)[g - 2](S, K, C, smem, a, (cudaStream_t)stream);
}
