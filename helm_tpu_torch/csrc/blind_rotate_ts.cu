// Transposed multi-bit blind rotation for Hopper (sm_90a), plain C
// interface: K4 of the port.
//
// Replaces the TPU kernel helm_tpu/ops/ts_pbs.py::blind_rotate_ts_mb
// (Pallas body _make_kernel_ts_mb, BSK layout mxu_server_key_ts). Computes
// the same function as K1 (blind_rotate_mb.cu) and as
// helm_tpu_torch/fhe/pbs.py::blind_rotate_transposed, word for word: for
// each of the n/g groups of mask elements, the additive-identity CMux
//     acc += INTT( sum_r NTT(dec(acc))_r (.) sum_v P_v (.) BSK_v )
// with P_v = prod_{i in v} (X^{a_i} - 1), over the 4 CRT primes, then
// Garner back to u32. What sets K4 apart is its transform: the four-step
// NTT of helm_tpu/ops/mxu_ntt.py (N = N1 x N2, N1 = 8), whose N2-point
// stage is a dense product with the gates' polynomials along the rows.
// On the TPU that product is bf16 limbs on the MXU; here it runs on the
// int8 tensor cores (mma.sync.aligned.m16n8k32, s8 x s8 -> s32).
//
// Design. One launch per group with grid (gate tiles, NP): a block holds
// GT gates (1, 2 or 4, by width) for one prime, and
//   1. decomposes each gate's accumulator into gadget rows, digits mod p,
//      into X [GT*rows, N] in shared memory (decompose_rows, as K6);
//   2. runs the three 8-point Cooley-Tukey stages of every (row, jB)
//      column in registers, twists, and splits each word's balanced
//      residue into signed 8-bit limbs, limb planes A_l [M, N2] with
//      M = GT x rows x N1: the rows of the product;
//   3. multiplies A_l by the limbs W_l of the N2 x N2 matrix on the tensor
//      cores, one s32 accumulator per limb shift la+lw, and recombines
//      sum_s acc_s 256^s mod p into X (now in the four-step order);
//   4. forms S_c = sum_v P_v (.) sum_r F_r (.) BSK_v[r, c] per frequency:
//      P_v by K1's direct monomial lookup in the four-step order, and each
//      BSK word loaded once per tile and used for all the tile's gates
//      (K4's row broadcast); sums exact as K1's (u32 when fits_u32, else
//      u64);
//   5. splits S into limb planes, runs the inverse N2-point product the
//      same way, then the inverse twist and the 8-point Gentleman-Sande
//      stages, and writes the residues to R [G, k+1, NP, N].
// A second launch (crt_accumulate) recombines the NP residues by Garner
// and adds them into acc. So a rotation is 2 x n/g launches.
//
// Limbs. Every product is exact: limbs are in [-128, 127], so a limb
// product is at most 2^14, a sum over N2 <= 256 terms below 2^22, and a
// shift's sum of at most three limb pairs below 2^24 in s32. p = 65537
// (PRIMES, N = 2048) balances to +-32768, and two signed 8-bit limbs hold
// only 65536 values: that prime takes three limbs on both operands (nine
// products where the others take four); ntt.py limb_count.
//
// The matrix operand. The N2 x N2 limb matrices are packed on the host in
// the mma B-fragment order (ops/ts_pbs.py b_fragments), so each warp
// reads one fragment as 32 x 8 contiguous bytes through L1 / L2, shared
// by every block of the prime. They are not staged in shared memory at
// any ring size: one prime's limbs of one direction take 8 KB at N = 512,
// 32 KB at N = 1024 and 192 KB at N = 2048, beside blocks of 104 KB
// (GATES_128_K3, 4 gates), 112.5 KB (LUT_128_K2, 2 gates) and 172.5 KB
// (ARITH_128_MB2, 2 gates). Both directions at N = 512, or one at
// N = 1024, would leave one block per SM where two run now; N = 2048
// does not fit.
//
// What bounds it. The integer work of the products and of the 8-point
// stages, twists and limb splits on the CUDA cores; the tensor-core
// products are a small part of the peak. Every entry point returns
// cudaGetLastError(); nothing is allocated here (the wrapper passes acc
// and R) and nothing synchronises.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace {

constexpr int N1 = 8;
constexpr int MAXL = 3;               // signed 8-bit limbs of a residue (p = 65537)
constexpr int NSHIFT = 2 * MAXL - 1;  // limb shifts la + lw
constexpr int MAX_KP1 = 4;            // k + 1 (k <= 3)

// the four-step transform's per-prime constants (fhe/ntt.py mxu_tables)
struct TsConsts {
  uint32_t stw[NP][3][N1], stw_sh[NP][3][N1];    // forward 8-point stages
  uint32_t istw[NP][3][N1], istw_sh[NP][3][N1];  // inverse 8-point stages
  int nl[NP];                                    // limbs of prime pi
  uint32_t pow256[NP][NSHIFT];                   // 256^s mod p
};

// the geometry of the N2-point products at ring size N
struct Geo {
  int N2, logN2;
  int Kp;  // N2 rounded up to the mma depth 32
  int AS;  // bytes per limb-plane row: Kp + 16 (keeps a fragment's 8 rows in distinct banks)
  int KK, NT;  // k-steps of 32, n-tiles of 8
};

// device tables of one rotation
struct Tabs {
  const uint2* bf;   // forward B fragments [NP][MAXL][KK][NT][32] x 8 bytes
  const uint2* bi;   // inverse
  const uint32_t *tw, *tw_sh, *twi, *twi_sh;  // [NP][N1][N2]
};

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One residue's balanced value split into nl signed 8-bit limbs (ntt.py
// split_limbs), written to the limb planes at byte offset off
__device__ __forceinline__ void put_limbs(int8_t* planes, size_t plane_bytes, size_t off,
                                          uint32_t x, uint32_t p, int nl) {
  int b = x > (p >> 1) ? (int)x - (int)p : (int)x;
  for (int l = 0; l < nl; ++l) {
    const int lo = ((b + 128) & 255) - 128;
    planes[l * plane_bytes + off] = (int8_t)lo;
    b = (b - lo) >> 8;
  }
}

// Zero the planes' padding: columns [N2, Kp) of rows [0, M), and rows
// [M, Mp) whole. Disjoint from the cells the data fills.
__device__ __forceinline__ void zero_padding(int8_t* planes, size_t plane_bytes, int M, int Mp,
                                             int nl, const Geo& T) {
  const int pad = T.Kp - T.N2;
  if (pad > 0) {
    for (int idx = threadIdx.x; idx < nl * M * pad; idx += blockDim.x) {
      const int l = idx / (M * pad), rem = idx % (M * pad);
      planes[l * plane_bytes + (size_t)(rem / pad) * T.AS + T.N2 + rem % pad] = 0;
    }
  }
  for (int idx = threadIdx.x; idx < nl * (Mp - M) * T.Kp; idx += blockDim.x) {
    const int l = idx / ((Mp - M) * T.Kp), rem = idx % ((Mp - M) * T.Kp);
    planes[l * plane_bytes + (size_t)(M + rem / T.Kp) * T.AS + rem % T.Kp] = 0;
  }
}

// Forward 8-point stages + twist of the polys [0, npoly) of X [., N]
// (natural order), each (poly, jB) column in registers, into the limb
// planes: plane row poly * N1 + fa_s, column jB.
__device__ __forceinline__ void forward_stages(const uint32_t* X, int npoly, int8_t* planes,
                                               size_t plane_bytes, int pi, const Geo& T,
                                               const Tabs& tb, const TsConsts& C,
                                               const Consts& K) {
  const uint32_t p = K.p[pi];
  const int N2 = T.N2, N = N1 * N2, nl = C.nl[pi];
  for (int idx = threadIdx.x; idx < npoly * N2; idx += blockDim.x) {
    const int poly = idx >> T.logN2, jb = idx & (N2 - 1);
    uint32_t x[N1];
#pragma unroll
    for (int j = 0; j < N1; ++j) x[j] = X[(size_t)poly * N + j * N2 + jb];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int t = N1 >> (s + 1);
#pragma unroll
      for (int r = 0; r < N1; ++r) {
        if ((r % (2 * t)) < t) {
          const uint32_t u = x[r];
          const uint32_t w = mul_shoup(x[r + t], C.stw[pi][s][r], C.stw_sh[pi][s][r], p);
          x[r] = add_mod(u, w, p);
          x[r + t] = sub_mod(u, w, p);
        }
      }
    }
    const size_t tb0 = (size_t)pi * N;
#pragma unroll
    for (int fa = 0; fa < N1; ++fa) {
      const size_t ti = tb0 + fa * N2 + jb;
      const uint32_t v = mul_shoup(x[fa], __ldg(tb.tw + ti), __ldg(tb.tw_sh + ti), p);
      put_limbs(planes, plane_bytes, (size_t)(poly * N1 + fa) * T.AS + jb, v, p, nl);
    }
  }
}

// Rows [0, M) of X viewed as [M, N2] (residues) into the limb planes
__device__ __forceinline__ void rows_to_planes(const uint32_t* X, int M, int8_t* planes,
                                               size_t plane_bytes, int pi, const Geo& T,
                                               const TsConsts& C, const Consts& K) {
  const uint32_t p = K.p[pi];
  for (int idx = threadIdx.x; idx < M * T.N2; idx += blockDim.x) {
    const int m = idx >> T.logN2, k = idx & (T.N2 - 1);
    put_limbs(planes, plane_bytes, (size_t)m * T.AS + k, X[idx], p, C.nl[pi]);
  }
}

// out [M, N2] = (A @ W) mod p on the tensor cores: A given by its limb
// planes (rows padded to a multiple of 16, columns to Kp with zeros), W by
// this prime's B fragments. Each warp takes 16 x 8 output tiles in turn.
__device__ __forceinline__ void limb_product(const int8_t* planes, size_t plane_bytes, int M,
                                             const uint2* __restrict__ bfrag, uint32_t* out,
                                             int pi, const Geo& T, const TsConsts& C,
                                             const Consts& K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nl = C.nl[pi];
  const uint32_t p = K.p[pi];
  const unsigned long long mu = K.mu[pi];
  // |sum_s acc_s 256^s mod p| < 5 x 2^24 x 2^17 < 2^44 <= p x 2^31
  const long long off = (long long)p << 31;
  const int MT = (M + 15) >> 4;
  for (int tile = warp; tile < MT * T.NT; tile += nwarps) {
    const int mt = tile / T.NT, nt = tile % T.NT;
    int acc[NSHIFT][4];
#pragma unroll
    for (int s = 0; s < NSHIFT; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][e] = 0;
    for (int kk = 0; kk < T.KK; ++kk) {
#pragma unroll
      for (int la = 0; la < MAXL; ++la) {
        if (la >= nl) break;
        const int8_t* A = planes + la * plane_bytes + (size_t)(mt * 16) * T.AS + kk * 32 + t * 4;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(A + g * T.AS);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(A + (g + 8) * T.AS);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(A + g * T.AS + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(A + (g + 8) * T.AS + 16);
#pragma unroll
        for (int lw = 0; lw < MAXL; ++lw) {
          if (lw >= nl) break;
          const uint2 b = __ldg(bfrag + ((size_t)(lw * T.KK + kk) * T.NT + nt) * 32 + lane);
          mma_s8(acc[la + lw], a0, a1, a2, a3, b.x, b.y);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mt * 16 + g + (e >= 2 ? 8 : 0);
      const int col = nt * 8 + 2 * t + (e & 1);
      if (row < M) {
        long long v = off;
#pragma unroll
        for (int s = 0; s < NSHIFT; ++s) v += (long long)acc[s][e] * C.pow256[pi][s];
        out[(size_t)row * T.N2 + col] = reduce64((unsigned long long)v, p, mu);
      }
    }
  }
}

// Inverse twist + inverse 8-point stages of the polys [0, npoly) of X
// (four-step order, after the inverse N2-point product), each (poly, jB)
// column in registers; dst(poly) receives the natural-order residues.
template <class Dst>
__device__ __forceinline__ void inverse_stages(const uint32_t* X, int npoly, Dst dst, int pi,
                                               const Geo& T, const Tabs& tb,
                                               const TsConsts& C, const Consts& K) {
  const uint32_t p = K.p[pi];
  const int N2 = T.N2, N = N1 * N2;
  for (int idx = threadIdx.x; idx < npoly * N2; idx += blockDim.x) {
    const int poly = idx >> T.logN2, jb = idx & (N2 - 1);
    uint32_t x[N1];
    const size_t tb0 = (size_t)pi * N;
#pragma unroll
    for (int fa = 0; fa < N1; ++fa) {
      const size_t ti = tb0 + fa * N2 + jb;
      x[fa] = mul_shoup(X[(size_t)poly * N + fa * N2 + jb], __ldg(tb.twi + ti),
                        __ldg(tb.twi_sh + ti), p);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int t = 1 << s;
#pragma unroll
      for (int r = 0; r < N1; ++r) {
        if ((r % (2 * t)) < t) {
          const uint32_t u = x[r], w = x[r + t];
          x[r] = add_mod(u, w, p);
          x[r + t] = mul_shoup(sub_mod(u, w, p), C.istw[pi][s][r], C.istw_sh[pi][s][r], p);
        }
      }
    }
    uint32_t* d = dst(poly);
#pragma unroll
    for (int j = 0; j < N1; ++j) d[j * N2 + jb] = x[j];
  }
}

// where inverse_stages of a rotation puts poly gl * kp1 + c: R[gate][c][pi]
struct ResDst {
  uint32_t* res;
  int gate0, kp1, pi, N;
  __device__ __forceinline__ uint32_t* operator()(int poly) const {
    const int gl = poly / kp1, c = poly % kp1;
    return res + (((size_t)(gate0 + gl) * kp1 + c) * NP + pi) * N;
  }
};

#define ROTATE_TS_PARAMS                                                                   \
  const uint32_t *__restrict__ acc, const int *__restrict__ abar,                         \
      const uint32_t *__restrict__ bsk_j, int group, const uint32_t *__restrict__ pw,      \
      const int *__restrict__ ef4, uint32_t *__restrict__ res, Tabs tb, Geo T, Shape S,   \
      Consts K, TsConsts C, size_t plane_bytes

// One group of the rotation for GT gates and one prime (blockIdx.y).
// bsk_j: this group's slab [NP, 2^g-1, rows, k+1, N] in the four-step
// frequency order (ops/ts_pbs.py ts_server_key).
template <int GT, int GB, bool NARROW>
__global__ void __launch_bounds__(THREADS) rotate_group_ts(ROTATE_TS_PARAMS) {
  using AT = typename std::conditional<NARROW, uint32_t, unsigned long long>::type;
  constexpr int NV1 = (1 << GB) - 1;
  const int N = S.N, rows = S.rows, kp1 = S.kp1;
  const int pi = blockIdx.y, gate0 = blockIdx.x * GT;
  const int ng = min(GT, S.G - gate0);
  uint32_t* X = reinterpret_cast<uint32_t*>(smem_raw);  // [GT * rows, N]
  int8_t* planes = reinterpret_cast<int8_t*>(smem_raw + (size_t)GT * rows * N * sizeof(uint32_t));
  const int M = ng * rows * N1, Mp = (M + 15) & ~15;
  const uint32_t p = K.p[pi], mu32 = K.mu32[pi];
  const unsigned long long mu = K.mu[pi];
  auto reduce = [&](AT x) -> uint32_t {
    if constexpr (NARROW) return reduce32(x, p, mu32);
    else return reduce64(x, p, mu);
  };

  // 1-2. decomposition, forward 8-point stages, twist, limb planes
  for (int gl = 0; gl < ng; ++gl)
    decompose_rows(AccWords{acc}, X + (size_t)gl * rows * N, gate0 + gl, pi, S, K);
  zero_padding(planes, plane_bytes, M, Mp, C.nl[pi], T);
  __syncthreads();
  forward_stages(X, ng * rows, planes, plane_bytes, pi, T, tb, C, K);
  __syncthreads();
  // 3. the forward N2-point stage on the tensor cores -> X, four-step order
  limb_product(planes, plane_bytes, M, tb.bf + (size_t)pi * MAXL * T.KK * T.NT * 32, X, pi, T,
               C, K);
  __syncthreads();

  // 4. pointwise products; S_c of gate gl lands in row gl * kp1 + c (each
  //    thread owns its frequency column and has read all of it first)
  const uint32_t* bp = bsk_j + (size_t)pi * NV1 * rows * kp1 * N;
  const uint32_t* pwp = pw + pi * 2 * N;
  const int mask2n = 2 * N - 1;
  for (int f = threadIdx.x; f < N; f += blockDim.x) {
    const int e = __ldg(ef4 + f);
    uint32_t d[GT][GB];
#pragma unroll
    for (int gl = 0; gl < GT; ++gl) {
      const int* ag = abar + (size_t)min(gate0 + gl, S.G - 1) * S.n + group * GB;
#pragma unroll
      for (int i = 0; i < GB; ++i)  // NTT(X^a_i) - 1; psi^t >= 1 so no wrap
        d[gl][i] = __ldg(pwp + ((__ldg(ag + i) * e) & mask2n)) - 1u;
    }
    AT s[GT][MAX_KP1];
#pragma unroll
    for (int gl = 0; gl < GT; ++gl)
#pragma unroll
      for (int c = 0; c < MAX_KP1; ++c) s[gl][c] = 0;
#pragma unroll
    for (int v = 1; v <= NV1; ++v) {
      uint32_t P[GT];
      const int lo = __ffs(v) - 1;
#pragma unroll
      for (int gl = 0; gl < GT; ++gl) {
        P[gl] = d[gl][lo];
#pragma unroll
        for (int i = lo + 1; i < GB; ++i)
          if ((v >> i) & 1) P[gl] = reduce((AT)P[gl] * d[gl][i]);
      }
      AT tacc[GT][MAX_KP1];
#pragma unroll
      for (int gl = 0; gl < GT; ++gl)
#pragma unroll
        for (int c = 0; c < MAX_KP1; ++c) tacc[gl][c] = 0;
      for (int r = 0; r < rows; ++r) {
        uint32_t F[GT];
#pragma unroll
        for (int gl = 0; gl < GT; ++gl) F[gl] = gl < ng ? X[((size_t)gl * rows + r) * N + f] : 0u;
        const uint32_t* bv = bp + ((size_t)((v - 1) * rows + r) * kp1) * N + f;
#pragma unroll
        for (int c = 0; c < MAX_KP1; ++c) {
          if (c < kp1) {
            const uint32_t b = __ldg(bv + (size_t)c * N);  // once for the tile's gates
#pragma unroll
            for (int gl = 0; gl < GT; ++gl) tacc[gl][c] += (AT)F[gl] * b;
          }
        }
      }
#pragma unroll
      for (int gl = 0; gl < GT; ++gl)
#pragma unroll
        for (int c = 0; c < MAX_KP1; ++c)
          if (c < kp1) s[gl][c] += (AT)P[gl] * reduce(tacc[gl][c]);
    }
#pragma unroll
    for (int gl = 0; gl < GT; ++gl)
#pragma unroll
      for (int c = 0; c < MAX_KP1; ++c)
        if (gl < ng && c < kp1) X[((size_t)gl * kp1 + c) * N + f] = reduce(s[gl][c]);
  }
  __syncthreads();

  // 5. inverse N2-point stage on the tensor cores, inverse twist and
  //    8-point stages -> R
  const int M2 = ng * kp1 * N1, Mp2 = (M2 + 15) & ~15;
  zero_padding(planes, plane_bytes, M2, Mp2, C.nl[pi], T);
  rows_to_planes(X, M2, planes, plane_bytes, pi, T, C, K);
  __syncthreads();
  limb_product(planes, plane_bytes, M2, tb.bi + (size_t)pi * MAXL * T.KK * T.NT * 32, X, pi, T,
               C, K);
  __syncthreads();
  inverse_stages(X, ng * kp1, ResDst{res, gate0, kp1, pi, N}, pi, T, tb, C, K);
}

// acc += Garner(R): one thread per (gate, component, coefficient)
__global__ void crt_accumulate(uint32_t* __restrict__ acc, const uint32_t* __restrict__ res,
                               Shape S, Consts K) {
  const size_t total = (size_t)S.G * S.kp1 * S.N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t gc = idx >> S.logN, coef = idx & (S.N - 1);
    const uint32_t* r = res + gc * NP * S.N + coef;
    acc[idx] += garner(r[0], r[S.N], r[2 * S.N], r[3 * S.N], K);
  }
}

// The four-step transforms alone, for checking them on the card: rows
// [R, NP, N] of residues; block (row, prime). fwd: out = NTT, four-step
// order; with inverse set, out = INTT of the input (four-step order in,
// natural order out).
__global__ void __launch_bounds__(THREADS) four_step_rows(const uint32_t* __restrict__ in,
                                                          uint32_t* __restrict__ out, int inverse,
                                                          Tabs tb, Geo T, Consts K, TsConsts C,
                                                          size_t plane_bytes) {
  const int row = blockIdx.x, pi = blockIdx.y;
  const int N = N1 * T.N2;
  uint32_t* X = reinterpret_cast<uint32_t*>(smem_raw);  // [N]
  int8_t* planes = reinterpret_cast<int8_t*>(smem_raw + (size_t)N * sizeof(uint32_t));
  const uint32_t* src = in + ((size_t)row * NP + pi) * N;
  uint32_t* dst = out + ((size_t)row * NP + pi) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) X[i] = src[i];
  zero_padding(planes, plane_bytes, N1, 16, C.nl[pi], T);
  __syncthreads();
  const size_t fo = (size_t)pi * MAXL * T.KK * T.NT * 32;
  if (!inverse) {
    forward_stages(X, 1, planes, plane_bytes, pi, T, tb, C, K);
    __syncthreads();
    limb_product(planes, plane_bytes, N1, tb.bf + fo, X, pi, T, C, K);
    __syncthreads();
    for (int i = threadIdx.x; i < N; i += blockDim.x) dst[i] = X[i];
  } else {
    rows_to_planes(X, N1, planes, plane_bytes, pi, T, C, K);
    __syncthreads();
    limb_product(planes, plane_bytes, N1, tb.bi + fo, X, pi, T, C, K);
    __syncthreads();
    inverse_stages(X, 1, [dst](int) { return dst; }, pi, T, tb, C, K);
  }
}

// Host helpers

bool make_geo(Geo& T, int N) {
  if (N % N1 != 0) return false;
  T.N2 = N / N1;
  T.logN2 = 0;
  while ((1 << T.logN2) < T.N2) ++T.logN2;
  if ((1 << T.logN2) != T.N2 || T.N2 < 8) return false;
  T.Kp = (T.N2 + 31) & ~31;
  T.AS = T.Kp + 16;
  T.KK = T.Kp / 32;
  T.NT = T.N2 / 8;
  return true;
}

// ts_consts (host): stw, stw_sh, istw, istw_sh (NP x 3 x N1 words each),
// nl[NP], pow256[NP][NSHIFT]. False unless every nl is 2 or 3.
bool load_ts_consts(TsConsts& C, const uint32_t* src) {
  const int blk = NP * 3 * N1;
  for (int i = 0; i < blk; ++i) {
    (&C.stw[0][0][0])[i] = src[i];
    (&C.stw_sh[0][0][0])[i] = src[blk + i];
    (&C.istw[0][0][0])[i] = src[2 * blk + i];
    (&C.istw_sh[0][0][0])[i] = src[3 * blk + i];
  }
  for (int pi = 0; pi < NP; ++pi) {
    C.nl[pi] = (int)src[4 * blk + pi];
    if (C.nl[pi] < 2 || C.nl[pi] > MAXL) return false;
    for (int s = 0; s < NSHIFT; ++s) C.pow256[pi][s] = src[4 * blk + NP + pi * NSHIFT + s];
  }
  return true;
}

int max_limbs(const TsConsts& C) {
  int m = 0;
  for (int pi = 0; pi < NP; ++pi) m = C.nl[pi] > m ? C.nl[pi] : m;
  return m;
}

size_t plane_bytes_for(int M, const Geo& T) { return (size_t)((M + 15) & ~15) * T.AS; }

size_t smem_for(int GT, const Shape& S, const Geo& T, int nlmax) {
  return (size_t)GT * S.rows * S.N * sizeof(uint32_t) +
         nlmax * plane_bytes_for(GT * S.rows * N1, T);
}

struct Args {
  uint32_t* acc;
  const int* abar;
  const uint32_t *bsk, *pw;
  const int* ef4;
  uint32_t* res;
};

template <int GT, int GB, bool NARROW>
cudaError_t rotate(const Shape& S, const Geo& T, const Consts& K, const TsConsts& C,
                   const Tabs& tb, const Args& a, int nlmax, cudaStream_t st) {
  const size_t pb = plane_bytes_for(GT * S.rows * N1, T);
  const size_t smem = smem_for(GT, S, T, nlmax);
  auto kern = rotate_group_ts<GT, GB, NARROW>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int nv1 = (1 << GB) - 1;
  const size_t slab = (size_t)NP * nv1 * S.rows * S.kp1 * S.N;
  const dim3 grid((S.G + GT - 1) / GT, NP);
  const size_t total = (size_t)S.G * S.kp1 * S.N;
  const int cblocks = (int)((total + THREADS - 1) / THREADS < 4096 ? (total + THREADS - 1) / THREADS : 4096);
  for (int j = 0; j < S.n / GB; ++j) {
    kern<<<grid, THREADS, smem, st>>>(a.acc, a.abar, a.bsk + slab * j, j, a.pw, a.ef4, a.res, tb, T,
                                      S, K, C, pb);
    crt_accumulate<<<cblocks, THREADS, 0, st>>>(a.acc, a.res, S, K);
    if (j == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

using Rotate = cudaError_t (*)(const Shape&, const Geo&, const Consts&, const TsConsts&,
                               const Tabs&, const Args&, int, cudaStream_t);

// grouping 2 or 4: every multi-bit set of params.py (each variant is
// built for three tile widths and two accumulator widths)
template <int GT, bool NARROW>
Rotate pick_g(int g) {
  return g == 2 ? rotate<GT, 2, NARROW> : rotate<GT, 4, NARROW>;
}

}  // namespace

// consts (host, 26 words): see load_consts in pbs_common.cuh. ts_consts:
// see load_ts_consts. acc: u32 [G, k+1, N], in/out. abar: i32 [G, n] in
// [0, 2N). bsk: u32 [n/g, NP, 2^g-1, rows, k+1, N], four-step frequency
// order (ops/ts_pbs.py ts_server_key). bfwd / binv: the N2-point matrices'
// limbs as mma B fragments [NP, 3, Kp/32, N2/8, 32, 8] bytes. tw*, twi*:
// u32 [NP, N1, N2]. pw: u32 [NP, 2N]. ef4: i32 [N], 2*bitrev(f)+1 at
// four-step position f. res: u32 [G, k+1, NP, N] scratch. Returns a
// cudaError_t.
extern "C" int helm_blind_rotate_ts(void* acc, const void* abar, const void* bsk,
                                    const void* bfwd, const void* binv, const void* tw,
                                    const void* tw_sh, const void* twi, const void* twi_sh,
                                    const void* pw, const void* ef4, void* res,
                                    const uint32_t* consts, const uint32_t* ts_consts, int G,
                                    int n, int N, int k, int g, int mask_bl, int mask_lv, int bl,
                                    int lv, void* stream) {
  Shape S;
  Consts K;
  TsConsts C;
  Geo T;
  if (!make_shape(S, G, n, N, k, g, mask_bl, mask_lv, bl, lv) || (g != 2 && g != 4) || n % g != 0 ||
      S.kp1 > MAX_KP1 || !load_consts(K, consts) || !load_ts_consts(C, ts_consts) ||
      !make_geo(T, N))
    return (int)cudaErrorInvalidValue;
  const bool narrow = fits_u32(K, S.rows) && fits_u32(K, (1 << g) - 1);
  const int nlmax = max_limbs(C);
  // gates per block: 4, 2 or 1, the most that fit in shared memory while
  // the grid still holds two blocks per SM
  int GT = 4;
  while (GT > 1 && (smem_for(GT, S, T, nlmax) > 200 * 1024 ||
                    (size_t)((G + GT - 1) / GT) * NP < 2 * 132))
    GT >>= 1;
  if (smem_for(GT, S, T, nlmax) > 227 * 1024) return (int)cudaErrorInvalidValue;
  const Tabs tb{(const uint2*)bfwd, (const uint2*)binv, (const uint32_t*)tw,
                (const uint32_t*)tw_sh, (const uint32_t*)twi, (const uint32_t*)twi_sh};
  const Args a{(uint32_t*)acc, (const int*)abar, (const uint32_t*)bsk, (const uint32_t*)pw,
               (const int*)ef4, (uint32_t*)res};
  Rotate fn;
  if (GT == 4) fn = narrow ? pick_g<4, true>(g) : pick_g<4, false>(g);
  else if (GT == 2) fn = narrow ? pick_g<2, true>(g) : pick_g<2, false>(g);
  else fn = narrow ? pick_g<1, true>(g) : pick_g<1, false>(g);
  return (int)fn(S, T, K, C, tb, a, nlmax, (cudaStream_t)stream);
}

// The four-step transforms of rows [R, NP, N] (see four_step_rows), for
// checking them on the card against fhe/ntt.py. Returns a cudaError_t.
extern "C" int helm_ts_four_step(const void* in, void* out, int inverse, int R, int N,
                                 const void* bfwd, const void* binv, const void* tw,
                                 const void* tw_sh, const void* twi, const void* twi_sh,
                                 const uint32_t* consts, const uint32_t* ts_consts, void* stream) {
  Consts K;
  TsConsts C;
  Geo T;
  if (R < 1 || !load_consts(K, consts) || !load_ts_consts(C, ts_consts) || !make_geo(T, N))
    return (int)cudaErrorInvalidValue;
  const Tabs tb{(const uint2*)bfwd, (const uint2*)binv, (const uint32_t*)tw,
                (const uint32_t*)tw_sh, (const uint32_t*)twi, (const uint32_t*)twi_sh};
  const size_t pb = plane_bytes_for(N1, T);
  const size_t smem = (size_t)N * sizeof(uint32_t) + max_limbs(C) * pb;
  cudaError_t e =
      cudaFuncSetAttribute(four_step_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  four_step_rows<<<dim3(R, NP), THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, inverse, tb, T, K, C, pb);
  return (int)cudaGetLastError();
}
