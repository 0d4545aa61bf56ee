// Transposed multi-bit blind rotation for Hopper (sm_90a), plain C
// interface: K4 of the port.
//
// Replaces the TPU kernel helm_tpu/ops/ts_pbs.py::blind_rotate_ts_mb
// (:643; Pallas body _make_kernel_ts_mb :353, call :710; BSK layout
// mxu_server_key_ts). Computes the same function as K1 (blind_rotate_mb.cu)
// and as helm_tpu_torch/fhe/pbs.py::blind_rotate_transposed, word for word:
// for each of the n/g groups of mask elements, the additive-identity CMux
//     acc += INTT( sum_r NTT(dec(acc))_r (.) sum_v P_v (.) BSK_v )
// with P_v = prod_{i in v} (X^{a_i} - 1), over the 4 CRT primes, then
// Garner back to u32. What sets K4 apart is its transform: the four-step
// NTT of helm_tpu/ops/mxu_ntt.py (N = N1 x N2, N1 = 8), whose N2-point
// stage is a dense product with the gates' polynomials along the rows. On
// the TPU that product is bf16 limbs on the MXU; here it runs on the int8
// tensor cores.
//
// Design. K1's body, rotate_tiles (rotate_tiles.cuh, which describes the
// design), with the FourStepTC transform: one launch per rotation, a
// cluster of 4 blocks (one per prime) per tile of gates, every group inside
// the launch with the accumulators, gadget rows and products in shared
// memory, the BSK streamed once per tile through the cp.async.bulk ring
// from K1's chunked layout in the four-step frequency order (ops/ts_pbs.py
// ts_server_key). Per step the forward transform is the first register
// pass (the 8-point stages), the twist and the split into signed 8-bit
// limb planes, then the N2-point product on the tensor cores
// (mma.sync.m16n8k32 s8 x s8 -> s32) against the matrix's two limbs; the
// products go straight to limb planes, and the inverse is the product
// against the inverse matrix, the inverse twist and the 8-point inverse
// stages. The TPU kernel's two launches per group (a rotation step and a
// CRT recombination through a residue array in device memory) are gone:
// Garner runs in the body's epilogue.
//
// Limbs. Every product is exact: limbs are in [-128, 127], so a limb
// product is at most 2^14, a sum over N2 <= 256 terms below 2^22, and a
// shift's sum of at most two limb pairs below 2^23 in s32. The matrices
// take two limbs at every prime: p = 65537 balances to +-32768, which two
// signed limbs cannot hold, so its matrices are scaled by c = 3 into the
// two-limb window (fhe/ntt.py window_tables) and c^-1 is folded into the
// recombination constants; its data keep three limbs (six limb products
// where the other primes take four).
//
// What bounds it is what bounds K1 (rotate_tiles.cuh): integer throughput,
// here of the products, the limb splits, the fragment loads from shared
// memory and the recombinations. At N = 2048 the limb matrices (128 KB a
// direction and prime) do not fit beside the tile, so each block reads
// them from L2 every step, and the planes leave room for one gate a tile.
//
// Every entry point returns the first launch error or cudaGetLastError();
// nothing is allocated here and nothing synchronises.

#include "rotate_tiles.cuh"

namespace {

// The build of rotate_tiles with the four-step transform for a shape, or
// nullptr when there is none: K1's builds (ops/mb_pbs.py K4_BUILDS)
template <int GB, int ROWS>
Kernel<Garner, FourStepTC> build_of(bool narrow) {
  return narrow ? rotate_tiles<GB, ROWS, true, AccQuarter, Garner, FourStepTC, Lookup, FourStepTC>
                : rotate_tiles<GB, ROWS, false, AccQuarter, Garner, FourStepTC, Lookup, FourStepTC>;
}

Kernel<Garner, FourStepTC> select_kernel(const Shape& S, bool narrow) {
  if (S.g == 2 && S.rows == 4) return build_of<2, 4>(narrow);
  if (S.g == 2 && S.rows == 6) return build_of<2, 6>(narrow);
  if (S.g == 2 && S.rows == 8) return build_of<2, 8>(narrow);
  if (S.g == 2 && S.rows == 9) return build_of<2, 9>(narrow);
  if (S.g == 4 && S.rows == 4 && !narrow)
    return rotate_tiles<4, 4, false, AccQuarter, Garner, FourStepTC, Lookup, FourStepTC>;
  return nullptr;
}

// FourStepTC's tables and constants (device pointers; ts_consts: per
// prime, the data's limb count, then the forward and the inverse
// recombination constants 256^s c^-1 mod p, s < 4, ops/ts_pbs.py
// transform_tables)
FourStepTC make_xf(const void* bfwd, const void* binv, const void* stw, const void* ef4,
                   const void* ts_consts) {
  return FourStepTC{(const uint2*)bfwd, (const uint2*)binv, (const uint2*)stw, (const int*)ef4,
                    (const uint32_t*)ts_consts, 0, 0};
}

// The four-step transforms alone, for checking them on the card: rows
// [R, NP, N] of residues; block (row, prime), the rotation's device
// functions on one polynomial (8 rows of the product, the matrices read
// from L2, no swizzle). Forward: out = NTT, four-step order; inverse: out =
// INTT of the input (four-step order in, natural order out, N^-1 scaled).
__global__ void __launch_bounds__(TPB, 1) four_step_rows(const uint32_t* __restrict__ in,
                                                       uint32_t* __restrict__ out, int inverse,
                                                       Shape S, Consts K, FourStepTC X,
                                                       const uint2* __restrict__ twf,
                                                       const uint2* __restrict__ twi) {
  const int pi = blockIdx.y, tid = threadIdx.x;
  const int N = S.N, N8 = N >> 3;
  const uint32_t p = K.p[pi];
  const int nl = (int)__ldg(X.consts + pi * 9);
  const TcGeo T(S, 1);  // S.rows = 1: one polynomial
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_raw);  // [N]
  uint8_t* zero = smem_raw + (size_t)N * 4;             // an identity swizzle
  uint2* stw = reinterpret_cast<uint2*>(smem_raw + (size_t)N * 4 + up(N, 16));
  int8_t* planes = reinterpret_cast<int8_t*>(stw + 16);
  const RowSwizzle sw{zero, S.logN};
  const uint32_t* src = in + ((size_t)blockIdx.x * NP + pi) * N;
  uint32_t* dst = out + ((size_t)blockIdx.x * NP + pi) * N;
  for (int i = tid; i < N; i += TPB) zero[i] = 0;
  if (tid < 16) stw[tid] = X.stw[pi * 16 + tid];
  const int pad = T.AS - 16 - T.N2, cells = T.Mp * pad;
  for (int i = tid; i < X.nlmax * cells; i += TPB) {
    const int l = i / cells, r = i - l * cells;
    planes[l * T.plane + (size_t)(r / pad) * T.AS + T.N2 + r % pad] = 0;
  }
  __syncthreads();
  uint32_t rc[4];
  for (int s = 0; s < 4; ++s) rc[s] = __ldg(X.consts + pi * 9 + (inverse ? 5 : 1) + s);
  if (!inverse) {
    for (int jj = tid; jj < N8; jj += TPB) {
      uint32_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = src[jj + k * N8];
      tc_fwd_column(v, stw, twf + (size_t)pi * N, jj, T, planes, p, nl);
    }
    __syncthreads();
    tc_product<8, 3>(planes, T, 8, nl, X.bf + pi * T.mat / 8, rc, p, K.mu[pi], x, sw);
    __syncthreads();
    for (int i = tid; i < N; i += TPB) dst[i] = x[i];
  } else {
    for (int i = tid; i < N; i += TPB)
      put_limbs(planes + (size_t)(i >> T.logN2) * T.AS + (i & (T.N2 - 1)), T.plane, src[i], p, nl);
    __syncthreads();
    tc_product<8, 3>(planes, T, 8, nl, X.bi + pi * T.mat / 8, rc, p, K.mu[pi], x, sw);
    __syncthreads();
    for (int jj = tid; jj < N8; jj += TPB) {
      uint32_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = x[jj + k * N8];
      tc_inv_column(v, stw, twi + (size_t)pi * N, jj, T, p);
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[jj + k * N8] = v[k];
    }
  }
}

}  // namespace

// Arguments as helm_blind_rotate_mb's (blind_rotate_mb.cu: the tile and
// chunk), with K4's own: bsk is K1's chunked layout in the four-step
// frequency order; twf, twi: the twists as u32 pairs [NP, N, 2] (fA_s N2 +
// jB); pw: u32 [NP, 2N]; bfwd, binv: the matrices' window limbs as mma B
// fragments [NP, 2, Kp/32, N2/8, 32, 8] bytes; stw: u32 pairs [NP, 16, 2],
// the 8-point stages' twiddles (forward at 1..7, inverse at 9..15); ef4:
// i32 [N]; ts_consts: u32 [NP, 9] (see make_xf). One launch. Returns a
// cudaError_t.
extern "C" int helm_blind_rotate_ts(
    void* acc, const void* abar, const void* bsk, const void* twf, const void* twi,
    const void* pw, const void* swz, const uint32_t* consts, const void* bfwd, const void* binv,
    const void* stw, const void* ef4, const void* ts_consts, int G, int n, int N, int k, int g,
    int mask_bl, int mask_lv, int bl, int lv, int gt, int cf, int elt, void* stream) {
  Shape S;
  Consts K;
  Plan L;
  FourStepTC X = make_xf(bfwd, binv, stw, ef4, ts_consts);
  Kernel<Garner, FourStepTC> kern;
  size_t smem;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, G, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt, &X.staged, &X.nlmax))
    return (int)cudaErrorInvalidValue;
  const Args args{(uint32_t*)acc,       (const int*)abar,     bsk,
                  (const uint2*)twf,    (const uint2*)twi,    (const uint32_t*)pw,
                  (const uint8_t*)swz};
  return launch_tiles(kern, smem, args, S, K, L, Garner{}, stream, X);
}

// The clusters of K4 the card holds at once for tiles of gt gates, and its
// dynamic shared memory: as helm_blind_rotate_mb_clusters.
extern "C" int helm_blind_rotate_ts_clusters(const uint32_t* consts, int n, int N, int k, int g,
                                             int mask_bl, int mask_lv, int bl, int lv, int gt,
                                             int cf, int elt, int* clusters, int* smem_bytes) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<Garner, FourStepTC> kern;
  size_t smem;
  int staged, nlmax;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, gt, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt, &staged, &nlmax))
    return (int)cudaErrorInvalidValue;
  return active_clusters(kern, smem, clusters, smem_bytes);
}

// The four-step transforms of rows [R, NP, N] (see four_step_rows), for
// checking them on the card against fhe/ntt.py. Returns a cudaError_t.
extern "C" int helm_ts_four_step(const void* in, void* out, int inverse, int R, int N,
                                 const void* bfwd, const void* binv, const void* twf,
                                 const void* twi, const void* stw, const uint32_t* consts,
                                 const void* ts_consts, void* stream) {
  Shape S;
  Consts K;
  FourStepTC X = make_xf(bfwd, binv, stw, nullptr, ts_consts);
  if (R < 1 || !make_shape(S, 1, 1, N, 1, 1, 1, 1, 1, 1) || !load_consts(K, consts))
    return (int)cudaErrorInvalidValue;
  S.rows = 1;
  X.nlmax = limb_count(K.p[NP - 1]);
  const TcGeo T(S, 1);
  const size_t smem = (size_t)N * 4 + up(N, 16) + 16 * 8 + X.nlmax * T.plane;
  cudaError_t e =
      cudaFuncSetAttribute(four_step_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  four_step_rows<<<dim3(R, NP), TPB, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, inverse, S, K, X, (const uint2*)twf, (const uint2*)twi);
  return (int)cudaGetLastError();
}
