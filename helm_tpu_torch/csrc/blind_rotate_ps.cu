// Prime-split multi-bit blind rotation for Hopper (sm_90a), plain C
// interface: K6 of the port.
//
// Replaces the TPU kernel helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_ps
// (:2425; Pallas body _make_kernel_fs_ps :2127, call :2526). Computes the
// same function as K1 (blind_rotate_mb.cu) and as
// helm_tpu_torch/fhe/pbs.py::blind_rotate_prime_split, word for word: for
// each of the n/g groups of mask elements, the additive-identity CMux
//     acc += INTT( sum_r NTT(dec(acc))_r (.) sum_v P_v (.) BSK_v )
// with P_v = prod_{i in v} (X^{a_i} - 1), each CRT prime's external
// product on its own, the primes then folded by CRT partial sums
// (fhe/ntt.py crt_fold) in place of Garner.
//
// Design. The TPU kernel puts the prime on the grid and folds the primes
// through running partial sums in scratch memory. Here the primes are the
// four blocks of a thread-block cluster: K1's body, rotate_tiles
// (rotate_tiles.cuh, which describes the design and what bounds it), with
// the bare accumulator as its word source and the CRT fold as its
// epilogue. One launch per rotation, a tile of gates per cluster, every
// group inside the launch, the intermediates in shared memory, the BSK
// streamed once per tile from K1's chunked layout (ops/mb_pbs.py
// tiled_bsk). Each block holds one prime's residues of the tile; after the
// inverse NTTs, block pi reads the four primes' residues of its quarter of
// the coefficients through distributed shared memory and folds them
// (rotate_tiles.cuh CrtFold, with the argument that its quotient is
// exact). The transforms, products and BSK bytes are K1's; the fold costs
// four double multiply-adds a coefficient where Garner takes a chain of
// Shoup products.
//
// What bounds it is what bounds K1 (rotate_tiles.cuh): the integer
// throughput of the products and butterflies at wide batches, the chain of
// one group's barriers at narrow ones. The TPU kernel's design (one
// launch per group, one gate per cluster, each block reading its prime's
// slab of the group's BSK from L2 once per gate, and a permuted copy of
// the BSK) is not carried over.
//
// Every entry point returns the first launch error or cudaGetLastError();
// nothing is allocated here and nothing synchronises.

#include "rotate_tiles.cuh"

namespace {

// The build of rotate_tiles with the CRT fold for a shape, or nullptr when
// there is none: K1's builds (ops/mb_pbs.py K1_BUILDS), grouping 2 with 4,
// 6, 8 or 9 gadget rows and grouping 4 with 4. No set of params.py has
// grouping 3, so it has no build (the wrapper refuses it)
template <int GB, int ROWS>
Kernel<CrtFold> build_of(bool narrow) {
  return narrow ? rotate_tiles<GB, ROWS, true, AccQuarter, CrtFold>
                : rotate_tiles<GB, ROWS, false, AccQuarter, CrtFold>;
}

Kernel<CrtFold> select_kernel(const Shape& S, bool narrow) {
  if (S.g == 2 && S.rows == 4) return build_of<2, 4>(narrow);
  if (S.g == 2 && S.rows == 6) return build_of<2, 6>(narrow);
  if (S.g == 2 && S.rows == 8) return build_of<2, 8>(narrow);
  if (S.g == 2 && S.rows == 9) return build_of<2, 9>(narrow);
  if (S.g == 4 && S.rows == 4 && !narrow) return rotate_tiles<4, 4, false, AccQuarter, CrtFold>;
  return nullptr;
}

}  // namespace

// Arguments as helm_blind_rotate_mb's (blind_rotate_mb.cu: K1's key
// layout, tile and chunk), and crt_w: u32 [4], crt_frac: f64 [4] (fhe/ntt.py
// crt_constants). One launch. Returns a cudaError_t.
extern "C" int helm_blind_rotate_ps(
    void* acc, const void* abar, const void* bsk, const void* twf, const void* twi,
    const void* pw, const void* swz, const uint32_t* consts, const uint32_t* crt_w,
    const double* crt_frac, int G, int n, int N, int k, int g, int mask_bl, int mask_lv, int bl,
    int lv, int gt, int cf, int elt, void* stream) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<CrtFold> kern;
  size_t smem;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, G, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  CrtFold E;
  for (int i = 0; i < NP; ++i) {
    E.w_mod[i] = crt_w[i];
    E.frac[i] = crt_frac[i];
  }
  const Args args{(uint32_t*)acc,       (const int*)abar,     bsk,
                  (const uint2*)twf,    (const uint2*)twi,    (const uint32_t*)pw,
                  (const uint8_t*)swz};
  return launch_tiles(kern, smem, args, S, K, L, E, stream);
}

// The clusters of K6 the card holds at once for tiles of gt gates, and
// its dynamic shared memory: as helm_blind_rotate_mb_clusters.
extern "C" int helm_blind_rotate_ps_clusters(const uint32_t* consts, int n, int N, int k, int g,
                                             int mask_bl, int mask_lv, int bl, int lv, int gt,
                                             int cf, int elt, int* clusters, int* smem_bytes) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<CrtFold> kern;
  size_t smem;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, gt, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  return active_clusters(kern, smem, clusters, smem_bytes);
}
