// Multi-bit blind rotation for Hopper (sm_90a), plain C interface: K1 of
// the port.
//
// Replaces the TPU kernel helm_tpu/ops/mxu_pbs.py::blind_rotate_fs_mb
// (:2706; Pallas body _make_kernel_fs_mb :834, call :2795). Computes the
// same function as helm_tpu/fhe/pbs_jnp.py::blind_rotate_multibit and its
// torch twin helm_tpu_torch/fhe/pbs.py::blind_rotate_multibit, word for
// word: for each of the n/g groups of mask elements, the additive-identity
// CMux
//     acc += INTT( sum_r NTT(dec(acc))_r (.) sum_v P_v (.) BSK_v )
// with P_v = prod_{i in v} (X^{a_i} - 1), over the 4 CRT primes, then
// Garner back to u32. At g = 1 the one subset polynomial is P_1 = X^a - 1
// (the key from gen_bsk_multibit, [n, 1, rows, k+1, NP, N]): the TPU
// kernel takes that grouping too, and so does this file. The production
// route sends grouping-1 sets to K2 (blind_rotate_sb.cu), which decomposes
// the rotated difference X^a acc - acc instead: a blind rotation of the
// same input with other noise, so other words.
//
// Design. The TPU kernel walks the groups along a sequential grid axis
// with a tile of gates' accumulators in VMEM and reads each BSK slab once
// per tile. Here that loop runs inside the kernel: one launch per rotation
// of rotate_tiles (rotate_tiles.cuh, which describes the design and what
// bounds it) with the bare accumulator as its word source and Garner as
// its epilogue. The intermediates F and S (67 and 33.5 MB per step at
// GATES_128_K3, G = 1024, in the three-launch design this replaced) never
// reach device memory; each tile reads its group's BSK slab from L2 once
// per step (0.39 MB as u16 at GATES_128_K3).
//
// Every entry point returns the first launch error or cudaGetLastError();
// nothing is allocated here and nothing synchronises.

#include "rotate_tiles.cuh"

namespace {

// The build of rotate_tiles for a shape, or nullptr when there is none:
// grouping 2 with 4, 6, 8 or 9 gadget rows, grouping 4 with 4 (whose sums
// never fit u32) — every multi-bit set of params.py (no set has grouping
// 3) — and grouping 1 with 4, 6 or 8 rows: the grouping-1 sets and
// GATES_128_K3 at g = 1 (tools/g1_fs_test.py), and the g = 1 rows that
// tools/param_search.py picks (ops/mb_pbs.py K1_BUILDS)
template <int GB, int ROWS>
Kernel<Garner> build_of(bool narrow) {
  return narrow ? rotate_tiles<GB, ROWS, true, AccQuarter, Garner>
                : rotate_tiles<GB, ROWS, false, AccQuarter, Garner>;
}

Kernel<Garner> select_kernel(const Shape& S, bool narrow) {
  if (S.g == 1 && S.rows == 4) return build_of<1, 4>(narrow);
  if (S.g == 1 && S.rows == 6) return build_of<1, 6>(narrow);
  if (S.g == 1 && S.rows == 8) return build_of<1, 8>(narrow);
  if (S.g == 2 && S.rows == 4) return build_of<2, 4>(narrow);
  if (S.g == 2 && S.rows == 6) return build_of<2, 6>(narrow);
  if (S.g == 2 && S.rows == 8) return build_of<2, 8>(narrow);
  if (S.g == 2 && S.rows == 9) return build_of<2, 9>(narrow);
  if (S.g == 4 && S.rows == 4 && !narrow) return rotate_tiles<4, 4, false, AccQuarter, Garner>;
  return nullptr;
}

}  // namespace

// consts (host, 26 words): see load_consts in pbs_common.cuh.
// acc: u32 [G, k+1, N], in/out. abar: i32 [G, n] in [0, 2N).
// bsk: [n/g, NP, N/cf, 2^g-1, rows, k+1, cf], u16 when every sum of
// products fits u32 (fits_u32), else u32 (ops/mb_pbs.py tiled_bsk).
// twf, twi: u32 pairs [NP, N, 2] (twiddles_by_pass). pw: u32 [NP, 2N].
// swz: u8 [N] (bank_swizzle). gt: gates per tile, a power of two
// <= 8; cf: frequencies per BSK chunk, a power of two in [32, N]; elt: the
// bytes of one BSK word, checked against the shape's choice of u16 or u32.
// One launch. Returns a cudaError_t.
extern "C" int helm_blind_rotate_mb(
    void* acc, const void* abar, const void* bsk, const void* twf, const void* twi,
    const void* pw, const void* swz, const uint32_t* consts, int G, int n, int N, int k,
    int g, int mask_bl, int mask_lv, int bl, int lv, int gt, int cf, int elt, void* stream) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<Garner> kern;
  size_t smem;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, G, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  const Args args{(uint32_t*)acc,       (const int*)abar,     bsk,
                  (const uint2*)twf,    (const uint2*)twi,    (const uint32_t*)pw,
                  (const uint8_t*)swz};
  return launch_tiles(kern, smem, args, S, K, L, Garner{}, stream);
}

// The clusters of K1 the card holds at once for tiles of gt gates
// (cudaOccupancyMaxActiveClusters), into *clusters: the tile plan's
// wave size; and the dynamic shared memory of one block (SmemLayout),
// into *smem, for the host's plan to be held against. Arguments as
// helm_blind_rotate_mb's. Returns a cudaError_t.
extern "C" int helm_blind_rotate_mb_clusters(const uint32_t* consts, int n, int N, int k, int g,
                                             int mask_bl, int mask_lv, int bl, int lv, int gt,
                                             int cf, int elt, int* clusters, int* smem_bytes) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<Garner> kern;
  size_t smem;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, gt, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  return active_clusters(kern, smem, clusters, smem_bytes);
}
