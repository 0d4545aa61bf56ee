// Single-bit blind rotation for Hopper (sm_90a), plain C interface: K2 of
// the port.
//
// Replaces both TPU kernels of the single-bit (grouping 1) blind rotation:
// helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu (K2a, :1652; Pallas body
// _make_kernel :399, call :1726) and helm_tpu/ops/pallas_pbs.py::
// blind_rotate_pallas (K2b, :339; body :246, call :401). Computes the same
// function as helm_tpu/fhe/pbs_jnp.py::blind_rotate and its torch twin
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
// Design. K1's body, rotate_tiles (rotate_tiles.cuh, which describes the
// design), at grouping 1 with the rotated difference as its word source:
// one launch per rotation, a cluster of 4 blocks (one per prime) per tile
// of gates, all n steps inside the launch with the accumulators, gadget
// rows and products in shared memory, the BSK streamed once per tile
// through the cp.async.bulk ring from K1's chunked layout (ops/mb_pbs.py
// tiled_bsk at g = 1). Each word of X^a acc - acc costs two reads of
// distributed shared memory (acc[(x - a) mod 2N] from whichever block owns
// it, and acc[x]) where K1 reads one; the products are one multiply-add
// per gadget row, reduced once, with no subset polynomial and no power
// table.
//
// What bounds it. Integer operations: per gate and step, (rows + k+1) x NP
// NTTs of N/2 log2 N butterflies and rows x (k+1) x NP x N multiply-adds,
// against a BSK slab every gate of the tile shares (67 MB per rotation at
// GATES_TPU). Narrow widths (a circuit level of 1-32 gates) are bound by
// the chain of one step's passes and barriers, n of them in a row: the
// three-launch design this replaced paid a chain of launches per step
// (1,536 launches per rotation at GATES_TPU), with F and S through device
// memory.
//
// Every entry point returns the first launch error or cudaGetLastError();
// nothing is allocated here and nothing synchronises.

#include "rotate_tiles.cuh"

namespace {

// The build of rotate_tiles at grouping 1 for a shape, or nullptr when
// there is none: 4, 6 or 8 gadget rows, every grouping-1 set of params.py
// and the tiny k=3 one of the tests (ops/mb_pbs.py K2_BUILDS)
template <int ROWS>
Kernel<Garner> build_of(bool narrow) {
  return narrow ? rotate_tiles<1, ROWS, true, RotDiffQuarter, Garner>
                : rotate_tiles<1, ROWS, false, RotDiffQuarter, Garner>;
}

Kernel<Garner> select_kernel(const Shape& S, bool narrow) {
  if (S.g != 1) return nullptr;
  if (S.rows == 4) return build_of<4>(narrow);
  if (S.rows == 6) return build_of<6>(narrow);
  if (S.rows == 8) return build_of<8>(narrow);
  return nullptr;
}

}  // namespace

// Arguments as helm_blind_rotate_mb's (blind_rotate_mb.cu: K1's key
// layout at g = 1, tile and chunk); g must be 1, pw is not read. One
// launch. Returns a cudaError_t.
extern "C" int helm_blind_rotate_sb(
    void* acc, const void* abar, const void* bsk, const void* twf, const void* twi,
    const void* pw, const void* swz, const uint32_t* consts, int G, int n, int N, int k,
    int g, int mask_bl, int mask_lv, int bl, int lv, int gt, int cf, int elt, void* stream) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<Garner> kern;
  size_t smem;
  if (!prepare<RotDiffQuarter>(S, K, L, kern, smem, select_kernel, consts, G, n, N,
                               k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  const Args args{(uint32_t*)acc,       (const int*)abar,     bsk,
                  (const uint2*)twf,    (const uint2*)twi,    (const uint32_t*)pw,
                  (const uint8_t*)swz};
  return launch_tiles(kern, smem, args, S, K, L, Garner{}, stream);
}

// The clusters of K2 the card holds at once for tiles of gt gates, and
// its dynamic shared memory: as helm_blind_rotate_mb_clusters.
extern "C" int helm_blind_rotate_sb_clusters(const uint32_t* consts, int n, int N, int k, int g,
                                             int mask_bl, int mask_lv, int bl, int lv, int gt,
                                             int cf, int elt, int* clusters, int* smem_bytes) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<Garner> kern;
  size_t smem;
  if (!prepare<RotDiffQuarter>(S, K, L, kern, smem, select_kernel, consts, gt, n, N,
                               k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  return active_clusters(kern, smem, clusters, smem_bytes);
}
