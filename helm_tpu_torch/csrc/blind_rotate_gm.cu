// Gate-major multi-bit blind rotation for Hopper (sm_90a), plain C
// interface: K3 of the port.
//
// Replaces the TPU kernel helm_tpu/ops/mxu_pbs.py::blind_rotate_mxu_mb
// (:1811; Pallas body _make_kernel_mb :567, call :1888; BSK layout
// mxu_server_key and its Shoup companion). Computes the same function as
// K1 (blind_rotate_mb.cu) and as
// helm_tpu_torch/fhe/pbs.py::blind_rotate_ladder, word for word: for each
// of the n/g groups of mask elements, the additive-identity CMux
//     acc += INTT( sum_v P_v (.) sum_r NTT(dec(acc))_r (.) BSK_v[r] )
// with P_v = prod_{i in v} (NTT(X^{a_i}) - 1), over the 4 CRT primes, then
// Garner back to u32. What sets K3 apart is how it builds NTT(X^a): the bit
// ladder over the tables T[b] = NTT(X^(2^b)) (pbs.monomial_tables), one
// Shoup product per set bit of a, where K1 looks psi^(a e_f) up in a power
// table.
//
// Design. K1's body, rotate_tiles (rotate_tiles.cuh, which describes the
// design), with the Ladder monomial source. The TPU kernel's gate-major
// step, every prime of a tile in one grid step, is the body's cluster: its
// four blocks hold the four primes of a tile of gates, and the epilogue
// reads them through distributed shared memory. One launch per rotation,
// every group inside the launch with the accumulators, gadget rows and
// products in shared memory, the BSK streamed once per tile through the
// cp.async.bulk ring from K1's own chunked layout (mb_server_key(dsk).
// bsk_k1: no copy of K3's own). The TPU kernel's Shoup products against
// the BSK and its companion were its way to the same exact words; here
// the products are K1's Barrett-reduced sums, and the companion (a second
// BSK-sized array) is not kept. T and its companion are read through the
// read-only path (40 KB a prime at N = 512, 192 KB at N = 2048), not
// staged. Each step's monomials NTT(X^a_i) - 1 of the tile (g per gate)
// are built by the ladder once per frequency, before the forward passes,
// into [gt, g, N] u16 in shared memory, where the products read them as
// K1 reads its power table: K3's layout is K1's plus those 2 g N bytes a
// gate, and its code is K1's but for the monomials.
//
// What bounds it is what bounds K1, plus the ladder: log2(2N) / 2 Shoup
// products on average per monomial, g N monomials per gate and step.
//
// Every entry point returns the first launch error or cudaGetLastError();
// nothing is allocated here and nothing synchronises.

#include "rotate_tiles.cuh"

namespace {

// The build of rotate_tiles with the bit ladder for a shape, or nullptr
// when there is none: K1's builds (ops/mb_pbs.py K3_BUILDS)
template <int GB, int ROWS>
Kernel<Garner, Ladder> build_of(bool narrow) {
  return narrow ? rotate_tiles<GB, ROWS, true, AccQuarter, Garner, RegisterPasses, Ladder, Ladder>
                : rotate_tiles<GB, ROWS, false, AccQuarter, Garner, RegisterPasses, Ladder, Ladder>;
}

Kernel<Garner, Ladder> select_kernel(const Shape& S, bool narrow) {
  if (S.g == 2 && S.rows == 4) return build_of<2, 4>(narrow);
  if (S.g == 2 && S.rows == 6) return build_of<2, 6>(narrow);
  if (S.g == 2 && S.rows == 8) return build_of<2, 8>(narrow);
  if (S.g == 2 && S.rows == 9) return build_of<2, 9>(narrow);
  if (S.g == 4 && S.rows == 4 && !narrow)
    return rotate_tiles<4, 4, false, AccQuarter, Garner, RegisterPasses, Ladder, Ladder>;
  return nullptr;
}

}  // namespace

// Arguments as helm_blind_rotate_mb's (blind_rotate_mb.cu: K1's key
// layout, tile and chunk; pw is not read), and mono, mono_sh: u32
// [log2(2N), NP, N], the ladder's tables and their Shoup companions. One
// launch. Returns a cudaError_t.
extern "C" int helm_blind_rotate_gm(
    void* acc, const void* abar, const void* bsk, const void* twf, const void* twi,
    const void* pw, const void* swz, const uint32_t* consts, const void* mono, const void* mono_sh,
    int G, int n, int N, int k, int g, int mask_bl, int mask_lv, int bl, int lv, int gt, int cf,
    int elt, void* stream) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<Garner, Ladder> kern;
  size_t smem;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, G, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  const Args args{(uint32_t*)acc,       (const int*)abar,     bsk,
                  (const uint2*)twf,    (const uint2*)twi,    (const uint32_t*)pw,
                  (const uint8_t*)swz};
  const Ladder M{(const uint32_t*)mono, (const uint32_t*)mono_sh};
  return launch_tiles(kern, smem, args, S, K, L, Garner{}, stream, M);
}

// The clusters of K3 the card holds at once for tiles of gt gates, and its
// dynamic shared memory: as helm_blind_rotate_mb_clusters.
extern "C" int helm_blind_rotate_gm_clusters(const uint32_t* consts, int n, int N, int k, int g,
                                             int mask_bl, int mask_lv, int bl, int lv, int gt,
                                             int cf, int elt, int* clusters, int* smem_bytes) {
  Shape S;
  Consts K;
  Plan L;
  Kernel<Garner, Ladder> kern;
  size_t smem;
  if (!prepare<AccQuarter>(S, K, L, kern, smem, select_kernel, consts, gt, n, N,
                           k, g, mask_bl, mask_lv, bl, lv, gt, cf, elt))
    return (int)cudaErrorInvalidValue;
  return active_clusters(kern, smem, clusters, smem_bytes);
}
