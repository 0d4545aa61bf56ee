// The pointwise stage's candidate inner loops for Hopper (sm_90a), plain C
// interface: K10 of the port.
//
// Replaces the Pallas probe tools/ptw_probe.py:213 (run -> kernel_A :61,
// kernel_NOB :95, _kernel_T :126 as B at L = 64 and B2 at L = 128,
// kernel_C :160), and computes the same function as
// helm_tpu_torch/ops/probes.py ptw_plain, word for word. Every pattern
// carries an accumulator across `steps` steps, each step running `units`
// units; a unit is the fs pointwise stage of one (prime, tile) of a CMux
// step at GATES_128_K3: 8 gadget rows, 12 term groups, mod P = 18433 in
// balanced float32 (redfbt: t - floor(t/P + 1/2) P, folded into
// [-(P-1)/2, (P-1)/2]; split256: t = lo + 256 hi):
//   A    per group, sum_r lo_r * b and sum_r hi_r * b over the 8 rows, b
//        the group's BSK word of the element's frequency row (a broadcast
//        across the gates: staged in shared memory, one word for the whole
//        block)
//   NOB  A with constants in place of the BSK words (no operand load)
//   B    A transposed: gates in rows, frequencies in columns ([G, L]),
//        each thread's BSK word its own (consecutive lanes, consecutive
//        words of shared memory); B2 is the same at L = 128
//   C    the term groups as a contraction over the 8 rows x 64 frequencies:
//        per (unit, group), W diag(b) for W = w0 + 256 w1 in three bf16
//        limb matrices (s00, m1 = s01 + s10, s11), times the feedback's
//        two bf16 limbs, in six products with f32 accumulation, recombined
//        mod P
// Every product and every sum of products rounds once (__fmul_rn,
// __fadd_rn, never a fused multiply-add), in the plain version's order;
// the reductions mod P and the limb splits are exact on the integers they
// see (redfbt_c, redmod_c, split_c below), so the words are the plain
// version's.
//
// Design. A, NOB, B: each output element's recurrence is its own, so one
// thread holds one element across all steps (the TPU's sequential grid is
// a loop inside the thread), its 8 row limb pairs in registers; the BSK
// words do not change across steps or units, so A and B keep all 96 in
// registers (the compiler hoists them out of the loops: no shared-memory
// load in the loop, as NOB). Their reductions and splits run at the FP32
// rate (floorf runs at the conversion rate, and a unit needed 52). C: one
// persistent cooperative launch, a block per SM, that builds each step's
// limb matrices once for the card into a scratch buffer laid out as
// wgmma's shared-memory operands, then takes the products on wgmma with
// both operands in shared memory; its note is at ptw_c below.
//
// What bounds it. A, NOB, B: the FP32 instruction rate (every multiply and
// add its own instruction). C: its six products a (unit, group) are 6 x 64
// x 512 x G x 2 bf16 FLOPs (at G = 512, 4.83 GFLOP a step: 4.9 us on the
// tensor cores); the build (some 14M FP32 instructions a step for the
// card) runs beside them on warps of its own; the recombination mod P,
// the round trip of each step's sums through L2 and the grid barrier come
// on top.
//
// Every entry returns cudaGetLastError() or cudaErrorInvalidValue; nothing
// is allocated here and nothing synchronises.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace {

constexpr int ROWS = 8, NVC = 12, NT = ROWS * NVC;  // rows, term groups, terms
constexpr float P = 18433.0f, HP = 9216.0f;
constexpr float IP = 0x1.c7162p-15f;  // 1/18433 rounded to float32
constexpr int TPB = 128;              // A, NOB, B: threads a block
enum Pattern { PA = 0, PNOB = 1, PT = 2, PC = 3 };

// The reductions mod P and the limb split, without floorf (a
// conversion-rate instruction). Every input of a reduction is an exact
// integer below 2^24 in magnitude, and of a split one below 2^23 (A, NOB,
// B: the bounds at ptw_elem, where a split's input is at most 9217; C: at
// ptw_c), so
//   redfbt_c: t - q P with q = rint(t / P) (the magic-number rounding
//             M = 1.5 2^23), folded into [-(P-1)/2, (P-1)/2], is the unique
//             balanced residue of t mod P: the plain version's redfbt word
//             (t - floor(t/P + 1/2) P, folded);
//   split_c:  hi = floor(t / 256 + 1/2) = rint(t / 256 + 1/512) exactly (t /
//             256 + 1/2 is a multiple of 1/256, so the shifted value is
//             never a tie, and t / 256 + 1/512 fits float32's 24 bits for
//             |t| < 2^23), lo = t - 256 hi: the plain version's split256
//             words (t = lo + 256 hi).
// tests/test_torch_probes.py checks both identities over these domains and
// that the plain versions' values at the probe's inputs lie in them.
constexpr float MAGIC = 12582912.0f;
__device__ __forceinline__ float redfbt_c(float t) {
  const float q = __fsub_rn(__fadd_rn(__fmul_rn(t, IP), MAGIC), MAGIC);
  t = __fmaf_rn(-q, P, t);
  t = t > HP ? __fsub_rn(t, P) : t;
  return t < -HP ? __fadd_rn(t, P) : t;
}
// t - rint(t / P) P: congruent to t mod P and at most (P + 1) / 2 in
// magnitude, exact; enough for a value that only feeds another reduction
__device__ __forceinline__ float redmod_c(float t) {
  const float q = __fsub_rn(__fadd_rn(__fmul_rn(t, IP), MAGIC), MAGIC);
  return __fmaf_rn(-q, P, t);
}
__device__ __forceinline__ void split_c(float t, float& lo, float& hi) {
  hi = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(t, 0.00390625f), 0.001953125f), MAGIC), MAGIC);
  lo = __fmaf_rn(-256.0f, hi, t);
}

// A and NOB: out [N2, G], the block on 128 gates of frequency row n, the
// row's 96 BSK words in shared memory (A reads them four at a time, one
// float4 broadcast). B: out [G, L], L dividing 128, the whole slab [96, L]
// in shared memory.
//
// Why the words are the plain version's with the reductions above. Every
// value is an integer: the accumulator and base are balanced residues
// (|.| <= 9216); a row's split input base + k is at most 9216 + 8 units in
// magnitude before its reduction, and the split's input at most 9217
// after it, so |lo| <= 128 and |hi| <= 36; with |b| <= 9216 (NOB: <= 26)
// a group's sums are |slo| <= 8 x 128 x 9216 ~ 9.4M and |shi| <= 8 x 36 x
// 9216 ~ 2.7M, both below 2^24, so every product and partial sum is
// exact; t = red(slo) + 256 red(shi) is at most 9217 x 257 ~ 2.4M, and
// the unit's total (the first t, then 23 residues added) stays below 2.6M.
// A reduction whose result only feeds another one (base, the row's split
// input, the group's two sums and each t after the first) uses redmod_c:
// its result differs from the plain version's redfbt but is congruent to
// it mod P, and the step's accumulator, the one value that leaves the
// step, is redfbt_c of a total congruent to the plain version's total:
// the same balanced residue.
template <int PAT>
__global__ void __launch_bounds__(TPB) ptw_elem(const float* __restrict__ slab,
                                                float* __restrict__ out, int rows_out,
                                                int cols_out, int steps, int units) {
  extern __shared__ float4 s4[];
  float* s = reinterpret_cast<float*>(s4);
  int e, l = 0;
  if constexpr (PAT == PT) {
    const int L = cols_out;
    for (int i = threadIdx.x; i < NT * L; i += TPB) s[i] = slab[i];
    e = blockIdx.x * TPB + threadIdx.x;
    l = e % L;
  } else {
    const int n = blockIdx.y;
    if constexpr (PAT == PA)
      for (int i = threadIdx.x; i < NT; i += TPB) s[i] = slab[n * NT + i];
    e = n * cols_out + blockIdx.x * TPB + threadIdx.x;
  }
  __syncthreads();
  const bool live = PAT == PT ? e < rows_out * cols_out
                              : (int)(blockIdx.x * TPB + threadIdx.x) < cols_out;
  float acc = 0.0f;
  for (int j = 0; j < steps; ++j) {
    const float base = redmod_c(__fadd_rn(acc, 1.0f));
    float total = 0.0f;
    for (int u = 0; u < units; ++u) {
      float flo[ROWS], fhi[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        split_c(redmod_c(__fadd_rn(base, (float)(u * ROWS + r))), flo[r], fhi[r]);
#pragma unroll
      for (int vc = 0; vc < NVC; ++vc) {
        float b[ROWS];  // the group's BSK words (NOB: unused)
        if constexpr (PAT == PA) {
#pragma unroll
          for (int h = 0; h < ROWS / 4; ++h) {
            const float4 q = s4[vc * (ROWS / 4) + h];
            b[4 * h] = q.x, b[4 * h + 1] = q.y, b[4 * h + 2] = q.z, b[4 * h + 3] = q.w;
          }
        } else if constexpr (PAT == PT) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) b[r] = s[(vc * ROWS + r) * cols_out + l];
        }
        float slo, shi;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float blo, bhi;
          if constexpr (PAT == PNOB) {
            blo = 3.0f + (float)(r + vc);
            bhi = 5.0f + (float)(r + vc);
          } else {
            blo = bhi = b[r];
          }
          const float plo = __fmul_rn(flo[r], blo), phi = __fmul_rn(fhi[r], bhi);
          slo = r == 0 ? plo : __fadd_rn(slo, plo);
          shi = r == 0 ? phi : __fadd_rn(shi, phi);
        }
        const float t = __fadd_rn(redmod_c(slo), __fmul_rn(256.0f, redmod_c(shi)));
        total = (u == 0 && vc == 0) ? t : __fadd_rn(total, redmod_c(t));
      }
    }
    acc = redfbt_c(total);
  }
  if (live) out[e] = acc;
}

// -- C ---------------------------------------------------------------------
//
// One persistent cooperative launch: a block per SM of 512 threads, three
// consumer warpgroups (one per limb matrix) and a build warpgroup, the
// steps separated by grid barriers. A step is
//   items     work items (group, column block of CN gates, pass of two
//             units), dealt round-robin over the blocks (one each at G =
//             512 on 132 SMs): the consumers write the feedback X = [x0 |
//             x1] of the item's columns (bf16, [512 x 2 CN], from the last
//             step's sums, straight into wgmma's swizzled layout in shared
//             memory) while the build warpgroup's first warp streams the
//             group's three limb chunks [64 x 64] per 64 contraction rows
//             through a ring (cp.async.bulk on mbarriers); warpgroup l runs
//             wgmma m64n96k16 of limb matrix l against X, once per unit,
//             over the 512 contraction rows; the epilogue exchanges the
//             products through shared memory (each warpgroup recombines 8
//             of a thread's 24 elements: float4 groups of the
//             accumulator), recombines them mod P, sums the units and adds
//             t into the step's sums [64 x G] with cp.reduce.async.bulk;
//   build     meanwhile the build warpgroup's other three warps build
//             this block's share of the NEXT step's limb matrices (12
//             groups x 3 limbs, [64 x 512] bf16 each, 2.36 MB, once for
//             the card) into a scratch buffer in the layout wgmma reads
//             (128-byte rows of 64 contraction rows, 16-byte chunks
//             swizzled by row: swz), and zero their share of the sums two
//             steps ahead;
//   barrier   a grid barrier (grid_barrier; grid.sync before the first step).
// setmaxnreg gives the consumers 152 registers (96 accumulator words a
// thread) and the build warps 56. After the last step every block writes its
// share of the output.
//
// The work is the reference's. Every step builds its limb matrices anew
// (from w0, w1 and bcol, into the buffer of that step: two buffers, the
// next step's built while this one's are read); nothing of one step's
// build is read in another step. Within a step a group's build serves both
// units and every column block. Every (step, unit, group) takes its six
// products on the tensor cores: a unit's three wgmma per 16 contraction
// rows are issued even though the probe gives both units the same operands
// (with an odd unit count the last pass computes a second, unused unit).
// X's 8 chunks of 64 contraction rows are written out in full, though the
// probe's feedback repeats every 64 rows (a CMux's gadget rows differ).
//
// Why the words are the plain version's in any order of summation:
// every operand is an integer of at most 8 bits (|s00|, |s11|, |x0| <=
// 128, |x1| <= 36, |m1| <= 164) and every partial sum stays below 2^24:
// |lo| <= 512 x 128 x 128 ~ 8.4M, |mid| <= 512 (164 x 128 + 128 x 36) ~
// 13.1M, and the 24 t's of a step (each |t| <= 9216) sum to at most
// 221,184. So the tensor cores' f32 sums, the exchange of the products,
// and the bulk adds into the step's sums in whatever order the blocks
// reach them, are all exact; and every reduction mod P of C sees an exact
// integer below 2^24, whose balanced residue is unique (redfbt_c). A
// reduction whose result only feeds another one (the recombination's
// first three, the feedback's first) need not be balanced: redmod_c keeps
// it congruent mod P and small enough that the next sum stays exact.

constexpr int N2 = 64, RN = ROWS * N2;  // frequencies, contraction rows
constexpr int LIMBS = 3;                // s00, m1 = s01 + s10, s11
constexpr int CN = 48;                  // columns of gates a work item
constexpr int BN = 2 * CN;              // wgmma N: the item's x0 | x1
constexpr int KC = 64;                  // contraction rows a chunk (128 bytes of bf16)
constexpr int NKC = RN / KC;            // chunks
constexpr int ATILE = N2 * KC * 2;      // bytes of a limb matrix's chunk [64 x 64]
constexpr int BTILE = BN * KC * 2;      // bytes of the feedback's chunk [96 x 64]
constexpr int STAGES = 4;               // ring of limb chunks
constexpr int CTHREADS = LIMBS * 128;   // consumer warpgroups
constexpr int CTPB = CTHREADS + 128;    // and the build warpgroup (its first warp feeds the ring)
constexpr int BUILD_THREADS = 96;       // the build warpgroup's warps 1-3
constexpr int REGS_CONSUMER = 152, REGS_BUILD = 56;  // setmaxnreg: 384 x 152 + 128 x 56 = 65536
constexpr int ACC = BN / 2;             // accumulator words a thread a unit
constexpr int LIMB_BYTES = NVC * LIMBS * NKC * ATILE;  // a step's limb matrices
constexpr int SM_B = STAGES * LIMBS * ATILE;           // X; the exchange after the products
constexpr int SM_T = SM_B + NKC * BTILE;               // t of the item [64 x CN] f32
constexpr int SM_BAR = SM_T + N2 * CN * 4;
constexpr int SMEM_C = SM_BAR + 2 * STAGES * 8 + 1024;  // + alignment of the base to 1024
constexpr int BAR_BYTES = 256;  // the steps' barrier counter, after the sums
constexpr int PHASES = 5;  // clocks: feedback, products, epilogue, barrier (thread 0); build (the build warps')
static_assert(LIMBS * ACC * 128 * 4 <= NKC * BTILE, "the exchange fits in X's place");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk q of row `row` in a tile of 128-byte rows:
// the 128-byte swizzle of wgmma's shared-memory layout (chunk q ^ row % 8)
__device__ __forceinline__ uint32_t swz(int row, int q) {
  return row * 128 + ((q ^ (row & 7)) << 4);
}

// wgmma's shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A B for A [64 x 16] and B [16 x 96], both bf16 in shared memory
__device__ __forceinline__ void wgmma_m64n96(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async products
__device__ __forceinline__ void fence_acc(float (&d)[2][ACC]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[u][i])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CTHREADS) : "memory");
}
// generic-proxy writes before async-proxy reads (and back), in shared or global memory
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
// dst[0 .. bytes/4) += src[...] (f32), from shared to global memory
__device__ __forceinline__ void bulk_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

// Tasks t, t + nt, ... of this block's share of a step's limb matrices
// into `dst` (LIMB_BYTES): a task is (group vc, contraction rows 8 k8 ..
// +7, frequency m), three 16-byte chunks; block b owns tasks b x TB ..
// +TB, consecutive tasks on consecutive frequencies (the reads of w0 and
// w1 coalesce).
constexpr int TASKS = NVC * (RN / 8) * N2;
__device__ void build_limbs(const float* __restrict__ w0, const float* __restrict__ w1,
                            const float* __restrict__ bcol, uint8_t* __restrict__ dst, int t, int nt) {
  const int tb = (TASKS + gridDim.x - 1) / gridDim.x;
  const int end = min(TASKS, (int)(blockIdx.x + 1) * tb);
  for (int g = blockIdx.x * tb + t; g < end; g += nt) {
    const int m = g % N2, k8 = (g / N2) % (RN / 8), vc = g / (N2 * (RN / 8));
    uint32_t q00[4], qm1[4], q11[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float v00[2], vm1[2], v11[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k8 * 8 + h * 2 + e;
        const float b = __ldg(bcol + k * NVC + vc);
        float s01, s10;
        split_c(redfbt_c(__fmul_rn(__ldg(w0 + k * N2 + m), b)), v00[e], s01);
        split_c(redfbt_c(__fmul_rn(__ldg(w1 + k * N2 + m), b)), s10, v11[e]);
        vm1[e] = __fadd_rn(s01, s10);
      }
      q00[h] = pack_bf16(v00[0], v00[1]);
      qm1[h] = pack_bf16(vm1[0], vm1[1]);
      q11[h] = pack_bf16(v11[0], v11[1]);
    }
    uint8_t* tile = dst + (size_t)((vc * LIMBS) * NKC + k8 / 8) * ATILE + swz(m, k8 & 7);
    *reinterpret_cast<uint4*>(tile) = make_uint4(q00[0], q00[1], q00[2], q00[3]);
    *reinterpret_cast<uint4*>(tile + NKC * ATILE) = make_uint4(qm1[0], qm1[1], qm1[2], qm1[3]);
    *reinterpret_cast<uint4*>(tile + 2 * NKC * ATILE) = make_uint4(q11[0], q11[1], q11[2], q11[3]);
  }
}

// elements t, t + nt, ... of this block's share of a [N2, G] plane zeroed
__device__ void zero_share(float* __restrict__ plane, int n, int t, int nt) {
  const int per = (n + gridDim.x - 1) / gridDim.x;
  const int end = min(n, (int)(blockIdx.x + 1) * per);
  for (int i = blockIdx.x * per + t; i < end; i += nt) plane[i] = 0.0f;
}

// All CTPB threads of the block, on named barrier 2 with its thread count,
// as warp-specialised kernels sync their branches: the barrier counts whole
// warps as they arrive, wherever in the code they are. The invariant that
// makes it one barrier: every warp of the block, the build warpgroup's from
// its branch of the step loop and the consumers' from theirs, arrives
// exactly once a step, all 32 lanes together; neither branch may leave the
// loop early or arrive more often. (The non-aligned barrier.sync, which
// needs no such invariant, made ptxas spill and slowed the products.)
__device__ __forceinline__ void block_sync_all() {
  asm volatile("bar.sync 2, %0;" ::"n"(CTPB) : "memory");
}

// The steps' grid barrier, on a counter that starts at 0: each block's
// thread 0 arrives with a release add and polls with acquire loads until
// every block has arrived at barrier `round` (0, 1, ...): one round trip
// to L2 fewer than grid.sync's atomic add and poll.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned round) {
  block_sync_all();
  if (threadIdx.x == 0) {
    const unsigned target = (round + 1) * gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
    } while (v < target);
  }
  block_sync_all();
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The epilogue of one unit for warpgroup W (its limb): word r of a thread
// is element (row 16 (wt / 32) + (wt % 32) / 4 + 8 (r % 4 / 2), column 8
// (r / 4 % 6) + 2 (wt % 4) + r % 2) in every warpgroup, words 24 on the x1
// half. Warpgroup W owns the float4 groups j = W, W + 3 of the x0 half: it
// writes the other groups' words (both halves) for their owners, reads
// its own groups' words of the two other limbs, and recombines its 8
// elements mod P into tsum (summed over the units).
template <int W>
__device__ __forceinline__ void epilogue_unit(const float (&a)[ACC], float4* __restrict__ ex, int wt,
                                              float (&tsum)[8], bool first) {
  consumers_sync();  // the products (first unit) or the last unit's reads are done
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (j % 3 != W) {
      ex[(W * 12 + j) * 128 + wt] = make_float4(a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]);
      ex[(W * 12 + j + 6) * 128 + wt] =
          make_float4(a[24 + 4 * j], a[24 + 4 * j + 1], a[24 + 4 * j + 2], a[24 + 4 * j + 3]);
    }
  }
  consumers_sync();
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int j = W + 3 * g;
    float v[LIMBS][2][4];  // [limb][half][element]
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (l == W) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[l][h][e] = a[24 * h + 4 * j + e];
        } else {
          const float4 f = ex[(l * 12 + j + 6 * h) * 128 + wt];
          v[l][h][0] = f.x, v[l][h][1] = f.y, v[l][h][2] = f.z, v[l][h][3] = f.w;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = v[0][0][e], s00x1 = v[0][1][e], m1x0 = v[1][0][e], m1x1 = v[1][1][e];
      const float s11x0 = v[2][0][e], hi3 = v[2][1][e];
      const float mid = __fadd_rn(m1x0, s00x1), hi2 = __fadd_rn(m1x1, s11x0);
      const float r3 = redmod_c(hi3);
      const float r2 = redmod_c(__fmaf_rn(256.0f, r3, hi2));
      const float r1 = redmod_c(__fmaf_rn(256.0f, r2, mid));
      const float t = redfbt_c(__fmaf_rn(256.0f, r1, lo));
      tsum[4 * g + e] = first ? t : __fadd_rn(tsum[4 * g + e], t);
    }
  }
}

template <int W>
__device__ __forceinline__ void tile_write(const float (&tsum)[8], float* __restrict__ st, int wt) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = W + 3 * (q / 4), e = q % 4;
    const int row = 16 * (wt >> 5) + ((wt & 31) >> 2) + 8 * (e >> 1);
    const int col = 8 * j + 2 * (wt & 3) + (e & 1);
    st[row * CN + col] = tsum[q];
  }
}

// out [RN, G]: the accumulator after `steps` steps; w0, w1 [RN, N2]; bcol
// [RN, NVC]; scratch: two steps' limb matrices (step j reads buffer j % 2),
// then three sums [N2, G] f32 (step j adds into plane j % 3, reads plane
// (j + 2) % 3 and zeroes plane (j + 1) % 3), then the barrier's counter
// (256 bytes: BAR_BYTES); clocks (or null): [gridDim.x,
// PHASES] clock64 sums over the steps: thread 0's feedback, products,
// epilogue and barrier (a step's whole time), and a build warp's busy time.
__global__ void __launch_bounds__(CTPB, 1)
    ptw_c(const float* __restrict__ w0, const float* __restrict__ w1, const float* __restrict__ bcol,
          float* __restrict__ out, uint8_t* __restrict__ scratch, unsigned long long* clocks, int G,
          int steps, int units) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* sx = smem + SM_B;
  float4* ex = reinterpret_cast<float4*>(sx);
  float* st = reinterpret_cast<float*>(smem + SM_T);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM_BAR);
  uint64_t* empty = full + STAGES;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  const int tid = threadIdx.x;
  const int wg = tid >> 7, wt = tid & 127;  // warpgroup (0-2: limb; 3: build), thread in it
  const int ncb = (G + CN - 1) / CN, npass = (units + 1) / 2;
  const int items = NVC * ncb * npass;
  float* sums = reinterpret_cast<float*>(scratch + 2 * (size_t)LIMB_BYTES);
  const int plane = N2 * G;
  unsigned* bar = reinterpret_cast<unsigned*>(sums + 3 * (size_t)plane);  // the steps' barrier

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], LIMBS);
      mbar_init(&empty[s], CTHREADS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  unsigned long long clk[PHASES] = {};
  long long t0, t1;
  // the first step's limb matrices; its sums and the zero feedback before it
  build_limbs(w0, w1, bcol, scratch, tid, CTPB);
  zero_share(sums, plane, tid, CTPB);
  zero_share(sums + 2 * plane, plane, tid, CTPB);
  if (blockIdx.x == 0 && tid == 0) *bar = 0;
  fence_async_global();
  grid.sync();

  if (wg == LIMBS) {
    setmaxnreg_dec<REGS_BUILD>();
    uint32_t it = 0;
    for (int j = 0; j < steps; ++j) {
      if (wt < 32) {  // warp 0 feeds the ring with the step's limb chunks
        const uint8_t* limbs = scratch + (size_t)(j & 1) * LIMB_BYTES;
        for (int i = blockIdx.x; i < items; i += gridDim.x) {
          const int vc = i / npass / ncb;
          for (int kc = 0; kc < NKC; ++kc, ++it) {
            if (wt == 0) {
              const int s = it % STAGES;
              if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
#pragma unroll
              for (int l = 0; l < LIMBS; ++l)
                bulk_load(ring + (s * LIMBS + l) * ATILE,
                          limbs + (size_t)((vc * LIMBS + l) * NKC + kc) * ATILE, ATILE, &full[s]);
            }
            __syncwarp();
          }
        }
      } else {  // warps 1-3 build the next step's limb matrices, zero the sums two steps ahead
        t0 = clock64();
        if (j + 1 < steps)
          build_limbs(w0, w1, bcol, scratch + (size_t)((j + 1) & 1) * LIMB_BYTES, wt - 32, BUILD_THREADS);
        zero_share(sums + (size_t)((j + 1) % 3) * plane, plane, wt - 32, BUILD_THREADS);
        if (wt == 32) clk[4] += clock64() - t0;
      }
      fence_async_global();
      grid_barrier(bar, j);
    }
    setmaxnreg_inc<128>();  // back to the launch's count for the common tail
  } else {
    setmaxnreg_inc<REGS_CONSUMER>();
    uint32_t it = 0;
    t0 = clock64();
    for (int j = 0; j < steps; ++j) {
      const float* prev = sums + (size_t)((j + 2) % 3) * plane;
      float* cur = sums + (size_t)(j % 3) * plane;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int pass = i % npass, cb = i / npass % ncb;
        const int nu = min(2, units - 2 * pass);
        const int col0 = cb * CN, width = min(CN, G - col0);
        if (i != (int)blockIdx.x) consumers_sync();  // the last item's exchange is read
        // X of the item's columns: column c = tid % CN, frequencies 8 f8 .. +7
        {
          const int c = tid % CN, f8 = tid / CN;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = c < width ? __ldcg(prev + (size_t)(f8 * 8 + e) * G + col0 + c) : 0.0f;
          uint32_t q0[4], q1[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            float x0[2] = {0.0f, 0.0f}, x1[2] = {0.0f, 0.0f};
            if (c < width) {
#pragma unroll
              for (int e = 0; e < 2; ++e) split_c(redfbt_c(__fadd_rn(redmod_c(v[2 * h + e]), 1.0f)), x0[e], x1[e]);
            }
            q0[h] = pack_bf16(x0[0], x0[1]);
            q1[h] = pack_bf16(x1[0], x1[1]);
          }
          const uint4 v0 = make_uint4(q0[0], q0[1], q0[2], q0[3]);
          const uint4 v1 = make_uint4(q1[0], q1[1], q1[2], q1[3]);
#pragma unroll
          for (int kc = 0; kc < NKC; ++kc) {  // x[k] = x[k % 64]: the feedback tiled over the rows
            *reinterpret_cast<uint4*>(sx + kc * BTILE + swz(c, f8)) = v0;
            *reinterpret_cast<uint4*>(sx + kc * BTILE + swz(CN + c, f8)) = v1;
          }
        }
        fence_async_shared();
        consumers_sync();
        t1 = clock64(); clk[0] += t1 - t0; t0 = t1;

        float acc[2][ACC];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int r = 0; r < ACC; ++r) acc[u][r] = 0.0f;
        int last = 0;
        for (int kc = 0; kc < NKC; ++kc, ++it) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          fence_acc(acc);
          wgmma_fence();
          const uint64_t da = gmma_desc(smem_u32(ring + (s * LIMBS + wg) * ATILE));
          const uint64_t db = gmma_desc(smem_u32(sx + kc * BTILE));
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk) {  // 16 rows = 32 bytes = 2 in the descriptor
            wgmma_m64n96(acc[0], da + 2 * kk, db + 2 * kk);
            wgmma_m64n96(acc[1], da + 2 * kk, db + 2 * kk);
          }
          wgmma_commit();
          fence_acc(acc);
          if (kc > 0) {
            wgmma_wait<1>();
            if ((tid & 31) == 0) mbar_arrive(&empty[last]);
          }
          last = s;
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if ((tid & 31) == 0) mbar_arrive(&empty[last]);
        t1 = clock64(); clk[1] += t1 - t0; t0 = t1;

        float tsum[8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u < nu) {
            if (wg == 0) epilogue_unit<0>(acc[u], ex, wt, tsum, u == 0);
            else if (wg == 1) epilogue_unit<1>(acc[u], ex, wt, tsum, u == 0);
            else epilogue_unit<2>(acc[u], ex, wt, tsum, u == 0);
          }
        }
        if (tid < N2) bulk_wait_read();  // the last item's t is read
        consumers_sync();
        if (wg == 0) tile_write<0>(tsum, st, wt);
        else if (wg == 1) tile_write<1>(tsum, st, wt);
        else tile_write<2>(tsum, st, wt);
        fence_async_shared();
        consumers_sync();
        if (tid < N2) {  // row tid of t into the step's sums
          bulk_add_f32(cur + (size_t)tid * G + col0, st + tid * CN, width * 4);
        }
        t1 = clock64(); clk[2] += t1 - t0; t0 = t1;
      }
      if (tid < N2) bulk_wait();
      fence_async_global();
      grid_barrier(bar, j);
      t1 = clock64(); clk[3] += t1 - t0; t0 = t1;
    }
    setmaxnreg_dec<128>();
  }

  // the output: acc = redfbt(sums) of the last step, tiled over the 8 rows
  const float* fin = sums + (size_t)((steps + 2) % 3) * plane;
  for (size_t i = blockIdx.x * (size_t)CTPB + tid; i < (size_t)RN * G; i += (size_t)gridDim.x * CTPB)
    out[i] = redfbt_c(__ldcg(fin + (i / G % N2) * G + i % G));
  if (clocks != nullptr && (tid == 0 || tid == CTHREADS + 32))  // the build warps' phase from one of them
    for (int p = 0; p < PHASES; ++p)
      if ((p == PHASES - 1) == (tid != 0)) clocks[blockIdx.x * PHASES + p] = clk[p];
}

// blocks of the cooperative launch on the current device (a block per SM
// when its shared memory allows one): 0 when none fits
int ptw_c_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  static int cached[64] = {};
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  if (cudaFuncSetAttribute(ptw_c, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_C) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ptw_c, CTPB, SMEM_C) != cudaSuccess)
    return 0;
  const int blocks = sms * min(per_sm, 1);
  if (dev < 64) cached[dev] = blocks;
  return blocks;
}

void* kernel_of(int pattern) {
  switch (pattern) {
    case PA: return (void*)ptw_elem<PA>;
    case PNOB: return (void*)ptw_elem<PNOB>;
    case PT: return (void*)ptw_elem<PT>;
    case PC: return (void*)ptw_c;
    default: return nullptr;
  }
}

}  // namespace

// pattern 0 A, 1 NOB, 2 B/B2 (C has its own entry below). A, NOB: slab
// [rows_out, 96], out [rows_out, cols_out = G]; B: slab [96, cols_out =
// L], out [rows_out = G, L]. One launch. Returns a cudaError_t.
extern "C" int helm_probe_ptw(int pattern, const void* slab_, void* out, int rows_out, int cols_out,
                              int steps, int units, void* stream) {
  if (pattern < PA || pattern > PT || rows_out <= 0 || cols_out <= 0 || steps < 0 || units <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  const float* slab = (const float*)slab_;
  if (pattern == PT) {
    if (128 % cols_out) return (int)cudaErrorInvalidValue;
    const int elems = rows_out * cols_out;
    ptw_elem<PT><<<(elems + TPB - 1) / TPB, TPB, NT * cols_out * sizeof(float), st>>>(
        slab, o, rows_out, cols_out, steps, units);
  } else {
    const dim3 grid((cols_out + TPB - 1) / TPB, rows_out);
    if (pattern == PA)
      ptw_elem<PA><<<grid, TPB, NT * sizeof(float), st>>>(slab, o, rows_out, cols_out, steps, units);
    else
      ptw_elem<PNOB><<<grid, TPB, 0, st>>>(slab, o, rows_out, cols_out, steps, units);
  }
  return (int)cudaGetLastError();
}

// Blocks of C's cooperative launch on the current device, and the layout
// constants the host mirrors (ops/probes.py): columns a work item, bytes of
// a step's limb matrices, clock phases. Returns a cudaError_t;
// cudaErrorCooperativeLaunchTooLarge when no block fits on an SM.
extern "C" int helm_probe_ptw_c_grid(int* blocks, int* cols, int* limb_bytes, int* phases) {
  *cols = CN;
  *limb_bytes = LIMB_BYTES;
  *phases = PHASES;
  *blocks = ptw_c_blocks();
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// C: w0, w1 [512, 64], bcol [512, 12], out [512, G], G a multiple of 8;
// scratch: 2 x LIMB_BYTES + 3 x 64 x G x 4 + BAR_BYTES bytes; clocks: null, or
// [blocks, PHASES] u64. One cooperative launch of helm_probe_ptw_c_grid's
// blocks. Returns a cudaError_t.
extern "C" int helm_probe_ptw_c(const void* w0, const void* w1, const void* bcol, void* out,
                                void* scratch, void* clocks, int G, int steps, int units,
                                void* stream) {
  if (G <= 0 || G % 8 || steps < 0 || units <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = ptw_c_blocks();
  if (blocks <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&w0, (void*)&w1, (void*)&bcol, (void*)&out, (void*)&scratch,
                  (void*)&clocks, (void*)&G, (void*)&steps, (void*)&units};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)ptw_c, dim3(blocks), dim3(CTPB), args,
                                                    SMEM_C, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Registers a thread and local-memory bytes a thread (the spills) of the
// pattern's kernel. Returns a cudaError_t.
extern "C" int helm_probe_ptw_resources(int pattern, int* regs, int* local) {
  const void* k = kernel_of(pattern);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return 0;
}
