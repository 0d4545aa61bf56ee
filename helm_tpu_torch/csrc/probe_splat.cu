// The column splat and the register live set for Hopper (sm_90a), plain C
// interface: K8 and K9 of the port, one templated body.
//
// Replaces the Pallas probes tools/mosaic_splat_repro.py:94 (K8, run ->
// make_kernel(variant) :54) and tools/liveset_harness.py:111 (K9, run ->
// make_kernel(R, A, G, variant) :52), and computes the same function as
// helm_tpu_torch/ops/probes.py liveset_plain, word for word: for each of
// `steps` steps, T = 96 terms, term i multiplying resident row pair i % R
// by b into accumulator pair i % A,
//     acc[2a]   = acc[2a]   + rows[2r]   * b
//     acc[2a+1] = acc[2a+1] + rows[2r+1] * b
// (one rounding for the product and one for the sum: __fmul_rn and
// __fadd_rn, never a fused multiply-add), then every accumulator halved;
// the output is the sum of the accumulators, in order. K8 is the R = A = 1
// case. The template's variant says what b is:
//   SCALAR  the constant 1 + i/2 (no operand load: the instruction-rate ceiling)
//   SPLAT   cols[step, n, i], the column of the step streamed into shared
//           memory and read by every thread of the row (a broadcast)
//   IMPL    the same word read by each thread from global memory (the
//           memory system's broadcast, no staging)
//   I16     SPLAT from int16 columns, streamed as they are and converted in
//           the thread
//   RED     SPLAT, and every 8 terms the pair reduced mod 16381 as
//           t - floor(t * (1/16381) + 1/2) * 16381
//   TWO     row pair (i + 1) % R's first row (a resident register) in
//           place of a column
//
// Design. Each output element's recurrence is its own (the rows and the
// accumulators of element (n, g) meet only the column of row n), so one
// thread holds one element: its 2R rows and 2A accumulators in registers
// (the live set the probe measures), the grid's sequential steps a loop
// inside the thread, and a block of 128 threads on 128 consecutive g of one
// row n shares that row's column. On the TPU the probe's question was
// whether Mosaic keeps a lane-splatted column in vector registers; here a
// splat is a shared-memory broadcast, and the question the probe answers
// is where the register file runs out: each build's registers a thread and
// local-memory (spill) bytes are read with helm_probe_splat_resources.
//
// The column stream (SPLAT, I16, RED). A step needs one column of its row:
// 384 bytes (192 for I16), at a 16-byte-aligned offset. The columns pass
// through a ring of STAGES stages in shared memory, a stage holding CPS
// columns (CPS steps), fed by 1-D bulk copies (cp.async.bulk, one a
// column, all completing on the stage's "full" mbarrier, which expects the
// stage's bytes) requested AHEAD stages before the stage is read. The
// producer of stage q + AHEAD is one consumer thread, lane 0 of warp q %
// 4, at the head of stage q: it waits on the slot's "empty" mbarrier, on
// which all TPB threads arrive once they have read stage q + AHEAD -
// STAGES (two stages back, so the wait almost never blocks), and refills
// it; the producer's work rotates over the warps, so no warp sets the
// block's pace. A thread waits on the full barrier once a stage: no block
// barrier, no exposed load, and one wait for CPS steps. A thread reads
// the column four terms at a time, one float4 broadcast load (I16: eight
// terms, one 16-byte load of int16 words, each converted exactly by one
// integer operation and one float subtraction: lo16, hi16). A first
// design waited once a step, its producer always thread 0: every step then
// lost some 350 clocks beside its instructions, on the wait that the
// step's first loads stand behind and on warp 0's producer work.
//
// RED's floor without floorf (a conversion-rate instruction): y = t *
// (1/16381) + 1/2 is not an integer (every step halves the accumulators),
// and floor(y) = RD(y + 1.5 2^23) - 1.5 2^23, with RD the addition rounded
// toward -inf, is exact for |y| < 2^22: y + 1.5 2^23 lies in [2^23, 2^24),
// where the float32 spacing is 1. At the probes' inputs |y| stays below
// 2^10 (tests/test_torch_probes.py checks the plain version's values).
//
// What bounds it: the FP32 instruction rate. Each term is 2 multiplies and
// 2 adds (4 instructions: they cannot fuse) on every element, 2 x N2 x G
// FMA-elements a term, against bytes of cols once and rows once. The grid
// is (G / 128, N2) blocks of 4 warps: at G = 512, 1024 warps on 528
// schedulers, so at most two a scheduler, and the term's issue slots (4 +
// 1/4 for the broadcast load, + 1/4 for the halving) are the time. Beside
// them, the broadcast column costs the shared-memory pipe as much as the
// FP32 pipe: one word a term a thread, 32 words a clock an SM, against 4
// instructions a term a thread, 128 lanes a clock an SM; the two pipes
// overlap, not fully, with two warps a scheduler.
//
// Every entry returns cudaGetLastError() or cudaErrorInvalidValue for a
// build that does not exist (or staged columns that are not 16-byte
// aligned); nothing is allocated here and nothing synchronises.

#include <cstdint>
#include <cuda_runtime.h>

#include "pbs_common.cuh"

namespace {

constexpr int T = 96;     // terms a step
constexpr int TPB = 128;  // threads a block: consecutive g of one row
constexpr int CPS = 8;      // columns a stage: the steps between two barrier waits
constexpr int STAGES = 4;   // ring of stages
constexpr int AHEAD = 2;    // stages a stage is requested before its first step
static_assert((STAGES & (STAGES - 1)) == 0 && AHEAD < STAGES, "a ring of a power of two");
enum Variant { SCALAR = 0, SPLAT = 1, IMPL = 2, I16 = 3, RED = 4, TWO = 5 };

// 1/16381 rounded to float32 (as the plain version's constant)
constexpr float IP16381 = 0x1.000cp-14f;
constexpr float MAGIC = 12582912.0f;  // 1.5 2^23

__device__ __forceinline__ float reduce16381(float t) {
  const float y = __fadd_rn(__fmul_rn(t, IP16381), 0.5f);
  const float q = __fsub_rn(__fadd_rd(y, MAGIC), MAGIC);  // floor(y): |y| < 2^22
  return __fsub_rn(t, __fmul_rn(q, 16381.0f));
}

// the int16 in the low (lo16) or high (hi16) half of w, as a float, exactly:
// 2^23 + (v + 2^15) and 1.5 2^23 + v built in the float's bits, then the
// offset subtracted (both sums lie in [2^23, 2^24), spacing 1). lo16's bits
// 0x4B000000 | ((w ^ 0x8000) & 0xFFFF) are one LOP3 (truth table 0x9A on
// w, 0xFFFF0000, 0x4B008000: bits 0-14 of w, bit 15 inverted, the high half
// the constant's), hi16's one LEA.HI (w >> 16 sign-extended, plus the bits)
__device__ __forceinline__ float lo16(uint32_t w) {
  uint32_t bits;
  asm("lop3.b32 %0, %1, %2, %3, 0x9A;" : "=r"(bits) : "r"(w), "r"(0xFFFF0000u), "r"(0x4B008000u));
  return __fsub_rn(__uint_as_float(bits), 8421376.0f);
}
__device__ __forceinline__ float hi16(uint32_t w) {
  return __fsub_rn(__int_as_float(((int32_t)w >> 16) + 0x4B400000), MAGIC);
}

// one term series of one step: 96 terms into the accumulators, then every
// accumulator halved. col: the step's column in shared memory (SPLAT, RED:
// f32; I16: int16 words); colg: its words in global memory (IMPL)
template <int R, int A, int V>
__device__ __forceinline__ void one_step(const float (&row)[2 * R], float (&acc)[2 * A],
                                         const uint4* col, const float* colg) {
  uint4 w;  // the words of terms i .. i + 3 (I16: i .. i + 7)
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int r = i % R, a = i % A;
    float b;
    if constexpr (V == SCALAR) {
      b = 1.0f + 0.5f * (float)i;
    } else if constexpr (V == IMPL) {
      b = __ldg(colg + i);
    } else if constexpr (V == TWO) {
      b = row[2 * ((i + 1) % R)];
    } else if constexpr (V == I16) {
      if (i % 8 == 0) w = col[i / 8];
      const uint32_t h = (i % 8) < 2 ? w.x : (i % 8) < 4 ? w.y : (i % 8) < 6 ? w.z : w.w;
      b = i % 2 == 0 ? lo16(h) : hi16(h);
    } else {
      if (i % 4 == 0) w = col[i / 4];
      b = __uint_as_float(i % 4 == 0 ? w.x : i % 4 == 1 ? w.y : i % 4 == 2 ? w.z : w.w);
    }
    acc[2 * a] = __fadd_rn(acc[2 * a], __fmul_rn(row[2 * r], b));
    acc[2 * a + 1] = __fadd_rn(acc[2 * a + 1], __fmul_rn(row[2 * r + 1], b));
    if constexpr (V == RED) {
      if ((i + 1) % 8 == 0) {
        acc[2 * a] = reduce16381(acc[2 * a]);
        acc[2 * a + 1] = reduce16381(acc[2 * a + 1]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2 * A; ++a) acc[a] = __fmul_rn(acc[a], 0.5f);
}

template <int R, int A, int V>
__global__ void __launch_bounds__(TPB) splat_body(const void* __restrict__ cols_v,
                                                  const float* __restrict__ rows,
                                                  float* __restrict__ out, int steps, int N2,
                                                  int G) {
  const int n = blockIdx.y;
  const int g = blockIdx.x * TPB + threadIdx.x;
  const bool live = g < G;
  const size_t plane = (size_t)N2 * G;
  float row[2 * R];
#pragma unroll
  for (int k = 0; k < 2 * R; ++k) row[k] = live ? rows[k * plane + (size_t)n * G + g] : 0.0f;
  float acc[2 * A];
#pragma unroll
  for (int a = 0; a < 2 * A; ++a) acc[a] = 0.0f;
  if constexpr (V == SPLAT || V == I16 || V == RED) {
    constexpr uint32_t COL_BYTES = V == I16 ? T * 2 : T * 4;
    __shared__ uint4 ring[STAGES][CPS][T / 4];  // 384 bytes a column (uint4: 16-byte aligned)
    __shared__ uint64_t full[STAGES], empty[STAGES];
    // the column of step j is at col0 + j * step_bytes
    const char* col0 = (const char*)cols_v + (size_t)n * COL_BYTES;
    const size_t step_bytes = (size_t)N2 * COL_BYTES;
    // stage f: its columns' bytes announced on full[f % STAGES] and copied
    const auto request = [&](int f) {
      const int s = f & (STAGES - 1), j0 = f * CPS, nc = min(CPS, steps - j0);
      expect_bytes(&full[s], nc * COL_BYTES);
      for (int c = 0; c < nc; ++c) copy_bulk(ring[s][c], col0 + (j0 + c) * step_bytes, COL_BYTES, &full[s]);
    };
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], TPB);
      }
      mbar_fence_init();
      for (int f = 0; f < AHEAD && f * CPS < steps; ++f) request(f);
    }
    __syncthreads();  // the barriers are initialised
    for (int q = 0; q * CPS < steps; ++q) {
      const int s = q & (STAGES - 1), f = q + AHEAD;
      // stage f's producer: lane 0 of warp q % 4, once every thread has
      // read stage f - STAGES (= q - 2) out of its slot
      if ((int)threadIdx.x == 32 * (q % (TPB / 32)) && f * CPS < steps) {
        if (f >= STAGES) mbar_wait(&empty[f & (STAGES - 1)], ((f / STAGES) - 1) & 1);
        request(f);
      }
      mbar_wait(&full[s], (q / STAGES) & 1);
      const int nj = min(CPS, steps - q * CPS);
      for (int jj = 0; jj < nj; ++jj) one_step<R, A, V>(row, acc, ring[s][jj], nullptr);
      mbar_arrive(&empty[s]);  // this thread has read the stage
    }
  } else {
    const float* colsf = (const float*)cols_v;
    for (int j = 0; j < steps; ++j) one_step<R, A, V>(row, acc, nullptr, colsf + ((size_t)j * N2 + n) * T);
  }
  float s = acc[0];
#pragma unroll
  for (int a = 1; a < 2 * A; ++a) s = __fadd_rn(s, acc[a]);
  if (live) out[(size_t)n * G + g] = s;
}

using Body = void (*)(const void*, const float*, float*, int, int, int);

template <int R, int A>
Body by_variant(int v) {
  switch (v) {
    case SPLAT: return splat_body<R, A, SPLAT>;
    case RED: return splat_body<R, A, RED>;
    case TWO: return splat_body<R, A, TWO>;
    default: break;
  }
  if (R == 1 && A == 1) {  // K8's own forms
    switch (v) {
      case SCALAR: return splat_body<1, 1, SCALAR>;
      case IMPL: return splat_body<1, 1, IMPL>;
      case I16: return splat_body<1, 1, I16>;
      default: break;
    }
  }
  return nullptr;
}

template <int R>
Body by_a(int A, int v) {
  switch (A) {
    case 1: return by_variant<R, 1>(v);
    case 4: return by_variant<R, 4>(v);
    case 8: return by_variant<R, 8>(v);
    case 12: return by_variant<R, 12>(v);
    case 16: return by_variant<R, 16>(v);
    default: return nullptr;
  }
}

// The build of (R, A, variant): K9's R in {1, 2, 4, 8} x A in {1, 4, 8,
// 12, 16} x {SPLAT, RED, TWO}, and K8's SCALAR, IMPL and I16 at R = A = 1
// (ops/probes.py LIVESET_RS, LIVESET_AS); nullptr for any other.
Body select(int R, int A, int v) {
  switch (R) {
    case 1: return by_a<1>(A, v);
    case 2: return by_a<2>(A, v);
    case 4: return by_a<4>(A, v);
    case 8: return by_a<8>(A, v);
    default: return nullptr;
  }
}

}  // namespace

// cols: f32 (int16 for I16) [steps, N2, 96], 16-byte aligned for the
// streamed variants (SPLAT, I16, RED); rows: f32 [2R, N2, G]; out: f32
// [N2, G]. One launch. Returns a cudaError_t.
extern "C" int helm_probe_splat(int R, int A, int variant, const void* cols, const void* rows,
                                void* out, int steps, int N2, int G, void* stream) {
  const Body body = select(R, A, variant);
  const bool streamed = variant == SPLAT || variant == I16 || variant == RED;
  if (body == nullptr || steps < 0 || N2 <= 0 || G <= 0 || (streamed && (uintptr_t)cols % 16))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((G + TPB - 1) / TPB, N2);
  body<<<grid, TPB, 0, (cudaStream_t)stream>>>(cols, (const float*)rows, (float*)out, steps, N2,
                                               G);
  return (int)cudaGetLastError();
}

// Registers a thread and local-memory bytes a thread (the spills) of the
// build (R, A, variant). Returns a cudaError_t.
extern "C" int helm_probe_splat_resources(int R, int A, int variant, int* regs, int* local) {
  const Body body = select(R, A, variant);
  if (body == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, body);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return 0;
}
