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
//   SPLAT   cols[step, n, i], the column of the step staged in shared
//           memory and read by every thread of the row (a broadcast)
//   IMPL    the same word read by each thread from global memory (the
//           memory system's broadcast, no staging)
//   I16     SPLAT from int16 columns, converted in the thread
//   RED     SPLAT, and every 8 terms the pair reduced mod 16381 as
//           t - floor(t * (1/16381) + 1/2) * 16381
//   TWO     row pair (i + 1) % R's first row (a resident register) in
//           place of a column
//
// Design. Each output element's recurrence is its own (the rows and the
// accumulators of element (n, g) meet only the column of row n), so one
// thread holds one element: its 2R rows and 2A accumulators in registers,
// the grid's sequential steps a loop inside the thread, and a block of 128
// threads on 128 consecutive g of one row n shares that row's column. On
// the TPU the probe's question was whether Mosaic keeps a lane-splatted
// column in vector registers; here a splat is one shared-memory broadcast
// read a term, and the question the probe answers is where the register
// file runs out: each build's registers a thread and local-memory (spill)
// bytes are read with helm_probe_splat_resources.
//
// What bounds it: the FP32 instruction rate. Each term is 2 multiplies and
// 2 adds (4 instructions: they cannot fuse) on every element, 2 x N2 x G
// FMA-elements a term, against bytes of cols once and rows once.
//
// Every entry returns cudaGetLastError() or cudaErrorInvalidValue for a
// build that does not exist; nothing is allocated here and nothing
// synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 96;     // terms a step
constexpr int TPB = 128;  // threads a block: consecutive g of one row
enum Variant { SCALAR = 0, SPLAT = 1, IMPL = 2, I16 = 3, RED = 4, TWO = 5 };

// 1/16381 rounded to float32 (as the plain version's constant)
constexpr float IP16381 = 0x1.000cp-14f;

__device__ __forceinline__ float reduce16381(float t) {
  const float q = floorf(__fadd_rn(__fmul_rn(t, IP16381), 0.5f));
  return __fsub_rn(t, __fmul_rn(q, 16381.0f));
}

template <int R, int A, int V>
__global__ void __launch_bounds__(TPB) splat_body(const void* __restrict__ cols_v,
                                                  const float* __restrict__ rows,
                                                  float* __restrict__ out, int steps, int N2,
                                                  int G) {
  constexpr bool STAGED = V == SPLAT || V == I16 || V == RED;
  __shared__ float col[T];
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
  const float* colsf = (const float*)cols_v;
  const int16_t* cols16 = (const int16_t*)cols_v;
  for (int j = 0; j < steps; ++j) {
    const size_t base = ((size_t)j * N2 + n) * T;
    if constexpr (STAGED) {
      __syncthreads();  // the previous step's column is read
      for (int i = threadIdx.x; i < T; i += TPB)
        col[i] = V == I16 ? (float)cols16[base + i] : colsf[base + i];
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int r = i % R, a = i % A;
      float b;
      if constexpr (V == SCALAR) {
        b = 1.0f + 0.5f * (float)i;
      } else if constexpr (V == IMPL) {
        b = __ldg(colsf + base + i);
      } else if constexpr (V == TWO) {
        b = row[2 * ((i + 1) % R)];
      } else {
        b = col[i];
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

// cols: f32 (int16 for I16) [steps, N2, 96]; rows: f32 [2R, N2, G]; out:
// f32 [N2, G]. One launch. Returns a cudaError_t.
extern "C" int helm_probe_splat(int R, int A, int variant, const void* cols, const void* rows,
                                void* out, int steps, int N2, int G, void* stream) {
  const Body body = select(R, A, variant);
  if (body == nullptr || steps < 0 || N2 <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
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
