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
//        limb matrices, times the feedback's two bf16 limbs, in six
//        products with f32 accumulation, recombined mod P
// Every multiply and add rounds once (__fmul_rn, __fadd_rn, never a fused
// multiply-add), in the plain version's order.
//
// Design. A, NOB, B: each output element's recurrence is its own, so one
// thread holds one element across all steps (the TPU's sequential grid is
// a loop inside the thread), its 8 row limb pairs in registers. C: the
// contraction mixes the 512 rows of a column of gates, and the columns
// never mix, so a block of 8 warps owns 8 columns for all steps. Warp w
// computes frequency rows 16 (w % 4) .. +16 over contraction rows
// 256 (w / 4) .. +256 with m16n8k16 bf16 mma.sync: each thread builds the
// limb-matrix words it holds in its A fragments from w0, w1 and the
// group's column of bcol (so each word of W diag(b) is built once a block
// and never stored), the feedback's limbs are the B fragments (staged in
// shared memory, transposed and padded so the fragment loads are
// conflict-free), and the two halves of the contraction are added through
// shared memory. Every operand is an integer of at most 8 bits and every
// partial sum is below 2^24, so the tensor cores' f32 sums are exact in any
// order.
//
// What bounds it. A, NOB, B: the FP32 instruction rate (every multiply and
// add its own instruction). C: the six products are 6 x 64 x 512 x 512 x 2 bf16 FLOPs
// a unit, but each block rebuilds the limb matrices itself (64 x 512 words
// x 2 matrices a group, some 30 FP32 instructions a word): at G = 512
// that build, 64 blocks each doing the whole of it, is what bounds C.
//
// Every entry returns cudaGetLastError() or cudaErrorInvalidValue; nothing
// is allocated here and nothing synchronises.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8, NVC = 12, NT = ROWS * NVC;  // rows, term groups, terms
constexpr float P = 18433.0f, HP = 9216.0f;
constexpr float IP = 0x1.c7162p-15f;  // 1/18433 rounded to float32
constexpr int TPB = 128;              // A, NOB, B: threads a block
enum Pattern { PA = 0, PNOB = 1, PT = 2, PC = 3 };

__device__ __forceinline__ float redfbt(float t) {
  const float q = floorf(__fadd_rn(__fmul_rn(t, IP), 0.5f));
  t = __fsub_rn(t, __fmul_rn(q, P));
  t = t > HP ? __fsub_rn(t, P) : t;
  return t < -HP ? __fadd_rn(t, P) : t;
}

__device__ __forceinline__ void split256(float t, float& lo, float& hi) {
  hi = floorf(__fadd_rn(__fmul_rn(t, 0.00390625f), 0.5f));
  lo = __fsub_rn(t, __fmul_rn(256.0f, hi));
}

// A and NOB: out [N2, G], the block on 128 gates of frequency row n, the
// row's 96 BSK words in shared memory. B: out [G, L], L dividing 128, the
// whole slab [96, L] in shared memory.
template <int PAT>
__global__ void __launch_bounds__(TPB) ptw_elem(const float* __restrict__ slab,
                                                float* __restrict__ out, int rows_out,
                                                int cols_out, int steps, int units) {
  extern __shared__ float s[];
  int e, l = 0;
  const float* bk;  // the BSK word of term k is bk[k * stride]
  int stride;
  if constexpr (PAT == PT) {
    const int L = cols_out;
    for (int i = threadIdx.x; i < NT * L; i += TPB) s[i] = slab[i];
    e = blockIdx.x * TPB + threadIdx.x;
    l = e % L;
    bk = s + l;
    stride = L;
  } else {
    const int n = blockIdx.y;
    if constexpr (PAT == PA)
      for (int i = threadIdx.x; i < NT; i += TPB) s[i] = slab[n * NT + i];
    e = n * cols_out + blockIdx.x * TPB + threadIdx.x;
    bk = s;
    stride = 1;
  }
  __syncthreads();
  const bool live = PAT == PT ? e < rows_out * cols_out
                              : (int)(blockIdx.x * TPB + threadIdx.x) < cols_out;
  float acc = 0.0f;
  for (int j = 0; j < steps; ++j) {
    const float base = redfbt(__fadd_rn(acc, 1.0f));
    float total = 0.0f;
    for (int u = 0; u < units; ++u) {
      float flo[ROWS], fhi[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        split256(redfbt(__fadd_rn(base, (float)(u * ROWS + r))), flo[r], fhi[r]);
#pragma unroll
      for (int vc = 0; vc < NVC; ++vc) {
        float slo, shi;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float blo, bhi;
          if constexpr (PAT == PNOB) {
            blo = 3.0f + (float)(r + vc);
            bhi = 5.0f + (float)(r + vc);
          } else {
            blo = bhi = bk[(vc * ROWS + r) * stride];
          }
          const float plo = __fmul_rn(flo[r], blo), phi = __fmul_rn(fhi[r], bhi);
          slo = r == 0 ? plo : __fadd_rn(slo, plo);
          shi = r == 0 ? phi : __fadd_rn(shi, phi);
        }
        const float t = __fadd_rn(redfbt(slo), __fmul_rn(256.0f, redfbt(shi)));
        total = (u == 0 && vc == 0) ? t : __fadd_rn(total, redfbt(t));
      }
    }
    acc = redfbt(total);
  }
  if (live) out[e] = acc;
}

// -- C ---------------------------------------------------------------------

constexpr int N2 = 64, RN = ROWS * N2;  // frequencies, contraction rows
constexpr int GB = 8;                   // columns of gates a block
constexpr int CW = 8, CTPB = CW * 32;   // warps, threads a block
constexpr int XS = RN + 8;              // padded row of the staged limbs (bf16)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out [RN, G]: the accumulator after `steps` steps; w0, w1 [RN, N2]; bcol
// [RN, NVC]. A block per GB columns, CTPB threads.
__global__ void __launch_bounds__(CTPB) ptw_c(const float* __restrict__ w0,
                                              const float* __restrict__ w1,
                                              const float* __restrict__ bcol,
                                              float* __restrict__ out, int G, int steps,
                                              int units) {
  __shared__ __align__(16) __nv_bfloat16 xt[2][GB][XS];  // the feedback's limbs, [column][row]
  __shared__ float accs[N2][GB];                         // redfbt(total): acc[k] = accs[k % N2]
  __shared__ float half[4][4][32][4];                    // the upper k-half's sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = warp & 3, kh = warp >> 2;
  const int g0 = blockIdx.x * GB;
  for (int i = threadIdx.x; i < N2 * GB; i += CTPB) accs[i / GB][i % GB] = 0.0f;
  float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < steps; ++j) {
    __syncthreads();  // accs holds the last step's accumulator
    for (int i = threadIdx.x; i < RN * GB; i += CTPB) {
      const int k = i / GB, c = i % GB;
      float lo, hi;
      split256(redfbt(__fadd_rn(accs[k % N2][c], 1.0f)), lo, hi);
      xt[0][c][k] = __float2bfloat16_rn(lo);
      xt[1][c][k] = __float2bfloat16_rn(hi);
    }
    __syncthreads();
    for (int u = 0; u < units; ++u) {
      for (int vc = 0; vc < NVC; ++vc) {
        float lo[4] = {}, mid[4] = {}, hi2[4] = {}, hi3[4] = {};
        for (int ks = 0; ks < RN / 2 / 16; ++ks) {
          const int k0 = kh * (RN / 2) + ks * 16;
          uint32_t a00[4], am1[4], a11[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // fragment register q: rows gid (+8), columns +0/+8
            const int n = mt * 16 + gid + ((q & 1) ? 8 : 0);
            float v00[2], vm1[2], v11[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = k0 + tig * 2 + ((q & 2) ? 8 : 0) + h;
              const float b = __ldg(bcol + k * NVC + vc);
              float s01, s10;
              split256(redfbt(__fmul_rn(__ldg(w0 + k * N2 + n), b)), v00[h], s01);
              split256(redfbt(__fmul_rn(__ldg(w1 + k * N2 + n), b)), s10, v11[h]);
              vm1[h] = __fadd_rn(s01, s10);
            }
            a00[q] = pack_bf16(v00[0], v00[1]);
            am1[q] = pack_bf16(vm1[0], vm1[1]);
            a11[q] = pack_bf16(v11[0], v11[1]);
          }
          const uint32_t* x0 = reinterpret_cast<const uint32_t*>(&xt[0][gid][k0 + tig * 2]);
          const uint32_t* x1 = reinterpret_cast<const uint32_t*>(&xt[1][gid][k0 + tig * 2]);
          const uint32_t b00 = x0[0], b01 = x0[4], b10 = x1[0], b11 = x1[4];
          mma_bf16(lo, a00, b00, b01);
          mma_bf16(mid, am1, b00, b01);
          mma_bf16(mid, a00, b10, b11);
          mma_bf16(hi2, am1, b10, b11);
          mma_bf16(hi2, a11, b00, b01);
          mma_bf16(hi3, a11, b10, b11);
        }
        if (kh == 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            half[mt][0][lane][i] = lo[i];
            half[mt][1][lane][i] = mid[i];
            half[mt][2][lane][i] = hi2[i];
            half[mt][3][lane][i] = hi3[i];
          }
        }
        __syncthreads();
        if (kh == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float vlo = __fadd_rn(lo[i], half[mt][0][lane][i]);
            const float vmid = __fadd_rn(mid[i], half[mt][1][lane][i]);
            const float vhi2 = __fadd_rn(hi2[i], half[mt][2][lane][i]);
            const float vhi3 = __fadd_rn(hi3[i], half[mt][3][lane][i]);
            const float r3 = redfbt(vhi3);
            const float r2 = redfbt(__fadd_rn(vhi2, __fmul_rn(256.0f, r3)));
            const float r1 = redfbt(__fadd_rn(vmid, __fmul_rn(256.0f, r2)));
            const float t = redfbt(__fadd_rn(vlo, __fmul_rn(256.0f, r1)));
            total[i] = (u == 0 && vc == 0) ? t : __fadd_rn(total[i], t);
          }
        }
        __syncthreads();  // half is free again
      }
    }
    if (kh == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        accs[mt * 16 + gid + ((i & 2) ? 8 : 0)][tig * 2 + (i & 1)] = redfbt(total[i]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RN * GB; i += CTPB) {
    const int k = i / GB, c = i % GB;
    out[(size_t)k * G + g0 + c] = accs[k % N2][c];
  }
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

// pattern 0 A, 1 NOB, 2 B/B2, 3 C. A, NOB: a = slab [rows_out, 96], out
// [rows_out, cols_out = G]; B: a = slab [96, cols_out = L], out
// [rows_out = G, L]; C: a, b, c = w0, w1 [512, 64], bcol [512, 12], out
// [rows_out = 512, cols_out = G], G a multiple of 8. One launch. Returns a
// cudaError_t.
extern "C" int helm_probe_ptw(int pattern, const void* a, const void* b, const void* c,
                              void* out, int rows_out, int cols_out, int steps, int units,
                              void* stream) {
  if (kernel_of(pattern) == nullptr || rows_out <= 0 || cols_out <= 0 || steps < 0 || units <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  const float* slab = (const float*)a;
  switch (pattern) {
    case PA:
    case PNOB: {
      const dim3 grid((cols_out + TPB - 1) / TPB, rows_out);
      if (pattern == PA)
        ptw_elem<PA><<<grid, TPB, NT * sizeof(float), st>>>(slab, o, rows_out, cols_out, steps, units);
      else
        ptw_elem<PNOB><<<grid, TPB, 0, st>>>(slab, o, rows_out, cols_out, steps, units);
      break;
    }
    case PT: {
      if (128 % cols_out) return (int)cudaErrorInvalidValue;
      const int elems = rows_out * cols_out;
      ptw_elem<PT><<<(elems + TPB - 1) / TPB, TPB, NT * cols_out * sizeof(float), st>>>(
          slab, o, rows_out, cols_out, steps, units);
      break;
    }
    case PC: {
      if (rows_out != RN || cols_out % GB) return (int)cudaErrorInvalidValue;
      ptw_c<<<cols_out / GB, CTPB, 0, st>>>(slab, (const float*)b, (const float*)c, o, cols_out,
                                            steps, units);
      break;
    }
  }
  return (int)cudaGetLastError();
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
