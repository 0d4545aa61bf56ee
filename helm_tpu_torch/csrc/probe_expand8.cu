// Lane expansion for Hopper (sm_90a), plain C interface: K7 of the port.
//
// Replaces the Pallas probe tools/expand8_hw_test.py:18 (its body is
// helm_tpu/ops/mxu_pbs.py:212 _expand8), and computes the same function as
// helm_tpu_torch/ops/probes.py expand8_plain, word for word:
//     out[r, l] = int(sum_j lo[r, j] e8[j, l]) + (int(sum_j hi[r, j] e8[j, l]) << 8)
// with lo = x & 255 and hi = x >> 8 (x an int32 bit pattern), each sum in
// float32 over j = 0..7 in order, one multiply and one add a term. With the
// one-hot e8 of the probe it is np.tile(x, (1, 16)).
//
// Design. On the TPU the expansion was one MXU pass a limb, because Mosaic
// lowers a lane repeat of a skinny array slowly. Here it is a stream: one
// thread an output word, a block of 128 threads on 128 consecutive columns
// of 16 rows; each thread keeps its column of e8 (8 floats) in registers,
// and a warp reads each row of x once (the same 32 bytes for all its
// lanes: a broadcast) and writes 128 consecutive words.
//
// What bounds it: bytes. Each output word is written once and the inputs
// are read once: R x L x 4 + R x 32 + 8 x L x 4 bytes (3.3 MB at the
// probe's R = 6144, L = 128), 16 multiply-adds a word.
//
// The entry returns cudaGetLastError(); nothing is allocated here and
// nothing synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;  // threads a block: columns
constexpr int RPB = 16;   // rows a block

__global__ void __launch_bounds__(TPB) expand8(const int32_t* __restrict__ x,
                                               const float* __restrict__ e8,
                                               int32_t* __restrict__ out, int R, int L) {
  const int l = blockIdx.y * TPB + threadIdx.x;
  if (l >= L) return;
  float e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = e8[j * L + l];
  const int r_end = min(R, (int)(blockIdx.x + 1) * RPB);
  for (int r = blockIdx.x * RPB; r < r_end; ++r) {
    const int4* row = reinterpret_cast<const int4*>(x + (size_t)r * 8);
    const int4 v0 = __ldg(row), v1 = __ldg(row + 1);
    const int xv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    float lo = __fmul_rn(__int2float_rn(xv[0] & 255), e[0]);
    float hi = __fmul_rn(__int2float_rn(xv[0] >> 8), e[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      lo = __fadd_rn(lo, __fmul_rn(__int2float_rn(xv[j] & 255), e[j]));
      hi = __fadd_rn(hi, __fmul_rn(__int2float_rn(xv[j] >> 8), e[j]));
    }
    out[(size_t)r * L + l] = __float2int_rz(lo) + (__float2int_rz(hi) << 8);
  }
}

}  // namespace

// x: int32 [R, 8] (16-byte aligned rows), e8: f32 [8, L], out: int32 [R, L].
// One launch. Returns a cudaError_t.
extern "C" int helm_probe_expand8(const void* x, const void* e8, void* out, int R, int L,
                                  void* stream) {
  if (R <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + RPB - 1) / RPB, (L + TPB - 1) / TPB);
  expand8<<<grid, TPB, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const float*)e8, (int32_t*)out, R, L);
  return (int)cudaGetLastError();
}

// Registers a thread and local-memory bytes a thread (the spills) of the
// kernel. Returns a cudaError_t.
extern "C" int helm_probe_expand8_resources(int* regs, int* local) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, expand8);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return 0;
}
