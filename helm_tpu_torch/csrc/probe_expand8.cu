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
// lowers a lane repeat of a skinny array slowly. Here it is a stream of
// bytes: a warp writes RPW rows of a column tile of 128 (grid y), a thread
// 4 consecutive words of each with one 16-byte store, its 4 columns of e8
// (32 floats) in registers; the warp reads each of its rows of x once (the
// same 32 bytes for all its lanes: a broadcast), and issues those reads
// and e8's together, before any use: at this size a call is a few
// round trips to memory, so the kernel keeps them to one. A block of WPB
// warps takes WPB x RPW consecutive rows, so the grid (R / 8 blocks at the
// probe's shape: 768 of them) covers the 132 SMs 5.8 times over. A ragged
// L masks the last tile's columns, and an L that is not a multiple of 4
// (rows not 16-byte aligned) stores word by word.
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

constexpr int WPB = 4, TPB = WPB * 32;  // warps, threads a block
constexpr int RPW = 2;                  // rows a warp
constexpr int TILE = 128;               // columns a warp (4 a lane)

__global__ void __launch_bounds__(TPB) expand8(const int32_t* __restrict__ x,
                                               const float* __restrict__ e8,
                                               int32_t* __restrict__ out, int R, int L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l0 = blockIdx.y * TILE + lane * 4;
  if (l0 >= L) return;
  const int nl = min(4, L - l0);
  const bool vec = nl == 4 && (L & 3) == 0;
  float e[4][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(e8 + j * L + l0));
      e[0][j] = v.x, e[1][j] = v.y, e[2][j] = v.z, e[3][j] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q][j] = q < nl ? __ldg(e8 + j * L + l0 + q) : 0.0f;
    }
  }
  const int r0 = (blockIdx.x * WPB + warp) * RPW;
  const int nr = min(RPW, R - r0);
  // every row of x the warp writes, loaded before any use (one round trip
  // for these and e8's words together)
  int4 xr[RPW][2];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i < nr) {
      const int4* row = reinterpret_cast<const int4*>(x + (size_t)(r0 + i) * 8);
      xr[i][0] = __ldg(row);
      xr[i][1] = __ldg(row + 1);
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i >= nr) break;
    const int xv[8] = {xr[i][0].x, xr[i][0].y, xr[i][0].z, xr[i][0].w,
                       xr[i][1].x, xr[i][1].y, xr[i][1].z, xr[i][1].w};
    float flo[8], fhi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      flo[j] = __int2float_rn(xv[j] & 255);
      fhi[j] = __int2float_rn(xv[j] >> 8);
    }
    int w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float lo = __fmul_rn(flo[0], e[q][0]), hi = __fmul_rn(fhi[0], e[q][0]);
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        lo = __fadd_rn(lo, __fmul_rn(flo[j], e[q][j]));
        hi = __fadd_rn(hi, __fmul_rn(fhi[j], e[q][j]));
      }
      w[q] = __float2int_rz(lo) + (__float2int_rz(hi) << 8);
    }
    int32_t* o = out + (size_t)(r0 + i) * L + l0;
    if (vec) {
      *reinterpret_cast<int4*>(o) = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nl) o[q] = w[q];
    }
  }
}

}  // namespace

// x: int32 [R, 8] (16-byte aligned rows), e8: f32 [8, L], out: int32 [R, L].
// One launch. Returns a cudaError_t.
extern "C" int helm_probe_expand8(const void* x, const void* e8, void* out, int R, int L,
                                  void* stream) {
  if (R <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + WPB * RPW - 1) / (WPB * RPW), (L + TILE - 1) / TILE);
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
