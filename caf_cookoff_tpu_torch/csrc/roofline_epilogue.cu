// The fused Stein rank's |R|^2 / running-max epilogue as a microbenchmark
// for Hopper (sm_90a): what that op mix runs at on this card, on data held
// on chip, with no tensor-core work and no device-memory traffic per sweep.
//
// Replaces docs/roofline_vpu.py::kern, the TPU's VPU roofline of the same
// epilogue (a (416, 8192) f32 pair in VMEM, 64 sweeps of mul, fma and max,
// one row reduce).
//
// Element (r, c) of a (rows, cols) pair is filled once, in registers, from
// its indices and a seed, as the TPU kernel fills its scratch:
//   x = (r * 1e-3 + c * 1e-6) + seed,   y = (c * 1e-3 - r * 1e-6) + seed
// Sweep s (s < kSweeps) then computes |R|^2 = mag2_rn(x + d_s, y + d_s)
// with d_s = (s + 1) * 2^-20 and folds it into the element's running max;
// out[r] is the max over the row's elements, reduced per block and merged
// with atomicMax (|R|^2 >= 0, so the float order is the int order).
//
// The offsets d_s keep the compiler (nvcc and ptxas) from folding the
// identical sweeps into one: every sweep works on distinct values.  So a
// sweep executes, per element, 6 f32 operations: the 2 offset adds, the
// 2 mul and 1 add of |R|^2 (explicitly rounded, no fma, as K1's mag2_rn)
// and 1 max.  The epilogue proper is the last 4.
//
// What bounds it: f32 issue.  No operand comes from memory after the fill:
// each thread keeps 8 elements (x, y and the running max) in registers,
// 8 independent chains a sweep; 256 threads a block, so a (416, 8192) pair
// is 1664 blocks, ~12.6 an SM, whose tail costs ~3%.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 8;                    // elements a thread
constexpr int kCols = kThreads * kElems;     // columns a block
constexpr float kStep = 1.0f / 1048576.0f;  // 2^-20, exact in f32

__device__ __forceinline__ float mag2_rn(float rr, float ri) {
  return __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
}

// grid (ceil(cols / kCols), rows); out (rows,) must start at 0.  Thread t
// of block x owns columns x*kCols + t + e*kThreads, e < kElems.
template <int kSweeps>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(float* __restrict__ out, int cols, float seed) {
  const int row = blockIdx.y;
  const int col0 = blockIdx.x * kCols + threadIdx.x;
  const float fr = static_cast<float>(row);
  float x[kElems], y[kElems], acc[kElems];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const float fc = static_cast<float>(col0 + e * kThreads);
    x[e] = __fadd_rn(__fadd_rn(__fmul_rn(fr, 1e-3f), __fmul_rn(fc, 1e-6f)),
                     seed);
    y[e] = __fadd_rn(__fsub_rn(__fmul_rn(fc, 1e-3f), __fmul_rn(fr, 1e-6f)),
                     seed);
    acc[e] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kSweeps; ++s) {
    const float d = static_cast<float>(s + 1) * kStep;
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      acc[e] = fmaxf(acc[e], mag2_rn(__fadd_rn(x[e], d), __fadd_rn(y[e], d)));
  }
  // The row reduce: the thread's columns inside the row, the warp, the
  // block, then across the row's blocks.
  float best = 0.f;
#pragma unroll
  for (int e = 0; e < kElems; ++e)
    if (col0 + e * kThreads < cols) best = fmaxf(best, acc[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(out) + row, __float_as_int(m));
  }
}

}  // namespace

extern "C" {

// out: (rows,) f32 on the current device, zeroed by the caller; sweeps is
// 1 or 64 (the two compiled variants; the difference of their times is
// 63 sweeps without the fill, the reduce or the launch).  Enqueues one
// launch on `stream`; returns the CUDA error (0 on success, 1 for an
// unsupported sweep count).
int caf_epilogue_roofline(void* out, int rows, int cols, int sweeps,
                          float seed, void* stream) {
  const dim3 grid((cols + kCols - 1) / kCols, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (sweeps == 64) {
    epilogue_kernel<64><<<grid, kThreads, 0, s>>>(o, cols, seed);
  } else if (sweeps == 1) {
    epilogue_kernel<1><<<grid, kThreads, 0, s>>>(o, cols, seed);
  } else {
    return 1;
  }
  return cudaGetLastError();
}

}  // extern "C"
