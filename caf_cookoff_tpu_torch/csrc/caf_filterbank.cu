// Fused CAF filterbank rows for Hopper (sm_90a).  Per doppler bin k:
//
//   s_k[n] = needle[n] * exp(j * rate_k * n)      n < N, zeros up to M
//   r_k    = IDFT(H . conj(DFT(s_k)))             unnormalised inverse
//
// K2, caf_filterbank_peak:    vals[k] = max_tau |r_k[tau]|^2 and idxs[k] =
//                              the lowest tau attaining it.
// K3, caf_filterbank_surface: surf[k, tau] = |r_k[tau]|^2 / M^2, natural order.
//
// Replaces caf_cookoff_tpu/ops/pallas_caf.py::_caf_kernel (K2) and
// ::_caf_surface_kernel (K3).  The TPU kernels run a four-step DFT as bf16
// MXU matmuls in a (k1, k2) layout; here both transforms are radix-2 FFTs
// in f32, written out below, which is at least as exact as either tier.
//
// What bounds it on this card: arithmetic.  At the main path's shape
// (K = 400 bins, M = 8192) the two transforms are 2 x 5 M log2 M = 1.06
// MFLOP per bin, 0.43 GFLOP in all, while K2 reads ~100 KB (needle, H,
// twiddles) and writes 3 KB; K3 also writes the 13.1 MB surface.  In
// practice the radix-2 passes are bound by shared-memory traffic and the
// block barrier between passes, not by the FMA units.
//
// Design.  One block of kThreads owns one bin and keeps its M-point
// complex f32 row in shared memory (64 KB at M = 8192, 128 KB at 16384;
// the wrapper refuses larger M).  The forward transform is a decimation-
// in-frequency FFT, which leaves the spectrum in bit-reversed order; the
// wrapper stores H in that same order, and the inverse is a decimation-in-
// time FFT that takes bit-reversed input and returns natural order, so no
// permutation runs in the kernel (the Hopper form of the TPU kernel's
// "no reorder" layout).  Since s_k is zero past M/2, the first forward
// pass is folded into the load; the last forward pass, the product with
// H and the first inverse pass touch only neighbouring pairs and run in
// registers.  Twiddles exp(-2 pi i j / M), j < M/2, come from a table
// built in f64 on the host and stored as f32.  The phase is computed as
// the TPU kernel does, rate * float(n) with a precise sincosf.  Blocks
// run in no order, so each bin's (max, lowest lag) is reduced inside its
// block: per thread, then by warp shuffles, then across warps, always
// preferring the lower lag on equal values.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float2 cmul_conj_b(float2 a, float2 b) {
  // a * conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// Builds the DIF spectrum of the shifted, zero-padded needle in x[0, m),
// multiplies it by h_br (both bit-reversed) and runs the DIT inverse:
// on return x holds r_k in natural order (all threads synchronised).
__device__ void correlate_row(float2* x, const float2* __restrict__ needle,
                              int n, const float2* __restrict__ h_br,
                              const float2* __restrict__ tw, float rate,
                              int m) {
  const int half = m >> 1;
  // Load + first DIF pass (h = m/2): the second half of s_k is zero, so
  // the butterfly gives (s, s * tw[i]).
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    float2 v = make_float2(0.f, 0.f);
    if (i < n) {
      const float2 a = needle[i];
      float sn, cs;
      sincosf(rate * static_cast<float>(i), &sn, &cs);
      v = make_float2(a.x * cs - a.y * sn, a.x * sn + a.y * cs);
    }
    const float2 w = __ldg(&tw[i]);
    x[i] = v;
    x[i + half] = make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
  }
  __syncthreads();
  // DIF passes h = m/4 .. 2: butterfly b pairs i = (b / h) * 2h + j and
  // i + h, j = b mod h, twiddle exp(-2 pi i j / 2h) = tw[j * m / 2h].
  for (int h = m >> 2, stride = 2; h >= 2; h >>= 1, stride <<= 1) {
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int j = b & (h - 1);
      const int i = ((b - j) << 1) + j;
      const float2 a = x[i], c = x[i + h];
      const float2 w = __ldg(&tw[j * stride]);
      const float dr = a.x - c.x, di = a.y - c.y;
      x[i] = make_float2(a.x + c.x, a.y + c.y);
      x[i + h] = make_float2(dr * w.x - di * w.y, dr * w.y + di * w.x);
    }
    __syncthreads();
  }
  // Last DIF pass (h = 1; already done by the load when m == 2), the
  // product P = H conj(S), and the first DIT pass (h = 1), pair by pair.
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    float2 s0 = x[2 * p], s1 = x[2 * p + 1];
    if (m > 2) {
      const float2 u = make_float2(s0.x + s1.x, s0.y + s1.y);
      s1 = make_float2(s0.x - s1.x, s0.y - s1.y);
      s0 = u;
    }
    const float2 p0 = cmul_conj_b(__ldg(&h_br[2 * p]), s0);
    const float2 p1 = cmul_conj_b(__ldg(&h_br[2 * p + 1]), s1);
    x[2 * p] = make_float2(p0.x + p1.x, p0.y + p1.y);
    x[2 * p + 1] = make_float2(p0.x - p1.x, p0.y - p1.y);
  }
  __syncthreads();
  // DIT passes h = 2 .. m/2 with conjugate twiddles: t = c * conj(w),
  // (a + t, a - t).
  for (int h = 2, stride = m >> 2; h < m; h <<= 1, stride >>= 1) {
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int j = b & (h - 1);
      const int i = ((b - j) << 1) + j;
      const float2 a = x[i];
      const float2 t = cmul_conj_b(x[i + h], __ldg(&tw[j * stride]));
      x[i] = make_float2(a.x + t.x, a.y + t.y);
      x[i + h] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// K2.  grid (K), kThreads threads, m * 8 bytes of dynamic shared memory.
__global__ void __launch_bounds__(kThreads) caf_peak_rows_kernel(
    const float2* __restrict__ needle, int n,
    const float2* __restrict__ h_br, const float2* __restrict__ tw,
    const float* __restrict__ rates, int m, float* __restrict__ vals,
    int* __restrict__ idxs) {
  extern __shared__ float2 row[];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  const int k = blockIdx.x;
  correlate_row(row, needle, n, h_br, tw, rates[k], m);

  float best = -1.f;  // |r|^2 >= 0: any lag beats it
  int arg = INT_MAX;
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const float2 v = row[t];
    const float p = v.x * v.x + v.y * v.y;
    if (better(p, t, best, arg)) {
      best = p;
      arg = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, arg, off);
    if (better(ov, oi, best, arg)) {
      best = ov;
      arg = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = arg;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kWarps ? s_val[lane] : -1.f;
    arg = lane < kWarps ? s_idx[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, arg, off);
      if (better(ov, oi, best, arg)) {
        best = ov;
        arg = oi;
      }
    }
    if (lane == 0) {
      vals[k] = best;
      idxs[k] = arg;
    }
  }
}

// K3.  grid (K), kThreads threads, m * 8 bytes of dynamic shared memory.
__global__ void __launch_bounds__(kThreads) caf_surface_kernel(
    const float2* __restrict__ needle, int n,
    const float2* __restrict__ h_br, const float2* __restrict__ tw,
    const float* __restrict__ rates, int m, float* __restrict__ surf) {
  extern __shared__ float2 row[];
  const int k = blockIdx.x;
  correlate_row(row, needle, n, h_br, tw, rates[k], m);
  const float inv_m = 1.f / static_cast<float>(m);  // exact: m = 2^p
  const float scale = inv_m * inv_m;
  float* out = surf + static_cast<size_t>(k) * m;
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const float2 v = row[t];
    out[t] = (v.x * v.x + v.y * v.y) * scale;
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Shapes (contiguous): needle (n,) complex64; h_br (m,) complex64, the DFT
// of the zero-padded haystack in bit-reversed order; tw (m/2,) complex64,
// tw[j] = exp(-2 pi i j / m); rates (k,) f32.  m is a power of two >= 2
// with n <= m/2 and m * 8 bytes within the block's shared memory.  K2
// writes vals (k,) f32 and idxs (k,) int32; K3 writes surf (k, m) f32.
// One launch on `stream`, on the calling thread's current device; returns
// the CUDA error (0 on success).
int caf_filterbank_peak(const void* needle, int n, const void* h_br,
                        const void* tw, const void* rates, int k, int m,
                        void* vals, void* idxs, void* stream) {
  const size_t smem = static_cast<size_t>(m) * sizeof(float2);
  cudaError_t err = prepare(caf_peak_rows_kernel, smem);
  if (err != cudaSuccess) return err;
  caf_peak_rows_kernel<<<k, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(needle), n,
      static_cast<const float2*>(h_br), static_cast<const float2*>(tw),
      static_cast<const float*>(rates), m, static_cast<float*>(vals),
      static_cast<int*>(idxs));
  return cudaGetLastError();
}

int caf_filterbank_surface(const void* needle, int n, const void* h_br,
                           const void* tw, const void* rates, int k, int m,
                           void* surf, void* stream) {
  const size_t smem = static_cast<size_t>(m) * sizeof(float2);
  cudaError_t err = prepare(caf_surface_kernel, smem);
  if (err != cudaSuccess) return err;
  caf_surface_kernel<<<k, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(needle), n,
      static_cast<const float2*>(h_br), static_cast<const float2*>(tw),
      static_cast<const float*>(rates), m, static_cast<float*>(surf));
  return cudaGetLastError();
}

}  // extern "C"
