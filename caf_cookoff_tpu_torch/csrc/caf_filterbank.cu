// Fused CAF filterbank rows for Hopper (sm_90a).  Per doppler bin k:
//
//   s_k[n] = needle[n] * exp(j * rate_k * n)      n < N, zeros up to M
//   r_k    = IDFT(H . conj(DFT(s_k)))             unnormalised inverse
//
// K2, caf_filterbank_peak:    vals[k] = max_tau |r_k[tau]|^2 and idxs[k] =
//                              the lowest tau attaining it.
// K3, caf_filterbank_surface: surf[k, tau] = |r_k[tau]|^2 / M^2, lags in
//                              natural order.
//
// Replaces caf_cookoff_tpu/ops/pallas_caf.py::_caf_kernel (K2) and
// ::_caf_surface_kernel (K3).  The TPU kernels run a four-step DFT as bf16
// MXU matmuls in a (k1, k2) layout; here both transforms are f32 FFTs,
// written out below, at least as exact as either tier.
//
// What bounds it on this card.  At the main path's shape (K = 400 bins,
// M = 8192) the two transforms are 2 x 5 M log2 M = 1.06 MFLOP a bin, 0.43
// GFLOP in all (6.4 us at the f32 peak), while K2 reads ~100 KB and writes
// 3 KB; K3 also writes the 13.1 MB surface (3.9 us at the HBM rate).  What
// a row-per-block FFT really pays is shared-memory traffic, barriers and
// the chain of dependent work in each thread: the radix-2 design this
// replaces ran 25 passes and 25 barriers a bin, 8 butterflies a thread
// between barriers, with twiddles gathered from a global table at a
// stride that grew each pass (0.197 ms a launch on the H100).  And the
// grid: a 64 KB row fits 3 blocks a SM, so K = 400 on 132 SMs runs a
// second wave of 4 bins, which costs a whole bin's latency.
//
// Design.  The row transform below lives in fft_rows.cuh, which K5
// (stein_rescore.cu, the Stein exact re-score) shares.
// * Register-radix passes.  A block of T = L / 32 threads transforms L =
//   M / C points kept in shared memory; each thread holds 32 of them, as
//   two groups of 16.  Each pass a thread loads a group, runs a radix-16
//   DFT in registers (two radix-4 stages) and stores it back in place,
//   decimation in frequency, then a last pass of radix 2^(log2 L mod 4)
//   (or 16) on neighbouring points: L = 8192 is 16 x 16 x 16 x 2, four
//   passes a transform and 6 barriers a bin for both transforms.  The
//   twiddles W_{L_q}^{jk} of each radix-16 pass come from a table built
//   in f64 by the wrapper (15 x L_q / 16 complex64 a pass, k-major, so a
//   warp reads neighbouring j, coalesced; ~64 KB at L = 8192, L1/L2
//   resident); the last pass has none.  No __sincosf anywhere.  The row
//   is stored XOR-swizzled (p ^ ((p >> 4) & 15)), which keeps every
//   pass's accesses, strided or contiguous, free of bank conflicts,
//   without padding (64 KB, not 68, at L = 8192).
// * Fused edges.  The phasor shift and the zero upper half fold into the
//   first forward pass (it reads the needle, not shared memory; the upper
//   8 points of each group are zeros it never loads).  The last forward
//   pass, the product with H and the first inverse pass run in registers
//   on the same neighbours; H is stored by the wrapper in the order the
//   threads hold those points (slot-major, so a warp reads it coalesced).
//   The inverse runs the forward passes' adjoints in reverse order
//   (conjugate twiddles, then the inverse DFT), which takes the
//   digit-reversed spectrum back to natural order with no permutation.
//   K2 reduces (max, lowest lag) in registers during the last inverse
//   pass, then by warp shuffles; K3 stores from it, coalesced.
// * Clusters of C blocks a bin for rows past one block (C = M / 8192, up
//   to 16: M = 131072; C = 16 needs the non-portable cluster size).  The
//   row is split as a four-step DFT with a radix-C first step: block k1
//   forms, for its L points n2, W_M^{n2 k1} sum_{n1} s[n2 + L n1]
//   W_C^{n1 k1} straight from the needle (Horner in W_C^{k1}), transforms
//   it with the passes above (spectrum bins k1 + C f), takes the product
//   and the inverse, multiplies by W_M^{-t k1}, and the cluster finishes
//   with a C-point inverse DFT across blocks, each block reading its 1/C
//   of the lags from every block's shared memory (distributed shared
//   memory, between two cluster barriers).  The bin's (max, lowest lag) is
//   merged by cluster rank 0 from the blocks' own.  Splitting a row that
//   one block holds was measured slower at every K on the H100
//   (utils/fb_study.py times): a thread keeps 32 points at any L, so a
//   block's chain does not shorten, while each block recomputes C / 2
//   phasors a point and the cross-block step is added; so C is the
//   fewest blocks that hold the row, and K = 400 at M = 8192 keeps its
//   4-bin second wave.
// * Rows of 2 to 16 points (M < 32) take a kernel of their own: one thread
//   a bin holds the row in registers (the shifted needle, one radix-M DFT,
//   the product with H in natural order, the inverse DFT), 64 bins a block,
//   no shared memory.
// The phase is computed as the TPU kernel does, rate * float(n) with a
// precise sincosf.

#include "fft_rows.cuh"

namespace {

constexpr int kSmallThreads = 64;   // bins a block of the M < 32 kernel

template <int LOG_L, bool SURFACE>
__global__ void __launch_bounds__(Shape<LOG_L>::T, Shape<LOG_L>::MIN_BLOCKS)
    caf_filterbank_kernel(const float2* __restrict__ needle, int n_len,
                          const float2* __restrict__ h_k,
                          const float2* __restrict__ tw,
                          const float* __restrict__ rates, int log_c,
                          float* __restrict__ vals, int* __restrict__ idxs,
                          float* __restrict__ surf) {
  using S = Shape<LOG_L>;
  extern __shared__ float2 row[];
  const int k1 = blockIdx.x & ((1 << log_c) - 1);
  const int bin = blockIdx.x >> log_c;
  const int log_m = LOG_L + log_c;
  const size_t m = static_cast<size_t>(1) << log_m;
  const float inv_m = __int_as_float((127 - log_m) << 23);  // exact 1 / M
  const float scale = inv_m * inv_m;
  float* out = SURFACE ? surf + bin * m : nullptr;
  float best = -1.f;  // |r|^2 >= 0: any lag beats it
  int arg = INT_MAX;
  row_transform<LOG_L>(row, needle, n_len, h_k, tw, rates[bin], log_c, k1,
                       [&](int lag, float2 r) {
                         const float mag = r.x * r.x + r.y * r.y;
                         if (SURFACE)
                           out[lag] = mag * scale;
                         else
                           take(mag, lag, best, arg);
                       });
  if (SURFACE) {
    // No block leaves while another reads its row.
    if (log_c > 0) cg::this_cluster().sync();
    return;
  }
  row_best<S::T>(best, arg, log_c, k1);
  if (k1 == 0 && threadIdx.x == 0) {
    vals[bin] = best;
    idxs[bin] = arg;
  }
}

// Rows of L = 2^LOG_L <= 16 points (C = 1): thread `bin` holds its row in
// registers; H is in natural order.
template <int LOG_L, bool SURFACE>
__global__ void __launch_bounds__(kSmallThreads)
    caf_filterbank_small_kernel(const float2* __restrict__ needle, int n_len,
                                const float2* __restrict__ h,
                                const float* __restrict__ rates, int k,
                                float* __restrict__ vals,
                                int* __restrict__ idxs,
                                float* __restrict__ surf) {
  constexpr int L = 1 << LOG_L;
  const int bin = blockIdx.x * kSmallThreads + threadIdx.x;
  if (bin >= k) return;
  const float rate = rates[bin];
  float2 v[L];
#pragma unroll
  for (int i = 0; i < L; ++i)
    v[i] = i < n_len ? phasor(needle, rate, i) : make_float2(0.f, 0.f);
  dft<L, false>(v);
#pragma unroll
  for (int i = 0; i < L; ++i) v[i] = cmul_conj(__ldg(&h[i]), v[i]);
  dft<L, true>(v);
  const float inv_l = __int_as_float((127 - LOG_L) << 23);  // exact 1 / M
  float best = -1.f;
  int arg = INT_MAX;
#pragma unroll
  for (int p = 0; p < L; ++p) {
    const float mag = v[p].x * v[p].x + v[p].y * v[p].y;
    if (SURFACE)
      surf[static_cast<size_t>(bin) * L + p] = mag * (inv_l * inv_l);
    else
      take(mag, p, best, arg);
  }
  if (!SURFACE) {
    vals[bin] = best;
    idxs[bin] = arg;
  }
}

// One call of the C interface: a launch of K2 or K3, or an occupancy query.
struct Call {
  bool surface;
  bool query;
  const float2* needle;
  int n;
  const float2* h_k;
  const float2* tw;
  const float* rates;
  int k;
  int log_c;
  float* vals;
  int* idxs;
  float* surf;
  cudaStream_t stream;
  int* blocks;
  int* clusters;
};

// The kernel's attributes, set once (host time a launch would repeat).
template <int LOG_L, bool SURFACE>
cudaError_t prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kernel = caf_filterbank_kernel<LOG_L, SURFACE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape<LOG_L>::SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = err == cudaSuccess;
  return err;
}

template <int LOG_L, bool SURFACE>
cudaError_t run(const Call& a) {
  using S = Shape<LOG_L>;
  auto kernel = caf_filterbank_kernel<LOG_L, SURFACE>;
  const int c = 1 << a.log_c;
  cudaError_t err = prepare<LOG_L, SURFACE>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.query ? c : a.k * c);
  cfg.blockDim = dim3(S::T);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c > 1 ? 1 : 0;
  if (a.query) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks, kernel,
                                                        S::T, S::SMEM);
    *a.clusters = -1;
    if (err != cudaSuccess || c == 1) return err;
    return cudaOccupancyMaxActiveClusters(a.clusters, kernel, &cfg);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a.needle, a.n, a.h_k, a.tw,
                           a.rates, a.log_c, a.vals, a.idxs, a.surf);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int LOG_L, bool SURFACE>
cudaError_t run_small(const Call& a) {
  auto kernel = caf_filterbank_small_kernel<LOG_L, SURFACE>;
  if (a.log_c != 0) return cudaErrorInvalidValue;
  if (a.query) {
    *a.clusters = -1;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks, kernel,
                                                        kSmallThreads, 0);
  }
  kernel<<<(a.k + kSmallThreads - 1) / kSmallThreads, kSmallThreads, 0,
           a.stream>>>(a.needle, a.n, a.h_k, a.rates, a.k, a.vals, a.idxs,
                       a.surf);
  return cudaGetLastError();
}

template <int LOG_L>
cudaError_t run(const Call& a) {
  if constexpr (LOG_L < kMinLogL)
    return a.surface ? run_small<LOG_L, true>(a) : run_small<LOG_L, false>(a);
  else
    return a.surface ? run<LOG_L, true>(a) : run<LOG_L, false>(a);
}

// Runs the call at LOG_L = log2(m / c), or returns cudaErrorInvalidValue
// for a shape outside the kernel's range.
cudaError_t dispatch(int m, int c, Call a) {
  const int log_c = log2_exact(c), log_m = log2_exact(m);
  if (log_c < 0 || log_c > kMaxLogC || log_m < 0) return cudaErrorInvalidValue;
  a.log_c = log_c;
  switch (log_m - log_c) {
    case 1: return run<1>(a);
    case 2: return run<2>(a);
    case 3: return run<3>(a);
    case 4: return run<4>(a);
    case 5: return run<5>(a);
    case 6: return run<6>(a);
    case 7: return run<7>(a);
    case 8: return run<8>(a);
    case 9: return run<9>(a);
    case 10: return run<10>(a);
    case 11: return run<11>(a);
    case 12: return run<12>(a);
    case 13: return run<13>(a);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(kMinLogL == 5 && kMaxLogL == 13, "dispatch covers 1..13");

}  // namespace

extern "C" {

// Shapes (contiguous): needle (n,) complex64; h_k (m,) complex64, the DFT
// of the zero-padded haystack in the kernel's order for cluster size c
// (ops/pallas_caf._h_order); tw, the block passes' twiddle tables for
// L = m / c (ops/pallas_caf._twiddle_table); rates (k,) f32.  m and c are
// powers of two with 32 <= m / c <= 8192 and c <= 16, or 2 <= m < 32 and
// c = 1; n <= m / 2.  K2 writes vals (k,) f32 and idxs (k,) int32; K3
// writes surf (k, m) f32.  One launch (k * c blocks; for m < 32, k / 64
// rounded up) on `stream`, on the calling thread's current device;
// returns the CUDA error (0 on success).
int caf_filterbank_peak(const void* needle, int n, const void* h_k,
                        const void* tw, const void* rates, int k, int m,
                        int c, void* vals, void* idxs, void* stream) {
  return dispatch(m, c, Call{false, false,
                             static_cast<const float2*>(needle), n,
                             static_cast<const float2*>(h_k),
                             static_cast<const float2*>(tw),
                             static_cast<const float*>(rates), k, 0,
                             static_cast<float*>(vals),
                             static_cast<int*>(idxs), nullptr,
                             static_cast<cudaStream_t>(stream), nullptr,
                             nullptr});
}

int caf_filterbank_surface(const void* needle, int n, const void* h_k,
                           const void* tw, const void* rates, int k, int m,
                           int c, void* surf, void* stream) {
  return dispatch(m, c, Call{true, false,
                             static_cast<const float2*>(needle), n,
                             static_cast<const float2*>(h_k),
                             static_cast<const float2*>(tw),
                             static_cast<const float*>(rates), k, 0, nullptr,
                             nullptr, static_cast<float*>(surf),
                             static_cast<cudaStream_t>(stream), nullptr,
                             nullptr});
}

// Blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of K2
// (surface = 0) or K3 at (m, c), and for c > 1 the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters; -1 for c = 1).
int caf_filterbank_occupancy(int surface, int m, int c, int* blocks,
                             int* clusters) {
  return dispatch(m, c, Call{surface != 0, true, nullptr, 0, nullptr,
                             nullptr, nullptr, 0, 0, nullptr, nullptr,
                             nullptr, nullptr, blocks, clusters});
}

}  // extern "C"
