// The Stein engines' exact re-score for Hopper (sm_90a), K5.  Per pair p of
// a batch, from the coarse ranking v_p (K values, one a doppler bin):
//
//   candidates  the 8 plain picks of v_p (descending, equal values lowest
//               bin first, at most num_valid of them), then the 4
//               mainlobe-separated picks (greedy, |i - j| <= sep
//               suppressed, surplus slots 0), sep = doppler_cell_bins;
//   rows        per candidate bin f: s[n] = needle_p[n] exp(j rate n),
//               rate = 2 pi (f / fs) in f32, r = IDFT(H_p conj(DFT(s))),
//               the (max, lowest lag) of |r|^2 / M^2 over lags <= the
//               pair's bound;
//   pick        the highest value; exact ties to the lowest bin, then the
//               first slot.
//
// Replaces no Pallas kernel.  It replaces the XLA re-score of the JAX
// package's _refine_topk (caf_cookoff_tpu/models/stein.py:225), which the
// port had run as plain torch and cuFFT (ops/stein_rescore.rescore_plain):
// a stable sort of the ranking, four argmax / where rounds, the phasor
// bank, the shifted needle's pad and FFT, the product, the inverse FFT,
// |.|^2, amax, argmax and the pick: 81 device operations a call at the
// benchmark's shapes, which materialise a (P, 12, M) complex64 tensor
// about ten times (0.7 GB at P = 64, M = 8192).
//
// What bounds it on this card.  The work is 12 P rows of two M-point
// transforms, 2 x 5 M log2 M = 1.06 MFLOP a row at M = 8192: 0.82 GFLOP at
// P = 64, 12 us at the f32 peak, against ~6 MB read (needles, spectra,
// ranking) and 36 bytes a pair written.  A transform's chain of dependent
// passes in one block sets the time of a row (~16 us at M = 8192, as in
// K2), so at small P the card waits on one row's latency, and at P = 64
// the 768 rows fill 132 SMs at 3 blocks an SM in two waves.
//
// Design.  Three launches, nothing of a row in device memory.
// * Candidates: one block a pair; each pick but the first separated one
//   (the first plain pick again) is one pass over the ranking (L1- and
//   L2-resident) with a block (max, lowest index) reduction, the
//   exclusions (earlier plain picks; the separated picks' +-sep) tested
//   against the picks kept in shared memory.  sep is computed as
//   doppler_cell_bins does, in f32 (IEEE quotient, ceil, clamp).
// * Rows: one block (past M = 8192, a cluster of M / 8192 blocks) a (pair,
//   candidate), on K2's row transform (fft_rows.cuh: register-radix passes,
//   swizzled shared row, f64-built twiddles, H in the threads' order; the
//   phasor folded into the first forward pass, the product and the
//   inverse's first pass in registers), reducing (max, lowest lag) in
//   registers, then by warp shuffles and across the cluster.  The value is
//   scaled by 1 / M^2, exact for a power of two.  The pair's H is one
//   batched torch.fft.fft outside the kernel, gathered into K2's order.
// * Pick: one thread a pair over its 12 (value, lag) slots.

#include "fft_rows.cuh"

namespace {

constexpr int kCandThreads = 256;   // a candidates block
constexpr int kMaxSlots = 16;       // picks a pair (8 plain + 4 separated)
constexpr int kPickThreads = 128;   // pairs a pick block

// One block a pair: cand[p, 0..n_plain) the plain picks, then
// cand[p, n_plain..n_plain + n_sep) the separated ones.
__global__ void __launch_bounds__(kCandThreads)
    rescore_candidates_kernel(const float* __restrict__ ranking, int k,
                              int n_plain, int n_sep,
                              const float* __restrict__ freqs, int k_grid,
                              float cell, int* __restrict__ cand) {
  __shared__ int picks[kMaxSlots];
  const float* v = ranking + static_cast<size_t>(blockIdx.x) * k;
  // The mainlobe in bins, as doppler_cell_bins takes it in f32.
  const float step = fmaxf(fabsf(freqs[min(1, k_grid - 1)] - freqs[0]),
                           1e-30f);
  const int sep = static_cast<int>(fminf(
      fmaxf(ceilf(__fdiv_rn(cell, step)), 1.f), static_cast<float>(k_grid)));
  const int slots = n_plain + n_sep;
  for (int r = 0; r < slots; ++r) {
    const bool plain = r < n_plain;
    if (r == n_plain) {
      // The first separated pick, nothing suppressed yet, is the first
      // plain one: the highest value, the lowest bin among equals.
      if (threadIdx.x == 0) {
        picks[r] = picks[0];
        cand[static_cast<size_t>(blockIdx.x) * slots + r] = picks[0];
      }
      __syncthreads();
      continue;
    }
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int j = threadIdx.x; j < k; j += kCandThreads) {
      float x = v[j];
      bool out = false;
      if (plain) {
        for (int s = 0; s < r; ++s) out |= picks[s] == j;
        if (out) continue;   // a plain pick is taken once
      } else {
        for (int s = n_plain; s < r; ++s) out |= abs(j - picks[s]) <= sep;
        if (out) x = -INFINITY;   // suppressed, as topk_separated's where
      }
      take(x, j, bv, bi);
    }
    block_best<kCandThreads>(bv, bi);
    if (threadIdx.x == 0) {
      picks[r] = bi;
      cand[static_cast<size_t>(blockIdx.x) * slots + r] = bi;
    }
    __syncthreads();
  }
}

// One block (C = 2^log_c blocks a cluster) a (pair, slot) row r = p slots
// + s: (max |r|^2 / M^2, lowest lag) over lags <= bounds[p] (M - 1 without
// bounds) into vals[r], lags[r]; -1 and lag 0 when no lag is in bounds.
template <int LOG_L>
__global__ void __launch_bounds__(Shape<LOG_L>::T, Shape<LOG_L>::MIN_BLOCKS)
    rescore_rows_kernel(const float2* __restrict__ needles, int n_len,
                        const float2* __restrict__ h_k,
                        const float2* __restrict__ tw,
                        const float* __restrict__ freqs, float two_pi,
                        float fs, const int* __restrict__ cand, int slots,
                        const int* __restrict__ bounds, int log_c,
                        float* __restrict__ vals, int* __restrict__ lags) {
  extern __shared__ float2 row[];
  const int k1 = blockIdx.x & ((1 << log_c) - 1);
  const int r = blockIdx.x >> log_c;
  const int pair = r / slots;
  const int log_m = LOG_L + log_c;
  const int bound = bounds ? bounds[pair] : (1 << log_m) - 1;
  // rate = 2 pi (f / fs), each step one rounding in f32 (_phase_ramp).
  const float rate = __fmul_rn(two_pi, __fdiv_rn(freqs[cand[r]], fs));
  float best = -1.f;  // |r|^2 >= 0: any lag in bounds beats it
  int arg = INT_MAX;
  row_transform<LOG_L>(
      row, needles + static_cast<size_t>(pair) * n_len, n_len,
      h_k + (static_cast<size_t>(pair) << log_m), tw, rate, log_c, k1,
      [&](int lag, float2 x) {
        if (lag <= bound) take(x.x * x.x + x.y * x.y, lag, best, arg);
      });
  row_best<Shape<LOG_L>::T>(best, arg, log_c, k1);
  if (k1 == 0 && threadIdx.x == 0) {
    const float inv_m = __int_as_float((127 - log_m) << 23);  // exact 1 / M
    const bool none = arg == INT_MAX;
    vals[r] = none ? -1.f : best * (inv_m * inv_m);
    lags[r] = none ? 0 : arg;
  }
}

// One thread a pair: the slot with the highest value, exact ties to the
// lowest bin, then the first slot.
__global__ void __launch_bounds__(kPickThreads)
    rescore_pick_kernel(const float* __restrict__ vals,
                        const int* __restrict__ lags,
                        const int* __restrict__ cand, int p, int slots,
                        float* __restrict__ value, int* __restrict__ freq_idx,
                        int* __restrict__ lag_idx) {
  const int pair = blockIdx.x * kPickThreads + threadIdx.x;
  if (pair >= p) return;
  const size_t base = static_cast<size_t>(pair) * slots;
  float bv = vals[base];
  int bc = cand[base], bs = 0;
  for (int s = 1; s < slots; ++s) {
    const float x = vals[base + s];
    const int c = cand[base + s];
    if (x > bv || (x == bv && c < bc)) {
      bv = x;
      bc = c;
      bs = s;
    }
  }
  value[pair] = bv;
  freq_idx[pair] = bc;
  lag_idx[pair] = lags[base + bs];
}

struct Rescore {
  const float* ranking;
  int k, n_plain, n_sep;
  const float* freqs;
  int k_grid;
  float cell, two_pi, fs;
  const float2* needles;
  int n;
  const float2* h_k;
  const float2* tw;
  const int* bounds;
  int p, log_c;
  int* cand;
  float* vals;
  int* lags;
  float* value;
  int* freq_idx;
  int* lag_idx;
  cudaStream_t stream;
};

// The rows kernel's shared memory and cluster attributes, set at every
// launch, as K1 sets its own, so that every card a process drives has
// them (a flag kept once a process would hold for the first card alone);
// a graph replay runs no host code.
template <int LOG_L>
cudaError_t prepare_rows() {
  auto kernel = rescore_rows_kernel<LOG_L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape<LOG_L>::SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int LOG_L>
cudaError_t run_rows(const Rescore& a) {
  using S = Shape<LOG_L>;
  cudaError_t err = prepare_rows<LOG_L>();
  if (err != cudaSuccess) return err;
  const int c = 1 << a.log_c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p * (a.n_plain + a.n_sep) * c);
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
  return cudaLaunchKernelEx(&cfg, rescore_rows_kernel<LOG_L>, a.needles,
                            a.n, a.h_k, a.tw, a.freqs, a.two_pi, a.fs,
                            a.cand, a.n_plain + a.n_sep, a.bounds, a.log_c,
                            a.vals, a.lags);
}

cudaError_t rows(int log_l, const Rescore& a) {
  switch (log_l) {
    case 5: return run_rows<5>(a);
    case 6: return run_rows<6>(a);
    case 7: return run_rows<7>(a);
    case 8: return run_rows<8>(a);
    case 9: return run_rows<9>(a);
    case 10: return run_rows<10>(a);
    case 11: return run_rows<11>(a);
    case 12: return run_rows<12>(a);
    case 13: return run_rows<13>(a);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(kMinLogL == 5 && kMaxLogL == 13, "rows covers 5..13");

cudaError_t rescore(int m, int c, Rescore a) {
  const int log_c = log2_exact(c), log_m = log2_exact(m);
  const int slots = a.n_plain + a.n_sep;
  if (log_c < 0 || log_c > kMaxLogC || log_m < 0 ||
      log_m - log_c < kMinLogL || log_m - log_c > kMaxLogL || a.p < 1 ||
      a.k < 1 || a.n_plain < 1 || a.n_sep < 0 || slots > kMaxSlots ||
      a.n > m)
    return cudaErrorInvalidValue;
  a.log_c = log_c;
  rescore_candidates_kernel<<<a.p, kCandThreads, 0, a.stream>>>(
      a.ranking, a.k, a.n_plain, a.n_sep, a.freqs, a.k_grid, a.cell, a.cand);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = rows(log_m - log_c, a);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rescore_pick_kernel<<<(a.p + kPickThreads - 1) / kPickThreads,
                        kPickThreads, 0, a.stream>>>(
      a.vals, a.lags, a.cand, a.p, slots, a.value, a.freq_idx, a.lag_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes (contiguous): ranking (p, k) f32; freqs (k_grid,) f32, the grid
// the ranking's bins index; needles (p, n) complex64, n <= m; h_k (p, m)
// complex64, each pair's DFT of its zero-padded haystack in K2's order for
// cluster size c (ops/pallas_caf._h_order); tw, K2's twiddle tables for
// L = m / c; bounds (p,) int32 inclusive lag bounds, or null for m - 1.
// cell = f32(fs) / f32(needle length) and two_pi = f32(2 pi), fs = f32(fs).
// m and c are powers of two, 32 <= m / c <= 8192, c <= 16; 1 <= n_plain,
// n_plain + n_sep <= 16.  Writes cand, vals, lags (p, n_plain + n_sep)
// (int32, f32, int32) and the answer value, freq_idx, lag_idx (p,) (f32,
// int32, int32).  Three launches on `stream`, on the calling thread's
// current device; returns the CUDA error (0 on success).
int caf_stein_rescore(const void* ranking, int k, int n_plain, int n_sep,
                      const void* freqs, int k_grid, float cell,
                      float two_pi, float fs, const void* needles, int n,
                      const void* h_k, const void* tw, const void* bounds,
                      int p, int m, int c, void* cand, void* vals,
                      void* lags, void* value, void* freq_idx, void* lag_idx,
                      void* stream) {
  return rescore(m, c, Rescore{static_cast<const float*>(ranking), k,
                               n_plain, n_sep,
                               static_cast<const float*>(freqs), k_grid,
                               cell, two_pi, fs,
                               static_cast<const float2*>(needles), n,
                               static_cast<const float2*>(h_k),
                               static_cast<const float2*>(tw),
                               static_cast<const int*>(bounds), p, 0,
                               static_cast<int*>(cand),
                               static_cast<float*>(vals),
                               static_cast<int*>(lags),
                               static_cast<float*>(value),
                               static_cast<int*>(freq_idx),
                               static_cast<int*>(lag_idx),
                               static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
