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
// Design.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kMinLogL = 5;   // L = 32 .. 8192 points a block
constexpr int kMaxLogL = 13;
constexpr int kMaxLogC = 4;   // clusters of up to 16 blocks
constexpr int kSmallThreads = 64;   // bins a block of the M < 32 kernel

// A block of L points: NPASS - 1 radix-16 passes (SEQ groups of 16 a
// thread), then a last pass of radix RL = 2^(log2 L mod 4), or 16, on
// neighbouring points (16 SEQ / RL groups a thread), fused with the
// product.
template <int LOG_L>
struct Shape {
  static constexpr int L = 1 << LOG_L;
  static constexpr int SEQ = 2;                   // 16-point groups a thread
  static constexpr int T = L / (16 * SEQ);        // threads a block
  static constexpr int LOG_RL = LOG_L % 4 == 0 ? 4 : LOG_L % 4;
  static constexpr int RL = 1 << LOG_RL;          // last pass's radix
  static constexpr int NPASS = 1 + (LOG_L - LOG_RL) / 4;
  static constexpr int GL = 16 * SEQ / RL;        // last-pass groups a thread
  // Blocks an SM can hold by shared memory (228 KB, 1 KB reserved a block).
  static constexpr int BY_SMEM = (228 * 1024) / (L * 8 + 1024 + 256);
  static constexpr int MIN_BLOCKS = BY_SMEM < 32 ? BY_SMEM : 32;
  static constexpr size_t SMEM = static_cast<size_t>(L) * sizeof(float2);
};

__device__ __forceinline__ int swz(int p) { return p ^ ((p >> 4) & 15); }

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
template <bool INV>
__device__ __forceinline__ float2 twist(float2 a, float2 w) {
  return INV ? cmul_conj(a, w) : cmul(a, w);
}
// a * (-i) forward, a * (+i) inverse
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// exp(-2 pi i e / 2^log_den), exact to the precise sincospif.
__device__ __forceinline__ float2 root(int e, int log_den) {
  e &= (1 << log_den) - 1;
  float s, c;
  sincospif(__int2float_rn(e) * __int_as_float((128 - log_den) << 23), &s,
            &c);  // e * 2^(1 - log_den)
  return make_float2(c, -s);
}

// cos and sin of 2 pi m / 16, m = 0..15.
__device__ __forceinline__ float2 w16(int m, bool inv) {
  constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508978f;
  constexpr float r2 = 0.70710678118654752f;
  const float cs[16] = {1.f, c1, r2, s1, 0.f, -s1, -r2, -c1,
                        -1.f, -c1, -r2, -s1, 0.f, s1, r2, c1};
  const float c = cs[m & 15], s = cs[(m + 12) & 15];  // sin = cos(x - pi/2)
  return make_float2(c, inv ? s : -s);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2,
                                     float2& x3) {
  const float2 t0 = add(x0, x2), t1 = sub(x0, x2), t2 = add(x1, x3);
  const float2 t3 = rot<INV>(sub(x1, x3));
  x0 = add(t0, t2);
  x2 = sub(t0, t2);
  x1 = add(t1, t3);
  x3 = sub(t1, t3);
}

// In-place R-point DFT, natural order in and out (unnormalised; INV uses
// exp(+2 pi i ik / R)).
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0];
    x[0] = add(a, x[1]);
    x[1] = sub(a, x[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(x[0], x[1], x[2], x[3]);
  } else if constexpr (R == 8) {
    // i = i1 + 2 i2, k = k2 + 4 k1
    dft4<INV>(x[0], x[2], x[4], x[6]);
    dft4<INV>(x[1], x[3], x[5], x[7]);
    x[3] = cmul(x[3], w16(2, INV));
    x[5] = rot<INV>(x[5]);
    x[7] = cmul(x[7], w16(6, INV));
    float2 y[8];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      y[k2] = add(x[2 * k2], x[2 * k2 + 1]);
      y[k2 + 4] = sub(x[2 * k2], x[2 * k2 + 1]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = y[k];
  } else if constexpr (R == 16) {
    // i = i1 + 4 i2, k = k2 + 4 k1
#pragma unroll
    for (int i1 = 0; i1 < 4; ++i1)
      dft4<INV>(x[i1], x[i1 + 4], x[i1 + 8], x[i1 + 12]);
#pragma unroll
    for (int i1 = 1; i1 < 4; ++i1)
#pragma unroll
      for (int k2 = 1; k2 < 4; ++k2)
        x[i1 + 4 * k2] = cmul(x[i1 + 4 * k2], w16(i1 * k2, INV));
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
      dft4<INV>(x[4 * k2], x[4 * k2 + 1], x[4 * k2 + 2], x[4 * k2 + 3]);
    float2 y[16];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2)
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) y[k2 + 4 * k1] = x[4 * k2 + k1];
#pragma unroll
    for (int k = 0; k < 16; ++k) x[k] = y[k];
  }
}

// x[k] *= W_{L_sub}^{j k} (INV: its conjugate), k = 1..R-1, from the
// pass's table tw[(k - 1) s + j] (f64-built, stored as f32; a warp reads
// neighbouring j, coalesced).
template <int R, bool INV>
__device__ __forceinline__ void twiddle(float2 (&x)[R],
                                        const float2* __restrict__ tw, int s,
                                        int j) {
#pragma unroll
  for (int k = 1; k < R; ++k)
    x[k] = twist<INV>(x[k], __ldg(&tw[(k - 1) * s + j]));
}

// Where radix-16 pass Q's table starts: 15 x s_q entries for each pass
// q < Q, s_q = L / 16^(q + 1).
template <int LOG_L, int Q>
__host__ __device__ constexpr int tw_offset() {
  int off = 0;
  for (int q = 0; q < Q; ++q) off += 15 << (LOG_L - 4 * q - 4);
  return off;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// The block's (max, lowest lag), left in thread 0.
template <int T>
__device__ void block_best(float& v, int& i) {
  constexpr int W = T < 32 ? T : 32;
  constexpr unsigned mask = T < 32 ? (1u << T) - 1 : 0xffffffffu;
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    take(__shfl_xor_sync(mask, v, off), __shfl_xor_sync(mask, i, off), v, i);
  if constexpr (T > 32) {
    constexpr int NW = T / 32;
    __shared__ float s_val[NW];
    __shared__ int s_idx[NW];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
      s_val[warp] = v;
      s_idx[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < NW ? s_val[lane] : -1.f;
      i = lane < NW ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = NW / 2; off > 0; off >>= 1)
        take(__shfl_xor_sync(0xffffffffu, v, off),
             __shfl_xor_sync(0xffffffffu, i, off), v, i);
    }
  }
}

// s_k[n] = needle[n] exp(j rate n), the phase rate * float(n).
__device__ __forceinline__ float2 phasor(const float2* __restrict__ needle,
                                         float rate, int n) {
  const float2 a = __ldg(&needle[n]);
  float sn, cs;
  sincosf(rate * static_cast<float>(n), &sn, &cs);
  return make_float2(a.x * cs - a.y * sn, a.x * sn + a.y * cs);
}

// The shifted needle's first forward pass, at local points p = j + s i:
// C = 1: s_k[p]; C > 1: sum over n = p + L n1 < n of s_k[n] W_M^{n k1}
// = W_M^{p k1} sum_{n1} s_k[p + L n1] z^{n1}, z = W_C^{k1}, by Horner.
template <int LOG_L>
__device__ __forceinline__ float2 shifted(const float2* __restrict__ needle,
                                          int n_len, float rate, int p,
                                          int k1, int log_c, float2 z) {
  constexpr int L = Shape<LOG_L>::L;
  if (p >= n_len) return make_float2(0.f, 0.f);
  const int top = log_c == 0 ? p : p + (n_len - 1 - p) / L * L;
  float2 acc = make_float2(0.f, 0.f);
  for (int n = top; n >= p; n -= L)
    acc = add(n == top ? acc : cmul(acc, z), phasor(needle, rate, n));
  return k1 == 0 ? acc : cmul(acc, root(p * k1, LOG_L + log_c));
}

// Radix-16 pass Q (1 <= Q < NPASS - 1) or its adjoint, on shared memory,
// in place.
template <int LOG_L, int Q, bool INV>
__device__ __forceinline__ void mid_pass(float2* row,
                                         const float2* __restrict__ tw) {
  using S = Shape<LOG_L>;
  constexpr int LOG_SUB = LOG_L - 4 * Q;
  constexpr int LOG_S = LOG_SUB - 4;
  constexpr int OFF = tw_offset<LOG_L, Q>();
#pragma unroll 1
  for (int u = 0; u < S::SEQ; ++u) {
    const int g = threadIdx.x + S::T * u;
    const int j = g & ((1 << LOG_S) - 1);
    const int base = ((g >> LOG_S) << LOG_SUB) + j;
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = row[swz(base + (i << LOG_S))];
    if (INV) twiddle<16, true>(v, tw + OFF, 1 << LOG_S, j);
    dft<16, INV>(v);
    if (!INV) twiddle<16, false>(v, tw + OFF, 1 << LOG_S, j);
#pragma unroll
    for (int i = 0; i < 16; ++i) row[swz(base + (i << LOG_S))] = v[i];
  }
}

template <int LOG_L, int Q, bool INV>
__device__ __forceinline__ void mid_passes(float2* row,
                                           const float2* __restrict__ tw) {
  if constexpr (Q >= 1 && Q < Shape<LOG_L>::NPASS - 1) {
    if constexpr (!INV) {
      mid_pass<LOG_L, Q, false>(row, tw);
      __syncthreads();
      mid_passes<LOG_L, Q + 1, false>(row, tw);
    } else {
      mid_passes<LOG_L, Q + 1, true>(row, tw);
      mid_pass<LOG_L, Q, true>(row, tw);
      __syncthreads();
    }
  }
}

// The cluster's closing step (C > 1): for each of this block's lags t,
// the C-point inverse DFT across the blocks' rows; calls emit(lag, r).
template <int LOG_L, int C, class Emit>
__device__ __forceinline__ void cross_blocks(float2* row, int k1, Emit emit) {
  using S = Shape<LOG_L>;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int PER = S::L / C;
#pragma unroll 1
  for (int w = 0; w < PER / S::T; ++w) {
    const int t = k1 * PER + threadIdx.x + S::T * w;
    float2 x[C];
#pragma unroll
    for (int b = 0; b < C; ++b)
      x[b] = cluster.map_shared_rank(row, b)[swz(t)];
    dft<C, true>(x);
#pragma unroll
    for (int b = 0; b < C; ++b) emit(t + b * S::L, x[b]);
  }
}

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
  const float rate = rates[bin];
  const int t = threadIdx.x;
  const float2 z = root(k1, log_c);   // W_C^{k1}

  // First forward pass, from the needle: radix 16 over stride L / 16.
  constexpr int LOG_S0 = LOG_L - 4;
#pragma unroll 1
  for (int u = 0; u < S::SEQ; ++u) {
    const int j = t + S::T * u;
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = shifted<LOG_L>(needle, n_len, rate, j + (i << LOG_S0), k1,
                            log_c, z);
    dft<16, false>(v);
    twiddle<16, false>(v, tw, 1 << LOG_S0, j);
#pragma unroll
    for (int i = 0; i < 16; ++i) row[swz(j + (i << LOG_S0))] = v[i];
  }
  __syncthreads();
  mid_passes<LOG_L, 1, false>(row, tw);

  // Last forward pass (RL neighbours, no twiddle), P = H conj(S), and its
  // adjoint, in registers.  H is slot-major: h_k[k1 L + (u RL + i) T + t].
  const float2* h = h_k + static_cast<size_t>(k1) * S::L;
#pragma unroll
  for (int u = 0; u < S::GL; ++u) {
    const int base = (t + S::T * u) << S::LOG_RL;
    float2 v[S::RL];
#pragma unroll
    for (int i = 0; i < S::RL; ++i) v[i] = row[swz(base + i)];
    dft<S::RL, false>(v);
#pragma unroll
    for (int i = 0; i < S::RL; ++i)
      v[i] = cmul_conj(__ldg(&h[(u * S::RL + i) * S::T + t]), v[i]);
    dft<S::RL, true>(v);
#pragma unroll
    for (int i = 0; i < S::RL; ++i) row[swz(base + i)] = v[i];
  }
  __syncthreads();
  mid_passes<LOG_L, 1, true>(row, tw);

  // Adjoint of the first pass: lags p = j + (L / 16) i in natural order.
  float best = -1.f;  // |r|^2 >= 0: any lag beats it
  int arg = INT_MAX;
  const size_t m = static_cast<size_t>(1) << log_m;
  const float inv_m = __int_as_float((127 - log_m) << 23);  // exact 1 / M
  const float scale = inv_m * inv_m;
  float* out = SURFACE ? surf + bin * m : nullptr;
#pragma unroll 1
  for (int u = 0; u < S::SEQ; ++u) {
    const int j = t + S::T * u;
    float2 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = row[swz(j + (i << LOG_S0))];
    twiddle<16, true>(v, tw, 1 << LOG_S0, j);
    dft<16, true>(v);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int p = j + (i << LOG_S0);
      if (log_c == 0) {
        const float mag = v[i].x * v[i].x + v[i].y * v[i].y;
        if (SURFACE)
          out[p] = mag * scale;
        else
          take(mag, p, best, arg);
      } else {
        row[swz(p)] = k1 ? cmul_conj(v[i], root(p * k1, log_m)) : v[i];
      }
    }
  }

  if (log_c > 0) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    auto emit = [&](int lag, float2 r) {
      const float mag = r.x * r.x + r.y * r.y;
      if (SURFACE)
        out[lag] = mag * scale;
      else
        take(mag, lag, best, arg);
    };
    switch (log_c) {
      case 1: cross_blocks<LOG_L, 2>(row, k1, emit); break;
      case 2: cross_blocks<LOG_L, 4>(row, k1, emit); break;
      case 3: cross_blocks<LOG_L, 8>(row, k1, emit); break;
      default: cross_blocks<LOG_L, 16>(row, k1, emit); break;
    }
    if (SURFACE) {
      cluster.sync();  // no block leaves while another reads its row
      return;
    }
    __shared__ float s_best;
    __shared__ int s_arg;
    block_best<S::T>(best, arg);
    if (t == 0) {
      s_best = best;
      s_arg = arg;
    }
    cluster.sync();
    if (k1 == 0 && t == 0) {
      for (int b = 1; b < (1 << log_c); ++b)
        take(*cluster.map_shared_rank(&s_best, b),
             *cluster.map_shared_rank(&s_arg, b), best, arg);
      vals[bin] = best;
      idxs[bin] = arg;
    }
    cluster.sync();
    return;
  }
  if (!SURFACE) {
    block_best<S::T>(best, arg);
    if (t == 0) {
      vals[bin] = best;
      idxs[bin] = arg;
    }
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

int log2_exact(int v) {
  int l = 0;
  while (l < 30 && (1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
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
