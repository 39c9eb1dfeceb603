// Row transforms shared by the filterbank kernels (K2/K3,
// caf_filterbank.cu) and the Stein exact re-score (K5, stein_rescore.cu):
// one correlation row of M = C L points on a block of L points (C = 1) or
// on a cluster of C blocks,
//
//   s[n] = needle[n] * exp(j * rate * n)      n < N, zeros up to M
//   r    = IDFT(H . conj(DFT(s)))             unnormalised inverse
//
// as register-radix passes over an XOR-swizzled row in shared memory, with
// f64-built twiddle tables (ops/pallas_caf._twiddle_table) and H in the
// threads' slot-major order (ops/pallas_caf._h_order).  The design is set
// out at the head of caf_filterbank.cu.  Everything here is internal to the
// translation unit that includes it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {
constexpr int kMinLogL = 5;   // L = 32 .. 8192 points a block
constexpr int kMaxLogL = 13;
constexpr int kMaxLogC = 4;   // clusters of up to 16 blocks

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

// One row: the shifted needle's forward transform (phasor and zero upper
// part folded into the first pass), the product with conj of the row's
// spectrum, the inverse transform.  `h` is the row's H for the whole
// cluster (block k1 reads its L slots at h + k1 L).  Calls emit(lag, r) once
// for each lag this block ends with: every lag for C = 1, its 1/C of them
// after the cross-block step for C > 1 (the caller then holds a cluster
// barrier before any block leaves, since others read its row).
template <int LOG_L, class Emit>
__device__ __forceinline__ void row_transform(
    float2* row, const float2* __restrict__ needle, int n_len,
    const float2* __restrict__ h, const float2* __restrict__ tw, float rate,
    int log_c, int k1, Emit emit) {
  using S = Shape<LOG_L>;
  const int t = threadIdx.x;
  const int log_m = LOG_L + log_c;
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
  // adjoint, in registers.  H is slot-major: h[k1 L + (u RL + i) T + t].
  const float2* hb = h + static_cast<size_t>(k1) * S::L;
#pragma unroll
  for (int u = 0; u < S::GL; ++u) {
    const int base = (t + S::T * u) << S::LOG_RL;
    float2 v[S::RL];
#pragma unroll
    for (int i = 0; i < S::RL; ++i) v[i] = row[swz(base + i)];
    dft<S::RL, false>(v);
#pragma unroll
    for (int i = 0; i < S::RL; ++i)
      v[i] = cmul_conj(__ldg(&hb[(u * S::RL + i) * S::T + t]), v[i]);
    dft<S::RL, true>(v);
#pragma unroll
    for (int i = 0; i < S::RL; ++i) row[swz(base + i)] = v[i];
  }
  __syncthreads();
  mid_passes<LOG_L, 1, true>(row, tw);

  // Adjoint of the first pass: lags p = j + (L / 16) i in natural order.
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
      if (log_c == 0)
        emit(p, v[i]);
      else
        row[swz(p)] = k1 ? cmul_conj(v[i], root(p * k1, log_m)) : v[i];
    }
  }

  if (log_c > 0) {
    cg::this_cluster().sync();
    switch (log_c) {
      case 1: cross_blocks<LOG_L, 2>(row, k1, emit); break;
      case 2: cross_blocks<LOG_L, 4>(row, k1, emit); break;
      case 3: cross_blocks<LOG_L, 8>(row, k1, emit); break;
      default: cross_blocks<LOG_L, 16>(row, k1, emit); break;
    }
  }
}

// The row's (max, lowest lag) from every thread's own, left in thread 0 of
// block k1 = 0 of the cluster (C = 1: of the block).  With C > 1 it ends
// on a cluster barrier, which every block reaches after its cross-block
// reads: no block leaves while another reads its shared memory.
template <int T>
__device__ __forceinline__ void row_best(float& best, int& arg, int log_c,
                                         int k1) {
  block_best<T>(best, arg);
  if (log_c == 0) return;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float s_best;
  __shared__ int s_arg;
  if (threadIdx.x == 0) {
    s_best = best;
    s_arg = arg;
  }
  cluster.sync();
  if (k1 == 0 && threadIdx.x == 0)
    for (int b = 1; b < (1 << log_c); ++b)
      take(*cluster.map_shared_rank(&s_best, b),
           *cluster.map_shared_rank(&s_arg, b), best, arg);
  cluster.sync();
}

int log2_exact(int v) {
  int l = 0;
  while (l < 30 && (1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace
