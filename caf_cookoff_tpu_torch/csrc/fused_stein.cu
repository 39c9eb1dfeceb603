// Fused Stein coarse rank for Hopper (sm_90a): per (pair, doppler bin),
// the max over lags of |R|^2 and the lowest lag that attains it, and on
// request the strongest lag more than `sep` from it (the top-2 mode).
//
// Replaces caf_cookoff_tpu/ops/pallas_stein.py::_fused_stein_kernel
// in modes (a) one pair, (b) many pairs, (c) share_h bands, (d) windows
// with a per-program lag bound, (c) with (d), and (e) want_top2 with any
// of them; lags always computed.
//
// Program i of P_eff = P * S * W runs band-major, i = (pair*S + band)*W
// + w (S = share_h, W = windows); it reads the needle operator
// lmat[i / W] and the haystack slice h_ext[(i / (S*W))*W + i % W]:
//
//   G[i, r, tau] = sum_{e<D} lmat[i/W, r, e]     * h[0, (r mod B)*D + e + tau]
//                          + lmat[i/W, r, D + e] * h[1, (r mod B)*D + e + tau]
//   Rr = ws1 @ G[i],  Ri = ws2 @ G[i]                 (K, 2B) x (2B, lags)
//   vals[k, i] = max_{tau < bound_i} Rr^2 + Ri^2,  lags[k, i] = lowest argmax
//
// with bound_i = min(num_valid[i], num_lags) when num_valid is given,
// else num_lags.  Lags at or past the bound read -1.0 inside the max (a
// program with bound 0 returns -1.0 at lag 0), so a strong correlation
// past a window's range cannot shadow the bin's in-range peak.
//
// Precision is the Pallas kernel's: ws1, ws2, lmat and h_ext rounded to
// bf16, G rounded to bf16, every sum accumulated in f32.
//
// What bounds it on this card: arithmetic.  At the main path's shape
// (K = 400 bins, 2B = 128 segment rows, 8192 lags, one pair) the
// synthesis is 2 x 400 x 128 x 8192 = 0.84 G multiply-adds, stage A
// 0.13 G, while the inputs are ~0.5 MB and G is 2 MB in bf16 (it stays
// in the 50 MB L2 between launches).
//
// Design.  The TPU kernel walks its lag tiles in order inside one
// program and carries a running max in VMEM; Hopper blocks run in no
// order, so the work is three launches on one stream:
//   1. stein_stage_a: one block per (program, segment, 128-lag tile) stages
//      the haystack window and the two needle-tap rows in shared memory
//      and writes G (P, 2B, m_pad) in bf16.
//   2. stein_stage_b: one block per (program, 64-bin tile, 128-lag tile);
//      the synthesis weights and a G tile are staged 32 rows at a time,
//      each thread keeps 4 bins x 8 lags of Rr and Ri in registers
//      (64 f32 FMA per 16 shared-memory reads), and the |R|^2 epilogue
//      reduces each bin to (max, lowest lag) for the tile: in order
//      within a thread, then by warp shuffles.
//   3. stein_reduce_tiles: per (program, bin), the tiles in ascending lag
//      order with a strict '>', so the lowest lag survives exact ties.
//      For want_top2, stein_reduce_top2 instead: one warp per (program,
//      bin) takes slot 1, (max, lowest lag), from the tile partials; slot
//      2 is the max over lags with |lag - lag1| > sep (lowest lag on
//      ties; (-1.0, 0) when there is none).  A tile wholly outside that
//      window gives its partial, a tile wholly inside gives nothing, and
//      the at most two tiles that straddle an edge of the window are
//      recomputed from G, ws1 and ws2 with stage B's own arithmetic (the
//      same fmaf order and mag2_rn), so their |R|^2 are stage B's bit
//      for bit.  This is exact for any separation > sep, where the TPU
//      kernel's greedy merge of 512-lag tiles is exact only past 2*sep;
//      the recompute is 2 x 128 lags of a bin's m_pad (3% of stage B at
//      8192 lags) and needs no |R|^2 buffer.
// The program axis is the grid's z, capped at 65535 by the hardware:
// launches 1 and 2 go out in chunks of at most that many programs; the
// reduces index programs globally.
// Plain FMA loops, no tensor cores: wgmma/TMA and keeping G out of
// device memory are later work (G is (P_eff, 2B, m_pad) bf16 in device
// memory: 134 MB at 64 pairs x 128 rows x 8192 lags).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kLagTile = 128;   // lags per block in launches 1 and 2
constexpr int kBinTile = 64;    // bins per stage-B block
constexpr int kRowChunk = 32;   // synthesis rows staged per step
constexpr int kThreadsB = 256;  // 16 (bin groups) x 16 (lag lanes)
constexpr int kBinsPerThread = kBinTile / 16;   // 4
constexpr int kLagsPerThread = kLagTile / 16;   // 8
constexpr int kGridZMax = 65535;                // programs per launch
constexpr int kWarpsTop2 = 8;                   // (program, bin)s per block

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// |R|^2 with explicit roundings: nvcc may not contract it into an fma,
// so stage B and the top-2 recompute round it alike, as the plain
// version's rr * rr + ri * ri does.
__device__ __forceinline__ float mag2_rn(float rr, float ri) {
  return __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
}

// (best, arg) <- (v, lag) if v is larger, or equal at a lower lag.
__device__ __forceinline__ void keep_better(float v, int lag, float& best,
                                            int& arg) {
  if (v > best || (v == best && lag < arg)) {
    best = v;
    arg = lag;
  }
}

// Every lane of the warp ends with the warp's (max, lowest lag).
__device__ __forceinline__ void warp_best(float& best, int& arg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int ol = __shfl_xor_sync(0xffffffffu, arg, off);
    keep_better(ov, ol, best, arg);
  }
}

// Launch 1.  grid (m_pad / kLagTile, B, programs in this chunk),
// kLagTile threads; program p = p_base + blockIdx.z; thread t owns lag
// tau = tile * kLagTile + t of segment rows blk and B + blk.
__global__ void __launch_bounds__(kLagTile) stein_stage_a(
    const __nv_bfloat16* __restrict__ lmat, const float* __restrict__ h_ext,
    __nv_bfloat16* __restrict__ g, int num_blocks, int sup, int h_len,
    int m_pad, int windows, int share_h, int p_base) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, blk = blockIdx.y, p = p_base + blockIdx.z;
  // The TPU kernel's BlockSpec index maps.
  const int op = p / windows;
  const int slice = (p / (share_h * windows)) * windows + p % windows;
  const int b2 = 2 * num_blocks;
  const int win = kLagTile + sup - 1;
  float* h0 = smem;            // haystack window, real plane
  float* h1 = h0 + win;        // imaginary plane
  float* top = h1 + win;       // taps of row blk (Re G)
  float* bot = top + 2 * sup;  // taps of row B + blk (Im G)

  const int start = blk * sup + tile * kLagTile;
  const float* hp = h_ext + static_cast<size_t>(slice) * 2 * h_len;
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    h0[i] = round_bf16(hp[start + i]);
    h1[i] = round_bf16(hp[h_len + start + i]);
  }
  const __nv_bfloat16* lp = lmat + static_cast<size_t>(op) * b2 * 2 * sup;
  for (int i = threadIdx.x; i < 2 * sup; i += blockDim.x) {
    top[i] = __bfloat162float(lp[static_cast<size_t>(blk) * 2 * sup + i]);
    bot[i] = __bfloat162float(
        lp[static_cast<size_t>(num_blocks + blk) * 2 * sup + i]);
  }
  __syncthreads();

  const int t = threadIdx.x;
  float acc_top = 0.f, acc_bot = 0.f;
  for (int e = 0; e < sup; ++e) {
    const float a = h0[t + e], c = h1[t + e];
    acc_top = fmaf(top[e], a, acc_top);
    acc_top = fmaf(top[sup + e], c, acc_top);
    acc_bot = fmaf(bot[e], a, acc_bot);
    acc_bot = fmaf(bot[sup + e], c, acc_bot);
  }
  const int tau = tile * kLagTile + t;
  __nv_bfloat16* gp = g + static_cast<size_t>(p) * b2 * m_pad;
  gp[static_cast<size_t>(blk) * m_pad + tau] = __float2bfloat16_rn(acc_top);
  gp[static_cast<size_t>(num_blocks + blk) * m_pad + tau] =
      __float2bfloat16_rn(acc_bot);
}

// Launch 2.  grid (m_pad / kLagTile, ceil(K / kBinTile), programs in
// this chunk), kThreadsB threads; program p = p_base + blockIdx.z;
// thread (ty, tx) owns bins k0 + 4*ty + i (i < 4) and lags
// tau0 + tx + 16*j (j < 8).  Writes part_val/part_lag[(p*K + k)*tiles + tile].
// num_valid may be null (every program bounded by num_lags).
__global__ void __launch_bounds__(kThreadsB) stein_stage_b(
    const __nv_bfloat16* __restrict__ ws1,
    const __nv_bfloat16* __restrict__ ws2,
    const __nv_bfloat16* __restrict__ g, const int* __restrict__ num_valid,
    float* __restrict__ part_val, int* __restrict__ part_lag, int num_bins,
    int b2, int m_pad, int num_lags, int p_base) {
  // +1 column: the transposing stores below hit distinct banks.
  __shared__ float s_w1[kRowChunk][kBinTile + 1];
  __shared__ float s_w2[kRowChunk][kBinTile + 1];
  __shared__ float s_g[kRowChunk][kLagTile];

  const int tile = blockIdx.x, p = p_base + blockIdx.z;
  const int k0 = blockIdx.y * kBinTile, tau0 = tile * kLagTile;
  const int bound = num_valid ? min(num_valid[p], num_lags) : num_lags;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const __nv_bfloat16* gp = g + static_cast<size_t>(p) * b2 * m_pad;

  float rr[kBinsPerThread][kLagsPerThread];
  float ri[kBinsPerThread][kLagsPerThread];
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) rr[i][j] = ri[i][j] = 0.f;

  for (int r0 = 0; r0 < b2; r0 += kRowChunk) {
    // Rows past b2 and bins past K stage as zeros.
    for (int i = threadIdx.x; i < kRowChunk * kBinTile; i += kThreadsB) {
      const int k = i / kRowChunk, r = i % kRowChunk;
      float v1 = 0.f, v2 = 0.f;
      if (k0 + k < num_bins && r0 + r < b2) {
        const size_t o = static_cast<size_t>(k0 + k) * b2 + r0 + r;
        v1 = __bfloat162float(ws1[o]);
        v2 = __bfloat162float(ws2[o]);
      }
      s_w1[r][k] = v1;
      s_w2[r][k] = v2;
    }
    for (int i = threadIdx.x; i < kRowChunk * kLagTile; i += kThreadsB) {
      const int r = i / kLagTile, t = i % kLagTile;
      s_g[r][t] = (r0 + r < b2)
                      ? __bfloat162float(
                            gp[static_cast<size_t>(r0 + r) * m_pad + tau0 + t])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRowChunk; ++r) {
      float w1[kBinsPerThread], w2[kBinsPerThread], gv[kLagsPerThread];
#pragma unroll
      for (int i = 0; i < kBinsPerThread; ++i) {
        w1[i] = s_w1[r][kBinsPerThread * ty + i];
        w2[i] = s_w2[r][kBinsPerThread * ty + i];
      }
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) gv[j] = s_g[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kBinsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kLagsPerThread; ++j) {
          rr[i][j] = fmaf(w1[i], gv[j], rr[i][j]);
          ri[i][j] = fmaf(w2[i], gv[j], ri[i][j]);
        }
    }
    __syncthreads();
  }

  const int n_tiles = m_pad / kLagTile;
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) {
    float best = -1.f;
    int arg = tau0 + tx;
#pragma unroll
    for (int j = 0; j < kLagsPerThread; ++j) {
      const int tau = tau0 + tx + 16 * j;
      // Lags past the bound read -1.0, as in the TPU kernel.
      const float v = tau < bound ? mag2_rn(rr[i][j], ri[i][j]) : -1.f;
      if (j == 0 || v > best) {  // ascending tau: ties keep the lowest
        best = v;
        arg = tau;
      }
    }
    // The 16 lanes with one ty hold one bin; xor offsets < 16 stay
    // inside that half-warp.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int ol = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ov > best || (ov == best && ol < arg)) {
        best = ov;
        arg = ol;
      }
    }
    const int k = k0 + kBinsPerThread * ty + i;
    if (tx == 0 && k < num_bins) {
      const size_t o =
          (static_cast<size_t>(p) * num_bins + k) * n_tiles + tile;
      part_val[o] = best;
      part_lag[o] = arg;
    }
  }
}

// Launch 3.  One thread per (program, bin): tiles in ascending lag order,
// strict '>' keeps the earliest (lowest-lag) maximum.
__global__ void stein_reduce_tiles(const float* __restrict__ part_val,
                                   const int* __restrict__ part_lag,
                                   float* __restrict__ vals,
                                   int* __restrict__ lags, int num_programs,
                                   int num_bins, int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_programs * num_bins) return;
  const int p = idx / num_bins, k = idx % num_bins;
  const float* pv = part_val + static_cast<size_t>(idx) * n_tiles;
  const int* pl = part_lag + static_cast<size_t>(idx) * n_tiles;
  float best = pv[0];
  int arg = pl[0];
  for (int t = 1; t < n_tiles; ++t) {
    if (pv[t] > best) {
      best = pv[t];
      arg = pl[t];
    }
  }
  vals[static_cast<size_t>(k) * num_programs + p] = best;
  lags[static_cast<size_t>(k) * num_programs + p] = arg;
}

// Launch 3 of the top-2 mode.  grid ceil(P_eff*K / kWarpsTop2), one warp
// per (program p, bin k), warp w of block x owns idx = x*kWarpsTop2 + w,
// p = idx / K (the global program id).  sep < 0 means no window (slot 2
// = slot 1, as |lag - lag1| <= sep never holds); the wrapper caps sep at
// m_pad so lag1 +- sep cannot overflow.
__global__ void __launch_bounds__(32 * kWarpsTop2) stein_reduce_top2(
    const __nv_bfloat16* __restrict__ ws1,
    const __nv_bfloat16* __restrict__ ws2,
    const __nv_bfloat16* __restrict__ g, const int* __restrict__ num_valid,
    const float* __restrict__ part_val, const int* __restrict__ part_lag,
    float* __restrict__ vals, int* __restrict__ lags,
    float* __restrict__ vals2, int* __restrict__ lags2, int num_programs,
    int num_bins, int b2, int m_pad, int num_lags, int sep) {
  const int lane = threadIdx.x % 32;
  const size_t idx =
      static_cast<size_t>(blockIdx.x) * kWarpsTop2 + threadIdx.x / 32;
  if (idx >= static_cast<size_t>(num_programs) * num_bins) return;  // warp
  const int p = static_cast<int>(idx / num_bins);
  const int k = static_cast<int>(idx % num_bins);
  const int n_tiles = m_pad / kLagTile;
  const float* pv = part_val + idx * n_tiles;
  const int* pl = part_lag + idx * n_tiles;

  // Slot 1: the tiles' (max, lowest lag).
  float v1 = -INFINITY;
  int a1 = 0x7fffffff;
  for (int t = lane; t < n_tiles; t += 32) keep_better(pv[t], pl[t], v1, a1);
  warp_best(v1, a1);

  // Slot 2 over the lags outside the window [lo, hi].
  const bool window = sep >= 0;
  const int lo = a1 - sep, hi = a1 + sep;
  float v2 = -1.f;
  int a2 = 0;
  for (int t = lane; t < n_tiles; t += 32) {
    const int t0 = t * kLagTile;
    if (!window || t0 + kLagTile - 1 < lo || t0 > hi)
      keep_better(pv[t], pl[t], v2, a2);
  }
  if (window) {
    const int bound = num_valid ? min(num_valid[p], num_lags) : num_lags;
    // The tile holding lo - 1 and lo, and the one holding hi and hi + 1.
    const int t_lo = (lo >= 1 && lo % kLagTile) ? lo / kLagTile : -1;
    const int t_hi =
        (hi + 1 < m_pad && (hi + 1) % kLagTile) ? hi / kLagTile : -1;
    const __nv_bfloat16* w1p = ws1 + static_cast<size_t>(k) * b2;
    const __nv_bfloat16* w2p = ws2 + static_cast<size_t>(k) * b2;
    for (int e = 0; e < 2; ++e) {
      const int t = e ? t_hi : t_lo;
      if (t < 0 || (e && t == t_lo)) continue;
      const int t0 = t * kLagTile;
      const __nv_bfloat16* gp =
          g + static_cast<size_t>(p) * b2 * m_pad + t0 + lane;
      constexpr int kLagsPerLane = kLagTile / 32;
      float rr[kLagsPerLane], ri[kLagsPerLane];
#pragma unroll
      for (int j = 0; j < kLagsPerLane; ++j) rr[j] = ri[j] = 0.f;
      // Stage B's order: rows ascending, one fmaf each.
      for (int r = 0; r < b2; ++r) {
        const float w1 = __bfloat162float(w1p[r]);
        const float w2 = __bfloat162float(w2p[r]);
        const __nv_bfloat16* gr = gp + static_cast<size_t>(r) * m_pad;
#pragma unroll
        for (int j = 0; j < kLagsPerLane; ++j) {
          const float gv = __bfloat162float(gr[32 * j]);
          rr[j] = fmaf(w1, gv, rr[j]);
          ri[j] = fmaf(w2, gv, ri[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kLagsPerLane; ++j) {
        const int tau = t0 + lane + 32 * j;
        const bool masked = tau >= bound || (tau >= lo && tau <= hi);
        keep_better(masked ? -1.f : mag2_rn(rr[j], ri[j]), tau, v2, a2);
      }
    }
  }
  warp_best(v2, a2);
  if (lane == 0) {
    const size_t o = static_cast<size_t>(k) * num_programs + p;
    vals[o] = v1;
    lags[o] = a1;
    vals2[o] = v2;
    lags2[o] = a2;
  }
}

}  // namespace

extern "C" {

int caf_fused_stein_lag_tile() { return kLagTile; }

const char* caf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shapes (row-major, contiguous): ws1, ws2 (K, 2B) bf16; lmat
// (P_eff / W, 2B, 2D) bf16; h_ext (P_eff / S, 2, h_len) f32; num_valid
// (P_eff,) int32 or null; g (P_eff, 2B, m_pad) bf16 scratch;
// part_val/part_lag (P_eff, K, m_pad / kLagTile) f32/int32 scratch;
// vals/lags (K, P_eff) f32/int32 out; vals2/lags2 (K, P_eff) f32/int32
// out, or both null (no top-2 mode; then sep is unused).  m_pad is a
// multiple of kLagTile, h_len >= (B - 1) * D + m_pad + D - 1 and
// sep <= m_pad.  Enqueues the launches on `stream`, on the calling
// thread's current device (the operands' card); returns the first CUDA
// error (0 on success).
int caf_fused_stein_rank(const void* ws1, const void* ws2, const void* lmat,
                         const void* h_ext, const void* num_valid, void* g,
                         void* part_val, void* part_lag, void* vals,
                         void* lags, void* vals2, void* lags2,
                         int num_programs, int num_bins, int num_blocks,
                         int sup, int h_len, int num_lags, int m_pad,
                         int windows, int share_h, int sep, void* stream) {
  cudaError_t err = cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = m_pad / kLagTile;
  const int b2 = 2 * num_blocks;
  const int bin_tiles = (num_bins + kBinTile - 1) / kBinTile;

  const size_t smem_a = (2 * (kLagTile + sup - 1) + 4 * sup) * sizeof(float);
  if (smem_a > 48 * 1024) {
    err = cudaFuncSetAttribute(stein_stage_a,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_a));
    if (err != cudaSuccess) return err;
  }
  for (int p0 = 0; p0 < num_programs; p0 += kGridZMax) {
    const int chunk = std::min(kGridZMax, num_programs - p0);
    stein_stage_a<<<dim3(n_tiles, num_blocks, chunk), kLagTile, smem_a, s>>>(
        static_cast<const __nv_bfloat16*>(lmat),
        static_cast<const float*>(h_ext), static_cast<__nv_bfloat16*>(g),
        num_blocks, sup, h_len, m_pad, windows, share_h, p0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    stein_stage_b<<<dim3(n_tiles, bin_tiles, chunk), kThreadsB, 0, s>>>(
        static_cast<const __nv_bfloat16*>(ws1),
        static_cast<const __nv_bfloat16*>(ws2),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const int*>(num_valid), static_cast<float*>(part_val),
        static_cast<int*>(part_lag), num_bins, b2, m_pad, num_lags, p0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  const int total = num_programs * num_bins;
  if (vals2 != nullptr) {
    stein_reduce_top2<<<(total + kWarpsTop2 - 1) / kWarpsTop2,
                        32 * kWarpsTop2, 0, s>>>(
        static_cast<const __nv_bfloat16*>(ws1),
        static_cast<const __nv_bfloat16*>(ws2),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const int*>(num_valid),
        static_cast<const float*>(part_val),
        static_cast<const int*>(part_lag), static_cast<float*>(vals),
        static_cast<int*>(lags), static_cast<float*>(vals2),
        static_cast<int*>(lags2), num_programs, num_bins, b2, m_pad,
        num_lags, sep);
    return cudaGetLastError();
  }
  stein_reduce_tiles<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_val),
      static_cast<const int*>(part_lag), static_cast<float*>(vals),
      static_cast<int*>(lags), num_programs, num_bins, n_tiles);
  return cudaGetLastError();
}

}  // extern "C"
