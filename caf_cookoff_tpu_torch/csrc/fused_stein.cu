// Fused Stein coarse rank for Hopper (sm_90a): per (pair, doppler bin),
// the max over lags of |R|^2 and the lowest lag that attains it, and on
// request the strongest lag more than `sep` from it (the top-2 mode).
//
// Replaces caf_cookoff_tpu/ops/pallas_stein.py::_fused_stein_kernel
// in modes (a) one pair, (b) many pairs, (c) share_h bands, (d) windows
// with a per-program lag bound, (c) with (d), (e) want_top2 with any of
// them and (f) rate-major synthesis rows (tall K); lags always computed.
//
// Program i of P_eff = P * S * W runs band-major, i = (pair*S + band)*W
// + w (S = share_h, W = windows); it reads the needle operator
// lmat[i / W] and the haystack slice h[(i / (S*W))*W + i % W]:
//
//   G[i, r, tau] = sum_{e<D} lmat[i/W, r, e]     * h[0, (r mod B)*D + e + tau]
//                          + lmat[i/W, r, D + e] * h[1, (r mod B)*D + e + tau]
//   Rr = ws1 @ G[i],  Ri = ws2 @ G[i]                 (K, 2B) x (2B, lags)
//   vals[k, i] = max_{tau < bound_i} Rr^2 + Ri^2,  lags[k, i] = lowest argmax
//
// with bound_i = min(num_valid[i], num_lags) when num_valid is given,
// else num_lags.  Lags at or past the bound read -1.0 inside the max (a
// program with bound 0 returns -1.0 at lag 0).
//
// Precision is the Pallas kernel's: ws1, ws2, lmat and h rounded to bf16
// (a first small launch writes ws1, ws2 as bf16 and lmat, h as f32
// holding bf16 values, which stage A copies with cp.async as they are),
// G rounded to bf16, every sum accumulated in f32.  Stage A sums each G
// element in a fixed order (tap e of the real plane, then of the
// imaginary plane, e ascending, one fmaf each), so G is the plain
// version's bit for bit; stage B sums on the tensor cores in their own
// order, so |R|^2 is held to an error bound, not bit for bit
// (ops/fused_stein.py::stage_b_error_bound).
//
// What bounds it on this card: operations.  Per lag a program needs 2 x
// 2K x 2B multiply-adds of stage B and 2B x 2D of stage A (rate3: 323 +
// 15 GFLOP against ~10 MB of operands, far past the 295 operations a
// byte where the memory stops being the limit).  Stage B runs on the
// bf16 tensor cores; stage A must sum each G element in a fixed f32 order
// and so runs on the FMA pipe, at a fifteenth of their rate: on an H100
// SXM (utils/k1_study.py split) stage A alone takes about half of config
// 2's time (2K = 800, 2D = 128), three quarters of config 4's (2K = 384,
// 2D = 256) and a quarter of rate3's (2K = 5508).
//
// Design.  One launch does the work of modes (a)-(d) and (f): a block
// per (program, 128-lag tile, bin split).
//   Stage A (FMA pipe): the block builds its G tile, 2B rows x 128 lags
//     in bf16, straight into shared memory, laid out [lag][row] so stage
//     B reads it as the mma B operand.  The haystack window and the taps
//     of 8 segments at a time arrive by cp.async into a double buffer
//     (the next 8 segments load while these compute); each warp takes a
//     segment, each thread 4 consecutive lags, reusing haystack samples
//     from a 4-slot register ring (one shared load a plane and tap) and
//     the taps as float4 broadcasts; the window is stored with a skew
//     (i + i/4) so the ring's loads hit 32 banks.
//   Stage B (tensor pipe): mma.sync.m16n8k16 bf16 x bf16 -> f32, not yet
//     wgmma.  2B is padded to a multiple of 16 with zeros (exact).  A
//     warp owns 8 bins x 128 lags: its A operand interleaves ws1 and ws2
//     by 8 rows (rows g = ws1[bin g], g + 8 = ws2[bin g]), so Rr and Ri
//     of one (bin, lag) land in one thread's accumulators (c0/c2, c1/c3)
//     and |R|^2 (mag2_rn, no fma contraction) needs no shuffle.  The
//     epilogue masks past the bound and reduces each bin to (max, lowest
//     lag) in ascending lag order, then across the 4 lanes of a group.
//   Reduce: a 64-bit atomicMax on an order-preserving key (value bits
//     mapped to unsigned, then ~lag) gives (max, lowest lag) whatever the
//     order the blocks finish in; a small launch decodes the keys.  No G
//     and no per-tile partials reach device memory.
//   Fill: where programs x tiles leave SMs idle (config 1: 64 tiles),
//     the wrapper splits the bins over blocks (grid y); stage A repeats
//     per split, ~4 MFLOP a tile.
// Mode (e) keeps per-tile partials: the same launch writes each tile's
// (max, lowest lag) instead of the atomic; stein_reduce_top2 takes slot 1
// from them and slot 2 from the tiles wholly outside [lag1 - sep, lag1 +
// sep]; stein_recompute_top2 rebuilds the G tile of each tile that
// straddles an edge of that window from the operands and runs the same
// tile product (the same device functions, tile shape, bin-group rows
// and k order), so its |R|^2 equal the tile pass's bit for bit and an
// exact tie across a recomputed tile still goes to the lowest lag; keys
// merge both, and a decode launch writes slot 2.
// The program axis is the grid's z, capped at 65535 by the hardware:
// the tile launches go out in chunks of at most that many programs.
//
// Tall G (row_plan): a G tile of 2B rows x 128 lags fits one block's
// shared memory up to 2B = 864 at D <= 16 (672 at D = 128).  Past that
// a lag tile takes a thread-block cluster of c <= 16 blocks (the fewest
// that fit; grid x = tiles * c) and rank j of the cluster holds the
// segments [j*S, (j+1)*S), S = ceil(B / c): G rows b and B + b for each,
// so the two rows of a segment still share their haystack loads, each
// row still comes from its own segment's taps by the same fmaf chain
// (G stays the plain version's bit for bit) and stage A's total work
// does not change.  The rounding launch writes ws1/ws2's columns in the
// ranks' row order (rank j's at [j*R, (j+1)*R), R = 2S padded to 16,
// zero past its rows), so each rank runs the same tile product over its
// R rows.  Per 64-bin pass each rank stores its partial (Rr, Ri) of
// 64 bins x 128 lags (68 KB) in shared memory, over the stage-A
// buffers, which are free by then; after a cluster barrier rank j sums
// its share of the pass's bins over the c ranks' partials through
// distributed shared memory, in ascending rank order (deterministic, so
// the top-2 recompute repeats the tile pass's |R|^2 bit for bit), and
// only then masks, squares and reduces to (max, lowest lag); a second
// barrier frees the buffer for the next pass (and keeps every block
// alive while its peers read it).  The split moves only stage B's
// summation order, which stage_b_error_bound already allows.  c = 1 is
// the one-block kernel (the template's kSplit = false), unchanged.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLagTile = 128;               // lags per block
constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSegChunk = kWarps;           // stage-A segments per buffer
constexpr int kLagsPerThread = kLagTile / 32;   // stage A: 4
constexpr int kBinGroup = 8;                // bins per warp in stage B
constexpr int kBinPass = kWarps * kBinGroup;    // bins per block pass: 64
constexpr int kNTiles = kLagTile / 8;       // n8 tiles per warp: 16
constexpr int kGridZMax = 65535;            // programs per launch
constexpr int kWarpsTop2 = 8;               // (program, bin)s per block
constexpr int kClusterMax = 16;             // blocks a lag tile, at most
constexpr size_t kSmemPerBlock = 232448;    // shared memory a block may use
// The split's exchange: a pass's partial (Rr, Ri) as float4s of two
// lags, a bin's row padded by 4 float4s so the stores of a warp's 8 bins
// spread over the banks.
constexpr int kXStride = kLagTile / 2 + 4;
constexpr size_t kXchgBytes =
    sizeof(float4) * static_cast<size_t>(kBinPass) * kXStride;

__host__ __device__ constexpr int skew(int i) { return i + (i >> 2); }

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory layout of a tile block (floats unless noted): the G
// tile, then the two stage-A buffers, which the split's exchange
// overlays once G is built.
struct TileSmem {
  int g_stride;   // bf16 elements per G lag row: its rows padded to 16, + 8
  int hay_len;    // floats per haystack plane buffer (skewed, mult. of 4)
  int buf_len;    // floats per stage-A buffer: 2 planes + 8 segments' taps
  size_t bytes;
  __host__ __device__ TileSmem(int rows, int sup, bool split) {
    g_stride = pad16(rows) + 8;
    hay_len = (skew(kSegChunk * sup + kLagTile - 2) + 1 + 3) / 4 * 4;
    buf_len = 2 * hay_len + kSegChunk * 4 * sup;
    const size_t stage_a = 2 * static_cast<size_t>(buf_len) * sizeof(float);
    bytes = static_cast<size_t>(kLagTile) * g_stride * 2 +
            (split && kXchgBytes > stage_a ? kXchgBytes : stage_a);
  }
};

// How a lag tile's G rows are shared: c blocks (a cluster when c > 1),
// each holding seg segments (the last rank may hold fewer), rows = 2*seg
// padded to 16 rows of G, and ld columns a row of the rounded weights.
// c = 1: one block holds all of G, the weights in their own order.
struct Share {
  int c;
  int seg;
  int rows;
  int ld;
};

// The fewest blocks a tile whose shares fit a block's shared memory;
// c = 0 past kClusterMax blocks.
Share row_plan(int num_blocks, int sup, size_t& bytes) {
  const int b2 = 2 * num_blocks;
  bytes = TileSmem(b2, sup, false).bytes;
  if (bytes <= kSmemPerBlock) return {1, num_blocks, pad16(b2), b2};
  for (int c = 2; c <= kClusterMax; ++c) {
    const int seg = (num_blocks + c - 1) / c;
    bytes = TileSmem(2 * seg, sup, true).bytes;
    if (bytes <= kSmemPerBlock)
      return {c, seg, pad16(2 * seg), c * pad16(2 * seg)};
  }
  bytes = 0;
  return {0, 0, 0, 0};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// |R|^2 with explicit roundings: nvcc may not contract it into an fma,
// so the tile pass and the top-2 recompute round it alike.
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

// Order-preserving key: a larger value, or an equal value at a lower
// lag, gives a larger key.  0 is below every key.
__device__ __forceinline__ unsigned long long rank_key(float v, int lag) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(~lag);
}

__device__ __forceinline__ void key_decode(unsigned long long key, float& v,
                                           int& lag) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  v = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  lag = static_cast<int>(~static_cast<unsigned>(key & 0xffffffffu));
}

// Stage A: the G tile of program p, lags [tau0, tau0 + kLagTile), for
// the nseg segments from seg0 (kSplit; else all B from 0): rows seg0 + b
// and B + seg0 + b of G into rows b and nseg + b of gs ([lag][row] bf16,
// row stride g_stride); rows [2*nseg, g_stride - 8) are zero.  All
// threads of the block take part; ends with a barrier.  lmat and h hold
// bf16 values in f32.
template <bool kSplit>
__device__ void build_g_tile(const float* __restrict__ lmat,
                             const float* __restrict__ h, int p,
                             int num_blocks, int seg0_, int nseg_, int sup,
                             int h_len, int windows, int share_h, int tau0,
                             const TileSmem& lay, __nv_bfloat16* gs,
                             float* bufs) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int seg0 = kSplit ? seg0_ : 0, nseg = kSplit ? nseg_ : num_blocks;
  const int b2 = 2 * nseg, b2p = kSplit ? lay.g_stride - 8 : pad16(b2);
  // The TPU kernel's BlockSpec index maps.
  const int op = p / windows;
  const int slice = (p / (share_h * windows)) * windows + p % windows;
  const float* hp = h + static_cast<size_t>(slice) * 2 * h_len;
  const float* lp = lmat + static_cast<size_t>(op) * 2 * num_blocks * 2 * sup;

  for (int i = tid; i < kLagTile * (b2p - b2); i += kThreads) {
    const int lag = i / (b2p - b2), r = b2 + i % (b2p - b2);
    gs[lag * lay.g_stride + r] = __float2bfloat16_rn(0.f);
  }

  const int chunks = (nseg + kSegChunk - 1) / kSegChunk;
  // Chunk c's haystack window: h[tau0 + (seg0 + c*8)*D + i], i < ns*D +
  // 127, into both planes (skewed); its taps: rows b and B + b, 2D each,
  // per segment.
  auto stage_chunk = [&](int c) {
    float* buf = bufs + (c & 1) * lay.buf_len;
    const int b0 = c * kSegChunk;
    const int ns = min(kSegChunk, nseg - b0);
    const int len = ns * sup + kLagTile - 1;
    const float* src = hp + tau0 + (seg0 + b0) * sup;
    for (int i = tid; i < len; i += kThreads) {
      cp_async4(buf + skew(i), src + i);
      cp_async4(buf + lay.hay_len + skew(i), src + h_len + i);
    }
    float* taps = buf + 2 * lay.hay_len;
    const int vec = 2 * sup / 4;          // 16-byte pieces a tap row
    for (int i = tid; i < ns * 2 * vec; i += kThreads) {
      const int s = i / (2 * vec), half = (i / vec) % 2, v = i % vec;
      const int row = half * num_blocks + seg0 + b0 + s;
      cp_async16(taps + (s * 2 + half) * 2 * sup + 4 * v,
                 lp + static_cast<size_t>(row) * 2 * sup + 4 * v);
    }
    cp_async_commit();
  };

  stage_chunk(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage_chunk(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = bufs + (c & 1) * lay.buf_len;
    const int b = c * kSegChunk + warp;
    if (b < nseg) {
      const float* t_top = buf + 2 * lay.hay_len + warp * 4 * sup;
      const float* t_bot = t_top + 2 * sup;
      // Window sample off + k of plane 0 sits at buf[skew(off + k)]; off
      // is a multiple of 4, so for e0 a multiple of 4 sample off + e0 + c
      // sits at hb[c + c/4], hb = buf + skew(off + e0): fixed offsets.
      const int off = warp * sup + kLagsPerThread * lane;
      float r0[4], r1[4];               // ring: sample off + k in slot k%4
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        r0[k] = buf[skew(off) + k];
        r1[k] = buf[lay.hay_len + skew(off) + k];
      }
      float acc_top[kLagsPerThread], acc_bot[kLagsPerThread];
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) acc_top[j] = acc_bot[j] = 0.f;
      for (int e0 = 0; e0 < sup; e0 += 4) {
        const float4 tr = *reinterpret_cast<const float4*>(t_top + e0);
        const float4 ti = *reinterpret_cast<const float4*>(t_top + sup + e0);
        const float4 br = *reinterpret_cast<const float4*>(t_bot + e0);
        const float4 bi = *reinterpret_cast<const float4*>(t_bot + sup + e0);
        const float trv[4] = {tr.x, tr.y, tr.z, tr.w};
        const float tiv[4] = {ti.x, ti.y, ti.z, ti.w};
        const float brv[4] = {br.x, br.y, br.z, br.w};
        const float biv[4] = {bi.x, bi.y, bi.z, bi.w};
        const float* hb = buf + skew(off + e0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int next = (u + 3) + ((u + 3) >> 2);   // sample off + e + 3
          r0[(u + 3) % 4] = hb[next];
          r1[(u + 3) % 4] = hb[lay.hay_len + next];
#pragma unroll
          for (int j = 0; j < kLagsPerThread; ++j) {
            const float a = r0[(u + j) % 4], cc = r1[(u + j) % 4];
            acc_top[j] = fmaf(trv[u], a, acc_top[j]);
            acc_top[j] = fmaf(tiv[u], cc, acc_top[j]);
            acc_bot[j] = fmaf(brv[u], a, acc_bot[j]);
            acc_bot[j] = fmaf(biv[u], cc, acc_bot[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j) {
        __nv_bfloat16* row = gs + (kLagsPerThread * lane + j) * lay.g_stride;
        row[b] = __float2bfloat16_rn(acc_top[j]);
        row[nseg + b] = __float2bfloat16_rn(acc_bot[j]);
      }
    }
    __syncthreads();   // stage_chunk(c + 2) refills this buffer
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two bf16 weights (columns c, c + 1 of row k, ld columns a row) as one
// register; zero past the K bins or the b2 columns (b2 is even).
__device__ __forceinline__ unsigned load_w2(const __nv_bfloat16* w, int ld,
                                            int k, int c, int num_bins,
                                            int b2) {
  if (k >= num_bins || c >= b2) return 0u;
  return __ldg(reinterpret_cast<const unsigned*>(
      w + static_cast<size_t>(k) * ld + c));
}

// Stage B for one warp: the 8 bins [kb8, kb8 + 8) against the whole G
// tile (its b2 rows, padded to 16; the weights' columns from ws, ld a
// row), k ascending in steps of 16.  acc[nt] holds lags nt*8 + 2t, +1
// (t = lane % 4) of bin kb8 + lane / 4: {Rr, Rr, Ri, Ri}.  The tile pass
// and the top-2 recompute both call this, so their sums are the same.
__device__ __forceinline__ void tile_product(
    const __nv_bfloat16* __restrict__ ws1,
    const __nv_bfloat16* __restrict__ ws2, int ld, int num_bins, int b2,
    int kb8, const __nv_bfloat16* gs, int g_stride,
    float (&acc)[kNTiles][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k = kb8 + g, b2p = pad16(b2);
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int k0 = 0; k0 < b2p; k0 += 16) {
    const unsigned a0 = load_w2(ws1, ld, k, k0 + 2 * t, num_bins, b2);
    const unsigned a1 = load_w2(ws2, ld, k, k0 + 2 * t, num_bins, b2);
    const unsigned a2 = load_w2(ws1, ld, k, k0 + 8 + 2 * t, num_bins, b2);
    const unsigned a3 = load_w2(ws2, ld, k, k0 + 8 + 2 * t, num_bins, b2);
    const __nv_bfloat16* gb = gs + g * g_stride + k0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const __nv_bfloat16* gr = gb + nt * 8 * g_stride;
      mma_bf16(acc[nt], a0, a1, a2, a3,
               *reinterpret_cast<const unsigned*>(gr),
               *reinterpret_cast<const unsigned*>(gr + 8));
    }
  }
}

// The split's exchange, written by each warp after its tile product:
// bin slot warp*8 + g of the pass, lag pair nt*4 + t (lags nt*8 + 2t,
// +1) as {Rr, Ri, Rr, Ri}.
__device__ __forceinline__ void store_partials(
    float4* xchg, const float (&acc)[kNTiles][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* x = xchg + (warp * kBinGroup + lane / 4) * kXStride + lane % 4;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
    x[nt * 4] = make_float4(acc[nt][0], acc[nt][2], acc[nt][1], acc[nt][3]);
}

// The bin slots of a pass of npass bins that rank `rank` of c closes:
// [lo, hi), ceil(kBinPass / c) a rank.
__device__ __forceinline__ void rank_slots(int c, int rank, int npass,
                                           int& lo, int& hi) {
  const int per = (kBinPass + c - 1) / c;
  lo = rank * per;
  hi = min(npass, lo + per);
}

// The split's closing step for bin slot i, by one warp: the sums over
// the cluster's c partials, in ascending rank order, of the lag pairs
// lane and lane + 32 (lags tau0 + 2*lane, +1, tau0 + 64 + 2*lane, +1),
// then |R|^2 of each lag not masked (-1.0 where masked) reduced to the
// slot's (max, lowest lag) on every lane, from (best, arg).
template <class Masked>
__device__ __forceinline__ void close_slot(float4* xchg, int c, int i,
                                           int tau0, Masked masked,
                                           float& best, int& arg) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % 32;
  const float4* x0 = cluster.map_shared_rank(xchg, 0) + i * kXStride;
  float4 s0 = x0[lane], s1 = x0[lane + 32];
  for (int r = 1; r < c; ++r) {
    const float4* xr = cluster.map_shared_rank(xchg, r) + i * kXStride;
    const float4 a = xr[lane], b = xr[lane + 32];
    s0.x += a.x; s0.y += a.y; s0.z += a.z; s0.w += a.w;
    s1.x += b.x; s1.y += b.y; s1.z += b.z; s1.w += b.w;
  }
  const float v[4] = {mag2_rn(s0.x, s0.y), mag2_rn(s0.z, s0.w),
                      mag2_rn(s1.x, s1.y), mag2_rn(s1.z, s1.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int tau = tau0 + (j / 2) * (kLagTile / 2) + 2 * lane + j % 2;
    keep_better(masked(tau) ? -1.f : v[j], tau, best, arg);
  }
  warp_best(best, arg);
}

// The tile launch.  grid (m_pad / kLagTile * c, bin splits, programs in
// this chunk), kThreads threads, clusters of c = sh.c blocks along x when
// kSplit (block x: tile x / c, rank x % c); program p = p_base +
// blockIdx.z; bins [blockIdx.y * bins_per_split, +bins_per_split).  keys
// != null: each bin's (max, lowest lag) over the tile goes into keys[k *
// P + p] by atomicMax; else into part_val/part_lag[(p*K + k)*tiles +
// tile].
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) stein_tile(
    const __nv_bfloat16* __restrict__ ws1,
    const __nv_bfloat16* __restrict__ ws2, const float* __restrict__ lmat,
    const float* __restrict__ h, const int* __restrict__ num_valid,
    unsigned long long* __restrict__ keys, float* __restrict__ part_val,
    int* __restrict__ part_lag, int num_programs, int num_bins,
    int num_blocks, int sup, int h_len, int m_pad, int num_lags,
    int windows, int share_h, int bins_per_split, int p_base, Share sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem lay(sh.rows, sup, kSplit);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bufs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(kLagTile) * lay.g_stride * 2);
  const int rank = kSplit ? static_cast<int>(blockIdx.x) % sh.c : 0;
  const int tile = kSplit ? static_cast<int>(blockIdx.x) / sh.c
                          : static_cast<int>(blockIdx.x);
  const int p = p_base + blockIdx.z;
  const int tau0 = tile * kLagTile;
  const int k_lo = blockIdx.y * bins_per_split;
  const int k_hi = min(num_bins, k_lo + bins_per_split);
  const int bound = num_valid ? min(num_valid[p], num_lags) : num_lags;
  const int seg0 = rank * sh.seg, nseg = min(sh.seg, num_blocks - seg0);
  const int b2 = kSplit ? sh.rows : 2 * num_blocks;
  const __nv_bfloat16* w1 = ws1 + rank * sh.rows;
  const __nv_bfloat16* w2 = ws2 + rank * sh.rows;

  build_g_tile<kSplit>(lmat, h, p, num_blocks, seg0, nseg, sup, h_len,
                       windows, share_h, tau0, lay, gs, bufs);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = m_pad / kLagTile;
  auto emit = [&](int k, float best, int arg) {
    if (keys) {
      atomicMax(keys + static_cast<size_t>(k) * num_programs + p,
                rank_key(best, arg));
    } else {
      const size_t o =
          (static_cast<size_t>(p) * num_bins + k) * n_tiles + tile;
      part_val[o] = best;
      part_lag[o] = arg;
    }
  };
  float4* xchg = reinterpret_cast<float4*>(bufs);
  for (int kp = k_lo; kp < k_hi; kp += kBinPass) {
    const int kb8 = kp + warp * kBinGroup;
    if (kb8 < k_hi) {                      // whole warp
      float acc[kNTiles][4];
      tile_product(w1, w2, kSplit ? sh.ld : b2, num_bins, b2, kb8, gs,
                   lay.g_stride, acc);
      if constexpr (kSplit) {
        store_partials(xchg, acc);
      } else {
        // Ascending lags: nt, then 2t, 2t + 1; strict '>' keeps the
        // lowest.
        float best = -INFINITY;
        int arg = 0;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int tau = tau0 + nt * 8 + 2 * t + q;
            // Lags past the bound read -1.0, as in the TPU kernel.
            const float v = tau < bound
                ? mag2_rn(acc[nt][q], acc[nt][2 + q]) : -1.f;
            if (v > best) {
              best = v;
              arg = tau;
            }
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int ol = __shfl_xor_sync(0xffffffffu, arg, off);
          keep_better(ov, ol, best, arg);
        }
        const int k = kb8 + g;
        if (t == 0 && k < k_hi) emit(k, best, arg);
      }
    }
    if constexpr (kSplit) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();                      // every rank's partials stored
      int lo, hi;
      rank_slots(sh.c, rank, min(kBinPass, k_hi - kp), lo, hi);
      for (int i = lo + warp; i < hi; i += kWarps) {
        float best = -INFINITY;
        int arg = 0;
        close_slot(xchg, sh.c, i, tau0,
                   [&](int tau) { return tau >= bound; }, best, arg);
        if (lane == 0) emit(kp + i, best, arg);
      }
      cluster.sync();                      // every read done
    }
  }
}

// Column col of a split's rounded weight row (ld = c * R columns) reads
// column ws_column(col) of ws1/ws2 (2B columns), -1 for a zero: rank j's
// R = sh.rows columns [j*R, (j+1)*R) hold its segments' rows in its G
// tile's order (seg0 + b, then B + seg0 + b), then zeros.  (c = 1 keeps
// the weights' own order.)
__device__ __forceinline__ int ws_column(int col, int num_blocks,
                                         const Share& sh) {
  const int j = col / sh.rows, r = col % sh.rows, seg0 = j * sh.seg;
  const int n = min(sh.seg, num_blocks - seg0);
  return r < n ? seg0 + r : r < 2 * n ? num_blocks + seg0 + r - n : -1;
}

// The operands' bf16 roundings in one launch: ws1 and ws2 into ws_b
// (2, K, ld) bf16 in the row share's column order, lmat and h into f32
// copies holding bf16 values.
__global__ void stein_round_operands(const float* __restrict__ ws1,
                                     const float* __restrict__ ws2,
                                     const float* __restrict__ lmat,
                                     const float* __restrict__ h,
                                     __nv_bfloat16* __restrict__ ws_b,
                                     float* __restrict__ lmat_r,
                                     float* __restrict__ h_r, size_t n_ws,
                                     size_t n_lmat, size_t n_h,
                                     int num_blocks, Share sh) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < 2 * n_ws + n_lmat + n_h; i += stride) {
    if (i < n_ws && sh.c == 1) {
      ws_b[i] = __float2bfloat16_rn(ws1[i]);
    } else if (i < 2 * n_ws && sh.c == 1) {
      ws_b[i] = __float2bfloat16_rn(ws2[i - n_ws]);
    } else if (i < 2 * n_ws) {
      const size_t e = i < n_ws ? i : i - n_ws;
      const size_t k = e / sh.ld;
      const int col = ws_column(static_cast<int>(e % sh.ld), num_blocks, sh);
      const float* w = i < n_ws ? ws1 : ws2;
      ws_b[i] = __float2bfloat16_rn(
          col < 0 ? 0.f : w[k * 2 * num_blocks + col]);
    } else if (i < 2 * n_ws + n_lmat) {
      const size_t j = i - 2 * n_ws;
      lmat_r[j] = __bfloat162float(__float2bfloat16_rn(lmat[j]));
    } else {
      const size_t j = i - 2 * n_ws - n_lmat;
      h_r[j] = __bfloat162float(__float2bfloat16_rn(h[j]));
    }
  }
}

// keys (K, P) -> vals (K, P) f32, lags (K, P) int32.
__global__ void stein_decode_keys(const unsigned long long* __restrict__ keys,
                                  float* __restrict__ vals,
                                  int* __restrict__ lags, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  key_decode(keys[i], vals[i], lags[i]);
}

// The window [lo, hi] around slot 1 and the tiles that straddle its
// edges (-1 where none): the tile holding lo - 1 and lo, and the one
// holding hi and hi + 1.  sep < 0: no window.
__device__ __forceinline__ void straddling_tiles(int a1, int sep, int m_pad,
                                                 int& t_lo, int& t_hi) {
  const int lo = a1 - sep, hi = a1 + sep;
  t_lo = (sep >= 0 && lo >= 1 && lo % kLagTile) ? lo / kLagTile : -1;
  t_hi = (sep >= 0 && hi + 1 < m_pad && (hi + 1) % kLagTile)
             ? hi / kLagTile
             : -1;
}

// Top-2 reduce.  grid ceil(P_eff*K / kWarpsTop2), one warp per (program
// p, bin k), idx = p*K + k.  Slot 1: the tiles' (max, lowest lag); slot
// 2 from the tiles wholly outside [lag1 - sep, lag1 + sep], as a key
// that stein_recompute_top2 completes ((-1.0, 0) when there is none).
// The wrapper caps sep at m_pad so lag1 +- sep cannot overflow.
__global__ void __launch_bounds__(32 * kWarpsTop2) stein_reduce_top2(
    const float* __restrict__ part_val, const int* __restrict__ part_lag,
    float* __restrict__ vals, int* __restrict__ lags,
    unsigned long long* __restrict__ keys2, int num_programs, int num_bins,
    int m_pad, int sep) {
  const int lane = threadIdx.x % 32;
  const size_t idx =
      static_cast<size_t>(blockIdx.x) * kWarpsTop2 + threadIdx.x / 32;
  if (idx >= static_cast<size_t>(num_programs) * num_bins) return;  // warp
  const int p = static_cast<int>(idx / num_bins);
  const int k = static_cast<int>(idx % num_bins);
  const int n_tiles = m_pad / kLagTile;
  const float* pv = part_val + idx * n_tiles;
  const int* pl = part_lag + idx * n_tiles;

  float v1 = -INFINITY;
  int a1 = 0x7fffffff;
  for (int t = lane; t < n_tiles; t += 32) keep_better(pv[t], pl[t], v1, a1);
  warp_best(v1, a1);

  const bool window = sep >= 0;
  const int lo = a1 - sep, hi = a1 + sep;
  float v2 = -1.f;
  int a2 = 0;
  for (int t = lane; t < n_tiles; t += 32) {
    const int t0 = t * kLagTile;
    if (!window || t0 + kLagTile - 1 < lo || t0 > hi)
      keep_better(pv[t], pl[t], v2, a2);
  }
  warp_best(v2, a2);
  if (lane == 0) {
    const size_t o = static_cast<size_t>(k) * num_programs + p;
    vals[o] = v1;
    lags[o] = a1;
    keys2[o] = rank_key(v2, a2);
  }
}

// Top-2 recompute.  The tile launch's grid, clusters and bins; a block
// (with its cluster: every rank sees the same bins) rebuilds its G tile
// only when some bin of its split has slot 1's window edge in this
// tile, then each warp whose 8 bins include such a bin runs the tile
// product and merges the lags outside the window (and below the bound)
// into keys2.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) stein_recompute_top2(
    const __nv_bfloat16* __restrict__ ws1,
    const __nv_bfloat16* __restrict__ ws2, const float* __restrict__ lmat,
    const float* __restrict__ h, const int* __restrict__ num_valid,
    const int* __restrict__ lags1, unsigned long long* __restrict__ keys2,
    int num_programs, int num_bins, int num_blocks, int sup, int h_len,
    int m_pad, int num_lags, int windows, int share_h, int bins_per_split,
    int sep, int p_base, Share sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileSmem lay(sh.rows, sup, kSplit);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bufs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(kLagTile) * lay.g_stride * 2);
  const int rank = kSplit ? static_cast<int>(blockIdx.x) % sh.c : 0;
  const int tile = kSplit ? static_cast<int>(blockIdx.x) / sh.c
                          : static_cast<int>(blockIdx.x);
  const int p = p_base + blockIdx.z;
  const int tau0 = tile * kLagTile;
  const int k_lo = blockIdx.y * bins_per_split;
  const int k_hi = min(num_bins, k_lo + bins_per_split);
  const int seg0 = rank * sh.seg, nseg = min(sh.seg, num_blocks - seg0);
  const int b2 = kSplit ? sh.rows : 2 * num_blocks;

  auto needs = [&](int k) {
    if (k >= k_hi) return false;
    int t_lo, t_hi;
    straddling_tiles(lags1[static_cast<size_t>(k) * num_programs + p], sep,
                     m_pad, t_lo, t_hi);
    return t_lo == tile || t_hi == tile;
  };
  int any = 0;
  for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads) any |= needs(k);
  if (!__syncthreads_or(any)) return;      // whole block (and cluster)

  build_g_tile<kSplit>(lmat, h, p, num_blocks, seg0, nseg, sup, h_len,
                       windows, share_h, tau0, lay, gs, bufs);

  const int bound = num_valid ? min(num_valid[p], num_lags) : num_lags;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* w1 = ws1 + rank * sh.rows;
  const __nv_bfloat16* w2 = ws2 + rank * sh.rows;
  float4* xchg = reinterpret_cast<float4*>(bufs);
  for (int kp = k_lo; kp < k_hi; kp += kBinPass) {
    const int kb8 = kp + warp * kBinGroup;
    const bool mine = kb8 < k_hi && lane < kBinGroup && needs(kb8 + lane);
    if (__any_sync(0xffffffffu, mine)) {
      float acc[kNTiles][4];
      tile_product(w1, w2, kSplit ? sh.ld : b2, num_bins, b2, kb8, gs,
                   lay.g_stride, acc);
      if constexpr (kSplit) {
        store_partials(xchg, acc);
      } else {
        const int k = kb8 + g;
        const int lo = k < k_hi
            ? lags1[static_cast<size_t>(k) * num_programs + p] - sep : 0;
        const int hi = lo + 2 * sep;
        float best = -1.f;
        int arg = 0;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int tau = tau0 + nt * 8 + 2 * t + q;
            const bool masked = tau >= bound || (tau >= lo && tau <= hi);
            keep_better(masked ? -1.f : mag2_rn(acc[nt][q], acc[nt][2 + q]),
                        tau, best, arg);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int ol = __shfl_xor_sync(0xffffffffu, arg, off);
          keep_better(ov, ol, best, arg);
        }
        if (t == 0 && needs(k))
          atomicMax(keys2 + static_cast<size_t>(k) * num_programs + p,
                    rank_key(best, arg));
      }
    }
    if constexpr (kSplit) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();                      // every rank's partials stored
      int lo_slot, hi_slot;
      rank_slots(sh.c, rank, min(kBinPass, k_hi - kp), lo_slot, hi_slot);
      for (int i = lo_slot + warp; i < hi_slot; i += kWarps) {
        const int k = kp + i;
        if (!needs(k)) continue;           // whole warp
        const int lo = lags1[static_cast<size_t>(k) * num_programs + p] - sep;
        const int hi = lo + 2 * sep;
        float best = -1.f;
        int arg = 0;
        close_slot(xchg, sh.c, i, tau0, [&](int tau) {
          return tau >= bound || (tau >= lo && tau <= hi);
        }, best, arg);
        if (lane == 0)
          atomicMax(keys2 + static_cast<size_t>(k) * num_programs + p,
                    rank_key(best, arg));
      }
      cluster.sync();                      // every read done
    }
  }
}

// One tile-kernel launch: kSplit instances go out in clusters of sh.c
// blocks along x (past 8 blocks a cluster needs the non-portable size).
template <class... Params, class... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), bool split, dim3 grid,
                         size_t smem, cudaStream_t s, int c,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (!split) {
    kernel<<<grid, kThreads, smem, s>>>(args...);
    return cudaGetLastError();
  }
  if (c > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

int caf_fused_stein_lag_tile() { return kLagTile; }

int caf_fused_stein_bin_pass() { return kBinPass; }

// The tile blocks' plan for 2B rows at block length sup: blocks a lag
// tile (*cluster; 0 past kClusterMax), G rows a block (*rows); returns
// the dynamic shared memory of a block (bytes; 0 past the ceiling).
long long caf_fused_stein_plan(int b2, int sup, int* cluster, int* rows) {
  size_t bytes = 0;
  const Share sh = row_plan(b2 / 2, sup, bytes);
  *cluster = sh.c;
  *rows = sh.rows;
  return static_cast<long long>(bytes);
}

// The tile launch's residency for 2B rows at block length sup: blocks a
// SM (*blocks) and, for a split plan, clusters the card holds at once
// (*clusters; -1 for one block a tile).  Returns the first CUDA error,
// cudaErrorInvalidValue past the ceiling.
int caf_fused_stein_occupancy(int b2, int sup, int* blocks, int* clusters) {
  size_t smem = 0;
  const Share sh = row_plan(b2 / 2, sup, smem);
  *blocks = 0;
  *clusters = -1;
  if (sh.c == 0) return cudaErrorInvalidValue;
  auto* kernel = sh.c > 1 ? stein_tile<true> : stein_tile<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && sh.c > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess || sh.c == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

const char* caf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shapes (row-major, contiguous): ws1, ws2 (K, 2B) f32; lmat (P_eff /
// W, 2B, 2D) f32; h (P_eff / S, 2, h_len) f32; ws_b (2, K, ld) bf16 with
// ld = 2B for one block a tile, else c * rows (caf_fused_stein_plan),
// lmat_r and h_r (lmat's and h's shapes) f32 scratch for their bf16
// roundings; num_valid (P_eff,) int32 or null; keys (K, P_eff) 64-bit
// scratch; part_val/part_lag (P_eff, K, m_pad / kLagTile) f32/int32
// scratch of the top-2 mode (else null); vals/lags (K, P_eff) f32/int32
// out; vals2/lags2 (K, P_eff) f32/int32 out, or both null (no top-2
// mode; then sep is unused).  m_pad is a multiple of kLagTile, D a
// multiple of 4, h_len >= (B - 1) * D + m_pad + D - 1, sep <= m_pad and
// bins_per_split a multiple of kBinPass.  Enqueues the work on `stream`,
// on the calling thread's current device (the operands' card); returns
// the first CUDA error (0 on success; cudaErrorInvalidValue for 2B past
// the ceiling).
int caf_fused_stein_rank(const void* ws1, const void* ws2, const void* lmat,
                         const void* h, void* ws_b, void* lmat_r, void* h_r,
                         const void* num_valid, void* keys, void* part_val,
                         void* part_lag, void* vals, void* lags, void* vals2,
                         void* lags2, int num_programs, int num_bins,
                         int num_blocks, int sup, int h_len, int num_lags,
                         int m_pad, int windows, int share_h, int sep,
                         int bins_per_split, void* stream) {
  cudaError_t err = cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  const Share sh = row_plan(num_blocks, sup, smem);
  if (sh.c == 0) return cudaErrorInvalidValue;
  const bool split = sh.c > 1;
  const int n_tiles = m_pad / kLagTile;
  const int splits = (num_bins + bins_per_split - 1) / bins_per_split;
  const bool top2 = vals2 != nullptr;
  const size_t n_ws = static_cast<size_t>(num_bins) * sh.ld;
  const size_t n_lmat = static_cast<size_t>(num_programs / windows) * 2 *
                        num_blocks * 2 * sup;
  const size_t n_h =
      static_cast<size_t>(num_programs / share_h) * 2 * h_len;
  const auto* w1 = static_cast<const __nv_bfloat16*>(ws_b);
  const auto* w2 = w1 + n_ws;
  const auto* lm = static_cast<const float*>(lmat_r);
  const auto* hh = static_cast<const float*>(h_r);
  const auto* nv = static_cast<const int*>(num_valid);
  auto* ks = static_cast<unsigned long long*>(keys);
  const size_t total = static_cast<size_t>(num_programs) * num_bins;

  const size_t n_round = 2 * n_ws + n_lmat + n_h;
  stein_round_operands<<<static_cast<unsigned>(
                             std::min<size_t>((n_round + 255) / 256, 4096)),
                         256, 0, s>>>(
      static_cast<const float*>(ws1), static_cast<const float*>(ws2),
      static_cast<const float*>(lmat), static_cast<const float*>(h),
      static_cast<__nv_bfloat16*>(ws_b), static_cast<float*>(lmat_r),
      static_cast<float*>(h_r), n_ws, n_lmat, n_h, num_blocks, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!top2) {
    err = cudaMemsetAsync(keys, 0, total * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
  }
  auto* tile = split ? stein_tile<true> : stein_tile<false>;
  for (int p0 = 0; p0 < num_programs; p0 += kGridZMax) {
    const int chunk = std::min(kGridZMax, num_programs - p0);
    err = launch_tiles(
        tile, split, dim3(n_tiles * sh.c, splits, chunk), smem, s, sh.c, w1,
        w2, lm, hh, nv, top2 ? nullptr : ks, static_cast<float*>(part_val),
        static_cast<int*>(part_lag), num_programs, num_bins, num_blocks, sup,
        h_len, m_pad, num_lags, windows, share_h, bins_per_split, p0, sh);
    if (err != cudaSuccess) return err;
  }
  const unsigned decode_blocks = static_cast<unsigned>((total + 255) / 256);
  if (!top2) {
    stein_decode_keys<<<decode_blocks, 256, 0, s>>>(
        ks, static_cast<float*>(vals), static_cast<int*>(lags), total);
    return cudaGetLastError();
  }
  stein_reduce_top2<<<static_cast<unsigned>(
                          (total + kWarpsTop2 - 1) / kWarpsTop2),
                      32 * kWarpsTop2, 0, s>>>(
      static_cast<const float*>(part_val),
      static_cast<const int*>(part_lag), static_cast<float*>(vals),
      static_cast<int*>(lags), ks, num_programs, num_bins, m_pad, sep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* recompute =
      split ? stein_recompute_top2<true> : stein_recompute_top2<false>;
  for (int p0 = 0; p0 < num_programs; p0 += kGridZMax) {
    const int chunk = std::min(kGridZMax, num_programs - p0);
    err = launch_tiles(
        recompute, split, dim3(n_tiles * sh.c, splits, chunk), smem, s, sh.c,
        w1, w2, lm, hh, nv, static_cast<const int*>(lags), ks, num_programs,
        num_bins, num_blocks, sup, h_len, m_pad, num_lags, windows, share_h,
        bins_per_split, sep, p0, sh);
    if (err != cudaSuccess) return err;
  }
  stein_decode_keys<<<decode_blocks, 256, 0, s>>>(
      ks, static_cast<float*>(vals2), static_cast<int*>(lags2), total);
  return cudaGetLastError();
}

}  // extern "C"
