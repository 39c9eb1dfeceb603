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
// 2D = 256) and a quarter of rate3's (2K = 5508).  The two pipes are
// separate units, so the pipelined launch runs them at once.
//
// Design.  Two tile launches share stage A (stage_a: the same fmaf chain,
// so G is the plain version's bit for bit in both) and the epilogue's
// (max, lowest lag) rule; the wrapper picks one from the shape
// (ops/fused_stein.pipelined: 2B, D, top-2, cluster).
//   Stage A (FMA pipe): 8 warps (a team of the pipelined launch, or the
//     tile block) build a G tile, 2B rows x 128 lags in bf16, straight
//     into shared memory.  The haystack window and the taps of a segment
//     a warp arrive by cp.async into a double buffer (the next chunk of 8
//     segments loads while this one computes); each warp takes a
//     segment, each thread 4 consecutive lags, reusing haystack samples
//     from a 4-slot register ring (one shared load a plane and tap) and
//     the taps as float4 broadcasts; the window is stored with a skew
//     (i + i/4) so the ring's loads hit 32 banks.
//   The pipelined launch (stein_pipe; the atomic-key modes (a)-(d), (f)
//     at one block a tile where two G tiles, stage A's buffers and a ring
//     of 3 weight tiles fit a block: 2B <= 192 at D = 64, so configs 1-4,
//     the windowed banded engines and the rate engines; not the stream's
//     2B = 512 at D = 16).  A persistent block a SM of 640 threads walks
//     its share of the work items (program, lag tile, bin split),
//     consecutive lag tiles.  Two teams of 8 producer warps take every
//     other item each and build its G tile by stage A into the team's own
//     G buffer, in wgmma's K-major layout (no swizzle; rows b and B + b
//     as G rows 2b, 2b + 1, one 4-byte store); an mbarrier pair a buffer
//     (full / empty) hands it over.  One warpgroup runs stage B on the
//     tensor cores while the producers keep the FMA pipe busy with the
//     next tiles: per 32 bins and the tile's 128 lags, K / 16
//     wgmma.mma_async m64n128k16 (bf16 x bf16 -> f32, both operands from
//     shared memory), A the weights, their ws1 / ws2 rows interleaved by
//     8 so Rr and Ri of one (bin, lag) land in one thread's accumulator
//     pair; the rounding launch writes each 32-bin m-tile in the layout
//     the warpgroup reads and a bulk copy brings it, 3 in flight.
//     setmaxnreg gives the producers 88 registers and the warpgroup 128
//     (of 96 a thread at launch).  The epilogue masks past the bound
//     (only in a tile the bound cuts) and reduces each bin to (max,
//     lowest lag) as below; a G buffer goes back to the producers once
//     its last wgmma has retired.
//   The tile launch (stein_tile; the stream's chunk, the cluster split,
//     mode (e)): a block per (program, 128-lag tile, bin split) runs
//     stage A, then stage B on mma.sync.m16n8k16 bf16 x bf16 -> f32 over
//     its G tile, laid out [lag][row] with rows padded to 16 (+ 8), its
//     A operand the weights read from device memory beside each mma.  A
//     warp owns 8 bins x 128 lags: rows g = ws1[bin g], g + 8 = ws2[bin
//     g], so Rr and Ri land in one thread's accumulators (c0/c2, c1/c3)
//     and |R|^2 (mag2_rn, no fma contraction) needs no shuffle.
//   Epilogue: lags past the bound read -1.0; each bin's (max, lowest
//     lag) in ascending lag order, then across the 4 lanes of a group.
//   Reduce: a 64-bit atomicMax on an order-preserving key (value bits
//     mapped to unsigned, then ~lag) gives (max, lowest lag) whatever the
//     order the blocks finish in; a small launch decodes the keys.  No G
//     and no per-tile partials reach device memory.
//   Fill: where programs x tiles leave SMs idle (config 1: 64 tiles),
//     the wrapper splits the bins over blocks (the tile launch's grid y,
//     the pipelined launch's work items); stage A repeats per split, ~4
//     MFLOP a tile.
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
  int buf_len;    // floats per stage-A buffer: 2 planes + a chunk's taps
  size_t bytes;
  // chunk: stage A's segments a buffer (its warps), 8 in a tile block.
  __host__ __device__ TileSmem(int rows, int sup, bool split,
                               int chunk = kSegChunk) {
    g_stride = pad16(rows) + 8;
    hay_len = (skew(chunk * sup + kLagTile - 2) + 1 + 3) / 4 * 4;
    buf_len = 2 * hay_len + chunk * 4 * sup;
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

// Stage A's chunk loop for program p, lags [tau0, tau0 + kLagTile): the
// nseg segments from seg0 (kSplit; else all B from 0), kWarpsA at a time
// (lay's chunk), by 32 * kWarpsA threads of indices tid whose barrier is
// sync() (the tile block's 8 warps, or a pipelined block's team of 8).
// Chunk c's haystack window and taps arrive by cp.async into bufs (two
// buffers: the next chunk loads while this one computes); warp tid / 32
// takes a segment b, each lane 4 consecutive lags.  Each chunk calls
// before_stores(c), then store(lag, b, top, bot) with the f32 sums of G
// rows seg0 + b (top) and B + seg0 + b (bot) at lag tau0 + lag, for
// store to round to bf16.  Ends with sync().  lmat and h hold bf16
// values in f32.
template <bool kSplit, int kWarpsA, class Sync, class BeforeStores,
          class Store>
__device__ __forceinline__ void stage_a(
    const float* __restrict__ lmat, const float* __restrict__ h, int p,
    int num_blocks, int seg0_, int nseg_, int sup, int h_len, int windows,
    int share_h, int tau0, const TileSmem& lay, float* bufs, int tid,
    Sync sync, BeforeStores before_stores, Store store) {
  constexpr int kThreadsA = 32 * kWarpsA;
  const int warp = tid / 32, lane = tid % 32;
  const int seg0 = kSplit ? seg0_ : 0, nseg = kSplit ? nseg_ : num_blocks;
  // The TPU kernel's BlockSpec index maps.
  const int op = p / windows;
  const int slice = (p / (share_h * windows)) * windows + p % windows;
  const float* hp = h + static_cast<size_t>(slice) * 2 * h_len;
  const float* lp = lmat + static_cast<size_t>(op) * 2 * num_blocks * 2 * sup;

  const int chunks = (nseg + kWarpsA - 1) / kWarpsA;
  // Chunk c's haystack window: h[tau0 + (seg0 + c*kWarpsA)*D + i], i <
  // ns*D + 127, into both planes (skewed); its taps: rows b and B + b,
  // 2D each, per segment.
  auto stage_chunk = [&](int c) {
    float* buf = bufs + (c & 1) * lay.buf_len;
    const int b0 = c * kWarpsA;
    const int ns = min(kWarpsA, nseg - b0);
    const int len = ns * sup + kLagTile - 1;
    const float* src = hp + tau0 + (seg0 + b0) * sup;
    for (int i = tid; i < len; i += kThreadsA) {
      cp_async4(buf + skew(i), src + i);
      cp_async4(buf + lay.hay_len + skew(i), src + h_len + i);
    }
    float* taps = buf + 2 * lay.hay_len;
    const int vec = 2 * sup / 4;          // 16-byte pieces a tap row
    for (int i = tid; i < ns * 2 * vec; i += kThreadsA) {
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
    sync();
    const float* buf = bufs + (c & 1) * lay.buf_len;
    const int b = c * kWarpsA + warp;
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
      before_stores(c);
#pragma unroll
      for (int j = 0; j < kLagsPerThread; ++j)
        store(kLagsPerThread * lane + j, b, acc_top[j], acc_bot[j]);
    }
    sync();   // stage_chunk(c + 2) refills this buffer
  }
}

// Stage A of a tile block: the G tile of program p, lags [tau0, tau0 +
// kLagTile), for the nseg segments from seg0 (kSplit; else all B from
// 0): rows seg0 + b and B + seg0 + b of G into rows b and nseg + b of gs
// ([lag][row] bf16, row stride g_stride); rows [2*nseg, g_stride - 8)
// are zero.  All threads of the block take part; ends with a barrier.
template <bool kSplit>
__device__ void build_g_tile(const float* __restrict__ lmat,
                             const float* __restrict__ h, int p,
                             int num_blocks, int seg0_, int nseg_, int sup,
                             int h_len, int windows, int share_h, int tau0,
                             const TileSmem& lay, __nv_bfloat16* gs,
                             float* bufs) {
  const int tid = threadIdx.x;
  const int nseg = kSplit ? nseg_ : num_blocks;
  const int b2 = 2 * nseg, b2p = kSplit ? lay.g_stride - 8 : pad16(b2);
  for (int i = tid; i < kLagTile * (b2p - b2); i += kThreads) {
    const int lag = i / (b2p - b2), r = b2 + i % (b2p - b2);
    gs[lag * lay.g_stride + r] = __float2bfloat16_rn(0.f);
  }
  stage_a<kSplit, kSegChunk>(
      lmat, h, p, num_blocks, seg0_, nseg_, sup, h_len, windows, share_h,
      tau0, lay, bufs, tid, [] { __syncthreads(); }, [](int) {},
      [&](int lag, int b, float top, float bot) {
        __nv_bfloat16* row = gs + lag * lay.g_stride;
        row[b] = __float2bfloat16_rn(top);
        row[nseg + b] = __float2bfloat16_rn(bot);
      });
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

// ---------------------------------------------------------------------
// The pipelined tile kernel (atomic-key modes; see the head of the file).

constexpr int kTeams = 2;                   // stage-A producer teams a block
constexpr int kTeamWarps = 8;               // a team's warps: its chunk
constexpr int kTeamThreads = 32 * kTeamWarps;
constexpr int kProducerThreads = kTeams * kTeamThreads;
constexpr int kWgThreads = 128;             // the stage-B warpgroup
constexpr int kPipeThreads = kWgThreads + kProducerThreads;    // 640
constexpr int kRing = 3;                    // weight tiles in shared memory
constexpr int kMBins = 32;                  // bins a wgmma (64 rows: ws1, ws2)
// A G buffer in wgmma's K-major layout without swizzle: 8 lags x 8 rows
// (16 B a lag) make a 128-byte core matrix; a buffer's 8-row groups sit
// 128 bytes apart (kGLbo) and its 8-lag groups kp * 16 + 16 bytes apart
// (the 16 past the groups' matrices put the 4-byte stores of a warp's 32
// lags on 8 banks, not 2).
constexpr int kGLbo = 128;
// The weights' m-tile, 64 rows x K: 8-row groups 128 bytes apart, 8-column
// groups 1 KB apart, as the rounding launch writes it in device memory.
constexpr int kWSbo = 128;
constexpr int kWLbo = 64 / 8 * kWSbo;         // 1024
// setmaxnreg moves registers within the block: the launch gives each of
// the 640 threads 96 (__launch_bounds__: 65536 / 640, rounded down to 8),
// the producer warps give 8 each back and the warpgroup takes them.
constexpr int kLaunchRegs = 96;
constexpr int kProducerRegs = 88;
constexpr int kConsumerRegs = 128;
static_assert(kProducerThreads * (kProducerRegs - kLaunchRegs) +
                  kWgThreads * (kConsumerRegs - kLaunchRegs) <= 0,
              "setmaxnreg takes more registers than the block gives back");

// Shared memory of a pipelined block for 2B rows at block length sup:
// the mbarriers, the weight ring, the teams' G buffers, then each team's
// two stage-A buffers (TileSmem's).
struct PipeSmem {
  TileSmem stage;
  int kp;          // G rows padded to 16: wgmma's K
  int g_sbo;       // bytes between a G buffer's 8-lag groups
  int g_bytes;     // a G buffer
  int w_bytes;     // a weight m-tile (64 rows x kp bf16)
  size_t ring, g0, bufs0, bytes;
  __host__ __device__ PipeSmem(int b2, int sup)
      : stage(b2, sup, false, kTeamWarps), kp(pad16(b2)) {
    g_sbo = kp / 8 * kGLbo + 16;
    g_bytes = kLagTile / 8 * g_sbo;
    w_bytes = kp / 8 * kWLbo;
    ring = 128;                              // the barriers: 7 x 8 bytes
    g0 = ring + static_cast<size_t>(kRing) * w_bytes;
    bufs0 = g0 + static_cast<size_t>(kTeams) * g_bytes;
    bytes = bufs0 + kTeams * 2 * static_cast<size_t>(stage.buf_len) *
                        sizeof(float);
  }
};

// Byte offset of G's (lag, row k) in a G buffer.
__device__ __forceinline__ int g_offset(const PipeSmem& lay, int lag, int k) {
  return (lag >> 3) * lay.g_sbo + (k >> 3) * kGLbo + (lag & 7) * 16 +
         (k & 7) * 2;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait for the completion of bar's phase of parity `parity`.  The hint
// (ns) lets the hardware suspend a waiting thread until the phase
// completes rather than return at once, so waiting warps spin less and
// leave the issue slots to the warps that work.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 100000;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// One thread: `bytes` from global src into shared dst by the bulk copy
// engine, completing on bar (which expects them).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A no-swizzle K-major wgmma operand at shared address addr.
__device__ __forceinline__ uint64_t wgmma_desc(unsigned addr, int lbo,
                                               int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (+)= A (64 x 16, desc a) x B (16 x 128, K-major, desc b), bf16 in,
// f32 accumulators; d[4j + q] is row 16w + lane/4, column 8j + 2(lane%4)
// + q of warp w of the group, d[4j + 2 + q] the row 8 below.
__device__ __forceinline__ void wgmma_n(float (&d)[64], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// setmaxnreg for the calling warpgroup: kRegs registers a thread, from
// the launch's kLaunchRegs.
template <int kRegs>
__device__ __forceinline__ void set_max_regs() {
  if constexpr (kRegs > kLaunchRegs)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
  else if constexpr (kRegs < kLaunchRegs)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// A walk over work items (program, lag tile, bin split), split fastest:
// one division at its start, none a step.
struct ItemWalk {
  int p, tile, split;
  __device__ ItemWalk(long long item, int splits, int n_tiles) {
    split = static_cast<int>(item % splits);
    const long long r = item / splits;
    tile = static_cast<int>(r % n_tiles);
    p = static_cast<int>(r / n_tiles);
  }
  __device__ void next(int splits, int n_tiles) {
    if (++split == splits) {
      split = 0;
      if (++tile == n_tiles) {
        tile = 0;
        ++p;
      }
    }
  }
};

// The warpgroup's epilogue over a G tile: lags lag0 + 8j + q (j < kAcc /
// 4, q < 2; lag0 = tau0 + 2t) of acc (Rr at 4j + q, Ri at 4j + 2 + q)
// into (best, arg), in ascending lag order.
// kMasked: lags at or past bound read -1.0.  |R|^2 takes one fma (within
// stage_b_error_bound's 2^-22 v, as mag2_rn is; no recompute repeats it).
template <bool kMasked, int kAcc>
__device__ __forceinline__ void scan_lags(const float (&acc)[kAcc], int lag0,
                                          int bound, float& best, int& arg) {
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int tau = lag0 + 8 * j + q;
      const float rr = acc[4 * j + q], ri = acc[4 * j + 2 + q];
      float v = __fmaf_rn(rr, rr, __fmul_rn(ri, ri));
      if (kMasked && tau >= bound) v = -1.f;
      if (v > best) {  // strict: a tie keeps the lower lag
        best = v;
        arg = tau;
      }
    }
  }
}

// The pipelined launch.  A persistent block of kPipeThreads threads takes
// the work items [i0, i1) of items = programs x lag tiles x bin splits
// (program-major, then tile, then split; ~items / gridDim.x a block, so
// consecutive lag tiles).  Warpgroup 0 runs stage B; warps 4-11 (team 0)
// and 12-19 (team 1) run stage A.  Item i0 + j goes to team j % 2, whose
// own G buffer j % 2 holds it: full[t] (256 arrivals) hands it to the
// warpgroup, empty[t] (128) back, so one team's tile is on the tensor
// cores while both teams' FMAs run.  The warpgroup walks the items in
// order and, per 32-bin m-tile of the item's bins,
// waits for that weight tile in the ring (wfull, one bulk copy each,
// issued a ring ahead by thread 0), runs K / 16 wgmma over the tile's
// 128 lags (ws1 / ws2 rows interleaved by 8), and reduces each
// bin to (max, lowest lag) as stein_tile does, into keys by atomicMax.
__global__ void __launch_bounds__(kPipeThreads, 1) stein_pipe(
    const __nv_bfloat16* __restrict__ wt, const float* __restrict__ lmat,
    const float* __restrict__ h, const int* __restrict__ num_valid,
    unsigned long long* __restrict__ keys, int num_programs, int num_bins,
    int num_blocks, int sup, int h_len, int m_pad, int num_lags,
    int windows, int share_h, int bins_per_split, long long items) {
  extern __shared__ __align__(128) unsigned char pipe_smem[];
  const PipeSmem lay(2 * num_blocks, sup);
  uint64_t* full = reinterpret_cast<uint64_t*>(pipe_smem);
  uint64_t* empty = full + kTeams;
  uint64_t* wfull = empty + kTeams;
  const int splits = (num_bins + bins_per_split - 1) / bins_per_split;
  const int n_tiles = m_pad / kLagTile;
  const long long i0 = items * blockIdx.x / gridDim.x;
  const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kTeams; ++b) {
      mbar_init(full + b, kTeamThreads);
      mbar_init(empty + b, kWgThreads);
    }
    for (int r = 0; r < kRing; ++r) mbar_init(wfull + r, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWgThreads) {
    // Stage A: a team builds its items' G tiles in its own buffer.
    set_max_regs<kProducerRegs>();
    const int team = (threadIdx.x - kWgThreads) / kTeamThreads;
    const int tid = threadIdx.x - kWgThreads - team * kTeamThreads;
    unsigned char* gb = pipe_smem + lay.g0 + team * lay.g_bytes;
    float* bufs = reinterpret_cast<float*>(pipe_smem + lay.bufs0) +
                  team * 2 * lay.stage.buf_len;
    // Rows [2B, kp) of G: zeros that stage A never writes.
    const int b2 = 2 * num_blocks, pad = lay.kp - b2;
    for (int i = tid; i < kLagTile * pad; i += kTeamThreads)
      *reinterpret_cast<__nv_bfloat16*>(
          gb + g_offset(lay, i / pad, b2 + i % pad)) = __float2bfloat16_rn(0.f);
    ItemWalk w(i0 + team, splits, n_tiles);
    int use = 0;
    for (long long it = i0 + team; it < i1; it += kTeams, ++use) {
      stage_a<false, kTeamWarps>(
          lmat, h, w.p, num_blocks, 0, num_blocks, sup, h_len, windows,
          share_h, w.tile * kLagTile, lay.stage, bufs, tid,
          [=] { named_sync(1 + team, kTeamThreads); },
          // The buffer's last tile must be off the tensor cores before
          // the first chunk's stores: chunk 0's sums overlap that wait.
          [&](int c) {
            if (c == 0 && use > 0) mbar_wait(empty + team, (use - 1) & 1);
          },
          // Rows b and B + b as G rows 2b, 2b + 1: one 4-byte store.
          [&](int lag, int b, float top, float bot) {
            *reinterpret_cast<__nv_bfloat162*>(
                gb + g_offset(lay, lag, 2 * b)) =
                __floats2bfloat162_rn(top, bot);
          });
      // The stores, made by the generic proxy, before wgmma reads them.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + team);
      for (int n = 0; n < kTeams; ++n) w.next(splits, n_tiles);
    }
  } else {
    // Stage B: the warpgroup.
    set_max_regs<kConsumerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int ksteps = lay.kp / 16;
    unsigned char* ring = pipe_smem + lay.ring;
    // Thread 0's cursor over the sequence of weight m-tiles: the bin
    // split of the item it is in, the m-tile in it, the ring slot.
    long long f_left = i1 - i0;
    int f_split = static_cast<int>(i0 % splits), f_m = 0, f_slot = 0;
    auto fetch = [&] {
      if (f_left == 0) return;
      const int k_lo = f_split * bins_per_split;
      const int nm =
          (min(num_bins, k_lo + bins_per_split) - k_lo + kMBins - 1) / kMBins;
      bulk_load(ring + f_slot * lay.w_bytes,
                wt + static_cast<size_t>(k_lo / kMBins + f_m) * 64 * lay.kp,
                lay.w_bytes, wfull + f_slot);
      if (++f_slot == kRing) f_slot = 0;
      if (++f_m == nm) {
        f_m = 0;
        --f_left;
        if (++f_split == splits) f_split = 0;
      }
    };
    if (threadIdx.x == 0)
      for (int r = 0; r < kRing; ++r) fetch();
    float acc[kLagTile / 2];
    int slot = 0;
    unsigned phase = 0;
    ItemWalk w(i0, splits, n_tiles);
    for (long long j = 0; j < i1 - i0; ++j, w.next(splits, n_tiles)) {
      const int buf = static_cast<int>(j % kTeams);
      const int k_lo = w.split * bins_per_split;
      const int k_hi = min(num_bins, k_lo + bins_per_split);
      const int nm = (k_hi - k_lo + kMBins - 1) / kMBins;
      const int tau0 = w.tile * kLagTile;
      const int bound = num_valid ? min(num_valid[w.p], num_lags) : num_lags;
      const bool whole = tau0 + kLagTile <= bound;       // no lag masked
      mbar_wait(full + buf, static_cast<unsigned>((j / kTeams) & 1));
      const unsigned gaddr = smem_u32(pipe_smem + lay.g0 + buf * lay.g_bytes);
      for (int m = 0; m < nm; ++m) {
        mbar_wait(wfull + slot, phase);
        const unsigned waddr = smem_u32(ring + slot * lay.w_bytes);
        wgmma_fence();
        for (int s = 0; s < ksteps; ++s) {
          wgmma_n(acc, wgmma_desc(waddr + s * 2 * kWLbo, kWLbo, kWSbo),
                  wgmma_desc(gaddr + s * 2 * kGLbo, kGLbo, lay.g_sbo), s);
        }
        wgmma_commit();
        wgmma_wait_all();
        if (m == nm - 1) mbar_arrive(empty + buf);   // G back to its team
        named_sync(1 + kTeams, kWgThreads);          // the slot read
        if (threadIdx.x == 0) fetch();
        float best = -INFINITY;
        int arg = 0;
        if (whole)
          scan_lags<false>(acc, tau0 + 2 * t, bound, best, arg);
        else
          scan_lags<true>(acc, tau0 + 2 * t, bound, best, arg);
        if (++slot == kRing) {
          slot = 0;
          phase ^= 1;
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int ol = __shfl_xor_sync(0xffffffffu, arg, off);
          keep_better(ov, ol, best, arg);
        }
        const int k = k_lo + m * kMBins + warp * kBinGroup + g;
        if (t == 0 && k < k_hi)
          atomicMax(keys + static_cast<size_t>(k) * num_programs + w.p,
                    rank_key(best, arg));
      }
    }
  }
}

// The pipelined launch's rounding: ws1 / ws2 into wt (ceil(K / 32)
// m-tiles of 64 rows x kp columns, each in the shared-memory image the
// warpgroup reads: row 16w + r of an m-tile is ws1 of bin 32m + 8w + r,
// row 16w + 8 + r ws2's; column 2b is weight column b, 2b + 1 column B +
// b, zero past 2B and past K), lmat and h into f32 copies holding bf16
// values.
__global__ void stein_round_pipe(const float* __restrict__ ws1,
                                 const float* __restrict__ ws2,
                                 const float* __restrict__ lmat,
                                 const float* __restrict__ h,
                                 __nv_bfloat16* __restrict__ wt,
                                 float* __restrict__ lmat_r,
                                 float* __restrict__ h_r, size_t n_wt,
                                 size_t n_lmat, size_t n_h, int num_bins,
                                 int num_blocks, int kp) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_wt + n_lmat + n_h; i += stride) {
    if (i < n_wt) {
      const size_t tile = i / (64 * static_cast<size_t>(kp));
      const int e = static_cast<int>(i % (64 * static_cast<size_t>(kp)));
      // e = (k/8)*512 + (row/8)*64 + (row%8)*8 + k%8
      const int k = (e / 512) * 8 + e % 8;
      const int row = ((e % 512) / 64) * 8 + (e % 64) / 8;
      const size_t bin = tile * kMBins + (row / 16) * kBinGroup + row % 8;
      const int col = k < 2 * num_blocks
          ? (k % 2 ? num_blocks + k / 2 : k / 2) : -1;
      const float* w = row % 16 < 8 ? ws1 : ws2;
      wt[i] = __float2bfloat16_rn(
          col < 0 || bin >= static_cast<size_t>(num_bins)
              ? 0.f : w[bin * 2 * num_blocks + col]);
    } else if (i < n_wt + n_lmat) {
      const size_t j = i - n_wt;
      lmat_r[j] = __bfloat162float(__float2bfloat16_rn(lmat[j]));
    } else {
      const size_t j = i - n_wt - n_lmat;
      h_r[j] = __bfloat162float(__float2bfloat16_rn(h[j]));
    }
  }
}

// The pipelined path of caf_fused_stein_rank: its rounding launch, the
// keys' reset, the persistent tile launch and the decode launch.
cudaError_t pipe_rank(const void* ws1, const void* ws2, const void* lmat,
                      const void* h, void* wt, void* lmat_r, void* h_r,
                      const void* num_valid, void* keys, void* vals,
                      void* lags, bool refused, int num_programs,
                      int num_bins, int num_blocks, int sup, int h_len,
                      int num_lags, int m_pad, int windows, int share_h,
                      int bins_per_split, int blocks, cudaStream_t s) {
  const PipeSmem lay(2 * num_blocks, sup);
  if (refused || lay.bytes > kSmemPerBlock) return cudaErrorInvalidValue;
  const size_t n_wt = static_cast<size_t>((num_bins + kMBins - 1) / kMBins) *
                      64 * lay.kp;
  const size_t n_lmat = static_cast<size_t>(num_programs / windows) * 2 *
                        num_blocks * 2 * sup;
  const size_t n_h =
      static_cast<size_t>(num_programs / share_h) * 2 * h_len;
  const size_t n_round = n_wt + n_lmat + n_h;
  stein_round_pipe<<<static_cast<unsigned>(
                         std::min<size_t>((n_round + 255) / 256, 4096)),
                     256, 0, s>>>(
      static_cast<const float*>(ws1), static_cast<const float*>(ws2),
      static_cast<const float*>(lmat), static_cast<const float*>(h),
      static_cast<__nv_bfloat16*>(wt), static_cast<float*>(lmat_r),
      static_cast<float*>(h_r), n_wt, n_lmat, n_h, num_bins, num_blocks,
      lay.kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(num_programs) * num_bins;
  err = cudaMemsetAsync(keys, 0, total * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stein_pipe,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return err;
  const int splits = (num_bins + bins_per_split - 1) / bins_per_split;
  const long long items =
      static_cast<long long>(num_programs) * (m_pad / kLagTile) * splits;
  auto* ks = static_cast<unsigned long long*>(keys);
  stein_pipe<<<blocks, kPipeThreads, lay.bytes, s>>>(
      static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(lmat_r), static_cast<const float*>(h_r),
      static_cast<const int*>(num_valid), ks, num_programs, num_bins,
      num_blocks, sup, h_len, m_pad, num_lags, windows, share_h,
      bins_per_split, items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stein_decode_keys<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      s>>>(ks, static_cast<float*>(vals),
                           static_cast<int*>(lags), total);
  return cudaGetLastError();
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

// The pipelined launch's dynamic shared memory for 2B rows at block
// length sup (bytes; it takes the shape when at most kSmemPerBlock).
long long caf_fused_stein_pipe_smem(int b2, int sup) {
  return static_cast<long long>(PipeSmem(b2, sup).bytes);
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
// bins_per_split a multiple of kBinPass.  pipe_blocks > 0 takes the
// pipelined launch on that many persistent blocks (no top-2, one block a
// tile, caf_fused_stein_pipe_smem within a block's shared memory; ws_b
// then holds ceil(K / 32) x 64 x pad16(2B) bf16), 0 the tile launch.
// Enqueues the work on `stream`, on the calling thread's current device
// (the operands' card); returns the first CUDA error (0 on success;
// cudaErrorInvalidValue for 2B past the ceiling or a pipelined launch of
// a shape it does not take).
int caf_fused_stein_rank(const void* ws1, const void* ws2, const void* lmat,
                         const void* h, void* ws_b, void* lmat_r, void* h_r,
                         const void* num_valid, void* keys, void* part_val,
                         void* part_lag, void* vals, void* lags, void* vals2,
                         void* lags2, int num_programs, int num_bins,
                         int num_blocks, int sup, int h_len, int num_lags,
                         int m_pad, int windows, int share_h, int sep,
                         int bins_per_split, int pipe_blocks, void* stream) {
  cudaError_t err = cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  const Share sh = row_plan(num_blocks, sup, smem);
  if (sh.c == 0) return cudaErrorInvalidValue;
  if (pipe_blocks > 0)
    return pipe_rank(ws1, ws2, lmat, h, ws_b, lmat_r, h_r, num_valid, keys,
                     vals, lags, vals2 != nullptr || sh.c != 1, num_programs,
                     num_bins, num_blocks, sup, h_len, num_lags, m_pad,
                     windows, share_h, bins_per_split, pipe_blocks, s);
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
