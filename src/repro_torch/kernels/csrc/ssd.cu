// Mamba2 SSD scan: y and the final state, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd (its
// pl.pallas_call, line 71). Layout is the same: x (B,H,S,P), dt (B,H,S),
// a (H,), b and c (B,S,N) shared by every head, initial state (B,H,P,N)
// -> y (B,H,S,P), final state (B,H,P,N). Per head:
//
//     h_t = exp(a dt_t) h_{t-1} + dt_t x_t b_t^T,   y_t = h_t c_t
//
// It computes the TPU kernel's chunked form, in tiles of kL = 32 tokens
// whatever the caller's chunk (the same function; sums in another order).
// Per tile, with lda_t = dt_t a <= 0, ca_t = sum_{j<=t} lda_j from the
// tile's start, after_s = sum_{j>s} lda_j to its end, and the state S
// (P x N) carried in from the tile before:
//
//     M   = (C B^T) o D,  D[t][s] = exp(sum_{s<j<=t} lda_j) dt_s for s <= t,
//                         0 above the diagonal                  (L x L)
//     Y^T = (S C^T) diag(exp(ca)) + X^T M^T                     (P x L)
//     S  <- exp(ca_last) S + (X o w)^T B,  w_s = exp(after_s) dt_s
//
// The products run on the tensor cores as mma.sync m16n8k8 TF32 in three
// passes (3xTF32): every fp32 operand v is split into hi (v cut to TF32)
// and lo = v - hi, and lo*hi + hi*lo + hi*hi accumulate in fp32, which
// keeps float32 accuracy (one TF32 pass errs by about 1e-3 relative per
// product). The decay exponents are never differences of prefix sums
// over the tile (which cancel once ca is large): below the diagonal's
// 8-token block, D's exponent is the sum of lda after s to the end of s's
// block, the totals of the blocks between and the sum from t's block's
// start to t; within that block its terms are summed one by one; every
// lda has one sign, so no sum cancels.
//
// What bounds it on an H100: at the serving path's shape (B=4, H=112,
// S=512, P=N=64) it reads x, dt, b, c and the initial state and writes y
// and the final state once, 134.1 MB: 40.0 us at 3.35 TB/s, the bound.
// Its products as run (320 m16n8k8 a tile and head) are 4.7 GFLOP,
// 14.1 in three TF32 passes: 28.5 us at the 495 TFLOP/s dense TF32 rate,
// of which mma.sync reaches part. The literal recurrence's 4.7 GFLOP of
// fp32 FMAs would take 70 us at 67 TFLOP/s.
//
// Design. One block of 8 warps per (b, two heads): b and c, which every
// head shares, are staged once for both, and C B^T is computed once for
// both. The block walks the tiles in order (the TPU grid's sequential
// chunk axis). x, b, c and dt of a tile are staged by cp.async into a
// two-stage shared-memory ring: tile k+1 is in flight while tile k is
// multiplied. Rows past S are zero-filled (dt = 0 gives lda = 0, w = 0
// and D = 0 there), so a ragged last tile needs no other mask than the
// store of y; with H odd, the last block's second head is all zeros and
// stores nothing.
//
// y is computed transposed, so that the state never leaves the registers:
// each head has 4 warps, and each warp owns 16 rows of p (all of them at
// P = 64; at P = 32 two warps share a row block and split the tile's
// tokens) and holds those rows of S, all of n, as mma accumulators across
// the tiles. They are the A operand of S C^T as they lie (the state's n
// columns are numbered so that an accumulator's columns 2c, 2c + 1 are
// the A fragment's c, c + 4), and the warp adds its own X^T M^T and
// advances its own rows of S: nothing about the state is shared. Per
// tile: warps 6 and 7 write the per-token sums of their head (warp
// scans); warps 0-5 each compute one of the six 16x8 tiles of C B^T at
// or below the diagonal, then (after a barrier) multiply it by each
// head's D, computed in place from those sums, and store it split (hi,
// lo) in shared memory; after a second barrier every warp takes X^T M^T,
// skipping the tiles above the diagonal. Shared rows are padded (4 floats
// for x, b, c and the staged states; 8 for M, read as float2), so every
// fragment load hits 32 different banks. Three barriers a tile; 92 KB of
// shared memory at P = N = 64 and at most 128 registers a thread, so two
// blocks fit an SM and all 224 blocks of the served shape run at once.
// The states go in and out through shared memory, whole rows at a time.
// P is 32 or 64, N is 16, 32 or 64. x, b and c may be strided views with
// unit stride along their last axis (the model passes slices of one
// projection); dt may have any strides.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace {

constexpr int kL = 32;         // tokens per tile
constexpr int kG = 2;          // heads per block
constexpr int kHeadWarps = 4;  // warps per head
constexpr int kWarps = kG * kHeadWarps;
constexpr int kThreads = kWarps * 32;
constexpr int kMStride = kL + 8;   // padded row of D and M

struct Strides {
  long long x_b, x_h, x_s;   // x (B,H,S,P), P contiguous
  long long dt_b, dt_h, dt_s;
  long long bc_b, bc_s;      // b and c (B,S,N), N contiguous
};

template <int P, int N>
struct Smem {
  static constexpr int kXS = P + 4;   // padded row of x
  static constexpr int kBS = N + 4;   // padded row of b and c
  // a stage: x and dt of each head, b and c shared
  static constexpr int kStage = kG * kL * kXS + 2 * kL * kBS + kG * kL;
  // per head: M's hi and lo parts; exp(ca), w; lda, its sums within
  // 8-token blocks (inclusive from the block's start, exclusive to its
  // end) and the block totals; exp(ca_last)
  static constexpr int kHead = 2 * kL * kMStride + 5 * kL + 8;
  static constexpr int kFloats = 2 * kStage + kG * kHead;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One 16x8 tile of C B^T: rows r0..r0+15, s 8 j..8 j+7
template <int N>
__device__ __forceinline__ void cb_tile(float (&acc)[4], const float* cs,
                                        const float* bs, int r0, int j,
                                        int g, int c) {
  constexpr int kBS = N + 4;
  // the three passes in three accumulators: chains a third as long
  float part[3][4] = {};
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += 8) {
    const float* c0 = cs + (r0 + g) * kBS + n0 + c;
    FragA a;
    a.set(c0[0], c0[8 * kBS], c0[4], c0[8 * kBS + 4]);
    const float* b0 = bs + (8 * j + g) * kBS + n0 + c;
    uint32_t h0, l0, h1, l1;
    split(b0[0], h0, l0);
    split(b0[4], h1, l1);
    mma_tf32(part[0], a.lo, h0, h1);
    mma_tf32(part[1], a.hi, l0, l1);
    mma_tf32(part[2], a.hi, h0, h1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e] = part[2][e] + (part[0][e] + part[1][e]);
  }
}

// Per-token values of one head's tile in shared memory
struct TileScalars {
  float* ec;      // [kL] exp(ca_t), ca_t = sum_{j<=t} lda_j
  float* wv;      // [kL] exp(after_s) dt_s, after_s = sum_{j>s} lda_j
  float* lda;     // [kL] dt_t a
  float* pre;     // [kL] sum of lda from t's 8-token block's start to t
  float* suf;     // [kL] sum of lda after s to the end of s's block
  float* blk;     // [kL / 8] block totals
  float* elast;   // exp(ca of the last token)
};

// lane = token: the head's TileScalars from dt and a (warp scans; every
// lda has one sign, so no sum cancels)
__device__ __forceinline__ void tile_scalars(const float* dts, float ah,
                                             const TileScalars& ts,
                                             int lane) {
  const float dtt = dts[lane];
  const float lda = dtt * ah;
  const int in8 = lane & 7;
  float ca = lda;    // inclusive prefix over the tile
  float suf = lda;   // inclusive suffix over the tile
  float pre8 = lda;  // inclusive prefix within the 8-token block
  float suf8 = lda;  // inclusive suffix within the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, ca, o);
    const float down = __shfl_down_sync(0xffffffffu, suf, o);
    if (lane >= o) ca += up;
    if (lane + o < 32) suf += down;
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, pre8, o, 8);
    const float down = __shfl_down_sync(0xffffffffu, suf8, o, 8);
    if (in8 >= o) pre8 += up;
    if (in8 + o < 8) suf8 += down;
  }
  float after = __shfl_down_sync(0xffffffffu, suf, 1);
  float after8 = __shfl_down_sync(0xffffffffu, suf8, 1);
  if (lane == 31) after = 0.f;
  if (in8 == 7) after8 = 0.f;
  ts.ec[lane] = expf(ca);
  ts.wv[lane] = expf(after) * dtt;
  ts.lda[lane] = lda;
  ts.pre[lane] = pre8;
  ts.suf[lane] = after8;
  if (in8 == 7) ts.blk[lane >> 3] = pre8;
  if (lane == 31) *ts.elast = expf(ca);
}

// The same tile multiplied by one head's decay D[t][s] = exp(seg) dt_s,
// seg = sum_{s<j<=t} lda_j on and below the diagonal (0 above), and
// stored split into that head's M (hi and lo parts). Below the diagonal's
// 8-token block seg = suf[s] + the blocks between + pre[t]; within it,
// the terms are summed one by one.
__device__ __forceinline__ void m_tile(const float (&acc)[4],
                                       const float* dts,
                                       const TileScalars& ts, float* mh,
                                       float* ml, int r0, int j, int g,
                                       int c) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r0 + g + 8 * half;
    const int bt = t >> 3;
    float dec[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 8 * j + 2 * c + e;
      float seg = 0.f;
      if (bt > j) {
        seg = ts.suf[s];
        for (int i = j + 1; i < bt; ++i) seg += ts.blk[i];
        seg += ts.pre[t];
      } else {
#pragma unroll
        for (int q = 1; q < 8; ++q) {
          const int jj = 8 * j + q;
          seg += jj > s && jj <= t ? ts.lda[jj] : 0.f;
        }
      }
      dec[e] = t >= s ? expf(seg) * dts[s] : 0.f;
    }
    const int at = t * kMStride + 8 * j + 2 * c;
    uint32_t h0, l0, h1, l1;
    split(acc[2 * half] * dec[0], h0, l0);
    split(acc[2 * half + 1] * dec[1], h1, l1);
    *reinterpret_cast<float2*>(mh + at) =
        make_float2(__uint_as_float(h0), __uint_as_float(h1));
    *reinterpret_cast<float2*>(ml + at) =
        make_float2(__uint_as_float(l0), __uint_as_float(l1));
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_tc(const float* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ a, const float* __restrict__ bm,
       const float* __restrict__ cm, const float* __restrict__ s0,
       float* __restrict__ y, float* __restrict__ sout, int heads, int seq,
       Strides sd) {
  using Sm = Smem<P, N>;
  constexpr int kXS = Sm::kXS;
  constexpr int kBS = Sm::kBS;
  constexpr int kPBlocks = P / 16;                     // 16-row blocks of p
  constexpr int kTT = kL / 8 / (kHeadWarps / kPBlocks);  // t tiles a warp
  constexpr int kNT = N / 8;                           // n8 tiles of S
  static_assert(kPBlocks * (kHeadWarps / kPBlocks) == kHeadWarps, "P");

  extern __shared__ __align__(16) float smem[];
  const int hblocks = (heads + kG - 1) / kG;
  const int b = blockIdx.x / hblocks;
  const int hbase = (blockIdx.x % hblocks) * kG;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  // this warp's head; the second head of the last block may not exist
  // (odd H): its warps compute on zeros and store nothing
  const int hw = warp / kHeadWarps;
  const int lw = warp % kHeadWarps;
  const int h = hbase + hw;
  const bool live = h < heads;

  float* stage0 = smem;                                // kStage each, x2
  float* head0 = smem + 2 * Sm::kStage;                // kHead each
  auto stage_x = [&](int st, int hh) {
    return stage0 + st * Sm::kStage + hh * kL * kXS;
  };
  auto stage_b = [&](int st) {
    return stage0 + st * Sm::kStage + kG * kL * kXS;
  };
  auto stage_c = [&](int st) { return stage_b(st) + kL * kBS; };
  auto stage_dt = [&](int st, int hh) {
    return stage_c(st) + kL * kBS + hh * kL;
  };
  auto head_mh = [&](int hh) { return head0 + hh * Sm::kHead; };
  auto head_ml = [&](int hh) { return head_mh(hh) + kL * kMStride; };
  auto head_ts = [&](int hh) {
    float* p = head_ml(hh) + kL * kMStride;
    return TileScalars{p, p + kL, p + 2 * kL, p + 3 * kL, p + 4 * kL,
                       p + 5 * kL, p + 5 * kL + kL / 8};
  };

  // This thread's share of a tile's copies, 16 bytes each: rows of its
  // own head's x (P / 4 threads a row), rows of b and c (N / 4 threads a
  // row), and one dt of either head. Rows past S, and the head that does
  // not exist, are zero-filled.
  constexpr int kXRows = kHeadWarps * 32 / (P / 4);   // x rows a pass
  constexpr int kBRows = kThreads / (N / 4);          // b, c rows a pass
  const int lt = tid % (kHeadWarps * 32);
  const int xr = lt / (P / 4);
  const int xcol = (lt % (P / 4)) * 4;
  const float* xsrc = x + b * sd.x_b + (live ? h : 0) * sd.x_h +
                      xr * sd.x_s + xcol;
  const int br = tid / (N / 4);
  const int bcol = (tid % (N / 4)) * 4;
  const long long boff = b * sd.bc_b + br * sd.bc_s + bcol;

  auto load_tile = [&](int tile, int st) {
    const int t0 = tile * kL;
    float* xs = stage_x(st, hw);
#pragma unroll
    for (int q = 0; q < kL / kXRows; ++q) {
      const int r = xr + q * kXRows;
      const bool ok = live && t0 + r < seq;
      cp_async16(xs + r * kXS + xcol,
                 ok ? xsrc + (t0 + q * kXRows) * sd.x_s : x, ok);
    }
    float* bs = stage_b(st);
    float* cs = stage_c(st);
#pragma unroll
    for (int q = 0; q < (kL + kBRows - 1) / kBRows; ++q) {
      const int r = br + q * kBRows;
      if (r < kL) {
        const bool ok = t0 + r < seq;
        const long long off = ok ? boff + (t0 + q * kBRows) * sd.bc_s : 0;
        cp_async16(bs + r * kBS + bcol, bm + off, ok);
        cp_async16(cs + r * kBS + bcol, cm + off, ok);
      }
    }
    if (tid < kG * kL) {
      const int hh = tid / kL;
      const int r = tid % kL;
      const bool ok = t0 + r < seq && hbase + hh < heads;
      const float* src =
          ok ? dt + b * sd.dt_b + (hbase + hh) * sd.dt_h + (t0 + r) * sd.dt_s
             : dt;
      cp_async4(stage_dt(st, hh) + r, src, ok);
    }
  };
  // the initial states of both heads, staged where tile 1 will go
  constexpr int kSS = N + 4;   // padded row of a staged state
  static_assert(kG * P * kSS <= Sm::kStage, "a state must fit a stage");
  float* sst = stage0 + Sm::kStage;
  for (int i = tid; i < kG * P * (N / 4); i += kThreads) {
    const int hh = i / (P * (N / 4));
    const int r = (i / (N / 4)) % P;
    const int col = (i % (N / 4)) * 4;
    const bool ok = hbase + hh < heads;
    const long long row =
        (static_cast<long long>(b) * heads + hbase + hh) * P + r;
    cp_async16(sst + (hh * P + r) * kSS + col, ok ? s0 + row * N + col : s0,
               ok);
  }
  load_tile(0, 0);
  cp_async_commit();

  // this warp's rows of p, and its tiles of the tile's tokens
  const int p0 = (lw % kPBlocks) * 16;
  const int i0 = kPBlocks == kHeadWarps ? 0 : (lw / kPBlocks) * kTT;
  // Its rows of the state, all of n. Column j of the accumulator's n8
  // tile u is n = 8u + (j / 2) + 4 (j % 2): the columns 2c, 2c + 1 a lane
  // holds are n = 8u + c and 8u + c + 4, which S C^T takes as the A
  // fragment's k = c and c + 4.
  float state[kNT][4];
  cp_async_wait_all();
  __syncthreads();   // the staged states (and tile 0) are visible
  {
    const float* sr = sst + (hw * P + p0 + g) * kSS + c;
#pragma unroll
    for (int u = 0; u < kNT; ++u) {
      state[u][0] = sr[8 * u];
      state[u][1] = sr[8 * u + 4];
      state[u][2] = sr[8 * kSS + 8 * u];
      state[u][3] = sr[8 * kSS + 8 * u + 4];
    }
  }
  const int perm_g = (g >> 1) + 4 * (g & 1);   // the column n of lane g
  // the tile of C B^T warps 0-5 compute: rows 0-15 with s 0-7, 8-15;
  // rows 16-31 with s 0-7, ..., 24-31
  const int mr0 = warp < 2 ? 0 : 16;
  const int mj = warp < 2 ? warp : warp - 2;

  const int tiles = (seq + kL - 1) / kL;
  for (int k = 0; k < tiles; ++k) {
    const int st = k & 1;
    const float* xs = stage_x(st, hw);
    const float* bs = stage_b(st);
    const float* cs = stage_c(st);
    cp_async_wait_all();   // this thread's copies of tile k have landed
    // tile k visible to all; every warp done with tile k - 1, its stage,
    // M and the per-token sums
    __syncthreads();
    if (k + 1 < tiles) {
      load_tile(k + 1, st ^ 1);
      cp_async_commit();
    }

    // the per-token values of heads 0 and 1 (warps 6, 7)
    if (warp >= 6) {
      const int hh = warp - 6;
      const float ah = hbase + hh < heads ? a[hbase + hh] : 0.f;
      tile_scalars(stage_dt(st, hh), ah, head_ts(hh), lane);
    }

    // Y^T = S C^T over this warp's tokens: the state's accumulators as A
    float yt[kTT][4];
#pragma unroll
    for (int i = 0; i < kTT; ++i) {
      yt[i][0] = yt[i][1] = yt[i][2] = yt[i][3] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kNT; ++u) {
      FragA fs;
      fs.set(state[u][0], state[u][2], state[u][1], state[u][3]);
#pragma unroll
      for (int i = 0; i < kTT; ++i) {
        const float* c0 = cs + (8 * (i0 + i) + g) * kBS + 8 * u + c;
        mma3(yt[i], fs, c0[0], c0[4]);
      }
    }
    // a tile of C B^T (warps 0-5)
    float cbt[4];
    if (warp < 6) cb_tile<N>(cbt, cs, bs, mr0, mj, g, c);
    __syncthreads();   // the per-token values are written
    if (warp < 6) {
#pragma unroll
      for (int hh = 0; hh < kG; ++hh) {
        m_tile(cbt, stage_dt(st, hh), head_ts(hh), head_mh(hh), head_ml(hh),
               mr0, mj, g, c);
      }
    }
    __syncthreads();   // M is written

    const float* mh = head_mh(hw);
    const float* ml = head_ml(hw);
    const TileScalars ts = head_ts(hw);
    const float* ec = ts.ec;
    const float* wv = ts.wv;
    // y^T's columns t scaled by exp(ca_t)
#pragma unroll
    for (int i = 0; i < kTT; ++i) {
      const float2 e = *reinterpret_cast<const float2*>(
          ec + 8 * (i0 + i) + 2 * c);
      yt[i][0] *= e.x;
      yt[i][1] *= e.y;
      yt[i][2] *= e.x;
      yt[i][3] *= e.y;
    }
    // Y^T += X^T M^T below the diagonal, over the tile's tokens s, 8 at a
    // time, lane c taking s = 2c and 2c + 1 (M's columns follow)
#pragma unroll
    for (int ks = 0; ks < kL / 8; ++ks) {
      const int sa = 8 * ks + 2 * c;
      const float* xa = xs + sa * kXS + p0 + g;
      FragA fx;
      fx.set(xa[0], xa[8], xa[kXS], xa[kXS + 8]);
#pragma unroll
      for (int i = 0; i < kTT; ++i) {
        if (i0 + i < ks) continue;   // above the diagonal: M is 0
        const int at = (8 * (i0 + i) + g) * kMStride + sa;
        mma3_split(yt[i], fx, *reinterpret_cast<const float2*>(mh + at),
                   *reinterpret_cast<const float2*>(ml + at));
      }
    }

    // y rows t0 + t, columns p (rows past S dropped)
    if (live) {
      const int t0 = k * kL;
      float* yp = y + (static_cast<long long>(b) * heads + h) * seq * P;
#pragma unroll
      for (int i = 0; i < kTT; ++i) {
        const int t = t0 + 8 * (i0 + i) + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = t + (e & 1);
          if (tt < seq) {
            yp[static_cast<long long>(tt) * P + p0 + g + 8 * (e >> 1)] =
                yt[i][e];
          }
        }
      }
    }

    // S <- exp(ca_last) S + (X o w)^T B, the tokens taken as above (B's
    // rows follow)
    const float el = *ts.elast;
#pragma unroll
    for (int u = 0; u < kNT; ++u) {
      state[u][0] *= el;
      state[u][1] *= el;
      state[u][2] *= el;
      state[u][3] *= el;
    }
#pragma unroll
    for (int ks = 0; ks < kL / 8; ++ks) {
      const int sa = 8 * ks + 2 * c;
      const float* xa = xs + sa * kXS + p0 + g;
      const float wa = wv[sa];
      const float wb = wv[sa + 1];
      FragA fw;
      fw.set(xa[0] * wa, xa[8] * wa, xa[kXS] * wb, xa[kXS + 8] * wb);
      const float* b0 = bs + sa * kBS + perm_g;
#pragma unroll
      for (int u = 0; u < kNT; ++u) {
        mma3(state[u], fw, b0[8 * u], b0[kBS + 8 * u]);
      }
    }
  }

  // the final states: staged in the stage no tile uses any more, then
  // copied out whole rows at a time
  sst = stage0 + (tiles & 1) * Sm::kStage;
  if (lw < kPBlocks) {
    float* sr = sst + (hw * P + p0 + g) * kSS + c;
#pragma unroll
    for (int u = 0; u < kNT; ++u) {
      sr[8 * u] = state[u][0];
      sr[8 * u + 4] = state[u][1];
      sr[8 * kSS + 8 * u] = state[u][2];
      sr[8 * kSS + 8 * u + 4] = state[u][3];
    }
  }
  __syncthreads();
  for (int i = tid; i < kG * P * (N / 4); i += kThreads) {
    const int hh = i / (P * (N / 4));
    const int r = (i / (N / 4)) % P;
    const int col = (i % (N / 4)) * 4;
    if (hbase + hh < heads) {
      const long long row =
          (static_cast<long long>(b) * heads + hbase + hh) * P + r;
      *reinterpret_cast<float4*>(sout + row * N + col) =
          *reinterpret_cast<const float4*>(sst + (hh * P + r) * kSS + col);
    }
  }
}

// above 48 KB a block's shared memory must be asked for; set once per
// instantiation
template <int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* b, const float* c, const float* s0, float* y,
                   float* sout, int batch, int heads, int seq,
                   const Strides& sd, cudaStream_t stream) {
  constexpr size_t smem = Smem<P, N>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_tc<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int blocks = batch * ((heads + kG - 1) / kG);
  ssd_tc<P, N><<<blocks, kThreads, smem, stream>>>(x, dt, a, b, c, s0, y,
                                                   sout, heads, seq, sd);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(int n, const float* x, const float* dt, const float* a,
                     const float* b, const float* c, const float* s0,
                     float* y, float* sout, int batch, int heads, int seq,
                     const Strides& sd, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<P, 16>(x, dt, a, b, c, s0, y, sout, batch, heads,
                                  seq, sd, stream);
    case 32: return launch<P, 32>(x, dt, a, b, c, s0, y, sout, batch, heads,
                                  seq, sd, stream);
    case 64: return launch<P, 64>(x, dt, a, b, c, s0, y, sout, batch, heads,
                                  seq, sd, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 on success).
// strides holds x's (b, h, s), dt's (b, h, s) and b's and c's (b, s)
// element strides, in that order.
int ssd_f32(const float* x, const float* dt, const float* a, const float* b,
            const float* c, const float* s0, float* y, float* sout,
            int batch, int heads, int seq, int p, int n,
            const long long* strides, void* stream) {
  const Strides sd{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p == 64) {
    err = launch_n<64>(n, x, dt, a, b, c, s0, y, sout, batch, heads, seq, sd,
                       s);
  } else if (p == 32) {
    err = launch_n<32>(n, x, dt, a, b, c, s0, y, sout, batch, heads, seq, sd,
                       s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
