// RWKV6 WKV recurrence: y and the final state, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py::wkv6 (its
// pl.pallas_call, line 74). Layout is the same: r, k, v, lw (B,H,S,D),
// u (H,D), initial state (B,H,D,D) -> y (B,H,S,D), final state (B,H,D,D).
// Per head, with k-dim = v-dim = D and w_t = exp(lw_t) <= 1:
//
//     y_t[v] = sum_k r_t[k] (S[k][v] + u[k] k_t[k] v_t[v])
//     S[k][v] <- w_t[k] S[k][v] + k_t[k] v_t[v]
//
// It computes the TPU kernel's chunked form, in tiles of kL = 32 tokens
// whatever the caller's chunk (the same function; sums in another order).
// Per tile, with the state S (D_k x D_v) carried in from the tile before:
//
//     r_in[t] = r[t] o exp(sum_{start<=j<t} lw_j)   reads the carried state
//     k_out[s] = k[s] o exp(sum_{s<j<=end} lw_j)    carried to the tile's end
//     A[t][s] = sum_i r[t,i] k[s,i] prod_{s<j<t} w[j,i]   for s < t,
//               sum_i r[t,i] u[i] k[t,i]                  for s = t, 0 above
//     Y = R_in S + A V,   S <- diag(exp(sum_tile lw)) S + K_out^T V
//
// No exponent is a difference of prefix sums (they cancel to 1e-4 once
// the sums are large), and no factor exceeds 1 (a factored
// exp(cl_prev[t]) exp(-cl[s]) would overflow: lw reaches -e^3 a token,
// exp(-cl) e^640 within a tile). Each tile is cut into four sub-tiles of
// kB = 8 tokens. Every exponent is a one-signed sum from a sub-tile's edge
// (r~[t] = r[t] o exp(sum of lw from t's sub-tile's start to t), k~[s] =
// k[s] o exp(sum after s to its sub-tile's end)) or over whole sub-tiles
// (their totals W_b = exp(sum over b)), and r_in = r~ o exp(sum before
// t's sub-tile), k_out = k~ o exp(sum after s's), those sums taken over
// the sub-tiles' totals. A's blocks below the diagonal's sub-tiles take
// the reference point at the end of s's sub-tile S: for t in sub-tile
// T > S,
//
//     A[t][s] = sum_i (r~[t,i] prod_{S<b<T} W_b[i]) k~[s,i],
//
// a product over the channels of factors <= 1; within a diagonal
// sub-tile A is a running product of w: walking t from s, kd = k[s]
// prod_{s<j<t} w[j], A[t][s] += r[t] . kd (at most 7 roundings).
//
// The products run on the tensor cores as mma.sync m16n8k8 TF32 in three
// passes (3xTF32): every fp32 operand v is split into hi (v cut to TF32)
// and lo = v - hi, and lo*hi + hi*lo + hi*hi accumulate in fp32, which
// keeps float32 accuracy (one TF32 pass errs by about 1e-3 relative per
// product): the state's readout and update, A V, and A below the
// diagonal's sub-tiles. The diagonal sub-tiles of A run on the CUDA cores.
//
// What bounds it on an H100: at the serving path's shape (B=4, H=32,
// S=512, D=64) it reads r, k, v, lw, u and the initial state and writes y
// and the final state once, 88.1 MB: 26.3 us at 3.35 TB/s, the bound. The
// products every form does, the state's readout and update (4 D^2 per
// token and head, 1.07 GFLOP), take 6.5 us in three TF32 passes at the
// 495 TFLOP/s dense TF32 rate, of which mma.sync reaches part; the
// literal recurrence's 7 fp32 instructions per token and state element
// (1.9 G) would take about 60 us on 132 x 128 fp32 lanes even at full
// issue rate.
//
// Design. One block per (b, h), walking the tiles in order (the TPU
// grid's sequential chunk axis), with D / 16 "state" warps and D / 8
// "A" warps (12 warps at D = 64). The A warps stage r, k, v and lw by
// cp.async into a three-stage shared-memory ring: tiles k+1 and k+2 are
// in flight while tile k is computed. Rows past S are zero-filled (r =
// k = v = 0, lw = 0): they add nothing to y or the state and decay
// nothing, so a ragged last tile needs no other mask than the store of
// y. Tile k's decays (r~, k~, r_in, k_out, w, the factors prod W_b
// between sub-tiles, exp(tot)) were computed during tile k-1, into the
// other of two buffers. Per tile:
//
//   the state warps: Y^T = S^T R_in^T, then S^T <- S^T diag(exp(tot))
//   + V^T K_out; after A is written, Y^T += V^T A^T below the diagonal,
//   and y is stored. y is computed transposed so that the state never
//   leaves the registers: each warp holds 16 rows of v of S^T, all of k,
//   as mma accumulators across the tiles, and they are the A operand of
//   S^T R_in^T as they lie (the accumulator's columns 2c, 2c + 1 are k =
//   8n + c, 8n + c + 4, the A fragment's c, c + 4). The decay is per k
//   channel: a column scale of each lane's fragment, from shared memory;
//
//   the A warps: at D = 64 four of them take one each of the four 16-row
//   tiles of A below the diagonal's sub-tiles (rows of sub-tiles S+1..
//   against the 8 columns of S; rows past the tile get a zero factor) on
//   the tensor cores, and four one diagonal sub-tile each, lane s % 8 and
//   channel group walking t over a quarter of the channels, the groups
//   summed by shuffles; A goes to shared memory split (hi, lo), and they
//   arrive at a barrier the state warps wait on. Then they wait for tile
//   k+1 and compute its decays, one thread per channel and sub-tile, in
//   8-token walks.
//
// Shared rows are padded (4 floats for the staged tile and the per-token
// arrays, 8 for A, read as float2), so every fragment load hits 32
// different banks. One block-wide barrier a tile, one from the A warps to
// the state warps and two among the A warps. 205 KB of shared memory at
// D = 64: one block an SM, all 128 blocks of the served shape at once. D
// is 32 or 64. r, k, v and lw may be strided views (the model passes
// (B,S,H,D) tensors transposed) with unit stride along D and the other
// strides multiples of 4 (16-byte copies).
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace {

constexpr int kL = 32;             // tokens per tile
constexpr int kB = 8;              // tokens per sub-tile
constexpr int kAStride = kL + 8;   // padded row of A's hi and lo parts
constexpr int kBarA = 1;       // named barrier: A is in shared memory
constexpr int kBarLoad = 2;    // named barrier: the A warps' tile landed
constexpr int kStages = 3;     // the ring of staged tiles
// rows of the factors between sub-tiles: 1, W_1, W_1 W_2, W_2, 0
constexpr int kMidRows = 5;

template <int D>
struct Geo {
  static constexpr int kSW = D / 16;   // state warps, 16 rows of v each
  static constexpr int kAW = D / 8;    // A warps
  static constexpr int kThreads = 32 * (kSW + kAW);   // 6 D
  static constexpr int kRS = D + 4;    // padded row of a token's channels
  static constexpr int kAThreads = 32 * kAW;
  static constexpr int kTile = kL * kRS;
  static constexpr int kStage = 4 * kTile;   // r, k, v, lw
  // a tile's decays: r~, k~, r_in, k_out, w; the factors between
  // sub-tiles; exp(tot)
  static constexpr int kDecays = 5 * kTile + kMidRows * D + D + kL / kB * D;
  // the ring of stages; two tiles' decays; A's hi and lo parts
  static constexpr int kFloats =
      kStages * kStage + 2 * kDecays + 2 * kL * kAStride;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// all but this thread's newest group of copies have landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a barrier of `threads` threads (whole warps) that waits
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the same barrier, marked reached without waiting; what this thread
// wrote before is visible to the threads that wait on it
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The decays of a tile's tokens in shared memory
struct Decays {
  float* rt;     // r~: r o exp(lw summed from the sub-tile's start to t)
  float* kt;     // k~: k o exp(lw summed after s to the sub-tile's end)
  float* rin;    // r~ o exp(lw summed before the sub-tile)
  float* kout;   // k~ o exp(lw summed after the sub-tile)
  float* w;      // exp(lw)
  float* mids;   // [kMidRows][D]: 1, W_1, W_1 W_2, W_2, 0
  float* etot;   // [D] exp(lw summed over the tile)
  float* tot;    // [kL / kB][D] the sub-tiles' sums of lw
};

// A tile's decays are computed in two steps, one thread per channel i
// and sub-tile, with a barrier between. Exponentials are ex2.approx of
// x log2(e) (__expf): about 2 ulp, and x log2(e)'s rounding, relative
// 1e-6 at x = -20 (the results are <= 1).
struct Walk {
  float rv[kB], kv[kB];   // r~ and k~ of the sub-tile's tokens
};

// Step 1: 8-token walks from the sub-tile's edges, forward (r~, w) and
// backward (k~); the sub-tile's sum of lw.
template <int D>
__device__ __forceinline__ void walk(const float* rs, const float* ks,
                                     const float* ls, const Decays& dc,
                                     int i, int sub, Walk& wk) {
  constexpr int kRS = Geo<D>::kRS;
  const int t0 = kB * sub;
  float l[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) l[j] = ls[(t0 + j) * kRS + i];
  float p = 0.f;   // lw from the sub-tile's start to t, t excluded
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int at = (t0 + j) * kRS + i;
    wk.rv[j] = rs[at] * __expf(p);
    dc.rt[at] = wk.rv[j];
    dc.w[at] = __expf(l[j]);
    p += l[j];
  }
  float a = 0.f;   // lw after s to the sub-tile's end
#pragma unroll
  for (int j = kB - 1; j >= 0; --j) {
    const int at = (t0 + j) * kRS + i;
    wk.kv[j] = ks[at] * __expf(a);
    dc.kt[at] = wk.kv[j];
    a += l[j];
  }
  dc.tot[sub * D + i] = p;
}

// Step 2: r_in and k_out from the sums of the sub-tiles before and after
// (summed from the tile's edges), the factors between sub-tiles and
// exp(tot).
template <int D>
__device__ __forceinline__ void carry(const Decays& dc, int i, int sub,
                                      const Walk& wk) {
  constexpr int kRS = Geo<D>::kRS;
  constexpr int kSubs = kL / kB;
  float tot[kSubs];
#pragma unroll
  for (int q = 0; q < kSubs; ++q) tot[q] = dc.tot[q * D + i];
  float before = 0.f, after = 0.f;
#pragma unroll
  for (int q = 0; q < kSubs; ++q) {
    if (q < sub) before += tot[q];
  }
#pragma unroll
  for (int q = kSubs - 1; q >= 0; --q) {
    if (q > sub) after += tot[q];
  }
  const float ein = __expf(before);
  const float eout = __expf(after);
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int at = (kB * sub + j) * kRS + i;
    dc.rin[at] = wk.rv[j] * ein;
    dc.kout[at] = wk.kv[j] * eout;
  }
  if (sub == 0) {
    dc.etot[i] = __expf(tot[0] + after);
  } else if (sub == 1) {
    dc.mids[D + i] = __expf(tot[1]);
    dc.mids[2 * D + i] = __expf(tot[1] + tot[2]);
  } else if (sub == 2) {
    dc.mids[3 * D + i] = __expf(tot[2]);
  }
}

// One 16-row tile of A below the diagonal's sub-tiles, x = 0..3: rows
// 8-23, 24-31, 16-31, 24-31 against the columns of sub-tile 0, 0, 1, 2,
// on the tensor cores, stored split. A row t in sub-tile T takes
// r~[t] o prod_{S<b<T} W_b (a zero factor for rows past the tile).
template <int D>
__device__ __forceinline__ void a_below(const Decays& dc, float* ah,
                                        float* al, int x, int g, int c) {
  constexpr int kRS = Geo<D>::kRS;
  const int sub = x < 2 ? 0 : x - 1;
  const int t0 = x == 0 ? kB : x == 2 ? 2 * kB : 3 * kB;
  const int two = t0 + kB < kL;   // a second row block
  const float* ra = dc.rt + (t0 + g) * kRS;
  const float* rb = dc.rt + (two ? t0 + kB + g : t0 + g) * kRS;
  const float* ma = dc.mids + (x == 1 ? 2 : 0) * D;
  const float* mb = dc.mids + (x == 0 ? 1 : x == 2 ? 3 : 4) * D;
  const float* kb = dc.kt + (kB * sub + g) * kRS;
  // the three passes in three accumulators: chains a third as long
  float part[3][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int ca = 8 * kk + c;
    const int cb = ca + 4;
    FragA fa;
    fa.set(ra[ca] * ma[ca], rb[ca] * mb[ca], ra[cb] * ma[cb],
           rb[cb] * mb[cb]);
    uint32_t h0, l0, h1, l1;
    split(kb[ca], h0, l0);
    split(kb[cb], h1, l1);
    mma_tf32(part[0], fa.lo, h0, h1);
    mma_tf32(part[1], fa.hi, l0, l1);
    mma_tf32(part[2], fa.hi, h0, h1);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (half && !two) break;
    const int at = (t0 + kB * half + g) * kAStride + kB * sub + 2 * c;
    uint32_t h0, l0, h1, l1;
    split(part[2][2 * half] + (part[0][2 * half] + part[1][2 * half]), h0,
          l0);
    split(part[2][2 * half + 1] +
              (part[0][2 * half + 1] + part[1][2 * half + 1]),
          h1, l1);
    *reinterpret_cast<float2*>(ah + at) =
        make_float2(__uint_as_float(h0), __uint_as_float(h1));
    *reinterpret_cast<float2*>(al + at) =
        make_float2(__uint_as_float(l0), __uint_as_float(l1));
  }
}

// A diagonal sub-tile b on the CUDA cores: lane (s % 8, channel group
// cg) walks t over the sub-tile with kd = k[s] prod_{s<j<t} w[j] (0
// until t reaches s) over its D / 4 channels, A[t][s] = r[t] . kd and the
// bonus r[s] . (u o k[s]) on the diagonal; the groups are summed by
// shuffles and stored split (zeros above the diagonal included).
template <int D>
__device__ __forceinline__ void a_diagonal(const float* rs, const float* ks,
                                           const float* ws, const float* uq,
                                           float* ah, float* al, int sub,
                                           int lane) {
  constexpr int kRS = Geo<D>::kRS;
  constexpr int kCG = D / 4;   // channels of a group
  const int sl = lane & (kB - 1);
  const int ch0 = (lane / kB) * kCG;
  const int s = kB * sub + sl;
  float kr[kCG], kd[kCG];
  float bonus = 0.f;
#pragma unroll
  for (int j = 0; j < kCG / 4; ++j) {
    const float4 k4 =
        *reinterpret_cast<const float4*>(ks + s * kRS + ch0 + 4 * j);
    const float4 r4 =
        *reinterpret_cast<const float4*>(rs + s * kRS + ch0 + 4 * j);
    const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kr[4 * j + e] = kk[e];
      kd[4 * j + e] = 0.f;
      bonus = fmaf(rr[e] * uq[4 * j + e], kk[e], bonus);
    }
  }
  float acc[kB];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const bool here = j == sl;
    const float* rt = rs + (kB * sub + j) * kRS + ch0;
    const float* wt = ws + (kB * sub + j) * kRS + ch0;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int q = 0; q < kCG / 4; ++q) {
      const float4 r4 = *reinterpret_cast<const float4*>(rt + 4 * q);
      const float4 w4 = *reinterpret_cast<const float4*>(wt + 4 * q);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        if (e & 1) {
          a1 = fmaf(rr[e], kd[i], a1);
        } else {
          a0 = fmaf(rr[e], kd[i], a0);
        }
        kd[i] = fmaf(kd[i], ww[e], here ? kr[i] : 0.f);
      }
    }
    acc[j] = a0 + a1 + (here ? bonus : 0.f);
  }
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
  }
  if (lane < kB) {
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int at = (kB * sub + j) * kAStride + s;
      uint32_t hi, lo;
      split(acc[j], hi, lo);
      ah[at] = __uint_as_float(hi);
      al[at] = __uint_as_float(lo);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Geo<D>::kThreads, 1)
wkv6_tc(const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ lw,
        const float* __restrict__ u, const float* __restrict__ s0,
        float* __restrict__ y, float* __restrict__ sout, int heads, int seq,
        long long stride_b, long long stride_h, long long stride_s) {
  using G = Geo<D>;
  constexpr int kRS = G::kRS;
  constexpr int kThreads = G::kThreads;
  constexpr int kAThreads = G::kAThreads;
  constexpr int kNT = D / 8;   // n8 tiles of the state's k columns

  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const bool state_warp = warp < G::kSW;
  const int at_id = tid - 32 * G::kSW;   // an A warp's thread

  // stage st holds r, k, v, lw of a tile, kTile floats each
  auto staged = [&](int st, int which) {
    return smem + st * G::kStage + which * G::kTile;
  };
  // the decays of tiles 2m and 2m + 1
  auto decays = [&](int buf) {
    Decays dc;
    dc.rt = smem + kStages * G::kStage + buf * G::kDecays;
    dc.kt = dc.rt + G::kTile;
    dc.rin = dc.kt + G::kTile;
    dc.kout = dc.rin + G::kTile;
    dc.w = dc.kout + G::kTile;
    dc.mids = dc.w + G::kTile;
    dc.etot = dc.mids + kMidRows * D;
    dc.tot = dc.etot + D;
    return dc;
  };
  float* ah = smem + kStages * G::kStage + 2 * G::kDecays;   // [t][kAStride]
  float* al = ah + kL * kAStride;
  for (int i = tid; i < 2 * D; i += kThreads) {
    float* mids = decays(i / D).mids;
    mids[i % D] = 1.f;
    mids[4 * D + i % D] = 0.f;
  }

  // The A warps copy the tiles: 16 bytes of each of r, k, v and lw in
  // every 16th row a thread, rows past S zero-filled; a group of copies
  // for each tile (empty past the last).
  constexpr int kRowsPass = kAThreads / (D / 4);
  const int cr = at_id / (D / 4);
  const int ccol = (at_id % (D / 4)) * 4;
  const long long base = b * stride_b + h * stride_h;
  const int tiles = (seq + kL - 1) / kL;
  auto load_tile = [&](int tile) {
    if (tile < tiles) {
      const int t0 = tile * kL;
      const int st = tile % kStages;
#pragma unroll
      for (int q = 0; q < kL / kRowsPass; ++q) {
        const int row = cr + q * kRowsPass;
        const bool ok = t0 + row < seq;
        const long long off =
            ok ? base + static_cast<long long>(t0 + row) * stride_s + ccol
               : 0;
        const int at = row * kRS + ccol;
        cp_async16(staged(st, 0) + at, r + off, ok);
        cp_async16(staged(st, 1) + at, k + off, ok);
        cp_async16(staged(st, 2) + at, v + off, ok);
        cp_async16(staged(st, 3) + at, lw + off, ok);
      }
    }
    cp_async_commit();
  };
  // the A warps: wait for tile `tile` (the newer one in flight), then
  // compute its decays, one channel and sub-tile a thread
  auto prepare = [&](int tile) {
    cp_async_wait_but_one();
    bar_sync(kBarLoad, kAThreads);   // the tile is visible to the A warps
    const int st = tile % kStages;
    const Decays dc = decays(tile & 1);
    Walk wk;
    walk<D>(staged(st, 0), staged(st, 1), staged(st, 3), dc, at_id % D,
            at_id / D, wk);
    bar_sync(kBarLoad, kAThreads);   // the sub-tiles' sums are written
    carry<D>(dc, at_id % D, at_id / D, wk);
  };

  // a state warp's rows of S^T (v), all of k: the accumulator's n8 tile
  // n, column j holds k = 8n + (j / 2) + 4 (j % 2)
  const int p0 = 16 * warp;
  float state[kNT][4];
  // an A warp's lane's channels of the bonus
  float uq[D / 4];
  if (state_warp) {
    const float* sp = s0 + static_cast<long long>(bh) * D * D;   // S[k][v]
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      state[n][0] = sp[(8 * n + c) * D + p0 + g];
      state[n][1] = sp[(8 * n + c + 4) * D + p0 + g];
      state[n][2] = sp[(8 * n + c) * D + p0 + g + 8];
      state[n][3] = sp[(8 * n + c + 4) * D + p0 + g + 8];
    }
  } else {
    const float* uh = u + h * D + (lane / kB) * (D / 4);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) uq[i] = uh[i];
    load_tile(0);
    load_tile(1);
    prepare(0);
  }
  const int perm_g = (g >> 1) + 4 * (g & 1);   // the k column of lane g
  // tile 0 and its decays are visible (and the factors' fixed rows)
  __syncthreads();

  for (int kt = 0; kt < tiles; ++kt) {
    const int st = kt % kStages;
    const float* rs = staged(st, 0);
    const float* ks = staged(st, 1);
    const float* vs = staged(st, 2);
    const Decays dc = decays(kt & 1);

    if (state_warp) {
      // Y^T = S^T R_in^T: the state's accumulators as A
      float yt[kL / 8][4];
#pragma unroll
      for (int i = 0; i < kL / 8; ++i) {
        yt[i][0] = yt[i][1] = yt[i][2] = yt[i][3] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        FragA fs;
        fs.set(state[n][0], state[n][2], state[n][1], state[n][3]);
#pragma unroll
        for (int i = 0; i < kL / 8; ++i) {
          const float* c0 = dc.rin + (8 * i + g) * kRS + 8 * n + c;
          mma3(yt[i], fs, c0[0], c0[4]);
        }
      }
      // S^T <- S^T diag(exp(tot)) + V^T K_out, over the tile's tokens s,
      // 8 at a time, lane c taking s = 2c and 2c + 1 (K_out's rows follow)
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float e0 = dc.etot[8 * n + c];
        const float e1 = dc.etot[8 * n + c + 4];
        state[n][0] *= e0;
        state[n][1] *= e1;
        state[n][2] *= e0;
        state[n][3] *= e1;
      }
#pragma unroll
      for (int q = 0; q < kL / 8; ++q) {
        const int sa = 8 * q + 2 * c;
        const float* xa = vs + sa * kRS + p0 + g;
        FragA fv;
        fv.set(xa[0], xa[8], xa[kRS], xa[kRS + 8]);
        const float* b0 = dc.kout + sa * kRS + perm_g;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          mma3(state[n], fv, b0[8 * n], b0[kRS + 8 * n]);
        }
      }
      bar_sync(kBarA, kThreads);   // A is written
      // Y^T += V^T A^T on and below the diagonal, the tokens s taken as
      // above (A's columns follow)
#pragma unroll
      for (int q = 0; q < kL / 8; ++q) {
        const int sa = 8 * q + 2 * c;
        const float* xa = vs + sa * kRS + p0 + g;
        FragA fv;
        fv.set(xa[0], xa[8], xa[kRS], xa[kRS + 8]);
#pragma unroll
        for (int i = q; i < kL / 8; ++i) {
          const int at = (8 * i + g) * kAStride + sa;
          mma3_split(yt[i], fv, *reinterpret_cast<const float2*>(ah + at),
                     *reinterpret_cast<const float2*>(al + at));
        }
      }
      // y rows t0 + t, columns v (rows past S dropped)
      const int t0 = kt * kL;
      float* yp = y + static_cast<long long>(bh) * seq * D;
#pragma unroll
      for (int i = 0; i < kL / 8; ++i) {
        const int t = t0 + 8 * i + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tt = t + (e & 1);
          if (tt < seq) {
            yp[static_cast<long long>(tt) * D + p0 + g + 8 * (e >> 1)] =
                yt[i][e];
          }
        }
      }
    } else {
      // tile kt + 2 into the stage tile kt - 1 left
      load_tile(kt + 2);
      // A: its four tiles below the diagonal's sub-tiles, then the four
      // diagonal sub-tiles
      for (int x = warp - G::kSW; x < 2 * kL / kB; x += G::kAW) {
        if (x < kL / kB) {
          a_below<D>(dc, ah, al, x, g, c);
        } else {
          a_diagonal<D>(rs, ks, dc.w, uq, ah, al, x - kL / kB, lane);
        }
      }
      bar_arrive(kBarA, kThreads);
      // the next tile's decays, while the state warps finish this one
      if (kt + 1 < tiles) prepare(kt + 1);
    }
    // every warp done with tile kt (its stage, decays and A); tile
    // kt + 1's decays are visible
    __syncthreads();
  }

  if (state_warp) {
    float* so = sout + static_cast<long long>(bh) * D * D;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      so[(8 * n + c) * D + p0 + g] = state[n][0];
      so[(8 * n + c + 4) * D + p0 + g] = state[n][1];
      so[(8 * n + c) * D + p0 + g + 8] = state[n][2];
      so[(8 * n + c + 4) * D + p0 + g + 8] = state[n][3];
    }
  }
}

// above 48 KB a block's shared memory must be asked for; set once per
// instantiation
template <int D>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* u, const float* s0, float* y,
                   float* sout, int batch, int heads, int seq,
                   long long stride_b, long long stride_h,
                   long long stride_s, cudaStream_t stream) {
  constexpr size_t smem = Geo<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  wkv6_tc<D><<<batch * heads, Geo<D>::kThreads, smem, stream>>>(
      r, k, v, lw, u, s0, y, sout, heads, seq, stride_b, stride_h, stride_s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 on success).
// stride_* are element strides of r, k, v and lw (shared by all four);
// their D axis has stride 1.
int wkv6_f32(const float* r, const float* k, const float* v, const float* lw,
             const float* u, const float* s0, float* y, float* sout,
             int batch, int heads, int seq, int dim, long long stride_b,
             long long stride_h, long long stride_s, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dim == 64) {
    err = launch<64>(r, k, v, lw, u, s0, y, sout, batch, heads, seq,
                     stride_b, stride_h, stride_s, s);
  } else if (dim == 32) {
    err = launch<32>(r, k, v, lw, u, s0, y, sout, batch, heads, seq,
                     stride_b, stride_h, stride_s, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
