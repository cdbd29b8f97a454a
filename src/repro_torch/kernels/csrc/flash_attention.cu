// Causal grouped-query attention forward (flash attention), bf16 or
// float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (its pl.pallas_call, line 73). It computes the same
// function: q (B,H,S,D), k and v (B,Hkv,S,D), H a multiple of Hkv, query
// head h reading KV head h / (H / Hkv) by indexing (k and v are never
// replicated), out (B,H,S,D) in q's type:
//
//     o[i] = sum_j softmax_j(scale * q[i] . k[j]) v[j],   j <= i if causal
//
// streamed over tiles of keys with a running row max m, a running sum l
// and an accumulator, all float32, and a final divide by max(l, 1e-30)
// (a multiply by its reciprocal on the bf16 route).
// As in the TPU kernel the scores are float32 sums of products of the
// inputs, the probabilities p are rounded to v's type before the PV
// product while l sums them unrounded, and key tiles that lie wholly past
// the causal frontier are skipped.
//
// What bounds it on an H100: at the served prefill of qwen3-8b (B=4,
// H=32, Hkv=8, S=512, D=128, bf16) the function reads q, k, v and writes
// o once, 42 MB: 12.5 us at 3.35 TB/s; its causal half is 8.6 GFLOP,
// 8.7 us at the 989 TFLOP/s of wgmma and about 13 us at the two thirds
// of it that mma.sync reaches. Bytes bound it at every served shape.
//
// Two routes, chosen by type in flash_attention_fwd:
//
// bf16 (the served route; every prefill of the LM path): flash_mma_bf16.
// One block of 4 warps per (64 query rows, head, batch); each warp owns
// 16 rows and walks key tiles of 64 (32 at D = 256). Both products run
// on the tensor cores as mma.sync m16n8k16 bf16 -> fp32: S = Q K^T with
// q and k read from shared memory by ldmatrix, O += P V with v read by
// ldmatrix.trans. The S accumulator fragments are repacked in registers
// into the A fragments of the PV product (two fp32 to one bf16x2, which
// is also the rounding of p), so P never touches shared memory. K and V
// sit in a ring of two shared-memory stages filled by 16-byte
// cp.async.cg: tile t+1 is in flight while tile t is multiplied. Q is
// staged once and its fragments stay in registers (at D = 256, whose O
// accumulator alone is 128 registers a thread, key tiles of 32 keep the
// kernel under 255 registers). The softmax runs on the fragments in the
// exp2 domain (scale * log2(e) folded into the scores, ex2.approx on the
// special-function unit); each row's max and sum are reduced over the 4
// lanes that share the row with two shuffles, and a row with no key yet
// keeps m = -inf and adds 0. The causal mask is applied only on the tiles
// that cross the diagonal or the ragged end; a warp whose rows all lie
// before a tile skips it. Rows of K, V and Q past S are zero-filled by
// cp.async (src-size 0), so a masked score never meets stale shared
// memory (0 * NaN). Each shared row is padded by 8 bf16 (16 bytes): 2D +
// 16 bytes is an odd multiple of 16 modulo 128 at every D, so the 8 rows
// of an ldmatrix hit 8 different bank groups (D = 112's 224-byte rows
// included). The output goes through the warp's own q rows in shared
// memory to 16-byte stores. mma.sync does not set the floor at these
// sizes; wgmma fed by TMA from a producer warp is the later step.
//
// float32 (the reference-precision form; not served: only chip_smoke.py's
// float32 parity runs it): flash_fma_f32, on the CUDA cores. One
// block of 4 warps per (32 query rows, head, batch), 8 rows a warp; per
// tile of 32 keys q, k^T and v are staged in shared memory as float32;
// lane j scores key j, the tile's row max by warp shuffles, p goes
// through shared memory and lane d accumulates columns d, d+32, ...;
// every product an fp32 FMA (about 130 us at qwen3-8b's shape). It takes
// no TF32, so the float32 tolerances (2e-4 against the plain version,
// 1e-3 for the LM path) stay as they are.
//
// q, k, v and o are strided views, unit stride along D, every other
// stride a multiple of 16 bytes: the model hands over its (B,S,H,D)
// tensors transposed and takes o back the same way. The grid walks the
// query tiles in reverse, so the longest causal rows start first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ------------------------------------------------------------ bf16 route
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBQ = kMmaWarps * 16;   // query rows per block
constexpr int kPad = 8;                  // bf16 padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaTile {
  static constexpr int kBK = D > 128 ? 32 : 64;  // keys per tile
  static constexpr int kStride = D + kPad;       // shared row, elements
  // q, then two stages of k and two of v
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * kStride * (kMmaBQ + 4 * kBK);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2 ulp; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of m16n8k16 (g = lane / 4, c = lane % 4): an fp32
// accumulator holds rows g and g + 8, columns 2c and 2c + 1; an A
// fragment rows g and g + 8, columns 2c, 2c + 1 and 2c + 8, 2c + 9.
// The launch bound asks for one block an SM: ptxas may then spend up to
// 255 registers a thread, and uses them to load fragments ahead of the
// mma that reads them. Two blocks of 128 threads still fit an SM's
// 65,536 registers at that count, and shared memory holds two (D = 128,
// 256) to nine (D = 32) blocks.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_mma_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int group, int seq,
               float scale_log2, int causal, long long qsb, long long qsh,
               long long qss, long long ksb, long long ksh, long long kss,
               long long osb, long long osh, long long oss) {
  constexpr int kBK = MmaTile<D>::kBK;
  constexpr int kStride = MmaTile<D>::kStride;
  constexpr int kChunks = D / 8;     // 16-byte chunks per row
  constexpr int kKSteps = D / 16;    // k16 steps of Q K^T
  constexpr int kNTiles = kBK / 8;   // n8 tiles of S
  constexpr int kDTiles = D / 8;     // n8 tiles of O
  static_assert(D % 16 == 0 && kDTiles % 2 == 0 && kBK % 16 == 0, "tile");
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf16[];
  __nv_bfloat16* sq = smem_bf16;                 // [kMmaBQ][kStride]
  __nv_bfloat16* sk = sq + kMmaBQ * kStride;     // [2][kBK][kStride]
  __nv_bfloat16* sv = sk + 2 * kBK * kStride;    // [2][kBK][kStride]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kMmaBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
  const int row0 = q0 + warp * 16;   // this warp's first query row

  const __nv_bfloat16* qp = q + b * qsb + h * qsh;
  const __nv_bfloat16* kp = k + b * ksb + (h / group) * ksh;
  const __nv_bfloat16* vp = v + b * ksb + (h / group) * ksh;

  for (int i = tid; i < kMmaBQ * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = q0 + r < seq;
    cp_async16(smem_u32(sq + r * kStride + c),
               qp + (ok ? (q0 + r) * qss + c : 0), ok);
  }
  cp_async_commit();

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    __nv_bfloat16* dk = sk + stage * kBK * kStride;
    __nv_bfloat16* dv = sv + stage * kBK * kStride;
    for (int i = tid; i < kBK * kChunks; i += kMmaThreads) {
      const int j = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool ok = k0 + j < seq;
      const long long off = ok ? (k0 + j) * kss + c : 0;
      cp_async16(smem_u32(dk + j * kStride + c), kp + off, ok);
      cp_async16(smem_u32(dv + j * kStride + c), vp + off, ok);
    }
  };

  const int last_row = min(q0 + kMmaBQ, seq) - 1;
  const int tiles = causal ? last_row / kBK + 1 : (seq + kBK - 1) / kBK;
  load_kv(0, 0);
  cp_async_commit();

  // ldmatrix row addresses, one per lane:
  //   q (A, 16x16 at a k16 step): row lane % 16, column 8 (lane / 16)
  //   k (B of two n8 tiles): key lane % 8 + 8 (lane / 16), d 8 ((lane / 8) % 2)
  //   v (B of two n8 tiles, transposed): key lane % 16, d 8 (lane / 16)
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_col = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* sq_warp = sq + warp * 16 * kStride;

  // q's A fragments stay in registers for the whole walk
  uint32_t qf[kKSteps][4];
  cp_async_wait<1>();   // q has landed (tile 0 may still be in flight)
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    ldmatrix_x4(qf[kk], smem_u32(sq_warp + a_row * kStride + kk * 16 + a_col));
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m_row[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float l_row[2] = {0.f, 0.f};               // this lane's partial sums

  for (int t = 0; t < tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < tiles) load_kv(t + 1, stage ^ 1);
    cp_async_commit();    // perhaps empty: one group per tile
    cp_async_wait<1>();   // all but the newest group: tile t has landed
    __syncthreads();

    const int k0 = t * kBK;
    if (row0 < seq && !(causal && k0 > row0 + 15)) {
      const __nv_bfloat16* tk = sk + stage * kBK * kStride;
      const __nv_bfloat16* tv = sv + stage * kBK * kStride;

      float s[kNTiles][4];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
        for (int nn = 0; nn < kNTiles / 2; ++nn) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(tk + (nn * 16 + kb_row) * kStride +
                                   kk * 16 + kb_col));
          mma_bf16(s[2 * nn], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // scores into the exp2 domain; mask only a tile that crosses the
      // diagonal or the ragged end
      const bool edge = k0 + kBK > seq || (causal && k0 + kBK - 1 > row0);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + j * 8 + c2 + (e & 1);
            const int row = row0 + g + (e >> 1) * 8;
            if (key >= seq || (causal && key > row)) x = -INFINITY;
          }
          s[j][e] = x;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_row[i], mx[i]);
        // a row with no key yet keeps everything at 0 instead of NaN
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = exp2_approx(m_row[i] - m_use[i]);
        m_row[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(s[j][e] - m_use[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_row[i] = l_row[i] * alpha[i] + sum[i];
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // O += P V, P taken from the score fragments as bf16
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < kDTiles / 2; ++dd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_u32(tv + (kk * 16 + a_row) * kStride +
                                         dd * 16 + a_col));
          mma_bf16(acc[2 * dd], a, bv[0], bv[1]);
          mma_bf16(acc[2 * dd + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // this stage is free for the load two tiles on
  }

  if (row0 >= seq) return;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  // the warp's own q rows (read by no other warp) stage its output
  __nv_bfloat16* so = sq + warp * 16 * kStride;
  __nv_bfloat16* sr = so + g * kStride + c2;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    *reinterpret_cast<uint32_t*>(sr + j * 8) =
        pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sr + 8 * kStride + j * 8) =
        pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* op = o + b * osb + h * osh;
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if (row0 + r < seq) {
      *reinterpret_cast<uint4*>(op + (row0 + r) * oss + c) =
          *reinterpret_cast<const uint4*>(so + r * kStride + c);
    }
  }
}

// --------------------------------------------------------- float32 route
constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kBK = 32;                  // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;
constexpr int kKtStride = kBK + 1;       // padded row of k^T in shared memory

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(kBQ) * d          // q tile
         + static_cast<size_t>(d) * kKtStride  // k tile, transposed
         + static_cast<size_t>(kBK) * d        // v tile
         + static_cast<size_t>(kBQ) * kBK;     // p, per warp
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fma_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int group,
              int seq, float scale, int causal, long long qsb, long long qsh,
              long long qss, long long ksb, long long ksh, long long kss,
              long long osb, long long osh, long long oss) {
  constexpr int kVec = 4;                // floats per 16-byte load
  constexpr int kCols = (D + 31) / 32;   // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [kBQ][D]
  float* kt = qs + kBQ * D;              // [D][kKtStride]
  float* vs = kt + D * kKtStride;        // [kBK][D]
  float* ps = vs + kBK * D;              // [kBQ][kBK]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = q0 + warp * kRows;    // this warp's first query row

  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + (h / group) * ksh;
  const float* vp = v + b * ksb + (h / group) * ksh;

  for (int i = tid; i < kBQ * (D / kVec); i += kThreads) {
    const int r = i / (D / kVec);
    const int c = (i % (D / kVec)) * kVec;
    float x[kVec];
    if (q0 + r < seq) {
      load16(qp + (q0 + r) * qss + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qs[r * D + c + e] = x[e];
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int last_row = min(q0 + kBQ, seq) - 1;
  const int tiles = causal ? last_row / kBK + 1 : (seq + kBK - 1) / kBK;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile is done with k, v and p
    for (int i = tid; i < kBK * (D / kVec); i += kThreads) {
      const int j = i / (D / kVec);
      const int c = (i % (D / kVec)) * kVec;
      float xk[kVec], xv[kVec];
      if (k0 + j < seq) {
        load16(kp + (k0 + j) * kss + c, xk);
        load16(vp + (k0 + j) * kss + c, xv);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) xk[e] = xv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        kt[(c + e) * kKtStride + j] = xk[e];
        vs[j * D + c + e] = xv[e];
      }
    }
    __syncthreads();
    // a warp whose rows all lie before this tile (causal), or past the
    // sequence, has nothing to add
    if (row0 >= seq || (causal && k0 > row0 + kRows - 1)) continue;

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* qw = qs + warp * kRows * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float k0v = kt[(d + 0) * kKtStride + lane];
      const float k1v = kt[(d + 1) * kKtStride + lane];
      const float k2v = kt[(d + 2) * kKtStride + lane];
      const float k3v = kt[(d + 3) * kKtStride + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qw + r * D + d);
        s[r] = fmaf(q4.x, k0v, s[r]);
        s[r] = fmaf(q4.y, k1v, s[r]);
        s[r] = fmaf(q4.z, k2v, s[r]);
        s[r] = fmaf(q4.w, k3v, s[r]);
      }
    }

    const int col = k0 + lane;
    float* pw = ps + warp * kRows * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const bool keep = col < seq && (!causal || col <= row);
      const float x = keep ? s[r] * scale : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[r], mx);
      // a row with no key yet keeps everything at 0 instead of NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[r] - m_use);
      const float p = expf(x - m_use);
      m[r] = m_new;
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      pw[r * kBK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p4[r] = *reinterpret_cast<const float4*>(pw + r * kBK + j);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (D % 32 == 0 || d < D) {
          const float v0 = vs[(j + 0) * D + d];
          const float v1 = vs[(j + 1) * D + d];
          const float v2 = vs[(j + 2) * D + d];
          const float v3 = vs[(j + 3) * D + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = acc[r][c];
            a = fmaf(p4[r].x, v0, a);
            a = fmaf(p4[r].y, v1, a);
            a = fmaf(p4[r].z, v2, a);
            a = fmaf(p4[r].w, v3, a);
            acc[r][c] = a;
          }
        }
      }
    }
  }

  if (row0 >= seq) return;
  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float sum = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    const int row = row0 + r;
    if (row >= seq) continue;
    const float den = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (D % 32 == 0 || d < D) op[row * oss + d] = acc[r][c] / den;
    }
  }
}

// ---------------------------------------------------------------- launch
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, heads, group, seq;
  float scale;
  int causal;
  const long long* qst;
  const long long* kst;
  const long long* ost;
  cudaStream_t stream;
};

// above 48 KB a block's shared memory must be asked for; set once per
// instantiation
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int D>
int launch_bf16(const Args& a) {
  const size_t smem = MmaTile<D>::kSmemBytes;
  static const int attr = allow_smem(flash_mma_bf16<D>, smem);
  if (attr != 0) return attr;
  const dim3 grid((a.seq + kMmaBQ - 1) / kMmaBQ, a.heads, a.batch);
  flash_mma_bf16<D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.group, a.seq, a.scale * kLog2e,
      a.causal, a.qst[0], a.qst[1], a.qst[2], a.kst[0], a.kst[1], a.kst[2],
      a.ost[0], a.ost[1], a.ost[2]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a) {
  const size_t smem = smem_floats(D) * sizeof(float);
  static const int attr = allow_smem(flash_fma_f32<D>, smem);
  if (attr != 0) return attr;
  const dim3 grid((a.seq + kBQ - 1) / kBQ, a.heads, a.batch);
  flash_fma_f32<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.group,
      a.seq, a.scale, a.causal, a.qst[0], a.qst[1], a.qst[2], a.kst[0],
      a.kst[1], a.kst[2], a.ost[0], a.ost[1], a.ost[2]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(bool bf16, const Args& a) {
  return bf16 ? launch_bf16<D>(a) : launch_f32<D>(a);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 on success).
// bf16 = 1 for __nv_bfloat16 tensors (the tensor-core route), 0 for
// float32 (the CUDA-core route). q_strides, kv_strides and o_strides are
// the element strides of the batch, head and sequence axes (k and v share
// theirs); the D axis has stride 1.
int flash_attention_fwd(int bf16, const void* q, const void* k,
                        const void* v, void* o, int batch, int heads,
                        int kv_heads, int seq, int dim, float scale,
                        int causal, const long long* q_strides,
                        const long long* kv_strides,
                        const long long* o_strides, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, batch, heads, heads / kv_heads, seq, scale,
               causal, q_strides, kv_strides, o_strides,
               static_cast<cudaStream_t>(stream)};
  switch (dim) {
    case 32:
      return launch<32>(bf16 != 0, a);
    case 64:
      return launch<64>(bf16 != 0, a);
    case 112:
      return launch<112>(bf16 != 0, a);
    case 128:
      return launch<128>(bf16 != 0, a);
    case 256:
      return launch<256>(bf16 != 0, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
