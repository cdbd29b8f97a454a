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
// and an accumulator, all float32, and a final divide by max(l, 1e-30).
// As in the TPU kernel the scores are float32 sums of products of the
// inputs, the probabilities p are rounded to v's type before the PV
// product (bf16 here: the kernel and the plain version round in the same
// place) while l sums them unrounded, and key tiles that lie wholly past
// the causal frontier are skipped.
//
// What bounds it on an H100: at the served prefill of qwen3-8b (B=4,
// H=32, Hkv=8, S=512, D=128, bf16) the function reads q, k, v and writes
// o once, 42 MB: 12.5 us at 3.35 TB/s; its causal half is 4.3 G
// multiply-adds, 8.7 us on the bf16 tensor cores. This kernel does not
// use the tensor cores: it is the simple first form, every product an
// fp32 FMA on the CUDA cores (67 TFLOP/s), so its own floor is about
// 130 us there. A tensor-core form (mma.sync or wgmma, with TMA) is the
// later step.
//
// Design. One block of 4 warps per (query tile of 32 rows, head,
// batch); the grid walks the query tiles in reverse, so the longest
// causal rows start first. Each warp carries 8 query rows. Per tile of
// 32 keys the block stages q (once), k transposed and v in shared memory
// as float32 (16-byte loads from device memory, converted); then
//   scores: lane j computes the 8 rows' scores against key j, reading
//           k^T[d][j] (padded rows, no bank conflicts) and q as float4
//           broadcasts;
//   softmax: the tile's row max by 5 warp shuffles; p = exp(s - m); each
//           lane keeps its own partial of l (m is shared, so the partials
//           rescale alike) and the partials are summed once at the end;
//   PV:     p goes through shared memory; lane d accumulates columns
//           d, d+32, ... of the 8 rows (D = 112 leaves lanes 16-31 of the
//           last column group idle).
// q, k, v and o are strided views, unit stride along D, every other
// stride a multiple of 16 bytes: the model hands over its (B,S,H,D)
// tensors transposed and takes o back the same way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

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

__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(kBQ) * d          // q tile
         + static_cast<size_t>(d) * kKtStride  // k tile, transposed
         + static_cast<size_t>(kBK) * d        // v tile
         + static_cast<size_t>(kBQ) * kBK;     // p, per warp
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int seq,
          float scale, int causal, long long qsb, long long qsh,
          long long qss, long long ksb, long long ksh, long long kss,
          long long osb, long long osh, long long oss) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
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

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + (h / group) * ksh;
  const T* vp = v + b * ksb + (h / group) * ksh;

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
      pw[r * kBK + lane] = round_to(p, T());
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
  T* op = o + b * osb + h * osh;
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
      if (D % 32 == 0 || d < D) store(op + row * oss + d, acc[r][c] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int group, int seq, float scale, int causal,
           const long long* qst, const long long* kst, const long long* ost,
           cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  // set once per instantiation: above 48 KB a block's shared memory must
  // be asked for
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, seq, scale,
      causal, qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], ost[0], ost[1],
      ost[2]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int dim, const void* q, const void* k, const void* v, void* o,
             int batch, int heads, int group, int seq, float scale,
             int causal, const long long* qst, const long long* kst,
             const long long* ost, cudaStream_t stream) {
  switch (dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, heads, group, seq, scale,
                           causal, qst, kst, ost, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, heads, group, seq, scale,
                           causal, qst, kst, ost, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, batch, heads, group, seq, scale,
                            causal, qst, kst, ost, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, heads, group, seq, scale,
                            causal, qst, kst, ost, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, batch, heads, group, seq, scale,
                            causal, qst, kst, ost, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the launch's cudaError_t (0 on success).
// bf16 = 1 for __nv_bfloat16 tensors, 0 for float32. q_strides, kv_strides
// and o_strides are the element strides of the batch, head and sequence
// axes (k and v share theirs); the D axis has stride 1.
int flash_attention_fwd(int bf16, const void* q, const void* k,
                        const void* v, void* o, int batch, int heads,
                        int kv_heads, int seq, int dim, float scale,
                        int causal, const long long* q_strides,
                        const long long* kv_strides,
                        const long long* o_strides, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || seq <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = heads / kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(dim, q, k, v, o, batch, heads, group, seq,
                                   scale, causal, q_strides, kv_strides,
                                   o_strides, s);
  }
  return dispatch<float>(dim, q, k, v, o, batch, heads, group, seq, scale,
                         causal, q_strides, kv_strides, o_strides, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
