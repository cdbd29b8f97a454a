// RWKV6 WKV recurrence: y and the final state, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py::wkv6 (its
// pl.pallas_call, line 74). Layout is the same: r, k, v, lw (B,H,S,D),
// u (H,D), initial state (B,H,D,D) -> y (B,H,S,D), final state (B,H,D,D).
// Per head, with k-dim = v-dim = D and w_t = exp(lw_t):
//
//     y_t[v] = sum_k r_t[k] (S[k][v] + u[k] k_t[k] v_t[v])
//     S[k][v] <- w_t[k] S[k][v] + k_t[k] v_t[v]
//
// The TPU kernel computes this in the chunked form (an intra-chunk
// decay tile of exponentials masked below the diagonal, plus the state
// carried between chunks); this kernel walks the literal recurrence,
// which is the same function with less arithmetic, no tile of decay
// exponentials and nothing to mask (every decay factor is exp(lw) <= 1).
// The function needs 5 operations per token and state element (k v, the
// decayed update, r S into y) and O(D) per token: the bonus term is
// rank-1 in v, v_t[v] * sum_k r_t[k] u[k] k_t[k]. The kernel folds the
// bonus into each element instead (one multiply and three fused
// multiply-adds, 7 operations): every lane would otherwise compute its
// part of the per-token scalar itself, for the same instruction count.
//
// What bounds it on an H100: at the serving path's shape (B=4, H=32,
// S=512, D=64) it reads 69 MB (r, k, v, lw, the initial state) and writes
// 19 MB (y, the final state): 26 us at 3.35 TB/s. The function's 1.4
// GFLOP take 20 us at the 67 TFLOP/s fp32 rate outside the tensor cores,
// so bytes bound it. The recurrence is sequential in t, so the design's
// aim is that the per-token step has no barrier and a short dependency
// chain.
//
// Design. One block per (b, h), walking t in order (the TPU grid's
// sequential chunk axis becomes the loop inside the block). The D x D
// state lives in registers: lane (kg, v) of a warp holds the D/4 rows
// k = 16j + 4kg + e (j < D/16, e < 4) of column v, so the reduction over
// k for y_t[v] is two warp shuffles, never a barrier. Blocks of 32 tokens
// of r, k, v and exp(lw) are staged in shared memory (float4 loads, one
// barrier on each side); lanes of one k group read the same float4, and
// the four groups read 64 contiguous bytes, so the reads do not conflict.
// y is written straight from the lanes of k group 0. D is 32 or 64
// (4 or 8 warps). r, k, v and lw may be strided views (the model passes
// (B,S,H,D) tensors transposed), with unit stride along D.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;     // tokens staged in shared memory per pass
constexpr int kGroups = 4; // lanes that share one column v, splitting k
constexpr int kColsPerWarp = 32 / kGroups;

template <int D>
__global__ void __launch_bounds__(D / kColsPerWarp * 32)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sout, int heads,
            int seq, long long stride_b, long long stride_h,
            long long stride_s) {
  constexpr int kThreads = D / kColsPerWarp * 32;
  constexpr int kRows = D / kGroups;   // state rows held by one lane
  __shared__ __align__(16) float rs[kT][D];
  __shared__ __align__(16) float ks[kT][D];
  __shared__ __align__(16) float vs[kT][D];
  __shared__ __align__(16) float ws[kT][D];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kg = lane & (kGroups - 1);
  const int col = (tid >> 5) * kColsPerWarp + (lane >> 2);

  float st[kRows], uu[kRows];
  const float* s0p = s0 + static_cast<long long>(bh) * D * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * j + 4 * kg + e;
      st[4 * j + e] = s0p[row * D + col];
      uu[4 * j + e] = u[h * D + row];
    }
  }

  const long long base = b * stride_b + h * stride_h;
  float* yp = y + static_cast<long long>(bh) * seq * D;
  for (int t0 = 0; t0 < seq; t0 += kT) {
    const int n = min(kT, seq - t0);
    __syncthreads();   // the previous pass is done reading the stage
    for (int i = tid; i < n * (D / 4); i += kThreads) {
      const int t = i / (D / 4);
      const int d = (i % (D / 4)) * 4;
      const long long off = base + (t0 + t) * stride_s + d;
      *reinterpret_cast<float4*>(&rs[t][d]) =
          *reinterpret_cast<const float4*>(r + off);
      *reinterpret_cast<float4*>(&ks[t][d]) =
          *reinterpret_cast<const float4*>(k + off);
      *reinterpret_cast<float4*>(&vs[t][d]) =
          *reinterpret_cast<const float4*>(v + off);
      const float4 l = *reinterpret_cast<const float4*>(lw + off);
      *reinterpret_cast<float4*>(&ws[t][d]) =
          make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w));
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vv = vs[t][col];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int d = 16 * j + 4 * kg;
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][d]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][d]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][d]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float kv = kk[e] * vv;
          acc = fmaf(rr[e], fmaf(uu[i], kv, st[i]), acc);
          st[i] = fmaf(ww[e], st[i], kv);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (kg == 0) yp[static_cast<long long>(t0 + t) * D + col] = acc;
    }
  }

  float* so = sout + static_cast<long long>(bh) * D * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      so[(16 * j + 4 * kg + e) * D + col] = st[4 * j + e];
    }
  }
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
  const dim3 grid(batch * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 64) {
    wkv6_kernel<64><<<grid, 256, 0, s>>>(r, k, v, lw, u, s0, y, sout, heads,
                                         seq, stride_b, stride_h, stride_s);
  } else if (dim == 32) {
    wkv6_kernel<32><<<grid, 128, 0, s>>>(r, k, v, lw, u, s0, y, sout, heads,
                                         seq, stride_b, stride_h, stride_s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
