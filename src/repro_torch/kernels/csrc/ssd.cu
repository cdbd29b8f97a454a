// Mamba2 SSD scan: y and the final state, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::ssd (its
// pl.pallas_call, line 71). Layout is the same: x (B,H,S,P), dt (B,H,S),
// a (H,), b and c (B,S,N) shared by every head, initial state (B,H,P,N)
// -> y (B,H,S,P), final state (B,H,P,N). Per head:
//
//     h[p][n] <- exp(dt_t a) h[p][n] + dt_t x_t[p] b_t[n]
//     y_t[p]   = sum_n h[p][n] c_t[n]
//
// The TPU kernel computes this in the chunked form (an inclusive lower
// triangular segment-sum decay tile, C B^T within the chunk, the incoming
// state's term, the state carried between chunks); this kernel walks the
// literal recurrence, which is the same function with less arithmetic:
// per token and state element a multiply and a multiply-add for the state
// and a multiply-add for y (5 operations), and one exponential per token
// and head, with no decay tile and
// nothing to mask (every decay factor exp(dt a) is <= 1 for a <= 0).
//
// What bounds it on an H100: at the serving path's shape (B=4, H=112,
// S=512, P=N=64) it reads 59 MB of x and writes 59 MB of y (40 us at
// 3.35 TB/s with the states) and does 4.7 GFLOP (70 us at the 67 TFLOP/s
// fp32 rate outside the tensor cores): operations bound it.
//
// Design. One block per (b, h), walking t in order (the TPU grid's
// sequential chunk axis becomes the loop inside the block). The P x N
// state lives in registers: lane (g, p) of a warp holds the N/4 columns
// n = 16j + 4g + e (j < N/16, e < 4) of row p, so the reduction over n
// for y_t[p] is two warp shuffles, never a barrier. Blocks of 32 tokens
// of x, b, c, dt and exp(dt a) are staged in shared memory (one barrier
// on each side); lanes of one group read the same float4 of b and c, and
// the four groups read 64 contiguous bytes, so the reads do not conflict.
// y is written straight from the lanes of group 0. P is 32 or 64 (4 or 8
// warps), N is 16, 32 or 64. x, b and c may be strided views with unit
// stride along their last axis (the model passes slices of one
// projection); dt may have any strides.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;     // tokens staged in shared memory per pass
constexpr int kGroups = 4; // lanes that share one row p, splitting n
constexpr int kRowsPerWarp = 32 / kGroups;

struct Strides {
  long long x_b, x_h, x_s;   // x (B,H,S,P), P contiguous
  long long dt_b, dt_h, dt_s;
  long long bc_b, bc_s;      // b and c (B,S,N), N contiguous
};

template <int P, int N>
__global__ void __launch_bounds__(P / kRowsPerWarp * 32)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ sout, int heads,
           int seq, Strides sd) {
  constexpr int kThreads = P / kRowsPerWarp * 32;
  constexpr int kCols = N / kGroups;   // state columns held by one lane
  __shared__ __align__(16) float xs[kT][P];
  __shared__ __align__(16) float bs[kT][N];
  __shared__ __align__(16) float cs[kT][N];
  __shared__ float dts[kT];
  __shared__ float das[kT];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane & (kGroups - 1);
  const int row = (tid >> 5) * kRowsPerWarp + (lane >> 2);
  const float ah = a[h];

  float st[kCols];
  const float* s0p = s0 + static_cast<long long>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      st[4 * j + e] = s0p[row * N + 16 * j + 4 * g + e];
    }
  }

  const float* xb = x + b * sd.x_b + h * sd.x_h;
  const float* dtb = dt + b * sd.dt_b + h * sd.dt_h;
  const float* bb = bm + b * sd.bc_b;
  const float* cb = cm + b * sd.bc_b;
  float* yp = y + static_cast<long long>(bh) * seq * P;
  for (int t0 = 0; t0 < seq; t0 += kT) {
    const int n = min(kT, seq - t0);
    __syncthreads();   // the previous pass is done reading the stage
    for (int i = tid; i < n * (P / 4); i += kThreads) {
      const int t = i / (P / 4);
      const int p = (i % (P / 4)) * 4;
      *reinterpret_cast<float4*>(&xs[t][p]) =
          *reinterpret_cast<const float4*>(xb + (t0 + t) * sd.x_s + p);
    }
    for (int i = tid; i < n * (N / 4); i += kThreads) {
      const int t = i / (N / 4);
      const int m = (i % (N / 4)) * 4;
      const long long off = (t0 + t) * sd.bc_s + m;
      *reinterpret_cast<float4*>(&bs[t][m]) =
          *reinterpret_cast<const float4*>(bb + off);
      *reinterpret_cast<float4*>(&cs[t][m]) =
          *reinterpret_cast<const float4*>(cb + off);
    }
    for (int t = tid; t < n; t += kThreads) {
      const float d = dtb[(t0 + t) * sd.dt_s];
      dts[t] = d;
      das[t] = expf(d * ah);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float decay = das[t];
      const float dx = dts[t] * xs[t][row];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        const int m = 16 * j + 4 * g;
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[t][m]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[t][m]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          st[i] = fmaf(decay, st[i], dx * bv[e]);
          acc = fmaf(st[i], cv[e], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) yp[static_cast<long long>(t0 + t) * P + row] = acc;
    }
  }

  float* so = sout + static_cast<long long>(bh) * P * N;
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      so[row * N + 16 * j + 4 * g + e] = st[4 * j + e];
    }
  }
}

template <int P, int N>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* b, const float* c, const float* s0, float* y,
                   float* sout, int batch, int heads, int seq,
                   const Strides& sd, cudaStream_t stream) {
  ssd_kernel<P, N><<<batch * heads, P / kRowsPerWarp * 32, 0, stream>>>(
      x, dt, a, b, c, s0, y, sout, heads, seq, sd);
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
