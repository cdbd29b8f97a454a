// Population-batched linear layer: y[n] = act(x[n] @ w[n] + b[n]).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pop_matmul.py::pop_matmul
// (its pl.pallas_call, line 83). Layout is the same: x (N,B,K), w (N,K,M),
// b (N,M), y (N,B,M), all float32, act one of none / relu / tanh.
//
// What bounds it on an H100: at the serving shapes (N=4 members, B=256,
// K,M in {3,256,1}) one launch moves about a megabyte and does at most
// 2*N*B*K*M = 134 MFLOP, so its bound is 0.3 to 2 microseconds (bytes for
// the K=3 and M=1 layers at 3.35 TB/s, operations for the 256x256 layer at
// the 67 TFLOP/s fp32 rate outside the tensor cores). Launch overhead is
// larger than either, so this first version aims at being right for every
// shape, not at the roofline.
//
// Design. The TPU kernel walks a sequential (N, B/bm, M/bn, K/bk) grid and
// carries the sum over K in a VMEM accumulator between grid steps. Blocks on
// the GPU run in no order, so the K loop moves inside the block: the grid is
// (M tiles, B tiles, N), each block stages a 64x16 tile of x and a 16x64
// tile of w in shared memory per step and keeps its 64x64 output tile in
// registers (4x4 per thread, fp32 FMA, no TF32). The epilogue adds the bias
// and applies the activation before the only store. Ragged B, K and M edges
// are masked (zero-filled loads, guarded stores), so every shape runs here;
// the TPU version's block-divisibility gate has no counterpart.
//
// x may be broadcast over members: x_member_stride is the element stride
// between members, B*K for a contiguous x and 0 when every member reads the
// same (B,K) requests. Within a member x is row-major and contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                       // batch rows per block
constexpr int kBN = 64;                       // output columns per block
constexpr int kBK = 16;                       // depth staged per step
constexpr int kTM = 4;                        // rows per thread
constexpr int kTN = 4;                        // columns per thread
constexpr int kThreadsM = kBM / kTM;          // 16
constexpr int kThreadsN = kBN / kTN;          // 16
constexpr int kThreads = kThreadsM * kThreadsN;  // 256
constexpr int kMaxGridYZ = 65535;

enum Activation { kNone = 0, kRelu = 1, kTanh = 2 };

template <int ACT>
__global__ void __launch_bounds__(kThreads)
pop_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int bsz, int k, int m, long long x_member_stride) {
  // x tile stored transposed (depth-major); the +1 spreads its stores over
  // the shared-memory banks
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];

  const int n = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const float* xn = x + n * x_member_stride;
  const float* wn = w + static_cast<long long>(n) * k * m;
  const int tid = threadIdx.x;
  // thread (tr, tc) owns rows tr + 16i and columns tc + 16j of the tile:
  // neighbouring threads read neighbouring w columns and store neighbouring
  // outputs
  const int tr = tid / kThreadsN;
  const int tc = tid % kThreadsN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < bsz && gk < k)
                      ? xn[static_cast<long long>(gr) * k + gk] : 0.0f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN;
      const int gk = k0 + kk, gc = col0 + c;
      ws[kk][c] = (gk < k && gc < m)
                      ? wn[static_cast<long long>(gk) * m + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], v[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][tr + i * kThreadsM];
#pragma unroll
      for (int j = 0; j < kTN; ++j) v[j] = ws[kk][tc + j * kThreadsN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + tr + i * kThreadsM;
    if (gr >= bsz) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tc + j * kThreadsN;
      if (gc >= m) continue;
      float v = acc[i][j];
      if (b != nullptr) v += b[static_cast<long long>(n) * m + gc];
      if (ACT == kRelu) {
        v = v < 0.0f ? 0.0f : v;  // keeps NaN, as torch.relu does
      } else if (ACT == kTanh) {
        v = tanhf(v);
      }
      y[(static_cast<long long>(n) * bsz + gr) * m + gc] = v;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `b` may be null (no bias). Sizes of 0 launch nothing and return 0.
extern "C" int pop_matmul_f32(const float* x, const float* w, const float* b,
                              float* y, int n, int bsz, int k, int m,
                              long long x_member_stride, int act,
                              void* stream) {
  if (n < 0 || bsz < 0 || k < 0 || m < 0) return cudaErrorInvalidValue;
  if (n == 0 || bsz == 0 || m == 0) return cudaSuccess;
  const dim3 grid((m + kBN - 1) / kBN, (bsz + kBM - 1) / kBM, n);
  if (grid.y > kMaxGridYZ || grid.z > kMaxGridYZ)
    return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kNone:
      pop_matmul_kernel<kNone><<<grid, kThreads, 0, s>>>(
          x, w, b, y, bsz, k, m, x_member_stride);
      break;
    case kRelu:
      pop_matmul_kernel<kRelu><<<grid, kThreads, 0, s>>>(
          x, w, b, y, bsz, k, m, x_member_stride);
      break;
    case kTanh:
      pop_matmul_kernel<kTanh><<<grid, kThreads, 0, s>>>(
          x, w, b, y, bsz, k, m, x_member_stride);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* pop_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
