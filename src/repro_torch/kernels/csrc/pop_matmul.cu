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
// the 67 TFLOP/s fp32 rate outside the tensor cores). At these sizes what
// holds a launch back is latency and the share of the 132 SMs it fills,
// not bytes or operations: 64x64 output tiles would give 64 blocks at N=4
// for the 256x256 layer and 16 for the M=1 head (63 of each tile's 64
// columns idle), and a K walk whose every step waits for its own loads
// leaves their latency exposed. The arithmetic stays fp32 FMA with no
// TF32 (the served answers are held to 1e-5).
//
// Two routes, chosen by the caller (kernels/pop_matmul.py::_route) from M:
//
// tiled (M >= 16): the grid is (M tiles of 64, B tiles of 32, N), 128
// threads a block, so N=4, B=256, M=256 gives 128 blocks and N=8 gives
// 256. K moves inside the block in tiles of 32, double-buffered in shared
// memory by cp.async (16-byte copies where K and M are multiples of 4 and
// the pointers aligned, 4-byte ones otherwise, zero-filled past the
// edges), so the next tile's loads are in flight during the current
// tile's FMAs. Each thread keeps a 4x4 register tile, reading x and w from
// shared memory as float4; only the depth that K leaves is multiplied
// (one group of 4 at K=3). The epilogue adds the bias and applies the
// activation before the only store.
//
// narrow (M < 16, the M=1 heads of the actor and critic): one warp per
// (member, batch row), 8 warps a block, grid (B/8, N): 128 blocks at
// N=4, B=256. The block stages w's M columns (transposed, up to 32 KB of
// depth at a time) in shared memory once; for one column after another,
// lanes split K with float4 loads of x and the sum is reduced across the
// warp by __shfl_xor_sync. The tiled route would give the M=1 head 32
// blocks at N=4, with 63 of each tile's 64 columns idle; chip_smoke.py
// times it beside this route at the served and training heads.
//
// x may be broadcast over members: x_member_stride is the element stride
// between members, B*K for a contiguous x and 0 when every member reads the
// same (B,K) requests. Within a member x is row-major and contiguous.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Activation { kNone = 0, kRelu = 1, kTanh = 2 };
enum Route { kTiled = 0, kNarrow = 1 };
constexpr int kMaxGridYZ = 65535;

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == kRelu) return v < 0.0f ? 0.0f : v;  // keeps NaN, as torch.relu
  if (ACT == kTanh) return tanhf(v);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; a source size of 0 zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ------------------------------------------------------------ tiled route
constexpr int kTM = 32;                       // batch rows per block
constexpr int kTN = 64;                       // output columns per block
constexpr int kTK = 32;                       // depth per stage
constexpr int kTiledThreads = 128;            // 8 x 16 threads, 4x4 each
constexpr int kXStride = kTK + 4;             // padded x row (floats)

// x tile [kTM][kTK] and w tile [kTK][kTN] of depth k0 into one stage.
// VEC: 16-byte copies (K and M multiples of 4, pointers aligned).
template <bool VEC>
__device__ __forceinline__ void load_tile(float (*xs)[kXStride],
                                          float (*ws)[kTN],
                                          const float* xn, const float* wn,
                                          int row0, int col0, int k0,
                                          int bsz, int k, int m) {
  const int tid = threadIdx.x;
  if (VEC) {
    for (int i = tid; i < kTM * kTK / 4; i += kTiledThreads) {
      const int r = i / (kTK / 4), c = (i % (kTK / 4)) * 4;
      const bool ok = row0 + r < bsz && k0 + c < k;
      cp_async16(&xs[r][c],
                 ok ? xn + static_cast<long long>(row0 + r) * k + k0 + c : xn,
                 ok);
    }
    for (int i = tid; i < kTK * kTN / 4; i += kTiledThreads) {
      const int r = i / (kTN / 4), c = (i % (kTN / 4)) * 4;
      const bool ok = k0 + r < k && col0 + c < m;
      cp_async16(&ws[r][c],
                 ok ? wn + static_cast<long long>(k0 + r) * m + col0 + c : wn,
                 ok);
    }
  } else {
    for (int i = tid; i < kTM * kTK; i += kTiledThreads) {
      const int r = i / kTK, c = i % kTK;
      const bool ok = row0 + r < bsz && k0 + c < k;
      cp_async4(&xs[r][c],
                ok ? xn + static_cast<long long>(row0 + r) * k + k0 + c : xn,
                ok);
    }
    for (int i = tid; i < kTK * kTN; i += kTiledThreads) {
      const int r = i / kTN, c = i % kTN;
      const bool ok = k0 + r < k && col0 + c < m;
      cp_async4(&ws[r][c],
                ok ? wn + static_cast<long long>(k0 + r) * m + col0 + c : wn,
                ok);
    }
  }
}

template <int ACT, bool VEC>
__global__ void __launch_bounds__(kTiledThreads)
pop_matmul_tiled(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y,
                 int bsz, int k, int m, long long x_member_stride) {
  __shared__ __align__(16) float xs[2][kTM][kXStride];
  __shared__ __align__(16) float ws[2][kTK][kTN];

  const int n = blockIdx.z;
  const int row0 = blockIdx.y * kTM;
  const int col0 = blockIdx.x * kTN;
  const float* xn = x + n * x_member_stride;
  const float* wn = w + static_cast<long long>(n) * k * m;
  // thread (tr, tc) owns rows 4tr..4tr+3 and columns 4tc..4tc+3 of the
  // tile: neighbouring threads read neighbouring w columns and store
  // neighbouring outputs
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int tiles = (k + kTK - 1) / kTK;
  if (tiles > 0) {
    load_tile<VEC>(xs[0], ws[0], xn, wn, row0, col0, 0, bsz, k, m);
  }
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < tiles) {
      load_tile<VEC>(xs[st ^ 1], ws[st ^ 1], xn, wn, row0, col0,
                     (t + 1) * kTK, bsz, k, m);
    }
    cp_async_commit();
    cp_async_wait1();   // all but the newest group: tile t has landed
    __syncthreads();
    // groups of 4 in depth that K leaves in this tile (zero-filled past K)
    const int groups = (min(kTK, k - t * kTK) + 3) / 4;
#pragma unroll 8
    for (int gi = 0; gi < groups; ++gi) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(&xs[st][4 * tr + i][4 * gi]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv =
            *reinterpret_cast<const float4*>(&ws[st][4 * gi + kk][4 * tc]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = kk == 0 ? a[i].x
                           : kk == 1 ? a[i].y
                           : kk == 2 ? a[i].z
                                     : a[i].w;
          acc[i][0] = fmaf(ai, wv.x, acc[i][0]);
          acc[i][1] = fmaf(ai, wv.y, acc[i][1]);
          acc[i][2] = fmaf(ai, wv.z, acc[i][2]);
          acc[i][3] = fmaf(ai, wv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();   // this stage is free for the load two tiles on
  }

  const int gc = col0 + 4 * tc;
  if (gc >= m) return;
  float bias[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (b != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (gc + j < m) bias[j] = b[static_cast<long long>(n) * m + gc + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + 4 * tr + i;
    if (gr >= bsz) continue;
    float* yr = y + (static_cast<long long>(n) * bsz + gr) * m + gc;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = activate<ACT>(acc[i][j] + bias[j]);
    if (VEC) {   // M is a multiple of 4: the 4 columns are all in
      *reinterpret_cast<float4*>(yr) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gc + j < m) yr[j] = v[j];
      }
    }
  }
}

// ----------------------------------------------------------- narrow route
constexpr int kNarrowWarps = 8;                      // batch rows per block
constexpr int kNarrowThreads = kNarrowWarps * 32;
constexpr int kMaxNarrowM = 15;
constexpr int kNarrowSmemFloats = 8192;              // w staged per pass

// VEC: float4 loads of x (K a multiple of 4, x aligned).
template <int ACT, bool VEC>
__global__ void __launch_bounds__(kNarrowThreads)
pop_matmul_narrow(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int bsz, int k, int m, long long x_member_stride) {
  __shared__ __align__(16) float ws[kNarrowSmemFloats];   // [m][depth]

  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kNarrowWarps + warp;
  const float* xr =
      x + n * x_member_stride + static_cast<long long>(row) * k;
  const float* wn = w + static_cast<long long>(n) * k * m;
  // depth staged per pass: a multiple of 128 (a warp's float4 stride)
  const int depth = (kNarrowSmemFloats / m) / 128 * 128;

  float out = 0.0f;   // lane j < m keeps column j's sum
  for (int k0 = 0; k0 < k; k0 += depth) {
    const int len = min(depth, k - k0);
    __syncthreads();   // the previous pass is done with ws
    for (int i = threadIdx.x; i < len * m; i += kNarrowThreads) {
      const int kk = i / m, j = i % m;
      ws[j * depth + kk] = wn[static_cast<long long>(k0 + kk) * m + j];
    }
    __syncthreads();
    if (row >= bsz) continue;
    // one column at a time (the served heads have one); x's row is read
    // again from L1 for each further column
    for (int j = 0; j < m; ++j) {
      const float* wj = ws + j * depth;
      // four partial sums (one per float4 lane of x), added at the end
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (VEC) {   // len is a multiple of 4
#pragma unroll 1   // unrolled, ptxas spills here
        for (int kk = 4 * lane; kk < len; kk += 128) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + k0 + kk);
          const float4 wv = *reinterpret_cast<const float4*>(wj + kk);
          acc.x = fmaf(xv.x, wv.x, acc.x);
          acc.y = fmaf(xv.y, wv.y, acc.y);
          acc.z = fmaf(xv.z, wv.z, acc.z);
          acc.w = fmaf(xv.w, wv.w, acc.w);
        }
      } else {
        for (int kk = lane; kk < len; kk += 32) {
          acc.x = fmaf(xr[k0 + kk], wj[kk], acc.x);
        }
      }
      float s = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == j) out += s;
    }
  }

  if (row >= bsz || lane >= m) return;
  if (b != nullptr) out += b[static_cast<long long>(n) * m + lane];
  y[(static_cast<long long>(n) * bsz + row) * m + lane] = activate<ACT>(out);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int ACT>
cudaError_t launch(int route, const float* x, const float* w, const float* b,
                   float* y, int n, int bsz, int k, int m,
                   long long x_member_stride, cudaStream_t s) {
  const bool x_vec = k % 4 == 0 && x_member_stride % 4 == 0 && aligned16(x);
  if (route == kTiled) {
    const dim3 grid((m + kTN - 1) / kTN, (bsz + kTM - 1) / kTM, n);
    if (grid.y > kMaxGridYZ) return cudaErrorInvalidConfiguration;
    if (x_vec && m % 4 == 0 && aligned16(w) && aligned16(y)) {
      pop_matmul_tiled<ACT, true><<<grid, kTiledThreads, 0, s>>>(
          x, w, b, y, bsz, k, m, x_member_stride);
    } else {
      pop_matmul_tiled<ACT, false><<<grid, kTiledThreads, 0, s>>>(
          x, w, b, y, bsz, k, m, x_member_stride);
    }
  } else {
    if (m > kMaxNarrowM) return cudaErrorInvalidValue;
    const dim3 grid((bsz + kNarrowWarps - 1) / kNarrowWarps, n);
    if (x_vec) {
      pop_matmul_narrow<ACT, true><<<grid, kNarrowThreads, 0, s>>>(
          x, w, b, y, bsz, k, m, x_member_stride);
    } else {
      pop_matmul_narrow<ACT, false><<<grid, kNarrowThreads, 0, s>>>(
          x, w, b, y, bsz, k, m, x_member_stride);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `b` may be null (no bias). Sizes of 0 launch nothing and return 0.
// route: 0 tiled (any M), 1 narrow (M <= 15).
extern "C" int pop_matmul_f32(const float* x, const float* w, const float* b,
                              float* y, int n, int bsz, int k, int m,
                              long long x_member_stride, int act, int route,
                              void* stream) {
  if (n < 0 || bsz < 0 || k < 0 || m < 0) return cudaErrorInvalidValue;
  if (route != kTiled && route != kNarrow) return cudaErrorInvalidValue;
  if (n == 0 || bsz == 0 || m == 0) return cudaSuccess;
  if (n > kMaxGridYZ) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kNone:
      return launch<kNone>(route, x, w, b, y, n, bsz, k, m, x_member_stride,
                           s);
    case kRelu:
      return launch<kRelu>(route, x, w, b, y, n, bsz, k, m, x_member_stride,
                           s);
    case kTanh:
      return launch<kTanh>(route, x, w, b, y, n, bsz, k, m, x_member_stride,
                           s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* pop_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
