// One control step of the planar hopper (src/repro/envs/hopper2d.py), for
// every env of a population at once.
//
// Replaces no TPU kernel: the JAX package has no pallas_call for it, since
// XLA fuses the whole control step into one program there. PyTorch runs
// eagerly, and the step written as tensor code (the plain version,
// src/repro_torch/envs/hopper2d.py::hopper2d_step_plain) is some 2,000
// small launches a control step: 5 substeps of 3 joints and 5 contacts. At
// a few microseconds of host time each, that is milliseconds a step at any
// env count. This kernel makes it one launch.
//
// Layout: pos (num, 4, 2), th (num, 4), vel (num, 4, 2), om (num, 4),
// action (num, 3), all float32 and contiguous; body order torso, thigh,
// leg, foot. Outputs: the new pos, th, vel and om, the observation
// (num, 11), the reward (num,) and the termination flag (num,) as bytes
// (torch.bool).
//
// What bounds it on an H100: each env reads 27 floats and writes 36 and a
// byte, about 253 bytes, and does some 2,000 float operations (5 substeps
// of 16 sincos, 5 tanh and the spring forces), so at 32,768 envs it moves
// 8.3 MB (2.5 us at 3.35 TB/s) and does about 66 MFLOP (1 us at the 67
// TFLOP/s fp32 rate): bytes bound it. One thread per env keeps the whole
// state (24 floats) and the force accumulators in registers through all
// substeps, so device memory is touched once on the way in and once on the
// way out. sinf, cosf and tanhf are the accurate ones, not the fast
// intrinsics, so that the kernel stays within the plain version's
// tolerance; forces and torques accumulate in the plain version's (and the
// JAX code's) order. It is built with -fmad=false (kernels/build.py) and
// divides by a constant as PyTorch does (times the reciprocal, rounded
// once in float), so each operation rounds as the plain version's does on
// the card and the two agree to the bit but for the reward's sum of three
// squares, whose order PyTorch's reduction picks.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSubsteps = 5;
constexpr float kDt = 0.002f;
constexpr float kInvControlDt = 1.0f / 0.01f;   // dt * substeps = 0.01
constexpr float kGravity = 9.8f;
constexpr float kJointK = 4000.0f;
constexpr float kJointC = 40.0f;
constexpr float kRotC = 2.0f;
constexpr float kLimitK = 60.0f;
constexpr float kContactK = 6000.0f;
constexpr float kContactC = 30.0f;
constexpr float kFriction = 0.9f;
constexpr float kInvVSmooth = 1.0f / 0.1f;
constexpr float kZMin = 0.7f;
constexpr float kThMax = 1.0f;

__device__ __constant__ float kMass[4] = {3.5f, 4.0f, 2.7f, 5.1f};
__device__ __constant__ float kLength[4] = {0.40f, 0.45f, 0.50f, 0.39f};
__device__ __constant__ float kTorque[3] = {30.0f, 30.0f, 15.0f};

// joints: parent, parent-frame anchor, child, child-frame anchor, limits
struct Joint {
  int p;
  float ax, az;
  int c;
  float bx, bz;
  float lo, hi;
};
__device__ __constant__ Joint kJoints[3] = {
    {0, 0.0f, -0.20f, 1, 0.0f, 0.225f, -1.0f, 1.0f},
    {1, 0.0f, -0.225f, 2, 0.0f, 0.25f, -1.2f, 1.2f},
    {2, 0.0f, -0.25f, 3, -0.0975f, 0.0f, -0.8f, 0.8f},
};

// ground-contact candidate points: body, body-frame offset
struct Contact {
  int b;
  float x, z;
};
__device__ __constant__ Contact kContacts[5] = {
    {3, 0.195f, 0.0f}, {3, -0.195f, 0.0f}, {2, 0.0f, -0.25f},
    {0, 0.0f, -0.20f}, {0, 0.0f, 0.20f},
};

__global__ void __launch_bounds__(kThreads)
    hopper2d_step_kernel(const float* __restrict__ pos_in,
                         const float* __restrict__ th_in,
                         const float* __restrict__ vel_in,
                         const float* __restrict__ om_in,
                         const float* __restrict__ action,
                         float* __restrict__ pos_out,
                         float* __restrict__ th_out,
                         float* __restrict__ vel_out,
                         float* __restrict__ om_out,
                         float* __restrict__ obs,
                         float* __restrict__ reward,
                         uint8_t* __restrict__ terminated, int num) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= num) return;
  float px[4], pz[4], th[4], vx[4], vz[4], om[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    px[i] = pos_in[e * 8 + 2 * i];
    pz[i] = pos_in[e * 8 + 2 * i + 1];
    vx[i] = vel_in[e * 8 + 2 * i];
    vz[i] = vel_in[e * 8 + 2 * i + 1];
    th[i] = th_in[e * 4 + i];
    om[i] = om_in[e * 4 + i];
  }
  float a[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a[j] = fminf(fmaxf(action[e * 3 + j], -1.0f), 1.0f);
  }
  float inertia[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inertia[i] = kMass[i] * (kLength[i] * kLength[i]) * (1.0f / 12.0f);
  }
  const float x0 = px[0];

  for (int sub = 0; sub < kSubsteps; ++sub) {
    float fx[4], fz[4], tau[4], c[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fx[i] = 0.0f;
      fz[i] = 0.0f - kGravity * kMass[i];
      tau[i] = 0.0f;
      c[i] = cosf(th[i]);
      s[i] = sinf(th[i]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const Joint J = kJoints[j];
      const int p = J.p, ch = J.c;
      const float wax = c[p] * J.ax - s[p] * J.az;
      const float waz = s[p] * J.ax + c[p] * J.az;
      const float wbx = c[ch] * J.bx - s[ch] * J.bz;
      const float wbz = s[ch] * J.bx + c[ch] * J.bz;
      const float dx = (px[p] + wax) - (px[ch] + wbx);
      const float dz = (pz[p] + waz) - (pz[ch] + wbz);
      const float pvx = vx[p] + om[p] * -waz, pvz = vz[p] + om[p] * wax;
      const float cvx = vx[ch] + om[ch] * -wbz, cvz = vz[ch] + om[ch] * wbx;
      const float fjx = kJointK * dx + kJointC * (pvx - cvx);
      const float fjz = kJointK * dz + kJointC * (pvz - cvz);
      fx[ch] += fjx;
      fz[ch] += fjz;
      fx[p] += -fjx;
      fz[p] += -fjz;
      tau[ch] += wbx * fjz - wbz * fjx;
      tau[p] += wax * -fjz - waz * -fjx;
      const float rel = th[ch] - th[p];
      const float tj = kTorque[j] * a[j] - kRotC * (om[ch] - om[p]) -
                       kLimitK * (fmaxf(rel - J.hi, 0.0f) +
                                  fminf(rel - J.lo, 0.0f));
      tau[ch] += tj;
      tau[p] += -tj;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const Contact C = kContacts[k];
      const int b = C.b;
      const float rx = c[b] * C.x - s[b] * C.z;
      const float rz = s[b] * C.x + c[b] * C.z;
      const float pwz = pz[b] + rz;
      const float vwx = vx[b] + om[b] * -rz, vwz = vz[b] + om[b] * rx;
      const float pen = fmaxf(-pwz, 0.0f);
      const float active = pen > 0.0f ? 1.0f : 0.0f;
      const float fn =
          fmaxf(kContactK * pen - kContactC * vwz, 0.0f) * active;
      const float ft = -kFriction * fn * tanhf(vwx * kInvVSmooth);
      fx[b] += ft;
      fz[b] += fn;
      tau[b] += rx * fn - rz * ft;
    }
    // semi-implicit Euler: velocities first, then positions from the new
    // velocities
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vx[i] = vx[i] + kDt * fx[i] / kMass[i];
      vz[i] = vz[i] + kDt * fz[i] / kMass[i];
      om[i] = om[i] + kDt * tau[i] / inertia[i];
      px[i] = px[i] + kDt * vx[i];
      pz[i] = pz[i] + kDt * vz[i];
      th[i] = th[i] + kDt * om[i];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos_out[e * 8 + 2 * i] = px[i];
    pos_out[e * 8 + 2 * i + 1] = pz[i];
    vel_out[e * 8 + 2 * i] = vx[i];
    vel_out[e * 8 + 2 * i + 1] = vz[i];
    th_out[e * 4 + i] = th[i];
    om_out[e * 4 + i] = om[i];
  }
  float* o = obs + e * 11;
  o[0] = pz[0];
  o[1] = th[0];
  o[2] = th[1] - th[0];
  o[3] = th[2] - th[1];
  o[4] = th[3] - th[2];
  o[5] = vx[0];
  o[6] = vz[0];
  o[7] = om[0];
  o[8] = om[1] - om[0];
  o[9] = om[2] - om[1];
  o[10] = om[3] - om[2];
  const float fwd = (px[0] - x0) * kInvControlDt;
  reward[e] = fwd + 1.0f - 1e-3f * (a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  terminated[e] = (pz[0] < kZMin) || (fabsf(th[0]) > kThMax);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// num = 0 launches nothing. Inputs and outputs must not overlap.
extern "C" int hopper2d_step_f32(const float* pos, const float* th,
                                 const float* vel, const float* om,
                                 const float* action, float* pos_out,
                                 float* th_out, float* vel_out,
                                 float* om_out, float* obs, float* reward,
                                 uint8_t* terminated, int num,
                                 void* stream) {
  if (num < 0) return cudaErrorInvalidValue;
  if (num == 0) return cudaSuccess;
  const int blocks = (num + kThreads - 1) / kThreads;
  hopper2d_step_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pos, th, vel, om, action, pos_out, th_out, vel_out, om_out, obs,
      reward, terminated, num);
  return cudaGetLastError();
}

// The kernel's registers a thread, its threads a block and the blocks
// of it an SM can hold at once (the occupancy the launch can reach).
extern "C" int hopper2d_kernel_info(int* regs, int* threads,
                                    int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, hopper2d_step_kernel);
  if (rc != cudaSuccess) return rc;
  *regs = attr.numRegs;
  *threads = kThreads;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, hopper2d_step_kernel, kThreads, 0);
}

extern "C" const char* hopper2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
