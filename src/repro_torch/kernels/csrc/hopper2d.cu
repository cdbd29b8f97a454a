// One control step of the planar hopper (src/repro/envs/hopper2d.py), for
// every env of a population at once; and the vector env's whole step on
// it: the control step, the time limit, the auto-reset and the episode
// accounting in one launch.
//
// Replaces no TPU kernel: the JAX package has no pallas_call for it, since
// XLA fuses the whole control step, and the vector env's step around it,
// into one program there. PyTorch runs eagerly, and the step written as
// tensor code (the plain versions, src/repro_torch/envs/hopper2d.py::
// hopper2d_step_plain and hopper2d_vec_step_plain) is some 2,000 small
// launches a control step: 5 substeps of 3 joints and 5 contacts, then
// about 50 more for the time limit, the reset and the accounting. These
// kernels make each one launch.
//
// Entry points:
//   hopper2d_step_f32      the raw step (Env.step): pos (num, 4, 2), th
//                          (num, 4), vel (num, 4, 2), om (num, 4), action
//                          (num, 3) -> the new pos, th, vel and om, the
//                          observation (num, 11), the reward (num,) and
//                          the termination flag (num,) as bytes;
//   hopper2d_vec_step_f32  VecEnv.step: besides those inputs t (num,)
//                          int32, the reset draws u_pos (num, 4, 2) and
//                          u_th (num, 4) and the six accounting tensors
//                          (num,); out the next state with finished envs
//                          reset, the observation after the reset and the
//                          terminal one before it, reward, done and
//                          truncated (bytes), the transition's done &
//                          ~truncated and truncated as floats, and the six
//                          accounting tensors updated.
// All float32 but t, the lengths and counts (int32) and the flags (bytes,
// torch.bool); contiguous; body order torso, thigh, leg, foot.
//
// What bounds it on an H100: the raw step reads 27 floats an env and
// writes 36 and a byte (253 B), the vector step 410 B; each does some
// 2,000 float operations (5 substeps of 16 sincos, 5 tanh and the spring
// forces). At the acting engine's 2,048-32,768 envs that is 0.2-4 us of
// bytes and under 1 us of operations, so one env's dependent chain sets
// the time: 5 substeps of sincos, the joints, the contacts and three IEEE
// divisions each. The design shortens that chain and keeps it out of
// memory:
//   * four lanes an env, one a body (a warp holds 8 envs): each lane
//     computes its own body's sin and cos, joint j's lane (its parent)
//     takes the child's pose from lane j + 1 by __shfl_down_sync and
//     hands the child's force and torque back by __shfl_up_sync, and each
//     lane runs its own body's contacts and integration. Four times the
//     threads, a quarter of the chain a thread;
//   * every lane's table entries (mass, inertia, joint anchors, limits,
//     gain, contact offsets, rest pose) are scalars chosen once from its
//     lane index, so nothing is indexed at run time and the state stays
//     in registers: no local memory but sinf's and cosf's own slow path,
//     taken only for angles beyond 105,615 rad.
// Each body's forces and torques accumulate in the plain version's (and
// the JAX code's) order: joint j - 1 as its child, joint j as its parent,
// then its contacts. sinf, cosf and tanhf are the accurate ones, not the
// fast intrinsics; the file is built with -fmad=false (kernels/build.py)
// and divides by a scalar as PyTorch does (times the reciprocal, rounded
// once in float), so each operation rounds as the plain version's does on
// the card: the two agree to the bit but for the reward's sum of three
// squares, whose order PyTorch's reduction picks, and in the vector step
// the returns that add the reward up.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;               // threads an env: one a body
constexpr unsigned kFull = 0xffffffffu;
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
constexpr float kResetLo = -5e-3f;     // a reset draw u moves the rest
constexpr float kResetSpan = 1e-2f;    // pose by kResetLo + kResetSpan u

// value v[lane] of a four-entry table, chosen by selects
__device__ __forceinline__ float pick(int lane, float v0, float v1, float v2,
                                      float v3) {
  return lane == 0 ? v0 : lane == 1 ? v1 : lane == 2 ? v2 : v3;
}

// What a lane needs of the tables for its body b = lane: the body's mass
// and inertia; joint b, whose parent it is (b < 3): the anchors in its own
// frame (ax, az) and in its child's (bx, bz), the relative angle's limit
// (the joints' limits are symmetric) and the actuator's gain; its ground-
// contact candidates, in the tables' order (the foot's toe and heel, the
// leg's bottom, the torso's two ends); its rest pose.
struct Lane {
  int body;
  float mass, inertia, weight;
  float ax, az, bx, bz, hi, gain;
  int contacts;
  float cx0, cz0, cx1, cz1;
  float rest_x, rest_z;
};

__device__ __forceinline__ Lane lane_tables(int b) {
  Lane k;
  k.body = b;
  k.mass = pick(b, 3.5f, 4.0f, 2.7f, 5.1f);
  const float length = pick(b, 0.40f, 0.45f, 0.50f, 0.39f);
  k.inertia = k.mass * (length * length) * (1.0f / 12.0f);  // a thin rod
  k.weight = 0.0f - kGravity * k.mass;
  k.ax = 0.0f;
  k.az = pick(b, -0.20f, -0.225f, -0.25f, 0.0f);
  k.bx = pick(b, 0.0f, 0.0f, -0.0975f, 0.0f);
  k.bz = pick(b, 0.225f, 0.25f, 0.0f, 0.0f);
  k.hi = pick(b, 1.0f, 1.2f, 0.8f, 0.0f);
  k.gain = pick(b, 30.0f, 30.0f, 15.0f, 0.0f);
  k.contacts = b == 1 ? 0 : b == 2 ? 1 : 2;
  k.cx0 = pick(b, 0.0f, 0.0f, 0.0f, 0.195f);
  k.cz0 = pick(b, -0.20f, 0.0f, -0.25f, 0.0f);
  k.cx1 = pick(b, 0.0f, 0.0f, 0.0f, -0.195f);
  k.cz1 = pick(b, 0.20f, 0.0f, 0.0f, 0.0f);
  k.rest_x = pick(b, -0.0975f, -0.0975f, -0.0975f, 0.0f);
  k.rest_z = pick(b, 1.21f, 0.785f, 0.31f, 0.06f);
  return k;
}

// one body's pose and velocity
struct Body {
  float px, pz, th, vx, vz, om;
};

// lane l of a four-lane group reads lane l + 1's value (the last its own)
__device__ __forceinline__ float from_next(float v) {
  return __shfl_down_sync(kFull, v, 1, kLanes);
}
// lane l reads lane l - 1's value (the first its own)
__device__ __forceinline__ float from_prev(float v) {
  return __shfl_up_sync(kFull, v, 1, kLanes);
}
__device__ __forceinline__ float from_lane(float v, int lane) {
  return __shfl_sync(kFull, v, lane, kLanes);
}

// one ground-contact candidate at body-frame offset (ox, oz): adds its
// normal and friction forces and their torque
__device__ __forceinline__ void contact(const Body& q, float c, float s,
                                        float ox, float oz, float& fx,
                                        float& fz, float& tau) {
  const float rx = c * ox - s * oz;
  const float rz = s * ox + c * oz;
  const float pwz = q.pz + rz;
  const float vwx = q.vx + q.om * -rz, vwz = q.vz + q.om * rx;
  const float pen = fmaxf(-pwz, 0.0f);
  const float active = pen > 0.0f ? 1.0f : 0.0f;
  const float fn = fmaxf(kContactK * pen - kContactC * vwz, 0.0f) * active;
  const float ft = -kFriction * fn * tanhf(vwx * kInvVSmooth);
  fx += ft;
  fz += fn;
  tau += rx * fn - rz * ft;
}

// The control step of one env, its body k.body on this lane: kSubsteps
// semi-implicit Euler steps under the joint, actuator and contact forces.
// `a` is the clipped action of joint k.body (0 on the foot's lane). Every
// lane of the group calls it (the shuffles take all four).
__device__ __forceinline__ void control_step(Body& q, float a,
                                             const Lane& k) {
  const bool parent = k.body < 3, child = k.body > 0;
  for (int sub = 0; sub < kSubsteps; ++sub) {
    const float c = cosf(q.th), s = sinf(q.th);
    // joint k.body: this body the parent, the next lane's the child
    const float cth = from_next(q.th), cc = from_next(c),
                cs = from_next(s), cpx = from_next(q.px),
                cpz = from_next(q.pz), cvx = from_next(q.vx),
                cvz = from_next(q.vz), com = from_next(q.om);
    const float wax = c * k.ax - s * k.az;
    const float waz = s * k.ax + c * k.az;
    const float wbx = cc * k.bx - cs * k.bz;
    const float wbz = cs * k.bx + cc * k.bz;
    const float dx = (q.px + wax) - (cpx + wbx);
    const float dz = (q.pz + waz) - (cpz + wbz);
    const float pvx = q.vx + q.om * -waz, pvz = q.vz + q.om * wax;
    const float qvx = cvx + com * -wbz, qvz = cvz + com * wbx;
    const float fjx = kJointK * dx + kJointC * (pvx - qvx);
    const float fjz = kJointK * dz + kJointC * (pvz - qvz);
    const float rel = cth - q.th;
    const float tj = k.gain * a - kRotC * (com - q.om) -
                     kLimitK * (fmaxf(rel - k.hi, 0.0f) +
                                fminf(rel - -k.hi, 0.0f));
    const float tchild = wbx * fjz - wbz * fjx;
    // joint k.body - 1's force and torques on this body, its child
    const float ifx = from_prev(fjx), ifz = from_prev(fjz),
                itc = from_prev(tchild), itj = from_prev(tj);
    float fx = 0.0f, fz = k.weight, tau = 0.0f;
    if (child) {
      fx += ifx;
      fz += ifz;
      tau += itc;
      tau += itj;
    }
    if (parent) {
      fx += -fjx;
      fz += -fjz;
      tau += wax * -fjz - waz * -fjx;
      tau += -tj;
    }
    if (k.contacts > 0) contact(q, c, s, k.cx0, k.cz0, fx, fz, tau);
    if (k.contacts > 1) contact(q, c, s, k.cx1, k.cz1, fx, fz, tau);
    // semi-implicit Euler: velocities first, then positions from the new
    // velocities
    q.vx = q.vx + kDt * fx / k.mass;
    q.vz = q.vz + kDt * fz / k.mass;
    q.om = q.om + kDt * tau / k.inertia;
    q.px = q.px + kDt * q.vx;
    q.pz = q.pz + kDt * q.vz;
    q.th = q.th + kDt * q.om;
  }
}

// the lane's entries of the 11 observations: torso height, torso angle,
// the three relative joint angles, torso velocity, torso spin and the
// three relative joint spins. Every lane calls it (the shuffles take all
// four); only a live one stores.
__device__ __forceinline__ void write_obs(float* o, const Body& q, int b,
                                          bool live) {
  const float th_prev = from_prev(q.th), om_prev = from_prev(q.om);
  if (!live) return;
  if (b == 0) {
    o[0] = q.pz;
    o[1] = q.th;
    o[5] = q.vx;
    o[6] = q.vz;
    o[7] = q.om;
  } else {
    o[1 + b] = q.th - th_prev;
    o[7 + b] = q.om - om_prev;
  }
}

// Where a thread's env and body are. Threads past the last env keep to
// the shuffles on the last env's data and store nothing.
struct Where {
  int env, body;
  bool live;
};

__device__ __forceinline__ Where where(int num) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  Where w;
  w.body = g % kLanes;
  w.live = g / kLanes < num;
  w.env = w.live ? g / kLanes : num - 1;
  return w;
}

__device__ __forceinline__ Body load_body(const float* pos, const float* th,
                                          const float* vel, const float* om,
                                          int e, int b) {
  const int i = e * 4 + b;
  return {pos[2 * i], pos[2 * i + 1], th[i], vel[2 * i], vel[2 * i + 1],
          om[i]};
}

__device__ __forceinline__ void store_body(const Body& q, float* pos,
                                           float* th, float* vel, float* om,
                                           int e, int b) {
  const int i = e * 4 + b;
  pos[2 * i] = q.px;
  pos[2 * i + 1] = q.pz;
  th[i] = q.th;
  vel[2 * i] = q.vx;
  vel[2 * i + 1] = q.vz;
  om[i] = q.om;
}

// the clipped action of joint b (0 on the foot's lane)
__device__ __forceinline__ float load_action(const float* action, int e,
                                             int b) {
  return b < 3 ? fminf(fmaxf(action[e * 3 + b], -1.0f), 1.0f) : 0.0f;
}

// The step's reward (forward progress of the torso, an alive bonus, an
// action cost) and termination (the torso fallen or tipped), on every lane
// of the group.
__device__ __forceinline__ void reward_and_termination(const Body& q,
                                                       float x0, float a,
                                                       float& reward,
                                                       bool& terminated) {
  const float sq = a * a;
  const float sq0 = from_lane(sq, 0), sq1 = from_lane(sq, 1),
              sq2 = from_lane(sq, 2);
  const float px0 = from_lane(q.px, 0), pz0 = from_lane(q.pz, 0),
              th0 = from_lane(q.th, 0);
  reward = (px0 - x0) * kInvControlDt + 1.0f - 1e-3f * (sq0 + sq1 + sq2);
  terminated = pz0 < kZMin || fabsf(th0) > kThMax;
}

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
  const Where w = where(num);
  const Lane k = lane_tables(w.body);
  Body q = load_body(pos_in, th_in, vel_in, om_in, w.env, w.body);
  const float a = load_action(action, w.env, w.body);
  const float x0 = from_lane(q.px, 0);
  control_step(q, a, k);
  float r;
  bool term;
  reward_and_termination(q, x0, a, r, term);
  write_obs(obs + w.env * 11, q, w.body, w.live);
  if (!w.live) return;
  store_body(q, pos_out, th_out, vel_out, om_out, w.env, w.body);
  if (w.body == 0) {
    reward[w.env] = r;
    terminated[w.env] = term;
  }
}

// the inputs and outputs of the vector env's step
struct VecArgs {
  const float *pos, *th, *vel, *om;
  const int* t;
  const float *action, *u_pos, *u_th;
  const float* episode_return;
  const int *episode_length, *completed_episodes;
  const float* completed_return_sum;
  const int* completed_length_sum;
  const float* last_episode_return;
  float *pos_out, *th_out, *vel_out, *om_out;
  int* t_out;
  float *obs, *terminal_obs, *reward;
  uint8_t *done, *truncated;
  float *done_f, *truncated_f;
  float* episode_return_out;
  int *episode_length_out, *completed_episodes_out;
  float* completed_return_sum_out;
  int* completed_length_sum_out;
  float* last_episode_return_out;
};

__global__ void __launch_bounds__(kThreads)
    hopper2d_vec_step_kernel(const VecArgs g, int num, int episode_length) {
  const Where w = where(num);
  const int e = w.env, b = w.body;
  const Lane k = lane_tables(b);
  Body q = load_body(g.pos, g.th, g.vel, g.om, e, b);
  const float a = load_action(g.action, e, b);
  const int t = g.t[e] + 1;
  const float ux = g.u_pos[(e * 4 + b) * 2], uz = g.u_pos[(e * 4 + b) * 2 + 1];
  const float uth = g.u_th[e * 4 + b];
  const float x0 = from_lane(q.px, 0);
  control_step(q, a, k);
  float r;
  bool term;
  reward_and_termination(q, x0, a, r, term);
  // the time limit truncates an episode that did not terminate; either
  // ends it, and a finished env restarts at the rest pose moved by its
  // draws, at rest, at t = 0
  const bool trunc = !term && t >= episode_length;
  const bool done = term || trunc;
  write_obs(g.terminal_obs + e * 11, q, b, w.live);
  if (done) {
    q = {k.rest_x + (kResetLo + kResetSpan * ux),
         k.rest_z + (kResetLo + kResetSpan * uz), kResetLo + kResetSpan * uth,
         0.0f, 0.0f, 0.0f};
  }
  write_obs(g.obs + e * 11, q, b, w.live);
  if (!w.live) return;
  store_body(q, g.pos_out, g.th_out, g.vel_out, g.om_out, e, b);
  if (b != 0) return;
  g.t_out[e] = done ? 0 : t;
  g.reward[e] = r;
  g.done[e] = done;
  g.truncated[e] = trunc;
  g.done_f[e] = done && !trunc ? 1.0f : 0.0f;
  g.truncated_f[e] = trunc ? 1.0f : 0.0f;
  // episode accounting: the running return and length, and the finished
  // episodes' count, return and length sums and last return
  const float ret = g.episode_return[e] + r;
  const int len = g.episode_length[e] + 1;
  g.episode_return_out[e] = done ? 0.0f : ret;
  g.episode_length_out[e] = done ? 0 : len;
  g.completed_episodes_out[e] = g.completed_episodes[e] + (done ? 1 : 0);
  g.completed_return_sum_out[e] =
      g.completed_return_sum[e] + (done ? ret : 0.0f);
  g.completed_length_sum_out[e] =
      g.completed_length_sum[e] + (done ? len : 0);
  g.last_episode_return_out[e] = done ? ret : g.last_episode_return[e];
}

int blocks_for(int num) {
  return (num * kLanes + kThreads - 1) / kThreads;
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
  if (num < 0 || num > (1 << 28)) return cudaErrorInvalidValue;
  if (num == 0) return cudaSuccess;
  hopper2d_step_kernel<<<blocks_for(num), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pos, th, vel, om, action, pos_out, th_out, vel_out, om_out, obs,
      reward, terminated, num);
  return cudaGetLastError();
}

// The vector env's whole step; `ptrs` holds VecArgs' 32 pointers in its
// order (the wrapper's). Launches on `stream`, returns cudaGetLastError().
extern "C" int hopper2d_vec_step_f32(void* const* ptrs, int num,
                                     int episode_length, void* stream) {
  if (num < 0 || num > (1 << 28)) return cudaErrorInvalidValue;
  if (num == 0) return cudaSuccess;
  VecArgs g;
  static_assert(sizeof(VecArgs) == 32 * sizeof(void*), "VecArgs' layout");
  memcpy(&g, ptrs, sizeof(VecArgs));
  hopper2d_vec_step_kernel<<<blocks_for(num), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      g, num, episode_length);
  return cudaGetLastError();
}

// A kernel's registers a thread, its threads a block, its threads an env
// and the blocks of it an SM can hold at once (the occupancy the launch
// can reach); `vec` picks the vector step's kernel.
extern "C" int hopper2d_kernel_info(int vec, int* regs, int* threads,
                                    int* threads_per_env,
                                    int* blocks_per_sm) {
  const void* fn = vec ? reinterpret_cast<const void*>(
                             hopper2d_vec_step_kernel)
                       : reinterpret_cast<const void*>(hopper2d_step_kernel);
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, fn);
  if (rc != cudaSuccess) return rc;
  *regs = attr.numRegs;
  *threads = kThreads;
  *threads_per_env = kLanes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, 0);
}

extern "C" const char* hopper2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
