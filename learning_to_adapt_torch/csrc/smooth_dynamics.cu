// Smooth dynamics of a batch of articulated bodies, for Hopper: one launch
// a dynamics pass, and one for the env's forward pass.
//
// Replaces no TPU kernel: the JAX package leaves this phase to XLA, which
// fuses it. In the port it was tensor code, physics/engine.py
// smooth_dynamics (forward kinematics, mass properties, body velocities,
// RNE bias forces, the CRBA mass matrix, passive, actuator and applied
// forces) and engine.forward (forward kinematics and the subtree COM
// quantities): a Python loop over bodies and joints whose every quaternion
// product, rotation and cross product is a launch of its own: on an H100
// 1,096 small ATen kernels a dynamics pass and 1,064 a forward pass on the
// Ant, 800 and 762 on HalfCheetah. That tensor code stays as the plain
// version, for CPU tensors.
//
// What bounds it on an H100: neither bytes nor operations. At 5 Ants a
// launch reads ~3 KB of state and ~6 KB of model table, writes ~13 KB and
// does ~0.1 MFLOP. The floor is latency: one launch, and the chain of
// dependent phases inside it, the tree's depth (4 levels on the Ant and on
// HalfCheetah) plus six more, each a barrier and a few hundred dependent
// flops a thread. Measured on an H100 (80GB HBM3, 700 W): ~12 us of device
// time a dynamics pass at 5 Ants or 10 HalfCheetahs, ~13 us at 512
// HalfCheetahs, against ~5 us for an empty launch timed the same way.
//
// What the design does about it: one block an env holds the env's whole
// state in shared memory, from the first body frame to the last output, so
// nothing goes back to device memory between phases. Each phase runs in
// parallel over the bodies, dofs or matrix entries it touches, separated by
// __syncthreads(); outputs are written as they are final. The model enters
// only through its table (Table below, built once per model, device and
// dtype by ops/smooth_dynamics.py): parents, the bodies of each tree level,
// the joints of each body, the dof and subtree masks as bit sets, gravity,
// springs and actuators. So one kernel serves every tree up to kMax bodies
// and dofs. The formulas are the tensor code's, term for term, in full
// precision (sin, cos and sqrt, no fast-math); only the order of the sums
// differs, and the compiler's fused multiply-adds.
//
// kForward: engine.forward's variant, which stops after the body
// velocities and computes subtree_com and subtree_comvel.
#include <cuda_runtime.h>

namespace {

constexpr int kMax = 32;      // bodies, dofs, joints, actuators, springs
constexpr int kThreads = 128;

enum { kFree = 0, kHinge = 1, kSlide = 2 };

// The model's constants (ops/smooth_dynamics.py _table_type mirrors it
// field by field). Joints are stored in body order: body b's joints are
// entries body_jadr[b] .. body_jadr[b] + body_jnum[b] - 1. The tree's
// levels below the world: level l holds the bodies level_body[
// level_start[l] .. level_start[l + 1] - 1], each parent in an earlier one.
template <typename T>
struct Table {
  int nbody, nv, nq, nu, nstiff, nlevel;
  int parent[kMax];
  int level_start[kMax + 1];
  int level_body[kMax];
  int body_jadr[kMax];
  int body_jnum[kMax];
  int jnt_type[kMax];
  int jnt_qadr[kMax];
  int jnt_dadr[kMax];
  unsigned body_dofs[kMax];     // bit k: dof k moves body b (body_dof)
  unsigned body_subtree[kMax];  // bit b: b in a's subtree (body_ancestor)
  unsigned dof_bodies[kMax];    // bit b: dof k moves body b
  unsigned dof_upper[kMax];     // bit i: M's entry (i, j) is kept, i <= j
  int dof_vsrc[kMax];
  int dof_body[kMax];
  int stiff_dadr[kMax];
  int stiff_qadr[kMax];
  int act_dadr[kMax];
  T body_pos[kMax][3];
  T body_quat[kMax][4];
  T body_ipos[kMax][3];
  T body_inertia[kMax][9];
  T jnt_axis[kMax][3];
  T jnt_pos[kMax][3];
  T jnt_ref[kMax];
  T armature[kMax];
  T a_grav[6];
  T stiff_k[kMax];
  T stiff_ref[kMax];
  T act_lo[kMax];
  T act_hi[kMax];
  T act_gear[kMax];
};

// Inputs, each (E, ...) with the env stride given in elements (0: one row
// shared by every env), and outputs, contiguous (E, ...). Outputs a
// variant does not produce are null.
template <typename T>
struct Args {
  const Table<T>* tab;
  const T* qpos;
  const T* qvel;
  const T* ctrl;            // null: no actuator force (forward's ctrl None)
  const T* body_mass;
  const T* dof_damping;
  const T* xfrc;
  long long qpos_s, qvel_s, ctrl_s, mass_s, damping_s, xfrc_s;
  T* xpos;
  T* xquat;
  T* ximat;
  T* xipos;
  T* body_vel;
  T* cdof;
  T* qfrc_actuator;
  T* mass_mat;
  T* qfrc_smooth;
  T* subtree_com;
  T* subtree_comvel;
};

template <typename T>
struct Shared {
  T xpos[kMax][3];
  T xquat[kMax][4];
  T xmat[kMax][9];
  T xipos[kMax][3];
  T cdof[kMax][6];
  T vel_dof[kMax][6];
  T body_vel[kMax][6];
  T vdot_dof[kMax][6];
  T f_bias[kMax][6];
  T f_ext[kMax][6];   // forward: mass * velocity of the body's COM
  T ispatial[kMax][36];
  T ic[kMax][36];
  T f_crb[kMax][6];
  T mass[kMax];
  T qvel[kMax];
};

__device__ __forceinline__ float sine(float x) { return sinf(x); }
__device__ __forceinline__ double sine(double x) { return sin(x); }
__device__ __forceinline__ float cosine(float x) { return cosf(x); }
__device__ __forceinline__ double cosine(double x) { return cos(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// c = a x b, as torch.linalg.cross
template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// out = q v q*, as maths.quat_rotate: v + w t + qv x t with t = 2 qv x v
template <typename T>
__device__ __forceinline__ void quat_rotate(const T* q, const T* v, T* out) {
  T c[3], t[3], u[3];
  cross(q + 1, v, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = T(2) * c[i];
  cross(q + 1, t, u);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * t[i] + u[i];
}

// out = a b, the Hamilton product (maths.quat_mul)
template <typename T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b, T* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// row-major 3x3 rotation of a unit quaternion (maths.quat_to_mat)
template <typename T>
__device__ __forceinline__ void quat_to_mat(const T* q, T* r) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  r[0] = 1 - 2 * (y * y + z * z);
  r[1] = 2 * (x * y - w * z);
  r[2] = 2 * (x * z + w * y);
  r[3] = 2 * (x * y + w * z);
  r[4] = 1 - 2 * (x * x + z * z);
  r[5] = 2 * (y * z - w * x);
  r[6] = 2 * (x * z - w * y);
  r[7] = 2 * (y * z + w * x);
  r[8] = 1 - 2 * (x * x + y * y);
}

// engine._fk for body b, its parent's frame final: the body's frame and
// the motion subspaces of its joints' dofs, joint after joint
template <typename T>
__device__ void fk_body(const Table<T>& t, Shared<T>& s, const T* qpos,
                        int b) {
  const int p = t.parent[b];
  T pos[3], quat[4], r[3];
  quat_rotate(s.xquat[p], t.body_pos[b], r);
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[i] = s.xpos[p][i] + r[i];
  quat_mul(s.xquat[p], t.body_quat[b], quat);
  for (int j = t.body_jadr[b]; j < t.body_jadr[b] + t.body_jnum[b]; ++j) {
    const int qa = t.jnt_qadr[j], da = t.jnt_dadr[j];
    if (t.jnt_type[j] == kFree) {
      const T* q = qpos + qa + 3;
      const T norm = root(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] +
                          q[3] * q[3]);
#pragma unroll
      for (int i = 0; i < 3; ++i) pos[i] = qpos[qa + i];
#pragma unroll
      for (int i = 0; i < 4; ++i) quat[i] = q[i] / norm;
      T m[9];
      quat_to_mat(quat, m);
#pragma unroll
      for (int k = 0; k < 3; ++k) {  // translational dofs, world axes
#pragma unroll
        for (int i = 0; i < 6; ++i) s.cdof[da + k][i] = T(i == 3 + k);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {  // rotational dofs, body-local axes
        T* c = s.cdof[da + 3 + k];
        c[0] = m[k];
        c[1] = m[3 + k];
        c[2] = m[6 + k];
        cross(pos, c, c + 3);
      }
    } else if (t.jnt_type[j] == kSlide) {
      T axis_w[3];
      quat_rotate(quat, t.jnt_axis[j], axis_w);
      const T d = qpos[qa] - t.jnt_ref[j];
      T* c = s.cdof[da];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pos[i] = pos[i] + axis_w[i] * d;
        c[i] = T(0);
        c[3 + i] = axis_w[i];
      }
    } else {  // kHinge
      const T* axis_l = t.jnt_axis[j];
      T axis_w[3], anchor[3], dq[4], turned[4];
      quat_rotate(quat, axis_l, axis_w);
      quat_rotate(quat, t.jnt_pos[j], r);
#pragma unroll
      for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + r[i];
      const T half = (qpos[qa] - t.jnt_ref[j]) * T(0.5);
      const T sn = sine(half);
      dq[0] = cosine(half);
#pragma unroll
      for (int i = 0; i < 3; ++i) dq[1 + i] = axis_l[i] * sn;
      quat_mul(quat, dq, turned);
#pragma unroll
      for (int i = 0; i < 4; ++i) quat[i] = turned[i];
      quat_rotate(quat, t.jnt_pos[j], r);
      T* c = s.cdof[da];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pos[i] = anchor[i] - r[i];
        c[i] = axis_w[i];
      }
      cross(anchor, axis_w, c + 3);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) s.xpos[b][i] = pos[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) s.xquat[b][i] = quat[i];
}

// ximat, xipos, and with kInertia the world inertia about the COM turned
// into the 6x6 spatial inertia about the origin (maths.spatial_inertia):
// [[Ic - m cx cx, m cx], [-m cx, m 1]]
template <typename T, bool kInertia>
__device__ void mass_properties(const Table<T>& t, Shared<T>& s, int b) {
  T* r = s.xmat[b];
  quat_to_mat(s.xquat[b], r);
  T* c = s.xipos[b];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c[i] = s.xpos[b][i] + (r[3 * i] * t.body_ipos[b][0] +
                           r[3 * i + 1] * t.body_ipos[b][1] +
                           r[3 * i + 2] * t.body_ipos[b][2]);
  }
  if (!kInertia) return;
  const T* in = t.body_inertia[b];
  T ri[9], w[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ri[3 * i + j] = r[3 * i] * in[j] + r[3 * i + 1] * in[3 + j] +
                      r[3 * i + 2] * in[6 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[3 * i + j] = ri[3 * i] * r[3 * j] + ri[3 * i + 1] * r[3 * j + 1] +
                     ri[3 * i + 2] * r[3 * j + 2];
    }
  }
  const T m = s.mass[b];
  const T cx[9] = {T(0), -c[2], c[1], c[2], T(0), -c[0], -c[1], c[0], T(0)};
  T* is = s.ispatial[b];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T cc = cx[3 * i] * cx[j] + cx[3 * i + 1] * cx[3 + j] +
                   cx[3 * i + 2] * cx[6 + j];
      is[6 * i + j] = w[3 * i + j] - m * cc;
      is[6 * i + 3 + j] = m * cx[3 * i + j];
      is[6 * (3 + i) + j] = -(m * cx[3 * i + j]);
      is[6 * (3 + i) + 3 + j] = m * T(i == j);
    }
  }
}

// y = A x for a row-major 6x6 A
template <typename T>
__device__ __forceinline__ void mat6_vec(const T* a, const T* x, T* y) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += a[6 * i + j] * x[j];
    y[i] = acc;
  }
}

template <typename T>
__device__ __forceinline__ T dot6(const T* a, const T* b) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < 6; ++i) acc += a[i] * b[i];
  return acc;
}

// clamp(ctrl, lo, hi) * gear summed onto each actuated dof, from 0
// (engine._actuator_force); a NaN control stays NaN, as in torch.clamp
template <typename T>
__device__ __forceinline__ T actuator_force(const Table<T>& t, const T* ctrl,
                                            int k) {
  T f = T(0);
  if (ctrl == nullptr) return f;
  for (int a = 0; a < t.nu; ++a) {
    if (t.act_dadr[a] != k) continue;
    T u = ctrl[a] < t.act_lo[a] ? t.act_lo[a] : ctrl[a];
    u = u > t.act_hi[a] ? t.act_hi[a] : u;
    f = f + u * t.act_gear[a];
  }
  return f;
}

template <typename T, bool kForward>
__global__ void __launch_bounds__(kThreads)
    smooth_dynamics_kernel(const Args<T> a) {
  __shared__ Shared<T> s;
  const Table<T>& t = *a.tab;
  const int e = blockIdx.x, tid = threadIdx.x;
  const int nb = t.nbody, nv = t.nv;
  const T* qpos = a.qpos + e * a.qpos_s;
  const T* ctrl = a.ctrl == nullptr ? nullptr : a.ctrl + e * a.ctrl_s;

  for (int i = tid; i < nb + nv; i += kThreads) {
    if (i < nb) {
      s.mass[i] = a.body_mass[e * a.mass_s + i];
    } else {
      s.qvel[i - nb] = a.qvel[e * a.qvel_s + i - nb];
    }
  }
  if (tid == 0) {  // the world
#pragma unroll
    for (int i = 0; i < 3; ++i) s.xpos[0][i] = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) s.xquat[0][i] = T(i == 0);
  }
  __syncthreads();

  // forward kinematics, one tree level after the other
  for (int l = 0; l < t.nlevel; ++l) {
    for (int i = t.level_start[l] + tid; i < t.level_start[l + 1];
         i += kThreads) {
      fk_body(t, s, qpos, t.level_body[i]);
    }
    __syncthreads();
  }

  // mass properties of every body (world included); each dof's velocity
  for (int i = tid; i < nb + nv; i += kThreads) {
    if (i < nb) {
      mass_properties<T, !kForward>(t, s, i);
      T* out = a.xpos + (e * nb + i) * 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) out[j] = s.xpos[i][j];
      out = a.xquat + (e * nb + i) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] = s.xquat[i][j];
      out = a.ximat + (e * nb + i) * 9;
#pragma unroll
      for (int j = 0; j < 9; ++j) out[j] = s.xmat[i][j];
      if (!kForward) {
        out = a.xipos + (e * nb + i) * 3;
#pragma unroll
        for (int j = 0; j < 3; ++j) out[j] = s.xipos[i][j];
        // external wrench at the COM: (torque + xipos x force, force)
        const T* x = a.xfrc + e * a.xfrc_s + i * 6;
        T* f = s.f_ext[i];
        cross(s.xipos[i], x, f);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          f[j] = x[3 + j] + f[j];
          f[3 + j] = x[j];
        }
      }
    } else {
      const int k = i - nb;
#pragma unroll
      for (int j = 0; j < 6; ++j) s.vel_dof[k][j] = s.cdof[k][j] * s.qvel[k];
      if (!kForward) {
        T* out = a.cdof + (e * nv + k) * 6;
#pragma unroll
        for (int j = 0; j < 6; ++j) out[j] = s.cdof[k][j];
      }
    }
  }
  __syncthreads();

  // body velocities; composite inertias, each the sum over the subtree
  const int n_ic = kForward ? 0 : nb * 36;
  for (int i = tid; i < nb + n_ic; i += kThreads) {
    if (i < nb) {
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (unsigned m = t.body_dofs[i]; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] += s.vel_dof[k][j];
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) s.body_vel[i][j] = v[j];
      if (kForward) {  // mass times the velocity of the body's COM
        T w[3];
        cross(v, s.xipos[i], w);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          s.f_ext[i][j] = s.mass[i] * (v[3 + j] + w[j]);
        }
      } else {
        T* out = a.body_vel + (e * nb + i) * 6;
#pragma unroll
        for (int j = 0; j < 6; ++j) out[j] = v[j];
      }
    } else {
      const int b = (i - nb) / 36, ent = (i - nb) % 36;
      T acc = T(0);
      for (unsigned m = t.body_subtree[b]; m; m &= m - 1) {
        acc += s.ispatial[__ffs(m) - 1][ent];
      }
      s.ic[b][ent] = acc;
    }
  }
  __syncthreads();

  if (kForward) {
    // subtree masses, COMs and COM velocities; the actuator force
    for (int i = tid; i < nb + nv; i += kThreads) {
      if (i < nb) {
        T mass = T(0), com[3] = {T(0), T(0), T(0)};
        T vel[3] = {T(0), T(0), T(0)};
        for (unsigned m = t.body_subtree[i]; m; m &= m - 1) {
          const int b = __ffs(m) - 1;
          mass += s.mass[b];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            com[j] += s.mass[b] * s.xipos[b][j];
            vel[j] += s.f_ext[b][j];
          }
        }
        const T safe = mass < T(1e-10) ? T(1e-10) : mass;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          a.subtree_com[(e * nb + i) * 3 + j] = com[j] / safe;
          a.subtree_comvel[(e * nb + i) * 3 + j] = vel[j] / safe;
        }
      } else {
        const int k = i - nb;
        a.qfrc_actuator[e * nv + k] = actuator_force(t, ctrl, k);
      }
    }
    return;
  }

  // bias accelerations of the dofs: d(cdof)/dt = v x cdof, v the velocity
  // of the body the axis is fixed in; each dof's composite-inertia force
  for (int k = tid; k < nv; k += kThreads) {
    const T* v = s.body_vel[t.dof_vsrc[k]];
    const T* u = s.vel_dof[k];
    T c[3], d[3];
    cross(v, u, s.vdot_dof[k]);
    cross(v, u + 3, c);
    cross(v + 3, u, d);
#pragma unroll
    for (int j = 0; j < 3; ++j) s.vdot_dof[k][3 + j] = c[j] + d[j];
    mat6_vec(s.ic[t.dof_body[k]], s.cdof[k], s.f_crb[k]);
  }
  __syncthreads();

  // RNE bias force of each body; CRBA: the mass matrix's entries
  for (int i = tid; i < nb + nv * nv; i += kThreads) {
    if (i < nb) {
      T acc[6], iv[6], fa[6], c[3], d[3];
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[j] = T(0);
      for (unsigned m = t.body_dofs[i]; m; m &= m - 1) {
        const int k = __ffs(m) - 1;
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[j] += s.vdot_dof[k][j];
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[j] = acc[j] + t.a_grav[j];
      const T* v = s.body_vel[i];
      mat6_vec(s.ispatial[i], v, iv);
      mat6_vec(s.ispatial[i], acc, fa);
      // + v x* (I v): (w x iv_t + v0 x iv_f, w x iv_f)
      cross(v, iv, c);
      cross(v + 3, iv + 3, d);
#pragma unroll
      for (int j = 0; j < 3; ++j) s.f_bias[i][j] = fa[j] + (c[j] + d[j]);
      cross(v, iv + 3, c);
#pragma unroll
      for (int j = 0; j < 3; ++j) s.f_bias[i][3 + j] = fa[3 + j] + c[j];
    } else {
      const int r = (i - nb) / nv, col = (i - nb) % nv;
      const int lo = r < col ? r : col, hi = r < col ? col : r;
      T m = T(0);
      if ((t.dof_upper[hi] >> lo) & 1u) m = dot6(s.cdof[lo], s.f_crb[hi]);
      if (r == col) m = m + t.armature[r];
      a.mass_mat[(e * nv + r) * nv + col] = m;
    }
  }
  __syncthreads();

  // generalized forces: actuator + passive + applied - bias
  for (int k = tid; k < nv; k += kThreads) {
    T bias = T(0), applied = T(0);
    for (unsigned m = t.dof_bodies[k]; m; m &= m - 1) {
      const int b = __ffs(m) - 1;
      bias += dot6(s.f_bias[b], s.cdof[k]);
      applied += dot6(s.f_ext[b], s.cdof[k]);
    }
    T passive = -a.dof_damping[e * a.damping_s + k] * s.qvel[k];
    for (int j = 0; j < t.nstiff; ++j) {
      if (t.stiff_dadr[j] == k) {
        passive = passive + -t.stiff_k[j] * (qpos[t.stiff_qadr[j]] -
                                             t.stiff_ref[j]);
      }
    }
    const T act = actuator_force(t, ctrl, k);
    a.qfrc_actuator[e * nv + k] = act;
    a.qfrc_smooth[e * nv + k] = act + passive + applied - bias;
  }
}

template <typename T>
int launch(const void* table, int forward, int n_envs, const Args<T>& args,
           cudaStream_t stream) {
  Args<T> a = args;
  a.tab = static_cast<const Table<T>*>(table);
  if (forward) {
    smooth_dynamics_kernel<T, true><<<n_envs, kThreads, 0, stream>>>(a);
  } else {
    smooth_dynamics_kernel<T, false><<<n_envs, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> args(const void* qpos, const void* qvel, const void* ctrl,
             const void* body_mass, const void* dof_damping,
             const void* xfrc, const long long* strides, void* const* out) {
  Args<T> a;
  a.tab = nullptr;
  a.qpos = static_cast<const T*>(qpos);
  a.qvel = static_cast<const T*>(qvel);
  a.ctrl = static_cast<const T*>(ctrl);
  a.body_mass = static_cast<const T*>(body_mass);
  a.dof_damping = static_cast<const T*>(dof_damping);
  a.xfrc = static_cast<const T*>(xfrc);
  a.qpos_s = strides[0];
  a.qvel_s = strides[1];
  a.ctrl_s = strides[2];
  a.mass_s = strides[3];
  a.damping_s = strides[4];
  a.xfrc_s = strides[5];
  T** outs[] = {&a.xpos, &a.xquat, &a.ximat, &a.xipos, &a.body_vel,
                &a.cdof, &a.qfrc_actuator, &a.mass_mat, &a.qfrc_smooth,
                &a.subtree_com, &a.subtree_comvel};
  for (int i = 0; i < 11; ++i) *outs[i] = static_cast<T*>(out[i]);
  return a;
}

}  // namespace

extern "C" {

// sizeof the model table for a scalar of `scalar_bytes` (4 or 8) bytes,
// which the wrapper holds its own layout to; 0 for another size
int smooth_table_bytes(int scalar_bytes) {
  if (scalar_bytes == 4) return static_cast<int>(sizeof(Table<float>));
  if (scalar_bytes == 8) return static_cast<int>(sizeof(Table<double>));
  return 0;
}

// One launch over n_envs >= 1 envs, one block each. table: the model's
// Table<T> on the device; the six inputs with their env strides
// (`strides`, elements; ctrl may be null); `out` the 11 outputs in the
// order of Args (xpos .. subtree_comvel), null where the variant writes
// none: the dynamics pass writes the first nine, forward (1) xpos, xquat,
// ximat, qfrc_actuator and the subtree pair. scalar_bytes 4 (float) or 8
// (double). Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for another scalar size.
int smooth_dynamics(const void* table, int scalar_bytes, int forward,
                    int n_envs, const void* qpos, const void* qvel,
                    const void* ctrl, const void* body_mass,
                    const void* dof_damping, const void* xfrc,
                    const long long* strides, void* const* out,
                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (scalar_bytes == 4) {
    return launch<float>(table, forward, n_envs,
                         args<float>(qpos, qvel, ctrl, body_mass,
                                     dof_damping, xfrc, strides, out), s);
  }
  if (scalar_bytes == 8) {
    return launch<double>(table, forward, n_envs,
                          args<double>(qpos, qvel, ctrl, body_mass,
                                       dof_damping, xfrc, strides, out), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
