// Copy of native/ltao_physics.cc at commit 0fd707d, kept as the benchmark's
// plain reference for the physics: an implementation in f64 C++ written
// apart from the port's engine (it mirrors the JAX package's), so a fault
// in the port's kinematics, contacts, constraint solve or integrator does
// not recur here. Changed from the original: `ltao_set_rounding` rounds the
// operands of the dense products (mass matrix, constraint rows, A = J M^-1
// J^T and its Jacobi sweeps, J^T f) to a narrower mantissa, which makes the
// lower-precision control; and `ltao_smooth0` exports the mass matrix and
// the motion subspace at a pose, from which the binding (reference/
// oracle.py) works out the compile-time constraint weights.
//
// Native (C++) CPU physics oracle for learning_to_adapt_tpu.
//
// A float64 host-side mirror of the JAX engine
// (learning_to_adapt_tpu/physics/engine.py). The TPU compute path is XLA —
// on TPU, compiled JAX *is* the native layer — but the framework keeps this
// independent C++ implementation of the same articulated-body pipeline as
//   (a) a numerical oracle: tests/test_native_oracle.py checks the jitted
//       engine against it step-for-step in float64, the role MuJoCo's closed
//       C library (libmujoco131.so, reference mujoco_py/mjlib.py:8-17)
//       played for the reference implementation, and
//   (b) a fast single-env stepper for host-side replay
//       (experiment_utils/sim_policy.py) with zero JIT latency.
//
// Pipeline per step (identical, op for op, to engine.py):
//   1. forward kinematics -> body frames, per-dof world motion subspace cdof
//   2. body spatial velocities, RNE bias forces, CRBA mass matrix
//   3. narrow-phase collisions over the static candidate-pair list
//   4. soft-constraint assembly (contacts + joint limits, MuJoCo
//      solref/solimp impedance) and projected Jacobi / Gauss-Seidel
//   5. semi-implicit Euler with implicit joint damping, or RK4
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -o libltao_physics.so ltao_physics.cc
// The benchmark's ctypes binding is port_bench/reference/oracle.py.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

using std::vector;

// mantissa bits kept in the operands of the dense products; 0 keeps f64
int g_round_bits = 0;

inline double rnd(double x) {
  if (g_round_bits == 0 || x == 0.0 || !std::isfinite(x)) return x;
  int e;
  double m = std::frexp(x, &e);
  double s = std::ldexp(1.0, g_round_bits + 1);
  return std::ldexp(std::nearbyint(m * s) / s, e);
}

inline double pr(double a, double b) { return rnd(a) * rnd(b); }

// ---------------------------------------------------------------------------
// small dense linear algebra (nv <= ~30, nrows <= ~100: plain loops suffice)
// ---------------------------------------------------------------------------

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
  double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct Mat3 {
  double m[3][3] = {{0}};
  Vec3 col(int k) const { return {m[0][k], m[1][k], m[2][k]}; }
  Vec3 mul(const Vec3& v) const {
    return {m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
            m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
            m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z};
  }
  Vec3 tmul(const Vec3& v) const {  // transpose * v
    return {m[0][0] * v.x + m[1][0] * v.y + m[2][0] * v.z,
            m[0][1] * v.x + m[1][1] * v.y + m[2][1] * v.z,
            m[0][2] * v.x + m[1][2] * v.y + m[2][2] * v.z};
  }
  Mat3 mul(const Mat3& o) const {
    Mat3 r;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        for (int k = 0; k < 3; k++) r.m[i][j] += m[i][k] * o.m[k][j];
    return r;
  }
  Mat3 mulT(const Mat3& o) const {  // this * o^T
    Mat3 r;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        for (int k = 0; k < 3; k++) r.m[i][j] += m[i][k] * o.m[j][k];
    return r;
  }
};

struct Quat {
  double w = 1, x = 0, y = 0, z = 0;
  Quat() = default;
  Quat(double a, double b, double c, double d) : w(a), x(b), y(c), z(d) {}
  Quat mul(const Quat& b) const {
    return {w * b.w - x * b.x - y * b.y - z * b.z,
            w * b.x + x * b.w + y * b.z - z * b.y,
            w * b.y - x * b.z + y * b.w + z * b.x,
            w * b.z + x * b.y - y * b.x + z * b.w};
  }
  Quat normalized() const {
    double n = std::sqrt(w * w + x * x + y * y + z * z);
    return {w / n, x / n, y / n, z / n};
  }
  Vec3 rotate(const Vec3& v) const {
    Vec3 qv{x, y, z};
    Vec3 t = qv.cross(v) * 2.0;
    return v + t * w + qv.cross(t);
  }
  Mat3 toMat() const {
    Mat3 r;
    r.m[0][0] = 1 - 2 * (y * y + z * z);
    r.m[0][1] = 2 * (x * y - w * z);
    r.m[0][2] = 2 * (x * z + w * y);
    r.m[1][0] = 2 * (x * y + w * z);
    r.m[1][1] = 1 - 2 * (x * x + z * z);
    r.m[1][2] = 2 * (y * z - w * x);
    r.m[2][0] = 2 * (x * z - w * y);
    r.m[2][1] = 2 * (y * z + w * x);
    r.m[2][2] = 1 - 2 * (x * x + y * y);
    return r;
  }
};

Quat axis_angle_quat(const Vec3& axis, double angle) {
  double s = std::sin(0.5 * angle);
  return {std::cos(0.5 * angle), axis.x * s, axis.y * s, axis.z * s};
}

// integrate orientation with body-frame angular velocity (maths.py
// quat_integrate)
Quat quat_integrate(const Quat& q, const Vec3& omega_local, double dt) {
  double angle = omega_local.norm();
  Vec3 axis = omega_local * (1.0 / (angle > 1e-12 ? angle : 1.0));
  Quat dq = axis_angle_quat(axis, angle * dt);
  return q.mul(dq).normalized();
}

// spatial motion vector (angular, linear-at-origin); force (torque, force)
struct Spatial {
  Vec3 a, l;
  Spatial operator+(const Spatial& o) const { return {a + o.a, l + o.l}; }
  Spatial operator*(double s) const { return {a * s, l * s}; }
  double dot(const Spatial& o) const { return a.dot(o.a) + l.dot(o.l); }
  double dot_r(const Spatial& o) const {
    return pr(a.x, o.a.x) + pr(a.y, o.a.y) + pr(a.z, o.a.z) +
           pr(l.x, o.l.x) + pr(l.y, o.l.y) + pr(l.z, o.l.z);
  }
};

Spatial motion_cross(const Spatial& v, const Spatial& m) {
  return {v.a.cross(m.a), v.a.cross(m.l) + v.l.cross(m.a)};
}
Spatial motion_cross_force(const Spatial& v, const Spatial& f) {
  return {v.a.cross(f.a) + v.l.cross(f.l), v.a.cross(f.l)};
}

// 6x6 world-origin spatial inertia: [[Ic - m cx cx, m cx], [-m cx, m I]]
struct SpatialInertia {
  double I[6][6] = {{0}};
  static SpatialInertia make(double mass, const Vec3& com, const Mat3& ic) {
    SpatialInertia s;
    double cx[3][3] = {{0, -com.z, com.y}, {com.z, 0, -com.x},
                       {-com.y, com.x, 0}};
    double cxcx[3][3] = {{0}};
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        for (int k = 0; k < 3; k++) cxcx[i][j] += cx[i][k] * cx[k][j];
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        s.I[i][j] = ic.m[i][j] - mass * cxcx[i][j];
        s.I[i][j + 3] = mass * cx[i][j];
        s.I[i + 3][j] = -mass * cx[i][j];
        s.I[i + 3][j + 3] = (i == j) ? mass : 0.0;
      }
    return s;
  }
  Spatial mul(const Spatial& m) const {
    double in[6] = {m.a.x, m.a.y, m.a.z, m.l.x, m.l.y, m.l.z};
    double out[6] = {0};
    for (int i = 0; i < 6; i++)
      for (int j = 0; j < 6; j++) out[i] += I[i][j] * in[j];
    return {{out[0], out[1], out[2]}, {out[3], out[4], out[5]}};
  }
  void add(const SpatialInertia& o) {
    for (int i = 0; i < 6; i++)
      for (int j = 0; j < 6; j++) I[i][j] += o.I[i][j];
  }
};

// dense Cholesky A = L L^T (lower) + triangular solves
struct Chol {
  int n;
  vector<double> L;  // row-major
  Chol(const vector<double>& A, int n_) : n(n_), L(A) {
    for (int j = 0; j < n; j++) {
      double d = L[j * n + j];
      for (int k = 0; k < j; k++) d -= L[j * n + k] * L[j * n + k];
      d = std::sqrt(std::max(d, 1e-300));
      L[j * n + j] = d;
      for (int i = j + 1; i < n; i++) {
        double s = L[i * n + j];
        for (int k = 0; k < j; k++) s -= L[i * n + k] * L[j * n + k];
        L[i * n + j] = s / d;
      }
    }
  }
  void solve(const double* b, double* x) const {
    vector<double> y(n);
    for (int i = 0; i < n; i++) {
      double s = b[i];
      for (int k = 0; k < i; k++) s -= L[i * n + k] * y[k];
      y[i] = s / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; i--) {
      double s = y[i];
      for (int k = i + 1; k < n; k++) s -= L[k * n + i] * x[k];
      x[i] = s / L[i * n + i];
    }
  }
};

// ---------------------------------------------------------------------------
// model
// ---------------------------------------------------------------------------

enum JointType { FREE = 0, HINGE = 1, SLIDE = 2 };
enum Integrator { EULER = 0, RK4 = 1 };
// pair kinds; codes fixed by the Python binding (oracle.py KIND_CODES)
enum PairKind {
  PLANE_SPHERE = 0, PLANE_CAPSULE = 1, HFIELD_SPHERE = 2, HFIELD_CAPSULE = 3,
  SPHERE_SPHERE = 4, SPHERE_CAPSULE = 5, CAPSULE_CAPSULE = 6,
  CAPSULE_BOX = 7, SPHERE_BOX = 8, BOX_BOX = 9,
};

struct Model {
  // every field arrives as an f64 array via ltao_model_set; integers are
  // round-tripped through double (exact below 2^53)
  std::map<std::string, vector<double>> f;

  int nq = 0, nv = 0, nu = 0, nbody = 0, ngeom = 0, njnt = 0, npair = 0;
  double timestep = 0.01;
  int integrator = EULER, iterations = 30, solver = 0;  // 0 jacobi, 1 pgs
  Vec3 gravity;

  const vector<double>& a(const std::string& k) const { return f.at(k); }
  int gi(const std::string& k, int i) const { return (int)f.at(k)[i]; }

  int finalize() {
    const char* req[] = {"nq", "nv", "nu", "nbody", "ngeom", "njnt",
                         "timestep", "integrator", "iterations", "solver",
                         "gravity", "body_parent", "body_pos", "body_quat",
                         "body_ipos", "body_inertia", "jnt_type", "jnt_body",
                         "jnt_pos", "jnt_axis", "jnt_range", "jnt_limited",
                         "jnt_stiffness", "jnt_springref", "jnt_ref",
                         "jnt_solref_limit", "jnt_solimp_limit",
                         "jnt_qposadr", "jnt_dofadr", "dof_body", "dof_vsrc",
                         "dof_armature", "geom_body", "geom_quat",
                         "geom_friction", "geom_margin", "geom_solref",
                         "geom_solimp", "geom_condim", "act_dofadr",
                         "act_gear", "act_ctrlrange", "body_ancestor",
                         "dof_ancestor", "body_dof", "dof_invweight0",
                         "body_invweight0"};
    for (const char* k : req)
      if (!f.count(k)) return -1;
    nq = gi("nq", 0);
    nv = gi("nv", 0);
    nu = gi("nu", 0);
    nbody = gi("nbody", 0);
    ngeom = gi("ngeom", 0);
    njnt = gi("njnt", 0);
    npair = f.count("pair_kind") ? (int)f["pair_kind"].size() : 0;
    timestep = f["timestep"][0];
    integrator = gi("integrator", 0);
    iterations = gi("iterations", 0);
    solver = gi("solver", 0);
    gravity = {f["gravity"][0], f["gravity"][1], f["gravity"][2]};
    return 0;
  }
};

// runtime-mutable fields (spec.py MutableModel), passed per call
struct Mutable {
  const double* body_mass;
  const double* dof_damping;
  const double* geom_size;  // (ngeom,3)
  const double* geom_pos;   // (ngeom,3)
  const double* xfrc;       // (nbody,6) world force,torque at body COM
  const double* hf_size;    // (4,)
  const double* hf_row;     // (hf_ncol,)
  long hf_ncol;
};

// ---------------------------------------------------------------------------
// forward kinematics (engine.py _fk)
// ---------------------------------------------------------------------------

struct FK {
  vector<Vec3> xpos;
  vector<Quat> xquat;
  vector<Mat3> ximat;
  vector<Spatial> cdof;  // (nv)
};

FK fk(const Model& m, const double* qpos) {
  FK out;
  out.xpos.assign(m.nbody, Vec3());
  out.xquat.assign(m.nbody, Quat());
  out.cdof.assign(m.nv, Spatial());

  vector<vector<int>> body_joints(m.nbody);
  for (int ji = 0; ji < m.njnt; ji++)
    body_joints[m.gi("jnt_body", ji)].push_back(ji);

  for (int b = 1; b < m.nbody; b++) {
    int p = m.gi("body_parent", b);
    Vec3 bp{m.a("body_pos")[b * 3], m.a("body_pos")[b * 3 + 1],
            m.a("body_pos")[b * 3 + 2]};
    Quat bq{m.a("body_quat")[b * 4], m.a("body_quat")[b * 4 + 1],
            m.a("body_quat")[b * 4 + 2], m.a("body_quat")[b * 4 + 3]};
    Vec3 pos = out.xpos[p] + out.xquat[p].rotate(bp);
    Quat quat = out.xquat[p].mul(bq);
    for (int ji : body_joints[b]) {
      int jt = m.gi("jnt_type", ji);
      int qadr = m.gi("jnt_qposadr", ji);
      int dadr = m.gi("jnt_dofadr", ji);
      if (jt == FREE) {
        pos = {qpos[qadr], qpos[qadr + 1], qpos[qadr + 2]};
        quat = Quat{qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5],
                    qpos[qadr + 6]}.normalized();
        Mat3 r = quat.toMat();
        for (int k = 0; k < 3; k++) {  // translational dofs, world axes
          Vec3 e(k == 0 ? 1.0 : 0.0, k == 1 ? 1.0 : 0.0, k == 2 ? 1.0 : 0.0);
          out.cdof[dadr + k] = {Vec3(), e};
        }
        for (int k = 0; k < 3; k++) {  // rotational dofs, body-local axes
          Vec3 axw = r.col(k);
          out.cdof[dadr + 3 + k] = {axw, pos.cross(axw)};
        }
      } else if (jt == SLIDE) {
        Vec3 axl{m.a("jnt_axis")[ji * 3], m.a("jnt_axis")[ji * 3 + 1],
                 m.a("jnt_axis")[ji * 3 + 2]};
        Vec3 axw = quat.rotate(axl);
        pos = pos + axw * (qpos[qadr] - m.a("jnt_ref")[ji]);
        out.cdof[dadr] = {Vec3(), axw};
      } else {  // HINGE
        Vec3 axl{m.a("jnt_axis")[ji * 3], m.a("jnt_axis")[ji * 3 + 1],
                 m.a("jnt_axis")[ji * 3 + 2]};
        Vec3 jp{m.a("jnt_pos")[ji * 3], m.a("jnt_pos")[ji * 3 + 1],
                m.a("jnt_pos")[ji * 3 + 2]};
        Vec3 axw = quat.rotate(axl);
        Vec3 anchor = pos + quat.rotate(jp);
        double angle = qpos[qadr] - m.a("jnt_ref")[ji];
        quat = quat.mul(axis_angle_quat(axl, angle));
        pos = anchor - quat.rotate(jp);
        out.cdof[dadr] = {axw, anchor.cross(axw)};
      }
    }
    out.xpos[b] = pos;
    out.xquat[b] = quat;
  }
  out.ximat.resize(m.nbody);
  for (int b = 0; b < m.nbody; b++) out.ximat[b] = out.xquat[b].toMat();
  return out;
}

// ---------------------------------------------------------------------------
// smooth dynamics (engine.py smooth_dynamics)
// ---------------------------------------------------------------------------

struct Smooth {
  vector<double> M;            // (nv*nv)
  vector<double> qfrc_smooth;  // (nv)
  FK k;
  vector<Vec3> xipos;
  vector<Spatial> body_vel;
};

Smooth smooth_dynamics(const Model& m, const Mutable& mm, const double* qpos,
                       const double* qvel, const double* ctrl) {
  Smooth s;
  s.k = fk(m, qpos);
  const auto& bd = m.a("body_dof");  // (nbody*nv) 0/1

  // world COM and world-frame spatial inertias
  s.xipos.resize(m.nbody);
  vector<SpatialInertia> isp(m.nbody);
  for (int b = 0; b < m.nbody; b++) {
    Vec3 ip{m.a("body_ipos")[b * 3], m.a("body_ipos")[b * 3 + 1],
            m.a("body_ipos")[b * 3 + 2]};
    s.xipos[b] = s.k.xpos[b] + s.k.ximat[b].mul(ip);
    Mat3 il;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        il.m[i][j] = m.a("body_inertia")[b * 9 + i * 3 + j];
    Mat3 iw = s.k.ximat[b].mul(il).mulT(s.k.ximat[b]);
    isp[b] = SpatialInertia::make(mm.body_mass[b], s.xipos[b], iw);
  }

  // body spatial velocities
  vector<Spatial> vel_dof(m.nv);
  for (int k = 0; k < m.nv; k++) vel_dof[k] = s.k.cdof[k] * qvel[k];
  s.body_vel.assign(m.nbody, Spatial());
  for (int b = 0; b < m.nbody; b++)
    for (int k = 0; k < m.nv; k++)
      if (bd[b * m.nv + k] != 0.0)
        s.body_vel[b] = s.body_vel[b] + vel_dof[k];

  // RNE bias (qacc = 0, gravity as base acceleration)
  Spatial a_grav{Vec3(), Vec3(-m.gravity.x, -m.gravity.y, -m.gravity.z)};
  vector<Spatial> vdot_dof(m.nv);
  for (int k = 0; k < m.nv; k++)
    vdot_dof[k] = motion_cross(s.body_vel[m.gi("dof_vsrc", k)], vel_dof[k]);
  vector<double> qfrc_bias(m.nv, 0.0);
  for (int b = 0; b < m.nbody; b++) {
    Spatial acc = a_grav;
    for (int k = 0; k < m.nv; k++)
      if (bd[b * m.nv + k] != 0.0) acc = acc + vdot_dof[k];
    Spatial iv = isp[b].mul(s.body_vel[b]);
    Spatial fb = isp[b].mul(acc) + motion_cross_force(s.body_vel[b], iv);
    for (int k = 0; k < m.nv; k++)
      if (bd[b * m.nv + k] != 0.0) qfrc_bias[k] += fb.dot(s.k.cdof[k]);
  }

  // CRBA
  const auto& banc = m.a("body_ancestor");  // (nbody*nbody)
  vector<SpatialInertia> ic(m.nbody);
  for (int a2 = 0; a2 < m.nbody; a2++)
    for (int b = 0; b < m.nbody; b++)
      if (banc[a2 * m.nbody + b] != 0.0) ic[a2].add(isp[b]);
  vector<Spatial> f_crb(m.nv);
  for (int k = 0; k < m.nv; k++)
    f_crb[k] = ic[m.gi("dof_body", k)].mul(s.k.cdof[k]);
  const auto& danc = m.a("dof_ancestor");  // (nv*nv)
  s.M.assign(m.nv * m.nv, 0.0);
  for (int i = 0; i < m.nv; i++)
    for (int j = 0; j < m.nv; j++)
      if (danc[i * m.nv + j] != 0.0) {
        double v = s.k.cdof[i].dot_r(f_crb[j]);
        s.M[i * m.nv + j] = v;
        s.M[j * m.nv + i] = v;
      }
  for (int k = 0; k < m.nv; k++)
    s.M[k * m.nv + k] += m.a("dof_armature")[k];

  // passive: damping + joint springs
  vector<double> qfrc_passive(m.nv);
  for (int k = 0; k < m.nv; k++)
    qfrc_passive[k] = -mm.dof_damping[k] * qvel[k];
  for (int ji = 0; ji < m.njnt; ji++) {
    double kstiff = m.a("jnt_stiffness")[ji];
    if (kstiff > 0 && m.gi("jnt_type", ji) != FREE) {
      int qadr = m.gi("jnt_qposadr", ji), dadr = m.gi("jnt_dofadr", ji);
      qfrc_passive[dadr] -= kstiff * (qpos[qadr] - m.a("jnt_springref")[ji]);
    }
  }

  // actuation: motor gear torque with ctrl clamped to ctrlrange
  vector<double> qfrc_act(m.nv, 0.0);
  for (int u = 0; u < m.nu; u++) {
    double lo = m.a("act_ctrlrange")[u * 2];
    double hi = m.a("act_ctrlrange")[u * 2 + 1];
    double c = std::min(std::max(ctrl[u], lo), hi);
    qfrc_act[m.gi("act_dofadr", u)] += c * m.a("act_gear")[u];
  }

  // external wrenches (xfrc_applied: world force,torque at body COM)
  vector<double> qfrc_applied(m.nv, 0.0);
  for (int b = 0; b < m.nbody; b++) {
    Vec3 frc{mm.xfrc[b * 6], mm.xfrc[b * 6 + 1], mm.xfrc[b * 6 + 2]};
    Vec3 trq{mm.xfrc[b * 6 + 3], mm.xfrc[b * 6 + 4], mm.xfrc[b * 6 + 5]};
    Spatial fe{trq + s.xipos[b].cross(frc), frc};
    for (int k = 0; k < m.nv; k++)
      if (bd[b * m.nv + k] != 0.0) qfrc_applied[k] += fe.dot(s.k.cdof[k]);
  }

  s.qfrc_smooth.resize(m.nv);
  for (int k = 0; k < m.nv; k++)
    s.qfrc_smooth[k] =
        qfrc_act[k] + qfrc_passive[k] + qfrc_applied[k] - qfrc_bias[k];
  return s;
}

// ---------------------------------------------------------------------------
// narrow phase (collision.py), contacts in engine order
// ---------------------------------------------------------------------------

struct Contact {
  double dist;
  Vec3 pos, normal;
  // friction-frame tangent hint (capsule long axis); zero = default frame
  Vec3 hint{0, 0, 0};
};

void sphere_sphere_raw(const Vec3& c1, double r1, const Vec3& c2, double r2,
                       Contact* out) {
  Vec3 d = c2 - c1;
  double dc = d.norm();
  Vec3 n = dc > 1e-9 ? d * (1.0 / dc) : Vec3{0, 0, 1};
  out->dist = dc - r1 - r2;
  out->pos = c1 + n * (r1 + 0.5 * out->dist);
  out->normal = n;
}

void plane_sphere(const Vec3& ppos, const Mat3& pmat, const Vec3& c, double r,
                  Contact* out) {
  Vec3 n = pmat.col(2);
  out->dist = n.dot(c - ppos) - r;
  out->pos = c - n * (r + 0.5 * out->dist);
  out->normal = n;
}

// mirrors collision.py hfield_sphere (round 4): nearest-feature distance
// to the terrain's x-z polyline within a +-HF_WINDOW cell window, with the
// penetration depth capped at the center-on-surface configuration
// (MuJoCo's prism collider saturates hfield depth at ~(r + eps) however
// deep the geom sinks — measured on the reference XML).
static const long HF_WINDOW = 16;

void hfield_sphere(const Vec3& hpos, const double* hsize, const double* hrow,
                   long ncol, const Vec3& c, double r, Contact* out) {
  double sx = hsize[0], sz = hsize[2];
  double dx_cell = 2 * sx / (ncol - 1);
  double u = (c.x - hpos.x + sx) / (2 * sx) * (ncol - 1);
  long i_c = (long)std::floor(u);
  // clamp the window to the grid: for ncol < 2*HF_WINDOW+1 the previous
  // `ncol - w` went negative and start could index before hrow (advisor
  // round-4 finding; latent with the shipped assets, ncol 41/500)
  long w = std::min(2 * HF_WINDOW + 1, ncol);
  long start = std::min(std::max(i_c - HF_WINDOW, 0L), ncol - w);
  // local surface sample (sign test + degenerate-normal fallback),
  // matching collision.py _hfield_surface exactly
  double ucl = std::min(std::max(u, 0.0), ncol - 1.000001);
  long i0 = (long)std::floor(ucl);
  double frac = ucl - i0;
  double h0 = hrow[i0];
  double h1 = hrow[std::min(i0 + 1, ncol - 1)];
  double z_surf = hpos.z + (h0 + (h1 - h0) * frac) * sz;
  double slope = (h1 - h0) * sz / dx_cell;
  double nl_x = -slope, nl_z = 1.0;
  double nl_norm = std::sqrt(nl_x * nl_x + nl_z * nl_z);
  nl_x /= nl_norm; nl_z /= nl_norm;

  double px = c.x, pz = c.z;
  double best_d2 = 1e300, qx = 0.0, qz = 0.0;
  for (long k = 0; k < w - 1; ++k) {
    double ax = (start + k) * dx_cell - sx + hpos.x;
    double az = hrow[start + k] * sz + hpos.z;
    double bx = ax + dx_cell;
    double bz = hrow[start + k + 1] * sz + hpos.z;
    double abx = bx - ax, abz = bz - az;
    double t = ((px - ax) * abx + (pz - az) * abz) /
               std::max(abx * abx + abz * abz, 1e-12);
    t = std::min(std::max(t, 0.0), 1.0);
    double cx_ = ax + t * abx, cz_ = az + t * abz;
    double d2 = (px - cx_) * (px - cx_) + (pz - cz_) * (pz - cz_);
    if (d2 < best_d2) { best_d2 = d2; qx = cx_; qz = cz_; }
  }
  double dist2d = std::sqrt(best_d2 + 1e-16);
  double sign = (c.z < z_surf) ? -1.0 : 1.0;
  double n2x = sign * (px - qx) / dist2d;
  double n2z = sign * (pz - qz) / dist2d;
  if (dist2d < 1e-9) { n2x = nl_x; n2z = nl_z; }
  Vec3 n{n2x, 0.0, n2z};
  double dist = sign * dist2d - r;
  dist = std::max(dist, -(r + 0.005));
  out->dist = dist;
  out->pos = c - n * (r + 0.5 * dist);
  out->normal = n;
}

Vec3 closest_on_segment(const Vec3& p, const Vec3& a, const Vec3& b) {
  Vec3 ab = b - a;
  double t = (p - a).dot(ab) / std::max(ab.dot(ab), 1e-12);
  return a + ab * std::min(std::max(t, 0.0), 1.0);
}

void sphere_box_raw(const Vec3& c, double r, const Vec3& bpos,
                    const Mat3& bmat, const Vec3& half, Contact* out) {
  Vec3 cl = bmat.tmul(c - bpos);
  Vec3 q{std::min(std::max(cl.x, -half.x), half.x),
         std::min(std::max(cl.y, -half.y), half.y),
         std::min(std::max(cl.z, -half.z), half.z)};
  Vec3 delta = cl - q;
  double d_out = delta.norm();
  if (d_out > 1e-9) {
    out->normal = bmat.mul(delta * (1.0 / d_out)) * -1.0;
    out->dist = d_out - r;
  } else {
    double fd[3] = {half.x - std::fabs(cl.x), half.y - std::fabs(cl.y),
                    half.z - std::fabs(cl.z)};
    int k = 0;
    if (fd[1] < fd[k]) k = 1;
    if (fd[2] < fd[k]) k = 2;
    double comp = cl[k];
    double sign = comp > 0 ? 1.0 : (comp < 0 ? -1.0 : 1.0);
    Vec3 nf(k == 0 ? sign : 0.0, k == 1 ? sign : 0.0, k == 2 ? sign : 0.0);
    out->normal = bmat.mul(nf) * -1.0;
    out->dist = -(fd[k] + r);
  }
  out->pos = c + out->normal * (r + 0.5 * out->dist);
}

// ---- box-box (collision.py box_box): SAT + clipped face manifold --------
// Mirrors the JAX kernel op-for-op, including argmax/top-k tie-breaking
// (first index wins), so oracle trajectories track the engine to ~1e-6.

static const double BB_BIG = 1e6;

struct BBManifold {
  double sep;          // best face separation for this reference choice
  double dist[4];
  Vec3 pos_local[4];   // contact points in the reference box frame
  Vec3 n_local;        // outward reference-face normal (local)
};

static Vec3 vset(int k, double val) {
  return {k == 0 ? val : 0.0, k == 1 ? val : 0.0, k == 2 ? val : 0.0};
}

BBManifold bb_face_manifold(const Vec3& ref_p, const Mat3& ref_m,
                            const Vec3& ref_half, const Vec3& inc_p,
                            const Mat3& inc_m, const Vec3& inc_half) {
  const double eps = 1e-9, tol = 1e-7;
  Mat3 Ri;  // ref_m^T * inc_m: incident axes in ref frame (columns)
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int q = 0; q < 3; q++) s += ref_m.m[q][i] * inc_m.m[q][j];
      Ri.m[i][j] = s;
    }
  Vec3 ci = ref_m.tmul(inc_p - ref_p);
  double sep[3];
  for (int q = 0; q < 3; q++) {
    double s = 0;
    for (int j2 = 0; j2 < 3; j2++) s += std::fabs(Ri.m[q][j2]) * inc_half[j2];
    sep[q] = std::fabs(ci[q]) - (ref_half[q] + s);
  }
  int k = 0;
  if (sep[1] > sep[k]) k = 1;
  if (sep[2] > sep[k]) k = 2;
  double sgn = ci[k] >= 0 ? 1.0 : -1.0;

  double mcomp[3];  // components of the ref normal along incident axes
  for (int q = 0; q < 3; q++) mcomp[q] = sgn * Ri.m[k][q];
  int j = 0;
  if (std::fabs(mcomp[1]) > std::fabs(mcomp[j])) j = 1;
  if (std::fabs(mcomp[2]) > std::fabs(mcomp[j])) j = 2;
  double sj = -(mcomp[j] >= 0 ? 1.0 : -1.0);
  Vec3 fc = ci + Ri.col(j) * (sj * inc_half[j]);
  int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
  Vec3 a_u = Ri.col(j1) * inc_half[j1];
  Vec3 a_v = Ri.col(j2) * inc_half[j2];
  int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
  double hu = ref_half[k1], hv = ref_half[k2], hw = ref_half[k];

  static const double SGN[4][2] = {{1, 1}, {1, -1}, {-1, -1}, {-1, 1}};
  double ua[24], va[24], wa[24], gap[24];
  bool valid[24];
  // (a) incident face corners in face coords (u=x[k1], v=x[k2], w=x[k])
  for (int c = 0; c < 4; c++) {
    Vec3 corner = fc + a_u * SGN[c][0] + a_v * SGN[c][1];
    ua[c] = corner[k1];
    va[c] = corner[k2];
    wa[c] = corner[k];
    valid[c] = std::fabs(ua[c]) <= hu + tol && std::fabs(va[c]) <= hv + tol;
  }
  // incident plane in face coords
  Vec3 ni = Ri.col(j) * sj;
  double nif[3] = {ni[k1], ni[k2], ni[k]};
  double fcf[3] = {fc[k1], fc[k2], fc[k]};
  double niw = std::fabs(nif[2]) < 1e-6 ? (nif[2] >= 0 ? 1e-6 : -1e-6)
                                        : nif[2];
  double nidotfc = nif[0] * fcf[0] + nif[1] * fcf[1] + nif[2] * fcf[2];
  auto plane_w = [&](double u, double v) {
    return (nidotfc - nif[0] * u - nif[1] * v) / niw;
  };
  // (b) reference face corners: valid if inside the incident 2D quad
  for (int c = 0; c < 4; c++) {
    int idx = 4 + c;
    double ub = SGN[c][0] * hu, vb = SGN[c][1] * hv;
    ua[idx] = ub;
    va[idx] = vb;
    wa[idx] = plane_w(ub, vb);
    bool all_pos = true, all_neg = true;
    for (int q = 0; q < 4; q++) {
      double ex = ua[(q + 1) % 4] - ua[q], ey = va[(q + 1) % 4] - va[q];
      double cr = ex * (vb - va[q]) - ey * (ub - ua[q]);
      if (cr < -tol) all_pos = false;
      if (cr > tol) all_neg = false;
    }
    valid[idx] = all_pos || all_neg;
  }
  // (c) 16 2D edge-edge intersections: rect edges x incident quad edges
  const double RA[4][2] = {{hu, -hv}, {hu, hv}, {-hu, hv}, {-hu, -hv}};
  for (int a2 = 0; a2 < 4; a2++)
    for (int b2 = 0; b2 < 4; b2++) {
      int idx = 8 + a2 * 4 + b2;
      double rdx = RA[(a2 + 1) % 4][0] - RA[a2][0];
      double rdy = RA[(a2 + 1) % 4][1] - RA[a2][1];
      double d2x = ua[(b2 + 1) % 4] - ua[b2];
      double d2y = va[(b2 + 1) % 4] - va[b2];
      double dfx = ua[b2] - RA[a2][0], dfy = va[b2] - RA[a2][1];
      double denom = rdx * d2y - rdy * d2x;
      double ds = std::fabs(denom) < eps ? 1.0 : denom;
      double ta = (dfx * d2y - dfy * d2x) / ds;
      double tb = (dfx * rdy - dfy * rdx) / ds;
      valid[idx] = std::fabs(denom) >= eps && ta >= -tol && ta <= 1 + tol &&
                   tb >= -tol && tb <= 1 + tol;
      ua[idx] = RA[a2][0] + ta * rdx;
      va[idx] = RA[a2][1] + ta * rdy;
      wa[idx] = plane_w(ua[idx], va[idx]);
    }
  for (int c = 0; c < 24; c++)
    gap[c] = valid[c] ? sgn * wa[c] - hw : BB_BIG;

  // top-4 smallest gap, ties by lower index (lax.top_k semantics)
  int order[24];
  for (int c = 0; c < 24; c++) order[c] = c;
  std::stable_sort(order, order + 24,
                   [&](int a2, int b2) { return gap[a2] < gap[b2]; });

  BBManifold out;
  out.sep = sep[k];
  out.n_local = vset(k, sgn);
  for (int c = 0; c < 4; c++) {
    int i = order[c];
    out.dist[c] = gap[i];
    double wmid = 0.5 * (sgn * hw + wa[i]);
    out.pos_local[c] = vset(k1, ua[i]) + vset(k2, va[i]) + vset(k, wmid);
  }
  return out;
}

void box_box(const Vec3& p1, const Mat3& m1, const Vec3& h1, const Vec3& p2,
             const Mat3& m2, const Vec3& h2, Contact out[4]) {
  BBManifold f1 = bb_face_manifold(p1, m1, h1, p2, m2, h2);
  BBManifold f2 = bb_face_manifold(p2, m2, h2, p1, m1, h1);
  bool use2 = f2.sep > f1.sep + 1e-8;
  const BBManifold& f = use2 ? f2 : f1;
  const Mat3& fm = use2 ? m2 : m1;
  const Vec3& fp = use2 ? p2 : p1;
  for (int c = 0; c < 4; c++) {
    out[c].dist = f.dist[c];
    out[c].pos = fp + fm.mul(f.pos_local[c]);
    out[c].normal = fm.mul(f.n_local) * (use2 ? -1.0 : 1.0);
  }

  // edge-edge SAT (9 cross axes, box1 frame)
  Mat3 R;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int q = 0; q < 3; q++) s += m1.m[q][i] * m2.m[q][j];
      R.m[i][j] = s;
    }
  Vec3 t = m1.tmul(p2 - p1);
  double best = -BB_BIG;
  int bi = 0, bj = 0;
  Vec3 ble;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      Vec3 l = vset(i, 1.0).cross(R.col(j));
      double n2 = l.norm();
      double sepe = -BB_BIG;
      Vec3 lh;
      if (n2 > 1e-6) {
        lh = l * (1.0 / n2);
        double td = lh.dot(t);
        if (td < 0) {
          lh = lh * -1.0;
          td = -td;
        }
        double supp1 = 0, supp2 = 0;
        for (int q = 0; q < 3; q++) {
          supp1 += h1[q] * std::fabs(lh[q]);
          supp2 += h2[q] * std::fabs(lh.dot(R.col(q)));
        }
        sepe = td - supp1 - supp2;
      }
      if (sepe > best) {  // strict: first max wins, matching jnp.argmax
        best = sepe;
        bi = i;
        bj = j;
        ble = lh;
      }
    }
  double sep_face = std::max(f1.sep, f2.sep);
  if (best > sep_face + 1e-8) {
    // supporting edges and their closest points (box1 frame)
    Vec3 sgn1{0, 0, 0}, sgn2{0, 0, 0};
    double s1c[3], s2c[3];
    Vec3 le2 = R.tmul(ble);
    for (int q = 0; q < 3; q++) {
      s1c[q] = q == bi ? 0.0 : (ble[q] >= 0 ? 1.0 : -1.0) * h1[q];
      s2c[q] = q == bj ? 0.0 : (le2[q] >= 0 ? -1.0 : 1.0) * h2[q];
    }
    Vec3 pA{s1c[0], s1c[1], s1c[2]};
    Vec3 dA = vset(bi, 1.0);
    double hA = h1[bi];
    Vec3 pB = t + R.mul(Vec3{s2c[0], s2c[1], s2c[2]});
    Vec3 dB = R.col(bj);
    double hB = h2[bj];
    Vec3 s1a = pA - dA * hA, s1b = pA + dA * hA;
    Vec3 s2a = pB - dB * hB, s2b = pB + dB * hB;
    Vec3 dd1 = s1b - s1a, dd2 = s2b - s2a, rr = s1a - s2a;
    double a = dd1.dot(dd1), e = dd2.dot(dd2), ff = dd2.dot(rr);
    double c = dd1.dot(rr), b = dd1.dot(dd2);
    double denom = std::max(a * e - b * b, 1e-12);
    double ss = std::min(std::max((b * ff - c * e) / denom, 0.0), 1.0);
    double tt = std::min(
        std::max((b * ss + ff) / std::max(e, 1e-12), 0.0), 1.0);
    ss = std::min(std::max((b * tt - c) / std::max(a, 1e-12), 0.0), 1.0);
    Vec3 q1 = s1a + dd1 * ss, q2e = s2a + dd2 * tt;
    out[0].dist = best;
    out[0].pos = p1 + m1.mul((q1 + q2e) * 0.5);
    out[0].normal = m1.mul(ble);
    for (int c2 = 1; c2 < 4; c2++) {
      out[c2].dist = BB_BIG;
      out[c2].pos = {0, 0, 0};
      out[c2].normal = {0, 0, 1};
    }
  }
  for (int c2 = 0; c2 < 4; c2++)
    if (out[c2].dist >= BB_BIG * 0.5) out[c2].normal = {0, 0, 1};
}

// per-contact metadata mirrors engine.py push_meta
struct ConMeta {
  int body1, body2, condim;
  double mu, margin;
  double solref[2], solimp[3];
};

void contacts(const Model& m, const Mutable& mm, const FK& k,
              vector<Contact>* out, vector<ConMeta>* meta) {
  auto geom_frame = [&](int g, Vec3* pos, Mat3* mat) {
    int b = m.gi("geom_body", g);
    Vec3 gp{mm.geom_pos[g * 3], mm.geom_pos[g * 3 + 1],
            mm.geom_pos[g * 3 + 2]};
    *pos = k.xpos[b] + k.ximat[b].mul(gp);
    Quat gq{m.a("geom_quat")[g * 4], m.a("geom_quat")[g * 4 + 1],
            m.a("geom_quat")[g * 4 + 2], m.a("geom_quat")[g * 4 + 3]};
    *mat = k.ximat[b].mul(gq.toMat());
  };
  for (int p = 0; p < m.npair; p++) {
    int kind = m.gi("pair_kind", p);
    int g1 = m.gi("pair_g1", p), g2 = m.gi("pair_g2", p);
    Vec3 p1, p2;
    Mat3 m1, m2;
    geom_frame(g1, &p1, &m1);
    geom_frame(g2, &p2, &m2);
    const double* s1 = mm.geom_size + g1 * 3;
    const double* s2 = mm.geom_size + g2 * 3;
    Contact c1, c2, c3, c4;
    int n_pts = 1;
    switch (kind) {
      case PLANE_SPHERE:
        plane_sphere(p1, m1, p2, s2[0], &c1);
        break;
      case PLANE_CAPSULE: {
        Vec3 axis = m2.col(2);
        plane_sphere(p1, m1, p2 + axis * s2[1], s2[0], &c1);
        plane_sphere(p1, m1, p2 - axis * s2[1], s2[0], &c2);
        c1.hint = axis;
        c2.hint = axis;
        n_pts = 2;
        break;
      }
      case HFIELD_SPHERE:
        hfield_sphere(p1, mm.hf_size, mm.hf_row, mm.hf_ncol, p2, s2[0], &c1);
        break;
      case HFIELD_CAPSULE: {
        Vec3 axis = m2.col(2);
        hfield_sphere(p1, mm.hf_size, mm.hf_row, mm.hf_ncol,
                      p2 + axis * s2[1], s2[0], &c1);
        hfield_sphere(p1, mm.hf_size, mm.hf_row, mm.hf_ncol,
                      p2 - axis * s2[1], s2[0], &c2);
        c1.hint = axis;
        c2.hint = axis;
        n_pts = 2;
        break;
      }
      case SPHERE_SPHERE:
        sphere_sphere_raw(p1, s1[0], p2, s2[0], &c1);
        break;
      case SPHERE_CAPSULE: {
        Vec3 axis = m2.col(2);
        Vec3 q = closest_on_segment(p1, p2 - axis * s2[1], p2 + axis * s2[1]);
        sphere_sphere_raw(p1, s1[0], q, s2[0], &c1);
        break;
      }
      case CAPSULE_CAPSULE: {
        Vec3 a1 = m1.col(2), a2 = m2.col(2);
        Vec3 s1a = p1 - a1 * s1[1], s1b = p1 + a1 * s1[1];
        Vec3 s2a = p2 - a2 * s2[1], s2b = p2 + a2 * s2[1];
        Vec3 d1 = s1b - s1a, d2 = s2b - s2a, r = s1a - s2a;
        double a = d1.dot(d1), e = d2.dot(d2), f2 = d2.dot(r);
        double c = d1.dot(r), bb = d1.dot(d2);
        double denom = std::max(a * e - bb * bb, 1e-12);
        double s = std::min(std::max((bb * f2 - c * e) / denom, 0.0), 1.0);
        double t = std::min(
            std::max((bb * s + f2) / std::max(e, 1e-12), 0.0), 1.0);
        s = std::min(std::max((bb * t - c) / std::max(a, 1e-12), 0.0), 1.0);
        sphere_sphere_raw(s1a + d1 * s, s1[0], s2a + d2 * t, s2[0], &c1);
        break;
      }
      case CAPSULE_BOX: {
        Vec3 axis = m1.col(2);
        Vec3 half{s2[0], s2[1], s2[2]};
        sphere_box_raw(p1 + axis * s1[1], s1[0], p2, m2, half, &c1);
        sphere_box_raw(p1 - axis * s1[1], s1[0], p2, m2, half, &c2);
        n_pts = 2;
        break;
      }
      case SPHERE_BOX: {
        Vec3 half{s2[0], s2[1], s2[2]};
        sphere_box_raw(p1, s1[0], p2, m2, half, &c1);
        break;
      }
      case BOX_BOX: {
        Vec3 ha{s1[0], s1[1], s1[2]}, hb{s2[0], s2[1], s2[2]};
        Contact cb[4];
        box_box(p1, m1, ha, p2, m2, hb, cb);
        n_pts = 4;
        c1 = cb[0];
        c2 = cb[1];
        c3 = cb[2];
        c4 = cb[3];
        break;
      }
      default:
        continue;
    }
    ConMeta cm;
    cm.body1 = m.gi("geom_body", g1);
    cm.body2 = m.gi("geom_body", g2);
    cm.mu = std::max(m.a("geom_friction")[g1 * 3],
                     m.a("geom_friction")[g2 * 3]);
    // MuJoCo includemargin: the two geom margins ADD
    cm.margin = m.a("geom_margin")[g1] + m.a("geom_margin")[g2];
    cm.condim = std::max(m.gi("geom_condim", g1), m.gi("geom_condim", g2));
    for (int q = 0; q < 2; q++)
      cm.solref[q] = 0.5 * (m.a("geom_solref")[g1 * 2 + q] +
                            m.a("geom_solref")[g2 * 2 + q]);
    for (int q = 0; q < 3; q++)
      cm.solimp[q] = 0.5 * (m.a("geom_solimp")[g1 * 3 + q] +
                            m.a("geom_solimp")[g2 * 3 + q]);
    out->push_back(c1);
    meta->push_back(cm);
    if (n_pts >= 2) {
      out->push_back(c2);
      meta->push_back(cm);
    }
    if (n_pts >= 4) {
      out->push_back(c3);
      meta->push_back(cm);
      out->push_back(c4);
      meta->push_back(cm);
    }
  }
}

// ---------------------------------------------------------------------------
// constraint forces (engine.py constraint_forces)
// ---------------------------------------------------------------------------

double impedance(const double* solimp, double r) {
  // MuJoCo power curve, midpoint 0.5 / power 2 (the solimp defaults)
  double dmin = solimp[0], dmax = solimp[1], width = solimp[2];
  double x = std::min(std::max(-r / std::max(width, 1e-10), 0.0), 1.0);
  double sm = x <= 0.5 ? 2.0 * x * x : 1.0 - 2.0 * (1.0 - x) * (1.0 - x);
  double d = dmin + (dmax - dmin) * sm;
  return std::min(std::max(d, 1e-4), 0.9999);
}

vector<double> constraint_forces(const Model& m, const Mutable& mm,
                                 const double* qpos, const double* qvel,
                                 const Smooth& s, const Chol& cholM) {
  const int nv = m.nv;
  const auto& bd = m.a("body_dof");

  // MuJoCo pyramidal formulation (engine.py constraint_forces): every row
  // is a non-negative force direction — limits, frictionless normals, and
  // condim>=3 contacts as 4 pyramid facets J = Jn +- mu*Jt_i.
  struct Row {
    vector<double> J;
    double r;        // constraint pos (raw signed distance for contacts)
    bool act;        // limits: r < 0; contacts: dist < margin
    double solref[2];
    double solimp[3];
    double dA;       // MuJoCo compile-time diagApprox weight
  };
  vector<Row> rows;

  const auto& dof_iw = m.a("dof_invweight0");
  const auto& body_iw = m.a("body_invweight0");

  // joint limit rows: two per limited joint, in joint order
  for (int ji = 0; ji < m.njnt; ji++) {
    if (m.a("jnt_limited")[ji] == 0.0 || m.gi("jnt_type", ji) == FREE)
      continue;
    int qadr = m.gi("jnt_qposadr", ji), dadr = m.gi("jnt_dofadr", ji);
    double lo = m.a("jnt_range")[ji * 2], hi = m.a("jnt_range")[ji * 2 + 1];
    double signs[2] = {1.0, -1.0};
    double bounds[2] = {lo, hi};
    for (int t = 0; t < 2; t++) {
      Row row;
      row.J.assign(nv, 0.0);
      row.J[dadr] = signs[t];
      row.r = signs[t] * (qpos[qadr] - bounds[t]);
      row.act = row.r < 0.0;
      row.solref[0] = m.a("jnt_solref_limit")[ji * 2];
      row.solref[1] = m.a("jnt_solref_limit")[ji * 2 + 1];
      for (int q = 0; q < 3; q++)
        row.solimp[q] = m.a("jnt_solimp_limit")[ji * 3 + q];
      row.dA = dof_iw[dadr];
      rows.push_back(std::move(row));
    }
  }
  const int nlim = (int)rows.size();

  vector<Contact> cons;
  vector<ConMeta> meta;
  contacts(m, mm, s.k, &cons, &meta);
  const int ncon = (int)cons.size();
  if (nlim == 0 && ncon == 0) return vector<double>(nv, 0.0);

  // contact point jacobians: Jp[k] = (cdof_lin[k] + cdof_ang[k] x pos)*mask
  // with mask = body_dof[body2] - body_dof[body1]
  vector<vector<Vec3>> jp(ncon, vector<Vec3>(nv));
  for (int c = 0; c < ncon; c++)
    for (int k = 0; k < nv; k++) {
      double mask = bd[meta[c].body2 * nv + k] - bd[meta[c].body1 * nv + k];
      Vec3 v = s.k.cdof[k].l + s.k.cdof[k].a.cross(cons[c].pos);
      jp[c][k] = v * mask;
    }

  // frictionless contacts (condim < 3): a single normal row each.
  // MuJoCo constraint position: dist - includemargin (spring + impedance).
  for (int c = 0; c < ncon; c++) {
    if (meta[c].condim >= 3) continue;
    Row row;
    row.J.assign(nv, 0.0);
    for (int k = 0; k < nv; k++) row.J[k] = jp[c][k].dot(cons[c].normal);
    row.r = cons[c].dist - meta[c].margin;
    row.act = row.r < 0.0;
    row.solref[0] = meta[c].solref[0];
    row.solref[1] = meta[c].solref[1];
    for (int q = 0; q < 3; q++) row.solimp[q] = meta[c].solimp[q];
    row.dA = body_iw[meta[c].body1] + body_iw[meta[c].body2];
    rows.push_back(std::move(row));
  }

  // pyramidal facets (condim >= 3): 4 rows per contact, grouped per
  // contact in order (+t1, -t1, +t2, -t2) — engine.py facet order
  for (int c = 0; c < ncon; c++) {
    if (meta[c].condim < 3) continue;
    Vec3 n = cons[c].normal;
    Vec3 ref = std::fabs(n.x) < 0.5 ? Vec3{1, 0, 0} : Vec3{0, 1, 0};
    Vec3 t1 = n.cross(ref);
    t1 = t1 * (1.0 / t1.norm());
    // align t1 with the collider's tangent hint when one exists
    // (engine.py: capsule long axis projected into the contact plane)
    Vec3 h = cons[c].hint;
    Vec3 hp = h - n * h.dot(n);
    double hn = hp.norm();
    if (hn > 1e-6) t1 = hp * (1.0 / hn);
    Vec3 t2 = n.cross(t1);
    double mu = meta[c].mu;
    double w12 = body_iw[meta[c].body1] + body_iw[meta[c].body2];
    double dA = 2.0 * mu * mu * (1.0 + mu * mu) * w12;
    const Vec3 tans[2] = {t1, t2};
    for (int ti = 0; ti < 2; ti++)
      for (int sgn = 0; sgn < 2; sgn++) {
        double sg = sgn == 0 ? 1.0 : -1.0;
        Row row;
        row.J.assign(nv, 0.0);
        for (int k = 0; k < nv; k++)
          row.J[k] = jp[c][k].dot(cons[c].normal) +
                     sg * mu * jp[c][k].dot(tans[ti]);
        row.r = cons[c].dist - meta[c].margin;
        row.act = row.r < 0.0;
        row.solref[0] = meta[c].solref[0];
        row.solref[1] = meta[c].solref[1];
        for (int q = 0; q < 3; q++) row.solimp[q] = meta[c].solimp[q];
        row.dA = dA;
        rows.push_back(std::move(row));
      }
  }
  const int nrows = (int)rows.size();

  vector<char> active(nrows);
  for (int i = 0; i < nrows; i++) active[i] = rows[i].act;

  vector<vector<double>> minv_jt(nrows, vector<double>(nv));
  for (int i = 0; i < nrows; i++) {
    if (!active[i]) std::fill(rows[i].J.begin(), rows[i].J.end(), 0.0);
    cholM.solve(rows[i].J.data(), minv_jt[i].data());
  }

  // impedance and virtual-spring reference acceleration
  vector<double> aref(nrows), dimp(nrows);
  for (int i = 0; i < nrows; i++) {
    double d = impedance(rows[i].solimp, rows[i].r);
    dimp[i] = d;
    // exact MuJoCo spring constants: b = 2/(dmax*tc), k = d/(dmax^2 tc^2 dr^2)
    // with tc clamped to >= 2*timestep as MuJoCo does
    double tc = std::max(rows[i].solref[0], 2.0 * m.timestep);
    double dr = rows[i].solref[1];
    double dmax = rows[i].solimp[1];
    double b = 2.0 / std::max(dmax * tc, 1e-8);
    double k = d / std::max(dmax * dmax * tc * tc * dr * dr, 1e-10);
    double vel = 0;
    for (int q = 0; q < nv; q++) vel += pr(rows[i].J[q], qvel[q]);
    aref[i] = (-b * vel - k * rows[i].r) * (active[i] ? 1.0 : 0.0);
  }

  // A = J M^-1 J^T + diag(R)
  vector<double> A(nrows * nrows, 0.0);
  for (int i = 0; i < nrows; i++)
    for (int j = 0; j < nrows; j++) {
      double v = 0;
      for (int k = 0; k < nv; k++) v += pr(rows[i].J[k], minv_jt[j][k]);
      A[i * nrows + j] = v;
    }
  vector<double> a_ii_inv(nrows);
  for (int i = 0; i < nrows; i++) {
    // regularizer from impedance and the compile-time diagApprox weight
    double R = std::max(
        (1.0 - dimp[i]) / std::max(dimp[i], 1e-10) * rows[i].dA, 1e-12);
    if (!active[i]) R = 1.0;
    A[i * nrows + i] += R;
    a_ii_inv[i] = 1.0 / std::max(A[i * nrows + i], 1e-12);
  }

  vector<double> qacc_smooth(nv);
  cholM.solve(s.qfrc_smooth.data(), qacc_smooth.data());
  vector<double> b_vec(nrows);
  for (int i = 0; i < nrows; i++) {
    double v = 0;
    for (int k = 0; k < nv; k++) v += pr(rows[i].J[k], qacc_smooth[k]);
    b_vec[i] = (v - aref[i]) * (active[i] ? 1.0 : 0.0);
  }

  // projection: every row is a non-negative pyramid facet force
  vector<double> f(nrows, 0.0);
  if (m.solver == 0) {
    // projected Jacobi with adaptive under-relaxation (engine.py 'jacobi'
    // branch): omega = 1/rho, rho = row-sum bound on spectral radius
    double rho = 0.0;
    for (int i = 0; i < nrows; i++) {
      double rs = 0.0;
      for (int j = 0; j < nrows; j++) rs += std::fabs(A[i * nrows + j]);
      rho = std::max(rho, rs * a_ii_inv[i]);
    }
    const double omega = std::min(1.0, 1.8 / std::max(rho, 1e-10));
    vector<double> tmp(nrows);
    for (int it = 0; it < 2 * m.iterations; it++) {
      for (int i = 0; i < nrows; i++) {
        double af = 0;
        for (int j = 0; j < nrows; j++) af += pr(A[i * nrows + j], f[j]);
        tmp[i] = std::max(f[i] - omega * (af + b_vec[i]) * a_ii_inv[i], 0.0);
      }
      f = tmp;
    }
  } else {
    // projected Gauss-Seidel: in-place row updates, fixed order
    for (int it = 0; it < m.iterations; it++) {
      for (int i = 0; i < nrows; i++) {
        double af = 0;
        for (int j = 0; j < nrows; j++) af += pr(A[i * nrows + j], f[j]);
        f[i] = std::max(f[i] - (af + b_vec[i]) * a_ii_inv[i], 0.0);
      }
    }
  }
  for (int i = 0; i < nrows; i++)
    if (!active[i]) f[i] = 0.0;

  vector<double> qfrc(nv, 0.0);
  for (int i = 0; i < nrows; i++)
    for (int k = 0; k < nv; k++) qfrc[k] += pr(rows[i].J[k], f[i]);
  return qfrc;
}

// ---------------------------------------------------------------------------
// integrators (engine.py _qacc / _integrate_pos / step)
// ---------------------------------------------------------------------------

void qacc_fn(const Model& m, const Mutable& mm, const double* qpos,
             const double* qvel, const double* ctrl, bool implicit_damping,
             double* qacc_out) {
  Smooth s = smooth_dynamics(m, mm, qpos, qvel, ctrl);
  Chol cholM(s.M, m.nv);
  vector<double> qfrc_con =
      constraint_forces(m, mm, qpos, qvel, s, cholM);
  vector<double> rhs(m.nv);
  for (int k = 0; k < m.nv; k++) rhs[k] = s.qfrc_smooth[k] + qfrc_con[k];
  if (implicit_damping) {
    vector<double> Mi = s.M;
    for (int k = 0; k < m.nv; k++)
      Mi[k * m.nv + k] += m.timestep * mm.dof_damping[k];
    Chol cholMi(Mi, m.nv);
    cholMi.solve(rhs.data(), qacc_out);
  } else {
    cholM.solve(rhs.data(), qacc_out);
  }
}

void integrate_pos(const Model& m, const double* qpos, const double* qvel,
                   double dt, double* out) {
  for (int ji = 0; ji < m.njnt; ji++) {
    int jt = m.gi("jnt_type", ji);
    int qadr = m.gi("jnt_qposadr", ji), dadr = m.gi("jnt_dofadr", ji);
    if (jt == FREE) {
      for (int k = 0; k < 3; k++)
        out[qadr + k] = qpos[qadr + k] + dt * qvel[dadr + k];
      Quat q{qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6]};
      Vec3 w{qvel[dadr + 3], qvel[dadr + 4], qvel[dadr + 5]};
      Quat qn = quat_integrate(q, w, dt);
      out[qadr + 3] = qn.w;
      out[qadr + 4] = qn.x;
      out[qadr + 5] = qn.y;
      out[qadr + 6] = qn.z;
    } else {
      out[qadr] = qpos[qadr] + dt * qvel[dadr];
    }
  }
}

void step_impl(const Model& m, const Mutable& mm, const double* qpos,
               const double* qvel, const double* ctrl, double* out_qpos,
               double* out_qvel) {
  const double h = m.timestep;
  const int nv = m.nv, nq = m.nq;
  if (m.integrator == EULER) {
    vector<double> qacc(nv);
    qacc_fn(m, mm, qpos, qvel, ctrl, true, qacc.data());
    for (int k = 0; k < nv; k++) out_qvel[k] = qvel[k] + h * qacc[k];
    integrate_pos(m, qpos, out_qvel, h, out_qpos);
  } else {  // RK4
    vector<double> a1(nv), a2(nv), a3(nv), a4(nv);
    vector<double> q2(nq), q3(nq), q4(nq), v2(nv), v3(nv), v4(nv);
    qacc_fn(m, mm, qpos, qvel, ctrl, false, a1.data());
    integrate_pos(m, qpos, qvel, 0.5 * h, q2.data());
    for (int k = 0; k < nv; k++) v2[k] = qvel[k] + 0.5 * h * a1[k];
    qacc_fn(m, mm, q2.data(), v2.data(), ctrl, false, a2.data());
    integrate_pos(m, qpos, v2.data(), 0.5 * h, q3.data());
    for (int k = 0; k < nv; k++) v3[k] = qvel[k] + 0.5 * h * a2[k];
    qacc_fn(m, mm, q3.data(), v3.data(), ctrl, false, a3.data());
    integrate_pos(m, qpos, v3.data(), h, q4.data());
    for (int k = 0; k < nv; k++) v4[k] = qvel[k] + h * a3[k];
    qacc_fn(m, mm, q4.data(), v4.data(), ctrl, false, a4.data());
    vector<double> v_avg(nv);
    for (int k = 0; k < nv; k++) {
      v_avg[k] = (qvel[k] + 2 * v2[k] + 2 * v3[k] + v4[k]) / 6.0;
      out_qvel[k] =
          qvel[k] + h * (a1[k] + 2 * a2[k] + 2 * a3[k] + a4[k]) / 6.0;
    }
    integrate_pos(m, qpos, v_avg.data(), h, out_qpos);
  }
}

// forward pass subset envs consume (engine.py forward)
void forward_impl(const Model& m, const Mutable& mm, const double* qpos,
                  const double* qvel, double* out_xpos, double* out_ximat,
                  double* out_com, double* out_comvel) {
  FK k = fk(m, qpos);
  const auto& bd = m.a("body_dof");
  const auto& banc = m.a("body_ancestor");
  vector<Vec3> xipos(m.nbody);
  for (int b = 0; b < m.nbody; b++) {
    Vec3 ip{m.a("body_ipos")[b * 3], m.a("body_ipos")[b * 3 + 1],
            m.a("body_ipos")[b * 3 + 2]};
    xipos[b] = k.xpos[b] + k.ximat[b].mul(ip);
  }
  vector<Spatial> body_vel(m.nbody);
  for (int b = 0; b < m.nbody; b++)
    for (int q = 0; q < m.nv; q++)
      if (bd[b * m.nv + q] != 0.0)
        body_vel[b] = body_vel[b] + k.cdof[q] * qvel[q];
  for (int b = 0; b < m.nbody; b++) {
    out_xpos[b * 3] = k.xpos[b].x;
    out_xpos[b * 3 + 1] = k.xpos[b].y;
    out_xpos[b * 3 + 2] = k.xpos[b].z;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        out_ximat[b * 9 + i * 3 + j] = k.ximat[b].m[i][j];
    double msub = 0;
    Vec3 csum, vsum;
    for (int c = 0; c < m.nbody; c++) {
      if (banc[b * m.nbody + c] == 0.0) continue;
      double mc = mm.body_mass[c];
      msub += mc;
      csum = csum + xipos[c] * mc;
      Vec3 vc = body_vel[c].l + body_vel[c].a.cross(xipos[c]);
      vsum = vsum + vc * mc;
    }
    double safe = std::max(msub, 1e-10);
    out_com[b * 3] = csum.x / safe;
    out_com[b * 3 + 1] = csum.y / safe;
    out_com[b * 3 + 2] = csum.z / safe;
    out_comvel[b * 3] = vsum.x / safe;
    out_comvel[b * 3 + 1] = vsum.y / safe;
    out_comvel[b * 3 + 2] = vsum.z / safe;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* ltao_model_new() { return new Model(); }

void ltao_model_free(void* h) { delete static_cast<Model*>(h); }

int ltao_model_set(void* h, const char* name, const double* data, long n) {
  auto* m = static_cast<Model*>(h);
  m->f[name] = vector<double>(data, data + n);
  return 0;
}

int ltao_model_finalize(void* h) {
  return static_cast<Model*>(h)->finalize();
}

int ltao_step(void* h, const double* qpos, const double* qvel,
              const double* ctrl, const double* body_mass,
              const double* dof_damping, const double* geom_size,
              const double* geom_pos, const double* xfrc,
              const double* hf_size, const double* hf_row, long hf_ncol,
              double* out_qpos, double* out_qvel) {
  auto* m = static_cast<Model*>(h);
  Mutable mm{body_mass, dof_damping, geom_size, geom_pos,
             xfrc,      hf_size,     hf_row,    hf_ncol};
  step_impl(*m, mm, qpos, qvel, ctrl, out_qpos, out_qvel);
  return 0;
}

void ltao_set_rounding(int bits) { g_round_bits = bits; }

// mass matrix (nv*nv), motion subspace (nv*6: angular, then linear) and body
// COMs (nbody*3) at qpos, at rest, with the given body masses
int ltao_smooth0(void* h, const double* qpos, const double* body_mass,
                 const double* dof_damping, const double* geom_size,
                 const double* geom_pos, const double* xfrc, double* out_m,
                 double* out_cdof, double* out_xipos) {
  auto* m = static_cast<Model*>(h);
  Mutable mm{body_mass, dof_damping, geom_size, geom_pos,
             xfrc,      nullptr,     nullptr,   0};
  vector<double> zv(m->nv, 0.0), zu(std::max(m->nu, 1), 0.0);
  Smooth s = smooth_dynamics(*m, mm, qpos, zv.data(), zu.data());
  for (int i = 0; i < m->nv * m->nv; i++) out_m[i] = s.M[i];
  for (int k = 0; k < m->nv; k++) {
    const Spatial& c = s.k.cdof[k];
    double v[6] = {c.a.x, c.a.y, c.a.z, c.l.x, c.l.y, c.l.z};
    for (int q = 0; q < 6; q++) out_cdof[k * 6 + q] = v[q];
  }
  for (int b = 0; b < m->nbody; b++) {
    out_xipos[b * 3] = s.xipos[b].x;
    out_xipos[b * 3 + 1] = s.xipos[b].y;
    out_xipos[b * 3 + 2] = s.xipos[b].z;
  }
  return 0;
}

int ltao_forward(void* h, const double* qpos, const double* qvel,
                 const double* body_mass, const double* geom_pos,
                 double* out_xpos, double* out_ximat, double* out_com,
                 double* out_comvel) {
  auto* m = static_cast<Model*>(h);
  Mutable mm{};
  mm.body_mass = body_mass;
  mm.geom_pos = geom_pos;
  forward_impl(*m, mm, qpos, qvel, out_xpos, out_ximat, out_com, out_comvel);
  return 0;
}

}  // extern "C"
