// The model-parametric fused AL-iLQR tracker with every operand of its
// reference: user constraint rows, the multipliers' warm start, the additive
// input mode, per-stage input weights, terminal box rows and per-lane
// weights. A group of G threads per scenario lane, one CTA per tile of T
// lanes, the whole augmented-Lagrangian solve in one launch.
//
// Replaces the Pallas TPU kernel _tracker_tile_kernel in
// model_predictive_control_tpu/ops/pallas/ilqr_factory.py (wrapper
// fused_tracker_solve) for the instantiations that need those operands; the
// racing and benchmark instantiations are built from csrc/ilqr_factory.cu,
// whose solver this one generalizes (its design notes hold here: the lane
// groups, the Jacobian pre-pass, one line-search candidate per member, the
// replicated Riccati sweep, the working set in shared memory, the tile-wide
// exits). The generalized body kept in one source with those instantiations
// cost the kinematic racing launch 5% (PERF.md), so they keep their own
// source and library. Plain twin: tracker_tiles_reference in
// model_predictive_control_tpu_torch/ops/cuda/ilqr_factory.py, the same
// operations in the same order, bit for bit (--fmad=false).
//
// The kernel is templated on a Problem: a model functor (`rows(x, u, p, mc,
// xdot)`, S float or a dual), whether it has an input box, its user
// constraint rows and their derivative order, per-lane weights (WRT),
// terminal box rows (TBOX) and per-stage input weights (RW), all compile-time
// properties of an instantiation (a runtime input-box flag cost the kinematic
// launch 12%, PERF.md); the state box, the reference and the multipliers'
// warm start are runtime. The instantiations, each behind its own entry:
//   - KinematicRows with ClearanceRows, the nine (vehicle circle, obstacle
//     circle) clearances c = (r_v + r_o)^2 - |center_i(x) - q_j|^2 <= 0 as
//     user rows after the input and state boxes (the reference's row order),
//     Euler, at derivative order 2 (the exact curvature sum_r act_r d2 c_r) and
//     1 (Gauss-Newton), each with the constant weights and with per-lane
//     weights (Qd, Rd, qn): the factory parking OCP;
//   - GatedKinematicRows in the additive input mode: x+ = step(x; exo_t) + u
//     with B = I, the ODE gamma f(x, u_model) driven by a per-stage exogenous
//     operand (gamma, u_model), RK4, no input box, the state box on x_0..x_N-1
//     and on x_N (terminal rows, multipliers in lam row N), per-stage input
//     weights: the nonlinear MHE windows.
// A constraint functor is `template <class S> static void rows(x, u, p, ec,
// out)` with NEXTRA rows depending on the NE z columns dep(0..NE-1) (z = x
// then u). Its gradient is one Dual<NE> pass, its curvature (order 2) one
// nested pass Dual<1, Dual<NE>> per dependency column q (column q of the
// Hessian and its p >= q half), the rows contracted with the frozen act
// first; these passes are dealt to the group's members beside the step
// Jacobians and stored per stage for the Riccati sweep, which every member
// runs alike.
//
// What bounds it: latency and the warp schedulers, not bytes or FLOPs (the
// factory parking launch at 2,048 lanes, N = 30, ~2% of its operation bound;
// the MHE windows ~1%: PERF.md). Built with nvcc -O3 for sm_90a,
// --fmad=false, without --use_fast_math: the transcendental functions and the
// divisions are the precise ones.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define NALPHA 7
#define MAXX 8   // largest state dimension (ops/cuda/ilqr_factory.py MAX_NX)
#define MAXU 8   // largest input dimension (MAX_NU)
#define MAXC 16  // model constants (MAX_CONSTS)
#define MAXE 16  // constraint-row constants (MAX_EXTRA_CONSTS)

// Threads per lane; one library is built per value (-DTRACKER_GROUP=G).
#ifndef TRACKER_GROUP
#define TRACKER_GROUP 1
#endif
constexpr int GROUP = TRACKER_GROUP;
static_assert(GROUP == 1 || GROUP == 8 || GROUP == 16 || GROUP == 32,
              "a group must divide the warp");
// Threads per CTA (tile x GROUP) the launch bounds allow; the wrapper reads it.
constexpr int MAX_THREADS = GROUP == 1 ? 256 : 512;

// Float constants, in the order ops/cuda/ilqr_factory.py::_consts writes them
// (the same layout for every model: state- and input-sized arrays padded).
struct Consts {
  float h, h_half, h_sixth;  // ts / substeps, 0.5 h, h / 6
  float qd[MAXX], rd[MAXU], qn;
  float qd2[MAXX], rd2[MAXU], qnqd2[MAXX];  // 2 Qd, 2 Rd, 2 qn Qd
  float lbu[MAXU], ubu[MAXU], lbx[MAXX], ubx[MAXX];
  float mu_init, mu_scale, mu_max, viol_tol, grad_tol;
  float alpha[NALPHA];
  float reg_init, reg_min, reg_max;
  float mc[MAXC];
  float ec[MAXE];  // the constraint rows' constants
  float tlbx[MAXX], tubx[MAXX];  // the terminal state box
};

struct Args {
  // (nx, Bp), (N, nu, Bp), (N+1, nx, Bp) or nullptr (regulation), (np, Bp)
  const float *x0, *u0, *refs, *par;
  // per-stage exogenous rows (N, nexo, Bp), per-stage input weights (N, nu,
  // Bp), per-lane weights (nx + nu + 1, Bp), the multipliers' warm start
  // (n_lam, nc, Bp); each nullptr where the instantiation or the call has none
  const float *exo, *rw, *wrt, *lam0;
  float *us, *xs, *viol, *conv, *lam, *ni;  // outputs; us, xs, lam are the state
  float* work;  // (rows, Bp): the workspace regions that are not in shared memory
  int N, substeps, sbox, outer, inner, Bp;
  int smask;  // bit r set: region r of a lane's working set lives in shared memory
};

// A lane's working set, by region, in the order the wrapper fills shared
// memory (ops/cuda/ilqr_factory.py regions). xs, us and lam have their home
// in the output buffers, refs, exo and rw in their operands; the A/B store,
// the gains, the candidates and the constraint rows' derivatives have theirs
// in `work`, in this order.
enum { R_AB, R_GAIN, R_XS, R_US, R_LAM, R_REF, R_CAND, R_EXO, R_RW, R_EXD, N_REGIONS };

// The sizes a lane's regions depend on: Jacobian columns nj (nx + nu, or nx in
// the additive mode), multiplier stages n_lam (N, or N + 1 with terminal
// rows), exogenous rows, per-stage input weights, the constraint rows'
// derivative record per stage. (The ref region holds nothing in regulation.)
struct Shape {
  int nx, nu, nj, N, nc, nlam, nexo, rw, nexd;
  bool track;
};

__host__ __device__ inline int region_floats(int r, const Shape& s) {
  switch (r) {
    case R_AB: return s.N * s.nx * s.nj;
    case R_GAIN: return s.N * s.nu * (1 + s.nx);
    case R_XS: return (s.N + 1) * s.nx;
    case R_REF: return s.track ? (s.N + 1) * s.nx : 0;
    case R_US: return s.N * s.nu;
    case R_LAM: return s.nlam * s.nc;
    case R_CAND: return NALPHA * ((s.N + 1) * s.nx + s.N * s.nu + 1);
    case R_EXO: return s.N * s.nexo;
    case R_RW: return s.rw ? s.N * s.nu : 0;
    default: return s.N * s.nexd;
  }
}

// Floats of one lane's block in shared memory: its regions in `smask`, padded
// to an odd count (neighbouring lanes then start on different banks).
__host__ __device__ inline int lane_floats(int smask, const Shape& s) {
  int n = 0;
  for (int r = 0; r < N_REGIONS; ++r)
    if (smask >> r & 1) n += region_floats(r, s);
  return n | 1;
}

// ---------------------------------------------------------------------------
// forward-mode dual numbers; the twin's Dual (ops/cuda/ilqr_factory.py)
// applies the same rules in the same order
// ---------------------------------------------------------------------------

// Dual<W, S>: a value and W tangents of scalar type S. S is float for the
// step Jacobians and the constraint rows' gradients, and Dual<NE> for their
// curvature (a tangent of a tangent: Dual<1, Dual<NE>>, whose inner tangent's
// tangent p is the second derivative along (p, q)). +, -, *, /, sin and cos
// take any S; the other rules float only.
template <int W, class S = float>
struct Dual {
  S v;
  S d[W];
};

template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator+(const Dual<W, S>& a, const Dual<W, S>& b) {
  Dual<W, S> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] + b.d[q];
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator+(const Dual<W, S>& a, float c) {
  Dual<W, S> r = a;
  r.v = a.v + c;
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator+(float c, const Dual<W, S>& a) {
  Dual<W, S> r = a;
  r.v = c + a.v;
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator-(const Dual<W, S>& a, const Dual<W, S>& b) {
  Dual<W, S> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] - b.d[q];
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator-(const Dual<W, S>& a, float c) {
  Dual<W, S> r = a;
  r.v = a.v - c;
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator-(float c, const Dual<W, S>& a) {
  Dual<W, S> r;
  r.v = c - a.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = -a.d[q];
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator*(const Dual<W, S>& a, const Dual<W, S>& b) {
  Dual<W, S> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] * b.v + a.v * b.d[q];
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator*(const Dual<W, S>& a, float c) {
  Dual<W, S> r;
  r.v = a.v * c;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] * c;
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator*(float c, const Dual<W, S>& a) {
  return a * c;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator/(const Dual<W, S>& a, const Dual<W, S>& b) {
  Dual<W, S> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = (a.d[q] - r.v * b.d[q]) / b.v;
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator/(const Dual<W, S>& a, float c) {
  Dual<W, S> r;
  r.v = a.v / c;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] / c;
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator-(const Dual<W, S>& a) {
  Dual<W, S> r;
  r.v = -a.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = -a.d[q];
  return r;
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> operator/(float c, const Dual<W, S>& a) {
  Dual<W, S> r;
  r.v = c / a.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = -(r.v * a.d[q]) / a.v;
  return r;
}

// tangent scaled by a weight: d <- d * w
template <int W, class S>
__device__ __forceinline__ Dual<W, S> scaled(const S& v, const Dual<W, S>& a, const S& w) {
  Dual<W, S> r;
  r.v = v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] * w;
  return r;
}

__device__ __forceinline__ float dsin(float a) { return sinf(a); }
__device__ __forceinline__ float dcos(float a) { return cosf(a); }
__device__ __forceinline__ float dtan(float a) { return tanf(a); }
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }

template <int W, class S>
__device__ __forceinline__ Dual<W, S> dsin(const Dual<W, S>& a) {
  return scaled(dsin(a.v), a, dcos(a.v));
}
template <int W, class S>
__device__ __forceinline__ Dual<W, S> dcos(const Dual<W, S>& a) {
  Dual<W, S> r;
  r.v = dcos(a.v);
  const S s = dsin(a.v);
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = -(a.d[q] * s);
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> dtan(const Dual<W>& a) {
  const float t = tanf(a.v);
  return scaled(t, a, 1.0f + t * t);
}
template <int W>
__device__ __forceinline__ Dual<W> dsqrt(const Dual<W>& a) {
  const float s = sqrtf(a.v);
  return scaled(s, a, 0.5f / s);
}
// ---------------------------------------------------------------------------
// models: the row functions of ops/cuda/parking_factory.py and
// models/bicycle.py, operation for operation (a float constant times a dual
// is the dual times the constant: the same product)
// ---------------------------------------------------------------------------

// What a model is unless it says otherwise: its input enters the ODE.
struct OdeModel {
  static constexpr bool ADD = false;  // the additive input mode
  static constexpr int NEXO = 0;  // exogenous rows per stage
};

// Kinematic bicycle, p = (acc, fric), mc = (kb, kb^2, 1 / lr).
struct KinematicRows : OdeModel {
  static constexpr int NX = 4, NU = 2, NP = 2;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* mc, S* f) {
    const S t = dtan(u[1]);
    const S den = dsqrt(1.0f + mc[1] * t * t);
    const S sinb = mc[0] * t / den;
    const S cosb = 1.0f / den;
    const S sp = dsin(x[2]), cp = dcos(x[2]);
    f[0] = x[3] * (cp * cosb - sp * sinb);
    f[1] = x[3] * (sp * cosb + cp * sinb);
    f[2] = x[3] * sinb * mc[2];
    f[3] = p[0] * u[0] - p[1] * x[3];
  }
};







// The gated kinematic bicycle of the nonlinear MHE windows, in the additive
// input mode (NU = NX: the decision inputs are process noises added after the
// step): the ODE is gamma f(x, u_model) with the exogenous stage rows e =
// (gamma, a, delta), so that a stage with gamma = 0 is exactly the identity
// and one with gamma = 1 exactly the model's step. Constant acceleration and
// friction, mc = (kb, kb^2, 1/lr, acc, fric) (models/bicycle.py
// make_kinematic_ode_rows, estimation_nl.py _gated_ode_rows).
struct GatedKinematicRows {
  static constexpr int NX = 4, NU = 4, NP = 0;
  static constexpr bool ADD = true;
  static constexpr int NEXO = 3;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const float* e, const float* p,
                                              const float* mc, S* f) {
    const float t = tanf(e[2]);
    const float den = sqrtf(1.0f + mc[1] * t * t);
    const float sinb = mc[0] * t / den;
    const float cosb = 1.0f / den;
    const S sp = dsin(x[2]), cp = dcos(x[2]);
    f[0] = e[0] * (x[3] * (cp * cosb - sp * sinb));
    f[1] = e[0] * (x[3] * (sp * cosb + cp * sinb));
    f[2] = e[0] * (x[3] * sinb * mc[2]);
    f[3] = e[0] * (mc[3] * e[1] - mc[4] * x[3]);
  }
};

// ---------------------------------------------------------------------------
// user constraint rows c(x, u[, p]) <= 0: NEXTRA rows, depending on the NE z
// columns dep(0..NE-1) (z = x then u), ec the rows' constants
// ---------------------------------------------------------------------------

struct NoRows {
  static constexpr int NEXTRA = 0, NE = 0;
  __host__ __device__ static constexpr int dep(int) { return -1; }
  template <class S>
  __device__ __forceinline__ static void rows(const S*, const S*, const float*, const float*,
                                              S*) {}
};

// The parking clearances (ops/cuda/parking_factory.py make_clearance_rows): for
// every (vehicle circle i, obstacle circle j) pair, r2 - |center_i(x) - q_j|^2,
// rows in (i, j) order; they depend on (px, py, psi) only. ec = (ox (3), r2,
// obs (3 x 2)).
struct ClearanceRows {
  static constexpr int NEXTRA = 9, NE = 3;
  __host__ __device__ static constexpr int dep(int k) { return k; }
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* ec, S* out) {
    const S sp = dsin(x[2]), cp = dcos(x[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const S cx = x[0] + ec[i] * cp;
      const S cy = x[1] + ec[i] * sp;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const S wx = cx - ec[4 + 2 * j];
        const S wy = cy - ec[5 + 2 * j];
        out[3 * i + j] = ec[3] - (wx * wx + wy * wy);
      }
    }
  }
};

// The position of z column `col` among the rows' dependencies, or -1.
template <class E>
__host__ __device__ constexpr int dep_pos(int col) {
  for (int k = 0; k < E::NE; ++k)
    if (E::dep(k) == col) return k;
  return -1;
}

// A problem: a model with its input box present (UBOX) or absent, user
// constraint rows E at derivative ORDER (2: exact curvature, 1: Gauss-Newton),
// per-lane weights (WRT), terminal state-box rows (TBOX), per-stage input
// weights (RW). All of them compile-time properties of the instantiation: a
// runtime input-box flag cost the kinematic launch 12% (PERF.md).
template <class Model, bool UBOX_, class Extra = NoRows, int ORDER_ = 0, bool WRT_ = false,
          bool TBOX_ = false, bool RW_ = false>
struct Problem : Model {
  static constexpr bool UBOX = UBOX_, WRT = WRT_, TBOX = TBOX_, RW = RW_;
  static constexpr int ORDER = ORDER_;
  using E = Extra;
  // constraint slots: u box, x box, user rows
  static constexpr int NR = 2 * Model::NU + 2 * Model::NX + Extra::NEXTRA;
  static constexpr int NJ = Model::ADD ? Model::NX : Model::NX + Model::NU;  // Jacobian columns
  static constexpr int TRI = Extra::NE * (Extra::NE + 1) / 2;  // pairs p <= q
  // the user rows' derivative record per stage: gradient (NE), Gauss-Newton
  // block (TRI), curvature (TRI, at order 2)
  static constexpr int NEXD = Extra::NEXTRA ? Extra::NE + TRI * (ORDER_ == 2 ? 2 : 1) : 0;
};

// ---------------------------------------------------------------------------
// the solver
// ---------------------------------------------------------------------------

// max that propagates NaN from either side (as jnp.maximum / torch.maximum)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// max(0, a) that keeps NaN (as jnp.maximum(0, a) / torch.clamp(a, min=0))
__device__ __forceinline__ float relu(float a) { return a < 0.0f ? 0.0f : a; }

// One prediction interval: `substeps` Euler or classic-RK4 sub-steps of the
// model, on values (S = float) or duals; U is the type of what drives the ODE
// (the input, or in the additive mode the stage's exogenous rows, floats).
// k1 + 2 k2 + 2 k3 + k4 is summed left to right, as in the reference.
template <class M, bool RK4, class S, class U>
__device__ __forceinline__ void step(const Consts& c, int substeps, S* x, const U* u,
                                     const float* p) {
  constexpr int NX = M::NX;
#pragma unroll 1
  for (int s = 0; s < substeps; ++s) {
    S k[NX];
    M::rows(x, u, p, c.mc, k);
    if (!RK4) {
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = x[i] + c.h * k[i];
    } else {
      S acc[NX], xs[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        acc[i] = k[i];
        xs[i] = x[i] + c.h_half * k[i];
      }
      M::rows(xs, u, p, c.mc, k);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        acc[i] = acc[i] + 2.0f * k[i];
        xs[i] = x[i] + c.h_half * k[i];
      }
      M::rows(xs, u, p, c.mc, k);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        acc[i] = acc[i] + 2.0f * k[i];
        xs[i] = x[i] + c.h * k[i];
      }
      M::rows(xs, u, p, c.mc, k);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        acc[i] = acc[i] + k[i];
        x[i] = x[i] + c.h_sixth * acc[i];
      }
    }
  }
}

// One region of a lane's working set: element i at p[i * stride] (stride 1 in
// the lane's shared-memory block, Bp in a [row][lane] global buffer).
struct Region {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int i) const { return p[(size_t)i * stride]; }
};

// A lane's weights where they are per lane (WRT): Qd, Rd, qn and the products
// the solver reads, 2 Qd, 2 Rd and (2 qn) Qd, in float32 as the reference
// forms them from its traced weight rows (ops/pallas/ilqr_factory.py:298-300,
// 699-707, 769-781). Without WRT the constants hold them.
template <class P>
struct LaneWeights {
  static constexpr int NX = P::WRT ? P::NX : 1, NU = P::WRT ? P::NU : 1;
  float qd[NX], qd2[NX], qnqd2[NX], rd[NU], rd2[NU], qn;
};

// A lane's views of its working set, its weights, and the problem's
// constraint rows: nc, the input box's 2 NU rows when `ubox` (compile-time,
// see Problem), the state box's 2 NX when `sbox`, then the user rows, in lam
// (a lane's local arrays keep every row at a fixed slot instead, see
// constraint_rows). With terminal rows lam has a row N: x_N - ub (NX), lb -
// x_N (NX), zeros to nc.
template <class P>
struct LaneView {
  static constexpr int NX = P::NX, NU = P::NU, NJ = P::NJ;
  static constexpr bool ubox = P::UBOX;
  Region ab, gain, xs, us, lam, ref, cand, exo, rw, exd;
  LaneWeights<P> wt;
  int nc, N;
  bool sbox;
  __device__ float& x(int t, int i) const { return xs[t * NX + i]; }
  __device__ float& u(int t, int j) const { return us[t * NU + j]; }
  __device__ float& l(int t, int r) const { return lam[t * nc + r]; }
  __device__ float r(int t, int i) const { return ref[t * NX + i]; }
  __device__ float& kg(int t, int j) const { return gain[t * NU + j]; }
  __device__ float& Kg(int t, int r) const { return gain[N * NU + t * NU * NX + r]; }
  // column col of the step Jacobian [A | B] of stage t ([A] in the additive
  // mode, where B = I), row k
  __device__ float& J(int t, int k, int col) const { return ab[(t * NX + k) * NJ + col]; }
  // candidate s of the line search: states, controls, cost (s fastest: the
  // members that write together write neighbouring words)
  __device__ float& cx(int s, int t, int i) const { return cand[(t * NX + i) * NALPHA + s]; }
  __device__ float& cu(int s, int t, int j) const {
    return cand[((N + 1) * NX + t * NU + j) * NALPHA + s];
  }
  __device__ float& cc(int s) const { return cand[((N + 1) * NX + N * NU) * NALPHA + s]; }
  __device__ float e(int t, int q) const { return exo[t * P::NEXO + q]; }  // exogenous row q
  __device__ float rwt(int t, int j) const { return rw[t * NU + j]; }  // stage t's Rd
  // word k of stage t's derivative record of the user rows (see extra_items)
  __device__ float& xd(int t, int k) const { return exd[t * P::NEXD + k]; }
};

// The weights a solve reads: from the lane (WRT), per stage for Rd (RW), or
// the constants.
template <class P>
__device__ __forceinline__ float w_qd(const Consts& c, const LaneView<P>& w, int i) {
  if constexpr (P::WRT) return w.wt.qd[i];
  else return c.qd[i];
}
template <class P>
__device__ __forceinline__ float w_qd2(const Consts& c, const LaneView<P>& w, int i) {
  if constexpr (P::WRT) return w.wt.qd2[i];
  else return c.qd2[i];
}
template <class P>
__device__ __forceinline__ float w_qnqd2(const Consts& c, const LaneView<P>& w, int i) {
  if constexpr (P::WRT) return w.wt.qnqd2[i];
  else return c.qnqd2[i];
}
template <class P>
__device__ __forceinline__ float w_qn(const Consts& c, const LaneView<P>& w) {
  if constexpr (P::WRT) return w.wt.qn;
  else return c.qn;
}
template <class P>
__device__ __forceinline__ float w_rd(const Consts& c, const LaneView<P>& w, int t, int j) {
  if constexpr (P::RW) return w.rwt(t, j);
  else if constexpr (P::WRT) return w.wt.rd[j];
  else return c.rd[j];
}
template <class P>
__device__ __forceinline__ float w_rd2(const Consts& c, const LaneView<P>& w, int t, int j) {
  if constexpr (P::RW) return 2.0f * w.rwt(t, j);
  else if constexpr (P::WRT) return w.wt.rd2[j];
  else return c.rd2[j];
}

// Phase boundary inside a lane's group: what a member wrote before it, every
// member reads after it. A group divides the warp, so the warp barrier does.
template <int G>
__device__ __forceinline__ void group_sync(unsigned mask) {
  if (G > 1) __syncwarp(mask);
}

// One interval from x under u at stage t: the model's step, or in the
// additive mode step(x; exo_t) + u.
template <class P, bool RK4>
__device__ __forceinline__ void advance(const Consts& c, const LaneView<P>& w, int t,
                                        int substeps, float* x, const float* u, const float* p) {
  if constexpr (P::ADD) {
    float e[P::NEXO];
#pragma unroll
    for (int q = 0; q < P::NEXO; ++q) e[q] = w.e(t, q);
    step<P, RK4>(c, substeps, x, e, p);
#pragma unroll
    for (int i = 0; i < P::NX; ++i) x[i] = x[i] + u[i];
  } else {
    step<P, RK4>(c, substeps, x, u, p);
  }
}

// Position (p <= q) of a pair of dependency columns in the triangle.
template <int NE>
__host__ __device__ constexpr int tri(int p, int q) {
  return p * NE - p * (p - 1) / 2 + (q - p);
}

// The user rows' derivative record of every stage at the stored (x_t, u_t),
// for the current multipliers and mu, dealt to the group's members with the
// Jacobians: per stage one item for the gradient sum_r act_r dc_r (word p:
// along dependency column p) and the Gauss-Newton block sum_r mu 1[act_r > 0]
// dc_r dc_r^T (words NE + tri(p, q), p <= q), from one Dual<NE> pass; at order
// 2 one item per column q for the curvature sum_r act_r d2c_r (words NE + TRI
// + tri(q, p), p >= q), from one pass of Dual<1, Dual<NE>> with the inner
// tangent along q, the rows contracted with the frozen act first (the
// reference's packed jvps, ops/pallas/ilqr_factory.py:597-686).
template <class P, int G>
__device__ __forceinline__ void extra_items(const Consts& c, const LaneView<P>& w, const float* p,
                                            float mu, int member) {
  using E = typename P::E;
  constexpr int NX = P::NX, NU = P::NU, NZ = NX + NU, NE = E::NE, M = E::NEXTRA, TRI = P::TRI;
  constexpr int PER = 1 + (P::ORDER == 2 ? NE : 0);
  const int base = (P::UBOX ? 2 * NU : 0) + (w.sbox ? 2 * NX : 0);  // the rows' first multiplier
  const int items = w.N * PER;
#pragma unroll 1
  for (int item = member; item < items; item += G) {
    const int t = item / PER, k = item - t * PER;
    float z[NZ];
#pragma unroll
    for (int i = 0; i < NX; ++i) z[i] = w.x(t, i);
#pragma unroll
    for (int j = 0; j < NU; ++j) z[NX + j] = w.u(t, j);
    if (k == 0) {
      Dual<NE> zd[NZ];
#pragma unroll
      for (int col = 0; col < NZ; ++col) {
        zd[col].v = z[col];
#pragma unroll
        for (int q = 0; q < NE; ++q) zd[col].d[q] = E::dep(q) == col ? 1.0f : 0.0f;
      }
      Dual<NE> out[M];
      E::rows(zd, zd + NX, p, c.ec, out);
      float act[M], ind[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        act[r] = relu(w.l(t, base + r) + mu * out[r].v);
        ind[r] = mu * (act[r] > 0.0f ? 1.0f : 0.0f);
      }
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        float s = act[0] * out[0].d[q];
#pragma unroll
        for (int r = 1; r < M; ++r) s = s + act[r] * out[r].d[q];
        w.xd(t, q) = s;
      }
#pragma unroll
      for (int a = 0; a < NE; ++a) {
#pragma unroll
        for (int b = a; b < NE; ++b) {
          float s = (ind[0] * out[0].d[a]) * out[0].d[b];
#pragma unroll
          for (int r = 1; r < M; ++r) s = s + (ind[r] * out[r].d[a]) * out[r].d[b];
          w.xd(t, NE + tri<NE>(a, b)) = s;
        }
      }
    } else {
      if constexpr (P::ORDER == 2) {
        using H = Dual<1, Dual<NE>>;
        const int q = k - 1;
        H zh[NZ];
#pragma unroll
        for (int col = 0; col < NZ; ++col) {
          zh[col].v.v = z[col];
          zh[col].d[0].v = E::dep(q) == col ? 1.0f : 0.0f;
#pragma unroll
          for (int a = 0; a < NE; ++a) {
            zh[col].v.d[a] = E::dep(a) == col ? 1.0f : 0.0f;
            zh[col].d[0].d[a] = 0.0f;
          }
        }
        H out[M];
        E::rows(zh, zh + NX, p, c.ec, out);
        H ws = out[0] * relu(w.l(t, base) + mu * out[0].v.v);
#pragma unroll
        for (int r = 1; r < M; ++r) ws = ws + out[r] * relu(w.l(t, base + r) + mu * out[r].v.v);
#pragma unroll
        for (int a = 0; a < NE; ++a)
          if (a >= q) w.xd(t, NE + TRI + tri<NE>(q, a)) = ws.d[0].d[a];
      }
    }
  }
}

// What the Riccati sweep reads besides the trajectory, at the stored (x_t,
// u_t) of all N stages: the step Jacobians J(t, k, i) = dx+_k / dx_i for i <
// nx, dx+_k / du_j at column nx + j (the N nj (stage, direction) items dealt
// to the group's members, each one Dual<1> pass through the integrator), and
// the user rows' derivative record.
template <class P, bool RK4, int G>
__device__ __forceinline__ void prepass(const Consts& c, const LaneView<P>& w, const float* p,
                                        int substeps, float mu, int member) {
  constexpr int NX = P::NX, NU = P::NU, NJ = P::NJ;
  const int items = w.N * NJ;
#pragma unroll 1
  for (int item = member; item < items; item += G) {
    const int t = item / NJ, col = item - t * NJ;
    Dual<1> xd[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      xd[i].v = w.x(t, i);
      xd[i].d[0] = col == i ? 1.0f : 0.0f;
    }
    if constexpr (P::ADD) {
      float e[P::NEXO];
#pragma unroll
      for (int q = 0; q < P::NEXO; ++q) e[q] = w.e(t, q);
      step<P, RK4>(c, substeps, xd, e, p);
    } else {
      Dual<1> ud[NU];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        ud[j].v = w.u(t, j);
        ud[j].d[0] = col == NX + j ? 1.0f : 0.0f;
      }
      step<P, RK4>(c, substeps, xd, ud, p);
    }
#pragma unroll
    for (int k = 0; k < NX; ++k) w.J(t, k, col) = xd[k].d[0];
  }
  if constexpr (P::E::NEXTRA > 0) extra_items<P, G>(c, w, p, mu, member);
}

// Constraint rows in the reference's order at fixed slots: u - ub (nu), lb -
// u (nu), then x - ub (nx), lb - x (nx), whether or not each box is present
// (a slot indexed at compile time keeps the local arrays in registers; the
// slots of an absent box are never read), then the user rows.
template <class P>
__device__ __forceinline__ void constraint_rows(const Consts& c, const float* x, const float* u,
                                                const float* p, float* cr) {
  constexpr int NX = P::NX, NU = P::NU;
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[j] = u[j] - c.ubu[j];
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[NU + j] = c.lbu[j] - u[j];
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[2 * NU + i] = x[i] - c.ubx[i];
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[2 * NU + NX + i] = c.lbx[i] - x[i];
  if constexpr (P::E::NEXTRA > 0) P::E::rows(x, u, p, c.ec, cr + 2 * NU + 2 * NX);
}

// Whether slot q is a row of this solve, and its row in lam.
template <class P>
__device__ __forceinline__ bool present(const LaneView<P>& w, int q) {
  return q < 2 * P::NU ? P::UBOX : (q < 2 * P::NU + 2 * P::NX ? w.sbox : true);
}
template <class P>
__device__ __forceinline__ int lam_row(const LaneView<P>& w, int q) {
  constexpr int NX = P::NX, NU = P::NU;
  if (q < 2 * NU) return q;
  const int o = P::UBOX ? 2 * NU : 0;  // lam's row of the first slot after the input box
  if (q < 2 * NU + 2 * NX) return o + (q - 2 * NU);
  return o + (w.sbox ? 2 * NX : 0) + (q - 2 * NU - 2 * NX);
}

template <class P>
__device__ __forceinline__ float quad_err(const Consts& c, const LaneView<P>& w, const float* x,
                                          const float* r) {
  float q = w_qd(c, w, 0) * (x[0] - r[0]) * (x[0] - r[0]);
#pragma unroll
  for (int i = 1; i < P::NX; ++i) q = q + w_qd(c, w, i) * (x[i] - r[i]) * (x[i] - r[i]);
  return q;
}

// Tracking cost plus the AL penalty sum_r (act_r^2 - lam_r^2) / (2 mu).
template <class P>
__device__ __forceinline__ float stage_cost(const Consts& c, const LaneView<P>& w, int t,
                                            const float* x, const float* u, const float* r,
                                            const float* lam, float mu, const float* p) {
  constexpr int NU = P::NU;
  float cr[P::NR];
  constraint_rows<P>(c, x, u, p, cr);
  float ru = w_rd(c, w, t, 0) * u[0] * u[0];
#pragma unroll
  for (int j = 1; j < NU; ++j) ru = ru + w_rd(c, w, t, j) * u[j] * u[j];
  const float quad = quad_err(c, w, x, r) + ru;
  // phi starts at 0: a term is never -0 (act^2 - lam^2 with act, lam >= 0),
  // so 0 + term has the term's bits, as the twin's sum from its first row
  float phi = 0.0f;
#pragma unroll
  for (int q = 0; q < P::NR; ++q) {
    if (present(w, q)) {
      const float act = relu(lam[q] + mu * cr[q]);
      phi = phi + (act * act - lam[q] * lam[q]);
    }
  }
  return quad + phi / (2.0f * mu);
}

// qn (x - ref)' Qd (x - ref) at x_N, plus the terminal rows' AL penalty.
template <class P>
__device__ __forceinline__ float terminal_cost(const Consts& c, const LaneView<P>& w,
                                               const float* x, const float* r, float mu) {
  float tc = w_qn(c, w) * quad_err(c, w, x, r);
  if constexpr (P::TBOX) {
    constexpr int NX = P::NX;
    float phi = 0.0f;
#pragma unroll
    for (int q = 0; q < 2 * NX; ++q) {
      const float cr = q < NX ? x[q] - c.tubx[q] : c.tlbx[q - NX] - x[q - NX];
      const float l = w.l(w.N, q);
      const float act = relu(l + mu * cr);
      phi = phi + (act * act - l * l);
    }
    tc = tc + phi / (2.0f * mu);
  }
  return tc;
}

template <class P>
__device__ __forceinline__ void load_x(const LaneView<P>& w, int t, float* x) {
#pragma unroll
  for (int i = 0; i < P::NX; ++i) x[i] = w.x(t, i);
}
template <class P>
__device__ __forceinline__ void load_u(const LaneView<P>& w, int t, float* u) {
#pragma unroll
  for (int j = 0; j < P::NU; ++j) u[j] = w.u(t, j);
}
template <class P>
__device__ __forceinline__ void load_r(const LaneView<P>& w, int t, float* r) {
#pragma unroll
  for (int i = 0; i < P::NX; ++i) r[i] = w.r(t, i);
}
// A stage's multipliers at constraint_rows' fixed slots (0 where a box is
// absent); lam holds the present rows only.
template <class P>
__device__ __forceinline__ void load_lam(const LaneView<P>& w, int t, float* l) {
#pragma unroll
  for (int q = 0; q < P::NR; ++q) l[q] = present(w, q) ? w.l(t, lam_row(w, q)) : 0.0f;
}

template <class P>
__device__ __forceinline__ float total_cost(const Consts& c, const LaneView<P>& w, float mu,
                                            const float* p) {
  float x[P::NX], u[P::NU], r[P::NX], l[P::NR];
  float cost = 0.0f;
  for (int t = 0; t < w.N; ++t) {
    load_x(w, t, x);
    load_u(w, t, u);
    load_r(w, t, r);
    load_lam(w, t, l);
    const float sc = stage_cost(c, w, t, x, u, r, l, mu, p);
    cost = t == 0 ? sc : cost + sc;
  }
  load_x(w, w.N, x);
  load_r(w, w.N, r);
  return cost + terminal_cost(c, w, x, r, mu);
}

// The regularised Quu solve of one stage, in the reference's three forms:
// kg = -Quu_r^-1 Qu and Kg = -Quu_r^-1 Qux; returns whether Quu_r was found
// positive definite (nu = 1: q > 0; nu = 2: q00 > 0 and det > 0; beyond:
// every Cholesky pivot > 0).
template <int NX, int NU>
__device__ __forceinline__ bool quu_solve(const float (&quu)[NU][NU], float reg,
                                          const float* Qu, const float (&Qux)[NU][NX],
                                          float* kg, float (&Kg)[NU][NX]) {
  if constexpr (NU <= 2) {
    float inv[NU][NU];
    bool ok;
    if constexpr (NU == 1) {
      const float q00r = quu[0][0] + reg;
      ok = q00r > 0.0f;
      const float det_safe = q00r > 0.0f ? q00r : 1.0f;
      inv[0][0] = 1.0f / det_safe;
    } else {  // closed form
      const float q00r = quu[0][0] + reg;
      const float q11r = quu[1][1] + reg;
      const float q01 = quu[0][1];
      const float det = q00r * q11r - q01 * q01;
      ok = (q00r > 0.0f) && (det > 0.0f);
      const float det_safe = det > 0.0f ? det : 1.0f;
      inv[0][0] = q11r / det_safe;
      inv[0][1] = -q01 / det_safe;
      inv[1][0] = -q01 / det_safe;
      inv[1][1] = q00r / det_safe;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float s = inv[a][0] * Qu[0];
#pragma unroll
      for (int b = 1; b < NU; ++b) s = s + inv[a][b] * Qu[b];
      kg[a] = -s;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float sj = inv[a][0] * Qux[0][j];
#pragma unroll
        for (int b = 1; b < NU; ++b) sj = sj + inv[a][b] * Qux[b][j];
        Kg[a][j] = -sj;
      }
    }
    return ok;
  } else {
    // unrolled Cholesky of Quu + reg I: L L^T, with a safe pivot where it is not
    // positive
    float L[NU][NU];
    bool ok = true;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        float s = a == b ? quu[a][b] + reg : quu[a][b];
#pragma unroll
        for (int v = 0; v < b; ++v) s = s - L[a][v] * L[b][v];
        if (a == b) {
          ok = ok && s > 0.0f;
          L[a][a] = sqrtf(s > 0.0f ? s : 1.0f);
        } else {
          L[a][b] = s / L[b][b];
        }
      }
    }
    // the forward then the backward sweep, for Qu and each column of Qux
#pragma unroll
    for (int col = 0; col <= NX; ++col) {
      float y[NU], sol[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float s = col == 0 ? Qu[a] : Qux[a][col - 1];
#pragma unroll
        for (int v = 0; v < a; ++v) s = s - L[a][v] * y[v];
        y[a] = s / L[a][a];
      }
#pragma unroll
      for (int a = NU - 1; a >= 0; --a) {
        float s = y[a];
#pragma unroll
        for (int v = a + 1; v < NU; ++v) s = s - L[v][a] * sol[v];
        sol[a] = s / L[a][a];
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        if (col == 0) kg[a] = -sol[a];
        else Kg[a][col - 1] = -sol[a];
      }
    }
    return ok;
  }
}

// A second-derivative entry of the user rows at dependency positions (a, b):
// base + Gauss-Newton term (+ curvature term at order 2), added in the
// reference's order (every Gauss-Newton entry, then every curvature entry;
// ops/pallas/ilqr_factory.py:584-596, 653-686).
template <class P>
__device__ __forceinline__ float extra_h(const float* xg, float base, int a, int b) {
  constexpr int NE = P::E::NE, TRI = P::TRI;
  const int k = a <= b ? tri<NE>(a, b) : tri<NE>(b, a);
  float h = base + xg[NE + k];
  if constexpr (P::ORDER == 2) h = h + xg[NE + TRI + k];
  return h;
}

// Riccati sweep over the stored trajectory, its stored step Jacobians and
// the user rows' derivative records; returns whether every stage's
// regularised Quu was positive definite, and max|Qu|. Every member of the
// group computes it alike; `store` (one member) writes the gains. An entry of
// the stage Hessian that no term reaches is left out, as the reference leaves
// out its absent dictionary keys.
template <class P>
__device__ __forceinline__ void backward(const Consts& c, const LaneView<P>& w, float mu,
                                         float reg, bool store, bool& ok_out, float& grad_out) {
  constexpr int NX = P::NX, NU = P::NU;
  using E = typename P::E;
  constexpr int NE = E::NE;
  const int N = w.N;
  float Vx[NX], V[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = w_qnqd2(c, w, i) * (w.x(N, i) - w.r(N, i));
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = i == j ? w_qnqd2(c, w, i) : 0.0f;
  }
  if constexpr (P::TBOX) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float xi = w.x(N, i);
      const float act_u = relu(w.l(N, i) + mu * (xi - c.tubx[i]));
      const float act_l = relu(w.l(N, NX + i) + mu * (c.tlbx[i] - xi));
      Vx[i] = Vx[i] + (act_u - act_l);
      const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
      V[i][i] = V[i][i] + mu * ind;
    }
  }
  bool ok = true;
  float grad = 0.0f;
  for (int t = N - 1; t >= 0; --t) {
    float X[NX], U[NU], R[NX], L[P::NR];
    load_x(w, t, X);
    load_u(w, t, U);
    load_r(w, t, R);
    load_lam(w, t, L);
    float A[NX][NX], Bm[NX][P::ADD ? 1 : NU];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
#pragma unroll
      for (int i = 0; i < NX; ++i) A[k][i] = w.J(t, k, i);
      if constexpr (!P::ADD) {
#pragma unroll
        for (int j = 0; j < NU; ++j) Bm[k][j] = w.J(t, k, NX + j);
      }
    }

    // stage derivatives: the tracking cost and the box rows (diagonal)
    float lx[NX], hxx[NX], lu[NU], huu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      lx[i] = w_qd2(c, w, i) * (X[i] - R[i]);
      hxx[i] = w_qd2(c, w, i);
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      lu[j] = w_rd2(c, w, t, j) * U[j];
      huu[j] = w_rd2(c, w, t, j);
      if (w.ubox) {
        const float act_u = relu(L[j] + mu * (U[j] - c.ubu[j]));
        const float act_l = relu(L[NU + j] + mu * (c.lbu[j] - U[j]));
        lu[j] = lu[j] + act_u - act_l;
        const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
        huu[j] = w_rd2(c, w, t, j) + mu * ind;
      }
    }
    if (w.sbox) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const float act_u = relu(L[2 * NU + i] + mu * (X[i] - c.ubx[i]));
        const float act_l = relu(L[2 * NU + NX + i] + mu * (c.lbx[i] - X[i]));
        lx[i] = lx[i] + (act_u - act_l);
        const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
        hxx[i] = hxx[i] + mu * ind;
      }
    }
    // the user rows: gradient, then the diagonal entries of their
    // second-derivative terms (the other entries are added where they are used)
    float xg[P::NEXD > 0 ? P::NEXD : 1];
    if constexpr (NE > 0) {
#pragma unroll
      for (int k = 0; k < P::NEXD; ++k) xg[k] = w.xd(t, k);
#pragma unroll
      for (int a = 0; a < NE; ++a) {
        const int d = E::dep(a);
        if (d < NX) {
          lx[d] = lx[d] + xg[a];
          hxx[d] = extra_h<P>(xg, hxx[d], a, a);
        } else {
          lu[d - NX] = lu[d - NX] + xg[a];
          huu[d - NX] = extra_h<P>(xg, huu[d - NX], a, a);
        }
      }
    }

    // Qx = lx + A^T Vx, Qu = lu + B^T Vx (B = I in the additive mode)
    float Qx[NX], Qu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = lx[i];
#pragma unroll
      for (int k = 0; k < NX; ++k) s = s + A[k][i] * Vx[k];
      Qx[i] = s;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      if constexpr (P::ADD) {
        Qu[j] = lu[j] + Vx[j];
      } else {
        float s = lu[j];
#pragma unroll
        for (int k = 0; k < NX; ++k) s = s + Bm[k][j] * Vx[k];
        Qu[j] = s;
      }
    }
    float VB[NX][P::ADD ? 1 : NU];
    if constexpr (!P::ADD) {
      // VB = Vxx B
#pragma unroll
      for (int k = 0; k < NX; ++k) {
#pragma unroll
        for (int b = 0; b < NU; ++b) {
          float s = V[k][0] * Bm[0][b];
#pragma unroll
          for (int m = 1; m < NX; ++m) s = s + V[k][m] * Bm[m][b];
          VB[k][b] = s;
        }
      }
    }
    // M = Vxx A
    float Mm[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = V[i][0] * A[0][j];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + V[i][k] * A[k][j];
        Mm[i][j] = s;
      }
    }
    float quu[NU][NU], Qux[NU][NX];
    if constexpr (P::ADD) {
      // B = I: Quu = luu + Vxx, Qux = lux + M (before Vxx is overwritten)
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int b = 0; b < NU; ++b) {
          const int pa = dep_pos<E>(NX + a), pb = dep_pos<E>(NX + b);
          quu[a][b] = a == b ? huu[a] + V[a][b]
                      : (pa >= 0 && pb >= 0 ? extra_h<P>(xg, 0.0f, pa, pb) + V[a][b] : V[a][b]);
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const int pa = dep_pos<E>(NX + a), pj = dep_pos<E>(j);
          Qux[a][j] = pa >= 0 && pj >= 0 ? extra_h<P>(xg, 0.0f, pj, pa) + Mm[a][j] : Mm[a][j];
        }
      }
    }
    // Qxx = lxx + sym(A^T M) (written into V, which is no longer needed)
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j) {
        float vij = A[0][i] * Mm[0][j], vji = A[0][j] * Mm[0][i];
#pragma unroll
        for (int k = 1; k < NX; ++k) {
          vij = vij + A[k][i] * Mm[k][j];
          vji = vji + A[k][j] * Mm[k][i];
        }
        const float sym = 0.5f * (vij + vji);
        const int pi = dep_pos<E>(i), pj = dep_pos<E>(j);
        V[i][j] = i == j ? sym + hxx[i]
                  : (pi >= 0 && pj >= 0 ? sym + extra_h<P>(xg, 0.0f, pi, pj) : sym);
        V[j][i] = V[i][j];
      }
    }
    if constexpr (!P::ADD) {
      // Quu = luu + B^T Vxx B, Qux = lux + B^T M
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int b = 0; b < NU; ++b) {
          const int pa = dep_pos<E>(NX + a), pb = dep_pos<E>(NX + b);
          float s = a == b ? huu[a] + Bm[0][a] * VB[0][b]
                    : (pa >= 0 && pb >= 0 ? extra_h<P>(xg, 0.0f, pa, pb) + Bm[0][a] * VB[0][b]
                                          : Bm[0][a] * VB[0][b]);
#pragma unroll
          for (int k = 1; k < NX; ++k) s = s + Bm[k][a] * VB[k][b];
          quu[a][b] = s;
        }
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const int pa = dep_pos<E>(NX + a), pj = dep_pos<E>(j);
          float s = pa >= 0 && pj >= 0 ? extra_h<P>(xg, 0.0f, pj, pa) + Bm[0][a] * Mm[0][j]
                                       : Bm[0][a] * Mm[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) s = s + Bm[k][a] * Mm[k][j];
          Qux[a][j] = s;
        }
      }
    }
    float kg[NU], Kg[NU][NX];
    ok = quu_solve<NX, NU>(quu, reg, Qu, Qux, kg, Kg) && ok;
    // Vx, Vxx with the unregularised Quu
    float g[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float s = quu[a][0] * kg[0];
#pragma unroll
      for (int b = 1; b < NU; ++b) s = s + quu[a][b] * kg[b];
      g[a] = s + Qu[a];
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s1 = Kg[0][j] * g[0], s2 = Qux[0][j] * kg[0];
#pragma unroll
      for (int a = 1; a < NU; ++a) {
        s1 = s1 + Kg[a][j] * g[a];
        s2 = s2 + Qux[a][j] * kg[a];
      }
      Vx[j] = (Qx[j] + s1) + s2;
    }
    float KQ[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = quu[a][0] * Kg[0][j];
#pragma unroll
        for (int b = 1; b < NU; ++b) s = s + quu[a][b] * Kg[b][j];
        KQ[a][j] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s1 = Kg[0][i] * KQ[0][j], s2 = Kg[0][i] * Qux[0][j], s3 = Qux[0][i] * Kg[0][j];
#pragma unroll
        for (int a = 1; a < NU; ++a) {
          s1 = s1 + Kg[a][i] * KQ[a][j];
          s2 = s2 + Kg[a][i] * Qux[a][j];
          s3 = s3 + Qux[a][i] * Kg[a][j];
        }
        V[i][j] = ((V[i][j] + s1) + s2) + s3;
      }
    }
    if (store) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        w.kg(t, a) = kg[a];
#pragma unroll
        for (int j = 0; j < NX; ++j) w.Kg(t, a * NX + j) = Kg[a][j];
      }
    }
    float gq = fabsf(Qu[0]);
#pragma unroll
    for (int a = 1; a < NU; ++a) gq = nmax(gq, fabsf(Qu[a]));
    grad = nmax(grad, gq);
  }
  ok_out = ok;
  grad_out = grad;
}

// Control of one line-search candidate at a stage: u = (uh + alpha k) + K dx.
template <int NX, int NU>
__device__ __forceinline__ void ls_control(float alpha, const float* xh, const float* uh,
                                           const float* kg, const float* Kg, const float* x,
                                           float* u) {
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = x[i] - xh[i];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    float s = Kg[a * NX] * dx[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) s = s + Kg[a * NX + j] * dx[j];
    u[a] = (uh[a] + alpha * kg[a]) + s;
  }
}

template <class P>
__device__ __forceinline__ void load_stage(const LaneView<P>& w, int t, float* xh, float* uh,
                                           float* kg, float* Kg) {
  load_x(w, t, xh);
#pragma unroll
  for (int j = 0; j < P::NU; ++j) {
    uh[j] = w.u(t, j);
    kg[j] = w.kg(t, j);
  }
#pragma unroll
  for (int q = 0; q < P::NU * P::NX; ++q) Kg[q] = w.Kg(t, q);
}

// The closed-loop rollouts of the line search, one candidate per member
// (members 0..6 at G >= 8): candidate s keeps its trajectory in cx / cu and
// its cost, summed in stage order, in cc.
template <class P, bool RK4, int G>
__device__ __forceinline__ void rollouts(const Consts& c, const LaneView<P>& w, const float* x0,
                                         const float* p, int substeps, float mu, int member) {
  constexpr int NX = P::NX, NU = P::NU;
#pragma unroll 1
  for (int s = member; s < NALPHA; s += G) {
    const float alpha = c.alpha[s];
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    float cost = 0.0f;
    float xh[NX], uh[NU], kg[NU], Kg[NU * NX], r[NX], l[P::NR];
#pragma unroll 1
    for (int t = 0; t < w.N; ++t) {
      load_stage(w, t, xh, uh, kg, Kg);
      load_r(w, t, r);
      load_lam(w, t, l);
      float u[NU];
      ls_control<NX, NU>(alpha, xh, uh, kg, Kg, x, u);
#pragma unroll
      for (int i = 0; i < NX; ++i) w.cx(s, t, i) = x[i];
#pragma unroll
      for (int j = 0; j < NU; ++j) w.cu(s, t, j) = u[j];
      const float sc = stage_cost(c, w, t, x, u, r, l, mu, p);
      cost = t == 0 ? sc : cost + sc;
      advance<P, RK4>(c, w, t, substeps, x, u, p);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) w.cx(s, w.N, i) = x[i];
    load_r(w, w.N, r);
    w.cc(s) = cost + terminal_cost(c, w, x, r, mu);
  }
}

// Row q of the box constraints at stage t (constraint_rows' order and
// operations), for a problem with box rows only.
template <class P>
__device__ __forceinline__ float constraint_row(const Consts& c, const LaneView<P>& w, int t,
                                                int q) {
  constexpr int NX = P::NX, NU = P::NU;
  if (w.ubox) {
    if (q < NU) return w.u(t, q) - c.ubu[q];
    if (q < 2 * NU) return c.lbu[q - NU] - w.u(t, q - NU);
    q -= 2 * NU;
  }
  if (q < NX) return w.x(t, q) - c.ubx[q];
  return c.lbx[q - NX] - w.x(t, q - NX);
}

// Row q of the terminal box at x_N: x_N - ub (q < NX), lb - x_N.
template <class P>
__device__ __forceinline__ float terminal_row(const Consts& c, const LaneView<P>& w, int q) {
  constexpr int NX = P::NX;
  return q < NX ? w.x(w.N, q) - c.tubx[q] : c.tlbx[q - NX] - w.x(w.N, q - NX);
}

template <class P>
__host__ __device__ inline Shape shape_of(int N, int nc, bool track) {
  return Shape{P::NX, P::NU, P::NJ, N, nc, P::TBOX ? N + 1 : N, P::NEXO, P::RW ? 1 : 0, P::NEXD,
               track};
}

extern __shared__ float lane_blocks[];  // T blocks of lane_floats() floats
// The reference of a regulated lane: every entry reads this 0 (x - 0 has the
// bits of x, so regulation is tracking a zero reference).
__device__ float zero_ref = 0.0f;

template <class P, bool RK4, int G>
__global__ void __launch_bounds__(MAX_THREADS) tracker_tile_kernel(const Args g, const Consts c) {
  constexpr int NX = P::NX, NU = P::NU, NP = P::NP > 0 ? P::NP : 1;
  const int member = threadIdx.x % G, slot = threadIdx.x / G;
  const int lane = blockIdx.x * (blockDim.x / G) + slot;
  // the threads of this warp: all of them are here, none has diverged yet
  const unsigned warp = G > 1 ? __activemask() : 0u;
  const int Bp = g.Bp, N = g.N;
  const bool track = g.refs != nullptr;

  // place the regions: in the lane's shared block, in its home, or in `work`
  LaneView<P> w;
  w.sbox = g.sbox != 0;
  w.nc = (w.ubox ? 2 * NU : 0) + (w.sbox ? 2 * NX : 0) + P::E::NEXTRA;
  w.N = N;
  const int nc = w.nc, nlam = P::TBOX ? N + 1 : N;
  const Shape sh = shape_of<P>(N, nc, track);
  float* const block = lane_blocks + (size_t)slot * lane_floats(g.smask, sh);
  int in_block = 0, in_work = 0;
  auto place = [&](int r, float* home) {  // called once per region, in region order
    const int n = region_floats(r, sh);
    Region v;
    if (g.smask >> r & 1) {
      v = Region{block + in_block, 1};
      in_block += n;
    } else if (home != nullptr) {
      v = Region{home + lane, Bp};
    } else {
      v = Region{g.work + (size_t)in_work * Bp + lane, Bp};
      in_work += n;
    }
    return v;
  };
  w.ab = place(R_AB, nullptr);
  w.gain = place(R_GAIN, nullptr);
  w.xs = place(R_XS, g.xs);
  w.us = place(R_US, g.us);
  w.lam = place(R_LAM, g.lam);
  w.ref = track ? place(R_REF, const_cast<float*>(g.refs)) : Region{&zero_ref, 0};
  w.cand = place(R_CAND, nullptr);
  w.exo = place(R_EXO, const_cast<float*>(g.exo));
  w.rw = place(R_RW, const_cast<float*>(g.rw));
  w.exd = place(R_EXD, nullptr);
  if constexpr (P::WRT) {
    // the lane's weights and the products the solver reads
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      w.wt.rd[j] = g.wrt[(size_t)(NX + j) * Bp + lane];
      w.wt.rd2[j] = 2.0f * w.wt.rd[j];
    }
    w.wt.qn = g.wrt[(size_t)(NX + NU) * Bp + lane];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      w.wt.qd[i] = g.wrt[(size_t)i * Bp + lane];
      w.wt.qd2[i] = 2.0f * w.wt.qd[i];
      w.wt.qnqd2[i] = (2.0f * w.wt.qn) * w.wt.qd[i];
    }
  }
  float p[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) p[q] = P::NP > 0 ? g.par[q * Bp + lane] : 0.0f;
  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = g.x0[i * Bp + lane];

  // init: controls from the warm start, multipliers from theirs (zero
  // without one), the operands kept in shared memory into their regions,
  // then a rollout (a chain: one member)
  for (int i = member; i < N * NU; i += G) w.us[i] = g.u0[(size_t)i * Bp + lane];
  for (int i = member; i < nlam * nc; i += G)
    w.lam[i] = g.lam0 != nullptr ? g.lam0[(size_t)i * Bp + lane] : 0.0f;
  if (track && (g.smask >> R_REF & 1))
    for (int i = member; i < (N + 1) * NX; i += G) w.ref[i] = g.refs[(size_t)i * Bp + lane];
  if constexpr (P::ADD) {
    if (g.smask >> R_EXO & 1)
      for (int i = member; i < N * P::NEXO; i += G) w.exo[i] = g.exo[(size_t)i * Bp + lane];
  }
  if constexpr (P::RW) {
    if (g.smask >> R_RW & 1)
      for (int i = member; i < N * NU; i += G) w.rw[i] = g.rw[(size_t)i * Bp + lane];
  }
  group_sync<G>(warp);
  if (member == 0) {
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    for (int t = 0; t < N; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w.x(t, i) = x[i];
      load_u(w, t, u);
      advance<P, RK4>(c, w, t, g.substeps, x, u, p);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) w.x(N, i) = x[i];
  }
  group_sync<G>(warp);

  // mu, viol, lam_step, cost, reg, grad and the counters are computed by
  // every member alike, so both votes see a lane's value G times
  float mu = c.mu_init, viol = INFINITY, lam_step = INFINITY;
  int ni_total = 0;
  for (int oi = 0; oi < g.outer; ++oi) {
    if (__syncthreads_and((viol < c.viol_tol) && (lam_step < 1e-3f))) break;
    // inner Levenberg-iLQR on the current multipliers
    float cost = total_cost(c, w, mu, p);
    float reg = c.reg_init, grad = INFINITY;
    int it = 0;
    for (; it < g.inner; ++it) {
      if (__syncthreads_and(grad < c.grad_tol)) break;
      prepass<P, RK4, G>(c, w, p, g.substeps, mu, member);
      group_sync<G>(warp);
      bool ok;
      backward(c, w, mu, reg, member == 0, ok, grad);
      group_sync<G>(warp);
      rollouts<P, RK4, G>(c, w, x0, p, g.substeps, mu, member);
      group_sync<G>(warp);
      float costs[NALPHA];
      float best = INFINITY;
#pragma unroll
      for (int s = 0; s < NALPHA; ++s) {
        costs[s] = w.cc(s);
        if (!isfinite(costs[s])) costs[s] = INFINITY;
        best = fminf(best, costs[s]);
      }
      int pick = 0;  // ties go to the largest step: the first at the minimum
#pragma unroll
      for (int s = NALPHA - 1; s >= 0; --s)
        if (costs[s] <= best) pick = s;
      const bool improved = (best < cost - 1e-12f) && ok;
      if (improved) {
        // the accepted candidate becomes the trajectory
        for (int i = member; i < (N + 1) * NX; i += G) w.xs[i] = w.cand[i * NALPHA + pick];
        for (int i = member; i < N * NU; i += G)
          w.us[i] = w.cand[((N + 1) * NX + i) * NALPHA + pick];
        cost = best;
        reg = fmaxf(reg * 0.5f, c.reg_min);
      } else {
        reg = fminf(reg * 10.0f, c.reg_max);
      }
      group_sync<G>(warp);
    }
    ni_total += it;
    // multiplier sweep: violation, lam step (every member), then the lam
    // update dealt by (stage, row), or by stage where rows are evaluated together
    float v_n = 0.0f, step_n = 0.0f, lmax = 0.0f;
    if constexpr (P::E::NEXTRA == 0 && !P::TBOX) {
      for (int t = 0; t < N; ++t) {
        for (int q = 0; q < nc; ++q) {
          const float cr = constraint_row(c, w, t, q);
          const float lam = w.l(t, q);
          const float lam_n = relu(lam + mu * cr);
          v_n = nmax(v_n, relu(cr));
          step_n = nmax(step_n, fabsf(lam_n - lam));
          lmax = nmax(lmax, fabsf(lam_n));
        }
      }
      group_sync<G>(warp);
      for (int item = member; item < N * nc; item += G) {
        const int t = item / nc, q = item - t * nc;
        w.l(t, q) = relu(w.l(t, q) + mu * constraint_row(c, w, t, q));
      }
      group_sync<G>(warp);
    } else {
      float x[NX], u[NU], cr[P::NR];
      for (int t = 0; t < N; ++t) {
        load_x(w, t, x);
        load_u(w, t, u);
        constraint_rows<P>(c, x, u, p, cr);
#pragma unroll
        for (int q = 0; q < P::NR; ++q) {
          if (!present(w, q)) continue;
          const float lam = w.l(t, lam_row(w, q));
          const float lam_n = relu(lam + mu * cr[q]);
          v_n = nmax(v_n, relu(cr[q]));
          step_n = nmax(step_n, fabsf(lam_n - lam));
          lmax = nmax(lmax, fabsf(lam_n));
        }
      }
      if constexpr (P::TBOX) {
        for (int q = 0; q < 2 * NX; ++q) {
          const float ct = terminal_row(c, w, q);
          const float lam = w.l(N, q);
          const float lam_n = relu(lam + mu * ct);
          v_n = nmax(v_n, relu(ct));
          step_n = nmax(step_n, fabsf(lam_n - lam));
          lmax = nmax(lmax, fabsf(lam_n));
        }
      }
      group_sync<G>(warp);
      for (int t = member; t < nlam; t += G) {
        if (t < N) {
          load_x(w, t, x);
          load_u(w, t, u);
          constraint_rows<P>(c, x, u, p, cr);
#pragma unroll
          for (int q = 0; q < P::NR; ++q) {
            if (!present(w, q)) continue;
            const int r = lam_row(w, q);
            w.l(t, r) = relu(w.l(t, r) + mu * cr[q]);
          }
        } else {  // the terminal rows, the rest of row N zero
          for (int q = 0; q < nc; ++q)
            w.l(N, q) = q < 2 * NX ? relu(w.l(N, q) + mu * terminal_row(c, w, q)) : 0.0f;
        }
      }
      group_sync<G>(warp);
    }
    viol = v_n;
    lam_step = step_n / (1.0f + lmax);
    if (viol > c.viol_tol) mu = fminf(mu * c.mu_scale, c.mu_max);
  }
  // regions kept in shared memory go to their outputs
  if (g.smask >> R_XS & 1)
    for (int i = member; i < (N + 1) * NX; i += G) g.xs[(size_t)i * Bp + lane] = w.xs[i];
  if (g.smask >> R_US & 1)
    for (int i = member; i < N * NU; i += G) g.us[(size_t)i * Bp + lane] = w.us[i];
  if (g.smask >> R_LAM & 1)
    for (int i = member; i < nlam * nc; i += G) g.lam[(size_t)i * Bp + lane] = w.lam[i];
  if (member == 0) {
    g.viol[lane] = viol;
    g.conv[lane] = viol < c.viol_tol ? 1.0f : 0.0f;
    g.ni[lane] = (float)ni_total;
  }
}

template <class M, bool RK4>
static int launch_kernel(const Args& g, const Consts& c, int n_tiles, int tile, size_t bytes,
                         cudaStream_t s) {
  auto kernel = tracker_tile_kernel<M, RK4, GROUP>;
  if (bytes > 48 * 1024) {  // beyond the default, dynamic shared memory is opt-in
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, tile * GROUP, bytes, s>>>(g, c);
  return (int)cudaGetLastError();
}

// Every entry point takes the same arguments.
#define TRACKER_ARGS                                                                           \
  const float *x0, const float *u0, const float *refs, const float *par, const float *exo,   \
      const float *rw, const float *wrt, const float *lam0, float *us, float *xs, float *viol, \
      float *conv, float *lam, float *ni, float *work, const float *consts, int n_consts,      \
      int N, int substeps, int rk4, int ubox, int sbox, int outer, int inner, int tile,       \
      int n_tiles, int group, int smask, void *stream
#define TRACKER_PASS                                                                           \
  x0, u0, refs, par, exo, rw, wrt, lam0, us, xs, viol, conv, lam, ni, work, consts, n_consts, \
      N, substeps, rk4, ubox, sbox, outer, inner, tile, n_tiles, group, smask, stream

// One launch of problem P: the launch's checks, its arguments and the
// shared memory of its plan.
template <class P, bool RK4>
static int launch_problem(TRACKER_ARGS) {
  const int nc = (P::UBOX ? 2 * P::NU : 0) + (sbox ? 2 * P::NX : 0) + P::E::NEXTRA;
  if (n_consts * sizeof(float) != sizeof(Consts) || N < 1 || substeps < 1 || tile < 1 ||
      n_tiles < 1 || (P::NP > 0 && par == nullptr) || group != GROUP ||
      tile * GROUP > MAX_THREADS || smask < 0 || smask >= 1 << N_REGIONS || nc == 0 ||
      P::ADD != (exo != nullptr) || P::RW != (rw != nullptr) || P::WRT != (wrt != nullptr) ||
      (P::TBOX && nc < 2 * P::NX))
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Args g;
  g.x0 = x0; g.u0 = u0; g.refs = refs; g.par = par;
  g.exo = exo; g.rw = rw; g.wrt = wrt; g.lam0 = lam0;
  g.us = us; g.xs = xs; g.viol = viol; g.conv = conv; g.lam = lam; g.ni = ni;
  g.work = work;
  g.N = N; g.substeps = substeps; g.sbox = sbox; g.outer = outer; g.inner = inner;
  g.Bp = tile * n_tiles;
  g.smask = smask;
  const size_t bytes =
      smask ? (size_t)tile * lane_floats(smask, shape_of<P>(N, nc, refs != nullptr)) * sizeof(float)
            : 0;
  return launch_kernel<P, RK4>(g, c, n_tiles, tile, bytes, (cudaStream_t)stream);
}

// A problem built with one integrator and its input box as declared; a launch
// that asks for another is refused.
template <class P, bool RK4>
static int launch_fixed(TRACKER_ARGS) {
  if (rk4 != (int)RK4 || ubox != (int)P::UBOX) return (int)cudaErrorInvalidValue;
  return launch_problem<P, RK4>(TRACKER_PASS);
}

// factory parking: Euler, both boxes, the clearances at order 2 and 1, with
// the constant weights and per lane (WRT)
using ParkingO2 = Problem<KinematicRows, true, ClearanceRows, 2>;
using ParkingO2Wrt = Problem<KinematicRows, true, ClearanceRows, 2, true>;
using ParkingO1 = Problem<KinematicRows, true, ClearanceRows, 1>;
using ParkingO1Wrt = Problem<KinematicRows, true, ClearanceRows, 1, true>;
// the MHE windows: additive, RK4, no input box, the terminal box, Rd per stage
using MheWindows = Problem<GatedKinematicRows, false, NoRows, 0, false, true, true>;

#define FIXED_ENTRY(NAME, PROBLEM, RK4) \
  extern "C" int NAME(TRACKER_ARGS) { return launch_fixed<PROBLEM, RK4>(TRACKER_PASS); }

FIXED_ENTRY(tracker_kinematic_clearance_o2_launch, ParkingO2, false)
FIXED_ENTRY(tracker_kinematic_clearance_o2_wrt_launch, ParkingO2Wrt, false)
FIXED_ENTRY(tracker_kinematic_clearance_o1_launch, ParkingO1, false)
FIXED_ENTRY(tracker_kinematic_clearance_o1_wrt_launch, ParkingO1Wrt, false)
FIXED_ENTRY(tracker_gated_kinematic_launch, MheWindows, true)

// The group this library was built for, and the threads per CTA it allows.
extern "C" int tracker_group() { return GROUP; }
extern "C" int tracker_max_threads() { return MAX_THREADS; }

extern "C" const char* tracker_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
