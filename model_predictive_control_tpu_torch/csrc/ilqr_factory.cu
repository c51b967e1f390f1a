// Model-parametric fused batched AL-iLQR tracker: a group of G threads per
// scenario lane, one CTA per tile of T lanes (T x G threads), the whole
// augmented-Lagrangian tracking solve in one launch, for any row-form ODE
// compiled in as a functor.
//
// Replaces the Pallas TPU kernel _tracker_tile_kernel in
// model_predictive_control_tpu/ops/pallas/ilqr_factory.py (wrapper
// fused_tracker_solve). Plain twin: tracker_tiles_reference in
// model_predictive_control_tpu_torch/ops/cuda/ilqr_factory.py, which does the
// same operations in the same order.
//
// What it computes, per lane: an outer PHR loop (lam <- max(0, lam + mu c),
// mu x mu_scale where still infeasible) around an inner Levenberg-iLQR on the
// tracking cost sum (x - ref)' Qd (x - ref) + u' Rd u + qn (x_N - ref_N)' Qd
// (x_N - ref_N) (in regulation, refs == nullptr, ref = 0), with an optional
// input box and an optional state box as AL rows (at least one of them), and
// a 7-step line search. Step Jacobians are exact: forward-mode dual numbers
// run through the same integrator code as the values (the reference's packed
// jvp on an (nx + nu, T) basis). The regularised Quu (nu x nu, nu = M::NU from
// 1 to 8) is solved as the reference solves it: 1 / q at nu = 1, the 2 x 2
// inverse in closed form at nu = 2, an unrolled Cholesky factor and two
// triangular sweeps per right-hand side beyond. Both loop exits are
// tile-wide (__syncthreads_and) over the same T lanes whatever G is, so a
// solve at tile T gives the same numbers for every G.
//
// A model is a functor with
//   template <class S> static void rows(const S* x, const S* u, const float* p,
//                                       const float* mc, S* xdot);
// (S is float or Dual<W>; p the lane's parameters, mc the model constants).
// The kernel is templated on the model (its NX, NU and NP, and whether it
// has an input box) and on the integrator (Euler or RK4, `substeps`
// sub-intervals per interval); the state box and the reference are runtime
// flags. Seven models are compiled in, each behind its own entry point, as
// their paths use them: the racing pair KinematicRows (nx 4, nu 2, per-lane
// (acc, fric)) and PacejkaRows (nx 6, nu 2) with either integrator and an
// input box; the benchmark family with RK4, with or without an input box:
// CartpoleRows (nx 4, nu 1), QuadrotorRows (nx 6, nu 2), OmnibaseRows and
// OmnibaseParamRows (nx 6, nu 3; the latter with a per-lane mass) and
// ThrusterRows (nx 6, nu 4).
//
// What bounds it: latency and the warp schedulers, not bytes or FLOPs. The
// operands are ~0.5 k floats per lane and the algorithm needs ~2 k (Euler,
// nx 4) to ~30 k (RK4 x 4, nx 6) FP32 and SFU operations per stage and inner
// iteration (tan, sin, cos, atan, sqrt, division), inside data-dependent
// loops. With one thread per lane, the racing sweeps' 2,048 lanes put ~15
// threads on each SM, each running ~0.5 M dependent operations per inner
// iteration. Of those only the Riccati recursion and each rollout's own
// stages are true chains, so the design spreads the rest over the G members
// of a lane's group (TRACKER_GROUP, one library per G; thread threadIdx.x
// serves lane threadIdx.x / G as member threadIdx.x % G):
//   - a pre-pass computes the step Jacobians of all N stages before the
//     Riccati sweep: the N (nx + nu) (stage, direction) items are dealt to the
//     members, each item one Dual<1> pass through the integrator, written to
//     a per-lane A/B store. A tangent is the same float program whatever the
//     pass width, so A and B keep their bits, and a Dual<1> pass needs far
//     fewer registers than a wide one;
//   - members 0..6 each roll one line-search candidate and keep its
//     trajectory; the pick reads the 7 costs with the reference's tie rule,
//     and the accepted candidate is copied into xs / us by all members (no
//     re-roll);
//   - the Riccati recursion, the total cost and the multiplier sweep's
//     reductions are computed by every member alike (a warp's operation
//     takes one scheduler slot whether one or all of its threads run it, and
//     replication saves a broadcast); only member 0 stores the gains, and the
//     multiplier update is dealt by (stage, row). Dealing the stage algebra's
//     dot products to the members through a scratch region (three barriers a
//     stage) was measured on an H100 and not kept: the kinematic launch took
//     1.7 times as long and the Pacejka launch the same (PERF.md);
//   - every split is `for (item = member; item < n; item += G)`, so G = 1
//     runs the same code in one thread. Phases are separated by __syncwarp
//     (G <= 32 divides the warp), the two loop votes by __syncthreads_and,
//     reached by every thread of the CTA;
//   - a lane's working set (A/B store, gains, xs, us, lam, refs, the 7
//     candidates: ~8.4 KB at N = 15, nx 6) lives in shared memory as far as
//     the tile allows, lane-major with an odd lane stride (members reading
//     neighbouring rows, or the same row of neighbouring lanes, hit different
//     banks; the candidate index is fastest where 7 members write together);
//     the wrapper picks the regions that fit (Args::smask) and the rest stays
//     in global memory laid out [row][lane], the outputs in their own buffers;
//   - __launch_bounds__ caps the registers so that T x G threads fit the
//     register file: 256 threads at G = 1, 512 at G > 1 (128 registers, which
//     costs the Pacejka instantiation 0.5-1 KB of spills a thread).
// On an NVIDIA H100 80GB HBM3 (700 W), 2,048 lanes, N = 15, at tile 16: a
// steady launch of the kinematic sweep takes 0.88-0.89 ms at G = 8 (2.07-2.09
// ms with one thread per lane at tile 64) and one of the Pacejka sweep 4.4-4.5
// ms at G = 32 (40.7 ms); the bound of the operations on the warm policy
// step's launch (3.8 and 12.1 ms) is 0.07 and 0.15 ms (PERF.md).
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math: the
// transcendental functions and the divisions are the precise ones.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define NALPHA 7
#define MAXX 8   // largest state dimension (ops/cuda/ilqr_factory.py MAX_NX)
#define MAXU 8   // largest input dimension (MAX_NU)
#define MAXC 16  // model constants (MAX_CONSTS)

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
};

struct Args {
  // (nx, Bp), (N, nu, Bp), (N+1, nx, Bp) or nullptr (regulation), (np, Bp)
  const float *x0, *u0, *refs, *par;
  float *us, *xs, *viol, *conv, *lam, *ni;  // outputs; us, xs, lam are the state
  float* work;  // (rows, Bp): the workspace regions that are not in shared memory
  int N, substeps, sbox, outer, inner, Bp;
  int smask;  // bit r set: region r of a lane's working set lives in shared memory
};

// A lane's working set, by region, in the order the wrapper fills shared
// memory (ops/cuda/ilqr_factory.py REGIONS). xs, us and lam have their home
// in the output buffers and refs in the operand; the A/B store, the gains
// and the candidates have theirs in `work`, in this order.
enum { R_AB, R_GAIN, R_XS, R_US, R_LAM, R_REF, R_CAND, N_REGIONS };

// (The ref region holds nothing in regulation.)
__host__ __device__ inline int region_floats(int r, int nx, int nu, int N, int nc, bool track) {
  switch (r) {
    case R_AB: return N * nx * (nx + nu);
    case R_GAIN: return N * nu * (1 + nx);
    case R_XS: return (N + 1) * nx;
    case R_REF: return track ? (N + 1) * nx : 0;
    case R_US: return N * nu;
    case R_LAM: return N * nc;
    default: return NALPHA * ((N + 1) * nx + N * nu + 1);
  }
}

// Floats of one lane's block in shared memory: its regions in `smask`, padded
// to an odd count (neighbouring lanes then start on different banks).
__host__ __device__ inline int lane_floats(int smask, int nx, int nu, int N, int nc, bool track) {
  int n = 0;
  for (int r = 0; r < N_REGIONS; ++r)
    if (smask >> r & 1) n += region_floats(r, nx, nu, N, nc, track);
  return n | 1;
}

// ---------------------------------------------------------------------------
// forward-mode dual numbers; the twin's Dual (ops/cuda/ilqr_factory.py)
// applies the same rules in the same order
// ---------------------------------------------------------------------------

template <int W>
struct Dual {
  float v;
  float d[W];
};

template <int W>
__device__ __forceinline__ Dual<W> operator+(const Dual<W>& a, const Dual<W>& b) {
  Dual<W> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] + b.d[q];
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator+(const Dual<W>& a, float c) {
  Dual<W> r = a;
  r.v = a.v + c;
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator+(float c, const Dual<W>& a) {
  Dual<W> r = a;
  r.v = c + a.v;
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator-(const Dual<W>& a, const Dual<W>& b) {
  Dual<W> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] - b.d[q];
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator-(const Dual<W>& a, float c) {
  Dual<W> r = a;
  r.v = a.v - c;
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator-(float c, const Dual<W>& a) {
  Dual<W> r;
  r.v = c - a.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = -a.d[q];
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator*(const Dual<W>& a, const Dual<W>& b) {
  Dual<W> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] * b.v + a.v * b.d[q];
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator*(const Dual<W>& a, float c) {
  Dual<W> r;
  r.v = a.v * c;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] * c;
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator*(float c, const Dual<W>& a) {
  return a * c;
}
template <int W>
__device__ __forceinline__ Dual<W> operator/(const Dual<W>& a, const Dual<W>& b) {
  Dual<W> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = (a.d[q] - r.v * b.d[q]) / b.v;
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator/(const Dual<W>& a, float c) {
  Dual<W> r;
  r.v = a.v / c;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] / c;
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator-(const Dual<W>& a) {
  Dual<W> r;
  r.v = -a.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = -a.d[q];
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> operator/(float c, const Dual<W>& a) {
  Dual<W> r;
  r.v = c / a.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = -(r.v * a.d[q]) / a.v;
  return r;
}

__device__ __forceinline__ float val(float a) { return a; }
template <int W>
__device__ __forceinline__ float val(const Dual<W>& a) { return a.v; }

// tangent scaled by a weight: d <- d * w
template <int W>
__device__ __forceinline__ Dual<W> scaled(float v, const Dual<W>& a, float w) {
  Dual<W> r;
  r.v = v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] * w;
  return r;
}

__device__ __forceinline__ float dsin(float a) { return sinf(a); }
__device__ __forceinline__ float dcos(float a) { return cosf(a); }
__device__ __forceinline__ float dtan(float a) { return tanf(a); }
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ float datan(float a) { return atanf(a); }
__device__ __forceinline__ float dtanh(float a) { return tanhf(a); }
__device__ __forceinline__ float dabs(float a) { return fabsf(a); }
// clamp from below / above, NaN kept (torch.clamp; jnp.maximum / minimum)
__device__ __forceinline__ float dclamp_min(float a, float c) { return a < c ? c : a; }
__device__ __forceinline__ float dclamp_max(float a, float c) { return a > c ? c : a; }
__device__ __forceinline__ float dwhere(bool m, float a, float b) { return m ? a : b; }

template <int W>
__device__ __forceinline__ Dual<W> dsin(const Dual<W>& a) {
  return scaled(sinf(a.v), a, cosf(a.v));
}
template <int W>
__device__ __forceinline__ Dual<W> dcos(const Dual<W>& a) {
  Dual<W> r;
  r.v = cosf(a.v);
  const float s = sinf(a.v);
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
template <int W>
__device__ __forceinline__ Dual<W> datan(const Dual<W>& a) {
  Dual<W> r;
  r.v = atanf(a.v);
  const float den = 1.0f + a.v * a.v;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = a.d[q] / den;
  return r;
}
template <int W>
__device__ __forceinline__ Dual<W> dtanh(const Dual<W>& a) {
  const float t = tanhf(a.v);
  return scaled(t, a, 1.0f - t * t);
}
// JAX's abs jvp: +d where x >= 0, -d elsewhere
template <int W>
__device__ __forceinline__ Dual<W> dabs(const Dual<W>& a) {
  Dual<W> r;
  r.v = fabsf(a.v);
  const bool pos = a.v >= 0.0f;
#pragma unroll
  for (int q = 0; q < W; ++q) r.d[q] = pos ? a.d[q] : -a.d[q];
  return r;
}
// JAX's balanced max/min jvp against a constant: weight 1, 1/2 at a tie, 0
template <int W>
__device__ __forceinline__ Dual<W> dclamp_min(const Dual<W>& a, float c) {
  const float w = a.v > c ? 1.0f : (a.v == c ? 0.5f : 0.0f);
  return scaled(dclamp_min(a.v, c), a, w);
}
template <int W>
__device__ __forceinline__ Dual<W> dclamp_max(const Dual<W>& a, float c) {
  const float w = a.v < c ? 1.0f : (a.v == c ? 0.5f : 0.0f);
  return scaled(dclamp_max(a.v, c), a, w);
}
template <int W>
__device__ __forceinline__ Dual<W> dwhere(bool m, const Dual<W>& a, const Dual<W>& b) {
  return m ? a : b;
}

// ---------------------------------------------------------------------------
// models: the row functions of ops/cuda/parking_factory.py,
// ops/cuda/ilqr_dyn_kernel.py and models/benchmarks.py, operation for
// operation (a float constant times a dual is the dual times the constant:
// the same product)
// ---------------------------------------------------------------------------

// Kinematic bicycle, p = (acc, fric), mc = (kb, kb^2, 1 / lr).
struct KinematicRows {
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

// Dynamic single-track (Pacejka) bicycle, mc = (lf, lr, 1/m, 1/Iz, bf, cf, df,
// br, cr, dr, cm1, cm2, cr1, cr2, 1/0.01).
struct PacejkaRows {
  static constexpr int NX = 6, NU = 2, NP = 0;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* mc, S* f) {
    const S vx = x[3], vy = x[4], om = x[5];
    const S vx_safe = dwhere(val(vx) >= 0.0f, dclamp_min(vx, 1e-2f), dclamp_max(vx, -1e-2f));
    const S alpha_f = u[1] - datan((om * mc[0] + vy) / vx_safe);
    const S alpha_r = datan((om * mc[1] - vy) / vx_safe);
    const S F_f = mc[6] * dsin(mc[5] * datan(mc[4] * alpha_f));
    const S F_r = mc[9] * dsin(mc[8] * datan(mc[7] * alpha_r));
    const S F_x = (mc[10] - mc[11] * vx) * u[0] - mc[13] * vx * dabs(vx) -
                  mc[12] * dtanh(vx * mc[14]);
    const S sp = dsin(x[2]), cp = dcos(x[2]);
    const S sd = dsin(u[1]), cd = dcos(u[1]);
    f[0] = vx * cp - vy * sp;
    f[1] = vx * sp + vy * cp;
    f[2] = om;
    f[3] = (F_x - F_f * sd) * mc[2] + vy * om;
    f[4] = (F_r + F_f * cd) * mc[2] - vx * om;
    f[5] = (F_f * mc[0] * cd - F_r * mc[1]) * mc[3];
  }
};

// Cart-pole, theta from the downward vertical, mc = (mc, mp, l, g, mp l,
// (mc + mp) g).
struct CartpoleRows {
  static constexpr int NX = 4, NU = 1, NP = 0;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* mc, S* f) {
    const S s = dsin(x[1]), c = dcos(x[1]);
    const S den = mc[0] + mc[1] * s * s;
    f[0] = x[2];
    f[1] = x[3];
    f[2] = (u[0] + mc[1] * s * (mc[2] * x[3] * x[3] + mc[3] * c)) / den;
    f[3] = (-u[0] * c - mc[4] * x[3] * x[3] * c * s - mc[5] * s) / (mc[2] * den);
  }
};

// Planar quadrotor, mc = (1/m, g, arm, 1/I).
struct QuadrotorRows {
  static constexpr int NX = 6, NU = 2, NP = 0;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* mc, S* f) {
    const S s = dsin(x[2]), c = dcos(x[2]);
    const S thrust = u[0] + u[1];
    f[0] = x[3];
    f[1] = x[4];
    f[2] = x[5];
    f[3] = -thrust * s * mc[0];
    f[4] = thrust * c * mc[0] - mc[1];
    f[5] = (u[0] - u[1]) * mc[2] * mc[3];
  }
};

// Omnidirectional base, body-frame forces and a torque, mc = (1/m, 1/I, c_v,
// c_w).
struct OmnibaseRows {
  static constexpr int NX = 6, NU = 3, NP = 0;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* mc, S* f) {
    const S s = dsin(x[2]), c = dcos(x[2]);
    f[0] = x[3];
    f[1] = x[4];
    f[2] = x[5];
    f[3] = (u[0] * c - u[1] * s) * mc[0] - mc[2] * x[3];
    f[4] = (u[0] * s + u[1] * c) * mc[0] - mc[2] * x[4];
    f[5] = u[2] * mc[1] - mc[3] * x[5];
  }
};

// The omnidirectional base with a per-lane mass, p = (m,), mc = (1/I, c_v,
// c_w): the division by the mass is a true division.
struct OmnibaseParamRows {
  static constexpr int NX = 6, NU = 3, NP = 1;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* mc, S* f) {
    const S s = dsin(x[2]), c = dcos(x[2]);
    f[0] = x[3];
    f[1] = x[4];
    f[2] = x[5];
    f[3] = (u[0] * c - u[1] * s) / p[0] - mc[1] * x[3];
    f[4] = (u[0] * s + u[1] * c) / p[0] - mc[1] * x[4];
    f[5] = u[2] * mc[0] - mc[2] * x[5];
  }
};

// Thrust cluster: a 3-D point mass, four pyramid thrusters of directions
// (sa, 0, ca), (0, sa, ca), (-sa, 0, ca), (0, -sa, ca), linear and quadratic
// drag, mc = (1/m, g, c1, c2, sa, ca). The force sums start at 0, as the
// reference's Python sums do.
struct ThrusterRows {
  static constexpr int NX = 6, NU = 4, NP = 0;
  template <class S>
  __device__ __forceinline__ static void rows(const S* x, const S* u, const float* p,
                                              const float* mc, S* f) {
    const float sa = mc[4], ca = mc[5];
    const S sp = dsqrt(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + 1e-9f);
    const S fx = (0.0f + u[0] * sa + u[1] * 0.0f + u[2] * -sa + u[3] * 0.0f) * mc[0];
    const S fy = (0.0f + u[0] * 0.0f + u[1] * sa + u[2] * 0.0f + u[3] * -sa) * mc[0];
    const S fz = (0.0f + u[0] * ca + u[1] * ca + u[2] * ca + u[3] * ca) * mc[0];
    f[0] = x[3];
    f[1] = x[4];
    f[2] = x[5];
    f[3] = fx - mc[2] * x[3] - mc[3] * sp * x[3];
    f[4] = fy - mc[2] * x[4] - mc[3] * sp * x[4];
    f[5] = fz - mc[1] - mc[2] * x[5] - mc[3] * sp * x[5];
  }
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
// model, on values (S = float) or duals. k1 + 2 k2 + 2 k3 + k4 is summed left
// to right, as in the reference.
template <class M, bool RK4, class S>
__device__ __forceinline__ void step(const Consts& c, int substeps, S* x, const S* u,
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

// A lane's views of its working set, and the problem's constraint rows: nc,
// the input box's 2 NU rows when `ubox` (a compile-time property of the
// instantiation: a runtime flag cost the kinematic launch 12%, PERF.md), then
// the state box's 2 NX when `sbox`, in lam (a lane's local arrays keep every
// row at a fixed slot instead, see constraint_rows).
template <int NX, int NU, bool UBOX>
struct LaneView {
  static constexpr int NZ = NX + NU;
  static constexpr bool ubox = UBOX;
  Region ab, gain, xs, us, lam, ref, cand;
  int nc, N;
  bool sbox;
  __device__ float& x(int t, int i) const { return xs[t * NX + i]; }
  __device__ float& u(int t, int j) const { return us[t * NU + j]; }
  __device__ float& l(int t, int r) const { return lam[t * nc + r]; }
  __device__ float r(int t, int i) const { return ref[t * NX + i]; }
  __device__ float& kg(int t, int j) const { return gain[t * NU + j]; }
  __device__ float& Kg(int t, int r) const { return gain[N * NU + t * NU * NX + r]; }
  // column col of the step Jacobian [A | B] of stage t, row k
  __device__ float& J(int t, int k, int col) const { return ab[(t * NX + k) * NZ + col]; }
  // candidate s of the line search: states, controls, cost (s fastest: the
  // members that write together write neighbouring words)
  __device__ float& cx(int s, int t, int i) const { return cand[(t * NX + i) * NALPHA + s]; }
  __device__ float& cu(int s, int t, int j) const {
    return cand[((N + 1) * NX + t * NU + j) * NALPHA + s];
  }
  __device__ float& cc(int s) const { return cand[((N + 1) * NX + N * NU) * NALPHA + s]; }
};

// Phase boundary inside a lane's group: what a member wrote before it, every
// member reads after it. A group divides the warp, so the warp barrier does.
template <int G>
__device__ __forceinline__ void group_sync(unsigned mask) {
  if (G > 1) __syncwarp(mask);
}

// The step Jacobians of all N stages at the stored (x_t, u_t): J(t, k, i) =
// dx+_k / dx_i for i < nx, dx+_k / du_j at column nx + j. The N (nx + nu)
// (stage, direction) items are dealt to the group's members, each item one
// Dual<1> pass through the integrator.
template <class M, bool RK4, int G>
__device__ __forceinline__ void jacobians(const Consts& c, const LaneView<M::NX, M::NU, M::UBOX>& w,
                                          const float* p, int substeps, int member) {
  constexpr int NX = M::NX, NU = M::NU, NZ = NX + NU;
  const int items = w.N * NZ;
#pragma unroll 1
  for (int item = member; item < items; item += G) {
    const int t = item / NZ, col = item - t * NZ;
    Dual<1> xd[NX], ud[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      xd[i].v = w.x(t, i);
      xd[i].d[0] = col == i ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      ud[j].v = w.u(t, j);
      ud[j].d[0] = col == NX + j ? 1.0f : 0.0f;
    }
    step<M, RK4>(c, substeps, xd, ud, p);
#pragma unroll
    for (int k = 0; k < NX; ++k) w.J(t, k, col) = xd[k].d[0];
  }
}

// Constraint rows in the reference's order at fixed slots: u - ub (nu), lb -
// u (nu), then x - ub (nx), lb - x (nx), whether or not each box is present
// (a slot indexed at compile time keeps the local arrays in registers; the
// slots of an absent box are never read).
template <int NX, int NU>
__device__ __forceinline__ void constraint_rows(const Consts& c, const float* x,
                                                const float* u, float* cr) {
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[j] = u[j] - c.ubu[j];
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[NU + j] = c.lbu[j] - u[j];
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[2 * NU + i] = x[i] - c.ubx[i];
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[2 * NU + NX + i] = c.lbx[i] - x[i];
}

template <int NX>
__device__ __forceinline__ float quad_err(const Consts& c, const float* x, const float* r) {
  float q = c.qd[0] * (x[0] - r[0]) * (x[0] - r[0]);
#pragma unroll
  for (int i = 1; i < NX; ++i) q = q + c.qd[i] * (x[i] - r[i]) * (x[i] - r[i]);
  return q;
}

// Tracking cost plus the AL penalty sum_r (act_r^2 - lam_r^2) / (2 mu).
template <int NX, int NU>
__device__ __forceinline__ float stage_cost(const Consts& c, bool ubox, bool sbox,
                                            const float* x, const float* u, const float* r,
                                            const float* lam, float mu) {
  float cr[2 * NU + 2 * NX];
  constraint_rows<NX, NU>(c, x, u, cr);
  float ru = c.rd[0] * u[0] * u[0];
#pragma unroll
  for (int j = 1; j < NU; ++j) ru = ru + c.rd[j] * u[j] * u[j];
  const float quad = quad_err<NX>(c, x, r) + ru;
  // phi starts at 0: a term is never -0 (act^2 - lam^2 with act, lam >= 0),
  // so 0 + term has the term's bits, as the twin's sum from its first row
  float phi = 0.0f;
#pragma unroll
  for (int q = 0; q < 2 * NU + 2 * NX; ++q) {
    if (q < 2 * NU ? ubox : sbox) {
      const float act = relu(lam[q] + mu * cr[q]);
      phi = phi + (act * act - lam[q] * lam[q]);
    }
  }
  return quad + phi / (2.0f * mu);
}

template <int NX, int NU, bool UB>
__device__ __forceinline__ void load_x(const LaneView<NX, NU, UB>& w, int t, float* x) {
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = w.x(t, i);
}
template <int NX, int NU, bool UB>
__device__ __forceinline__ void load_u(const LaneView<NX, NU, UB>& w, int t, float* u) {
#pragma unroll
  for (int j = 0; j < NU; ++j) u[j] = w.u(t, j);
}
template <int NX, int NU, bool UB>
__device__ __forceinline__ void load_r(const LaneView<NX, NU, UB>& w, int t, float* r) {
#pragma unroll
  for (int i = 0; i < NX; ++i) r[i] = w.r(t, i);
}
// A stage's multipliers at constraint_rows' fixed slots (0 where a box is
// absent); lam holds the present rows only.
template <int NX, int NU, bool UB>
__device__ __forceinline__ void load_lam(const LaneView<NX, NU, UB>& w, int t, float* l) {
  const int ox = w.ubox ? 0 : 2 * NU;  // the slot of lam's row 0 when the input box is absent
#pragma unroll
  for (int q = 0; q < 2 * NU + 2 * NX; ++q)
    l[q] = (q < 2 * NU ? w.ubox : w.sbox) ? w.l(t, q - ox) : 0.0f;
}

template <int NX, int NU, bool UB>
__device__ __forceinline__ float total_cost(const Consts& c, const LaneView<NX, NU, UB>& w,
                                            float mu) {
  float x[NX], u[NU], r[NX], l[2 * NU + 2 * NX];
  float cost = 0.0f;
  for (int t = 0; t < w.N; ++t) {
    load_x(w, t, x);
    load_u(w, t, u);
    load_r(w, t, r);
    load_lam(w, t, l);
    const float sc = stage_cost<NX, NU>(c, w.ubox, w.sbox, x, u, r, l, mu);
    cost = t == 0 ? sc : cost + sc;
  }
  load_x(w, w.N, x);
  load_r(w, w.N, r);
  return cost + c.qn * quad_err<NX>(c, x, r);
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

// Riccati sweep over the stored trajectory and its stored step Jacobians;
// returns whether every stage's regularised Quu was positive definite, and
// max|Qu|. Every member of the group computes it alike; `store` (one member)
// writes the gains.
template <int NX, int NU, bool UB>
__device__ __forceinline__ void backward(const Consts& c, const LaneView<NX, NU, UB>& w, float mu,
                                         float reg, bool store, bool& ok_out, float& grad_out) {
  const int N = w.N;
  float Vx[NX], V[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = c.qnqd2[i] * (w.x(N, i) - w.r(N, i));
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = i == j ? c.qnqd2[i] : 0.0f;
  }
  bool ok = true;
  float grad = 0.0f;
  for (int t = N - 1; t >= 0; --t) {
    float X[NX], U[NU], R[NX], L[2 * NU + 2 * NX];
    load_x(w, t, X);
    load_u(w, t, U);
    load_r(w, t, R);
    load_lam(w, t, L);
    float A[NX][NX], Bm[NX][NU];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
#pragma unroll
      for (int i = 0; i < NX; ++i) A[k][i] = w.J(t, k, i);
#pragma unroll
      for (int j = 0; j < NU; ++j) Bm[k][j] = w.J(t, k, NX + j);
    }

    // stage derivatives: the tracking cost and the box rows (diagonal)
    float lx[NX], hxx[NX], lu[NU], huu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      lx[i] = c.qd2[i] * (X[i] - R[i]);
      hxx[i] = c.qd2[i];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      lu[j] = c.rd2[j] * U[j];
      huu[j] = c.rd2[j];
      if (w.ubox) {
        const float act_u = relu(L[j] + mu * (U[j] - c.ubu[j]));
        const float act_l = relu(L[NU + j] + mu * (c.lbu[j] - U[j]));
        lu[j] = lu[j] + act_u - act_l;
        const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
        huu[j] = c.rd2[j] + mu * ind;
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

    // Qx = lx + A^T Vx, Qu = lu + B^T Vx
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
      float s = lu[j];
#pragma unroll
      for (int k = 0; k < NX; ++k) s = s + Bm[k][j] * Vx[k];
      Qu[j] = s;
    }
    // VB = Vxx B, M = Vxx A
    float VB[NX][NU];
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
        V[i][j] = i == j ? sym + hxx[i] : sym;
        V[j][i] = V[i][j];
      }
    }
    // Quu = luu + B^T Vxx B, Qux = B^T M
    float quu[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int b = 0; b < NU; ++b) {
        float s = a == b ? huu[a] + Bm[0][a] * VB[0][b] : Bm[0][a] * VB[0][b];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + Bm[k][a] * VB[k][b];
        quu[a][b] = s;
      }
    }
    float Qux[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = Bm[0][a] * Mm[0][j];
#pragma unroll
        for (int k = 1; k < NX; ++k) s = s + Bm[k][a] * Mm[k][j];
        Qux[a][j] = s;
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

template <int NX, int NU, bool UB>
__device__ __forceinline__ void load_stage(const LaneView<NX, NU, UB>& w, int t, float* xh,
                                           float* uh, float* kg, float* Kg) {
  load_x(w, t, xh);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    uh[j] = w.u(t, j);
    kg[j] = w.kg(t, j);
  }
#pragma unroll
  for (int q = 0; q < NU * NX; ++q) Kg[q] = w.Kg(t, q);
}

// The closed-loop rollouts of the line search, one candidate per member
// (members 0..6 at G >= 8): candidate s keeps its trajectory in cx / cu and
// its cost, summed in stage order, in cc.
template <class M, bool RK4, int G>
__device__ __forceinline__ void rollouts(const Consts& c, const LaneView<M::NX, M::NU, M::UBOX>& w,
                                         const float* x0, const float* p, int substeps,
                                         float mu, int member) {
  constexpr int NX = M::NX, NU = M::NU;
#pragma unroll 1
  for (int s = member; s < NALPHA; s += G) {
    const float alpha = c.alpha[s];
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    float cost = 0.0f;
    float xh[NX], uh[NU], kg[NU], Kg[NU * NX], r[NX], l[2 * NU + 2 * NX];
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
      const float sc = stage_cost<NX, NU>(c, w.ubox, w.sbox, x, u, r, l, mu);
      cost = t == 0 ? sc : cost + sc;
      step<M, RK4>(c, substeps, x, u, p);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) w.cx(s, w.N, i) = x[i];
    load_r(w, w.N, r);
    w.cc(s) = cost + c.qn * quad_err<NX>(c, x, r);
  }
}

// Row q of the constraints at stage t (constraint_rows' order and operations).
template <int NX, int NU, bool UB>
__device__ __forceinline__ float constraint_row(const Consts& c, const LaneView<NX, NU, UB>& w,
                                                int t, int q) {
  if (w.ubox) {
    if (q < NU) return w.u(t, q) - c.ubu[q];
    if (q < 2 * NU) return c.lbu[q - NU] - w.u(t, q - NU);
    q -= 2 * NU;
  }
  if (q < NX) return w.x(t, q) - c.ubx[q];
  return c.lbx[q - NX] - w.x(t, q - NX);
}

extern __shared__ float lane_blocks[];  // T blocks of lane_floats() floats
// The reference of a regulated lane: every entry reads this 0 (x - 0 has the
// bits of x, so regulation is tracking a zero reference).
__device__ float zero_ref = 0.0f;

template <class M, bool RK4, int G>
__global__ void __launch_bounds__(MAX_THREADS) tracker_tile_kernel(const Args g, const Consts c) {
  constexpr int NX = M::NX, NU = M::NU, NP = M::NP > 0 ? M::NP : 1;
  const int member = threadIdx.x % G, slot = threadIdx.x / G;
  const int lane = blockIdx.x * (blockDim.x / G) + slot;
  // the threads of this warp: all of them are here, none has diverged yet
  const unsigned warp = G > 1 ? __activemask() : 0u;
  const int Bp = g.Bp, N = g.N;
  const bool track = g.refs != nullptr;

  // place the regions: in the lane's shared block, in its home, or in `work`
  LaneView<NX, NU, M::UBOX> w;
  w.sbox = g.sbox != 0;
  w.nc = (w.ubox ? 2 * NU : 0) + (w.sbox ? 2 * NX : 0);
  w.N = N;
  const int nc = w.nc;
  float* const block = lane_blocks + (size_t)slot * lane_floats(g.smask, NX, NU, N, nc, track);
  int in_block = 0, in_work = 0;
  auto place = [&](int r, float* home) {  // called once per region, in region order
    const int n = region_floats(r, NX, NU, N, nc, track);
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
  float p[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) p[q] = M::NP > 0 ? g.par[q * Bp + lane] : 0.0f;
  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = g.x0[i * Bp + lane];

  // init: controls from the warm start, multipliers zero, the reference
  // window into its region, then a rollout (a chain: one member)
  for (int i = member; i < N * NU; i += G) w.us[i] = g.u0[(size_t)i * Bp + lane];
  for (int i = member; i < N * nc; i += G) w.lam[i] = 0.0f;
  if (track && (g.smask >> R_REF & 1))
    for (int i = member; i < (N + 1) * NX; i += G) w.ref[i] = g.refs[(size_t)i * Bp + lane];
  group_sync<G>(warp);
  if (member == 0) {
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    for (int t = 0; t < N; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w.x(t, i) = x[i];
      load_u(w, t, u);
      step<M, RK4>(c, g.substeps, x, u, p);
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
    float cost = total_cost(c, w, mu);
    float reg = c.reg_init, grad = INFINITY;
    int it = 0;
    for (; it < g.inner; ++it) {
      if (__syncthreads_and(grad < c.grad_tol)) break;
      jacobians<M, RK4, G>(c, w, p, g.substeps, member);
      group_sync<G>(warp);
      bool ok;
      backward(c, w, mu, reg, member == 0, ok, grad);
      group_sync<G>(warp);
      rollouts<M, RK4, G>(c, w, x0, p, g.substeps, mu, member);
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
    // update dealt by (stage, row)
    float v_n = 0.0f, step_n = 0.0f, lmax = 0.0f;
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
    for (int i = member; i < N * nc; i += G) g.lam[(size_t)i * Bp + lane] = w.lam[i];
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

// A model with its input box present (UBOX) or absent, a compile-time
// property of the instantiation (see LaneView).
template <class Model, bool UBOX_>
struct Boxed : Model {
  static constexpr bool UBOX = UBOX_;
};

// Every model is built with RK4 and an input box; EULER: also with Euler and
// the box (the racing pair), NOBOX: also with RK4 and no input box (the
// benchmark models). A launch the library does not hold is refused.
template <class Model, bool EULER, bool NOBOX>
static int launch(const float* x0, const float* u0, const float* refs, const float* par,
                  float* us, float* xs, float* viol, float* conv, float* lam, float* ni,
                  float* work, const float* consts, int n_consts, int N, int substeps,
                  int rk4, int ubox, int sbox, int outer, int inner, int tile, int n_tiles,
                  int group, int smask, void* stream) {
  const int nc = (ubox ? 2 * Model::NU : 0) + (sbox ? 2 * Model::NX : 0);
  if (n_consts * sizeof(float) != sizeof(Consts) || N < 1 || substeps < 1 || tile < 1 ||
      n_tiles < 1 || (Model::NP > 0 && par == nullptr) || group != GROUP ||
      tile * GROUP > MAX_THREADS || smask < 0 || smask >= 1 << N_REGIONS || nc == 0 ||
      (!rk4 && !(EULER && ubox)) || (!ubox && !NOBOX))
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Args g;
  g.x0 = x0; g.u0 = u0; g.refs = refs; g.par = par;
  g.us = us; g.xs = xs; g.viol = viol; g.conv = conv; g.lam = lam; g.ni = ni;
  g.work = work;
  g.N = N; g.substeps = substeps; g.sbox = sbox; g.outer = outer; g.inner = inner;
  g.Bp = tile * n_tiles;
  g.smask = smask;
  const size_t bytes =
      smask ? (size_t)tile *
                  lane_floats(smask, Model::NX, Model::NU, N, nc, refs != nullptr) *
                  sizeof(float)
            : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (NOBOX) {
    if (!ubox) return launch_kernel<Boxed<Model, false>, true>(g, c, n_tiles, tile, bytes, s);
  }
  if constexpr (EULER) {
    if (!rk4) return launch_kernel<Boxed<Model, true>, false>(g, c, n_tiles, tile, bytes, s);
  }
  return launch_kernel<Boxed<Model, true>, true>(g, c, n_tiles, tile, bytes, s);
}

#define TRACKER_ENTRY(NAME, MODEL, EULER, NOBOX)                                           \
  extern "C" int NAME(const float* x0, const float* u0, const float* refs, const float* par, \
                      float* us, float* xs, float* viol, float* conv, float* lam, float* ni, \
                      float* work, const float* consts, int n_consts, int N, int substeps,   \
                      int rk4, int ubox, int sbox, int outer, int inner, int tile,           \
                      int n_tiles, int group, int smask, void* stream) {                     \
    return launch<MODEL, EULER, NOBOX>(x0, u0, refs, par, us, xs, viol, conv, lam, ni, work,\
                                consts, n_consts, N, substeps, rk4, ubox, sbox, outer,      \
                                inner, tile, n_tiles, group, smask, stream);                \
  }

TRACKER_ENTRY(tracker_kinematic_launch, KinematicRows, true, false)
TRACKER_ENTRY(tracker_pacejka_launch, PacejkaRows, true, false)
TRACKER_ENTRY(tracker_cartpole_launch, CartpoleRows, false, true)
TRACKER_ENTRY(tracker_quadrotor_launch, QuadrotorRows, false, true)
TRACKER_ENTRY(tracker_omnibase_launch, OmnibaseRows, false, true)
TRACKER_ENTRY(tracker_omnibase_param_launch, OmnibaseParamRows, false, true)
TRACKER_ENTRY(tracker_thruster_launch, ThrusterRows, false, true)

// The group this library was built for, and the threads per CTA it allows.
extern "C" int tracker_group() { return GROUP; }
extern "C" int tracker_max_threads() { return MAX_THREADS; }

extern "C" const char* tracker_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
