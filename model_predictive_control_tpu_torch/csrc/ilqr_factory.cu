// Model-parametric fused batched AL-iLQR tracker: one thread per scenario
// lane, one CTA per tile of T lanes, the whole augmented-Lagrangian tracking
// solve in one launch, for any row-form ODE compiled in as a functor.
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
// (x_N - ref_N), with an input box and an optional state box as AL rows, and a
// 7-step line search. Step Jacobians are exact: forward-mode dual numbers run
// through the same integrator code as the values (the reference's packed jvp
// on an (nx + nu, T) basis). Quu (2 x 2) is solved in closed form. Both loop
// exits are tile-wide (__syncthreads_and), as in the reference.
//
// A model is a functor with
//   template <class S> static void rows(const S* x, const S* u, const float* p,
//                                       const float* mc, S* xdot);
// (S is float or Dual<W>; p the lane's parameters, mc the model constants).
// The kernel is templated on the model and on the integrator (Euler or RK4,
// `substeps` sub-intervals per interval); the state box is a runtime flag.
// Two models are compiled in, each behind its own entry point:
// KinematicRows (nx 4, per-lane (acc, fric)) and PacejkaRows (nx 6).
//
// What bounds it: latency, not bytes or FLOPs. At the racing sweeps' size
// (2048 lanes) the card holds about 15 threads per SM, each running a long
// dependent chain of FP32 and SFU operations (tan, sin, cos, atan, sqrt,
// division) through N-stage sweeps inside data-dependent loops. As in the
// parking kernel (csrc/ilqr_kernel.cu) the design therefore:
//   - keeps the trajectory, the multipliers and the gains in global memory
//     laid out [stage][row][lane] (coalesced; ~0.5 k floats per lane at N=15,
//     ~4 MB at 2048 lanes, L2-resident); xs, us and lam live directly in the
//     output buffers;
//   - keeps the Riccati carry, the step Jacobian and the stage algebra in
//     registers;
//   - computes a step Jacobian W directions at a time (M::JW), so that the
//     dual numbers of a 6-state RK4 step fit the register file;
//   - runs the 7 line-search rollouts interleaved in one pass over the
//     stages and re-rolls the accepted step with the same device function,
//     instead of storing 7 candidate trajectories; without FMA contraction
//     (--fmad=false) the re-roll gives the same numbers bit for bit.
// Making it fast (several lanes per thread, directions spread over threads,
// a persistent grid) is left for later work.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math: the
// transcendental functions and the divisions are the precise ones.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define NU 2
#define NALPHA 7
#define MAXX 8   // largest state dimension (ops/cuda/ilqr_factory.py MAX_NX)
#define MAXC 16  // model constants (MAX_CONSTS)

// Float constants, in the order ops/cuda/ilqr_factory.py::_consts writes them.
struct Consts {
  float h, h_half, h_sixth;  // ts / substeps, 0.5 h, h / 6
  float qd[MAXX], rd[NU], qn;
  float qd2[MAXX], rd2[NU], qnqd2[MAXX];  // 2 Qd, 2 Rd, 2 qn Qd
  float lbu[NU], ubu[NU], lbx[MAXX], ubx[MAXX];
  float mu_init, mu_scale, mu_max, viol_tol, grad_tol;
  float alpha[NALPHA];
  float reg_init, reg_min, reg_max;
  float mc[MAXC];
};

struct Args {
  const float *x0, *u0, *refs, *par;  // (nx, Bp), (N, 2, Bp), (N+1, nx, Bp), (np, Bp)
  float *us, *xs, *viol, *conv, *lam, *ni;  // outputs; us, xs, lam are the state
  float* work;  // (N (2 + 2 nx), Bp): k (N, 2) then K (N, 2 nx)
  int N, substeps, sbox, outer, inner, Bp;
};

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
// models: the row functions of ops/cuda/parking_factory.py and
// ops/cuda/ilqr_dyn_kernel.py, operation for operation
// ---------------------------------------------------------------------------

// Kinematic bicycle, p = (acc, fric), mc = (kb, kb^2, 1 / lr).
struct KinematicRows {
  static constexpr int NX = 4, NP = 2, JW = 6;
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
  static constexpr int NX = 6, NP = 0, JW = 2;
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

// A[k][i] = dx+_k / dx_i and B[k][j] = dx+_k / du_j of one interval, JW
// directions per dual pass.
template <class M, bool RK4>
__device__ __forceinline__ void jacobian(const Consts& c, int substeps, const float* X,
                                         const float* U, const float* p,
                                         float (&A)[M::NX][M::NX], float (&B)[M::NX][NU]) {
  constexpr int NX = M::NX, NZ = NX + NU, W = M::JW;
#pragma unroll
  for (int c0 = 0; c0 < NZ; c0 += W) {
    Dual<W> xd[NX], ud[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      xd[i].v = X[i];
#pragma unroll
      for (int q = 0; q < W; ++q) xd[i].d[q] = c0 + q == i ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      ud[j].v = U[j];
#pragma unroll
      for (int q = 0; q < W; ++q) ud[j].d[q] = c0 + q == NX + j ? 1.0f : 0.0f;
    }
    step<M, RK4>(c, substeps, xd, ud, p);
#pragma unroll
    for (int k = 0; k < NX; ++k) {
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int col = c0 + q;
        if (col < NX)
          A[k][col] = xd[k].d[q];
        else if (col < NZ)
          B[k][col - NX] = xd[k].d[q];
      }
    }
  }
}

// Lane-offset views of the [stage][row][lane] buffers.
template <int NX>
struct LaneView {
  float *xs, *us, *lam, *k, *K;
  const float* refs;
  int Bp, nc, N;
  __device__ float& x(int t, int i) const { return xs[(t * NX + i) * Bp]; }
  __device__ float& u(int t, int j) const { return us[(t * NU + j) * Bp]; }
  __device__ float& l(int t, int r) const { return lam[(t * nc + r) * Bp]; }
  __device__ float& kg(int t, int j) const { return k[(t * NU + j) * Bp]; }
  __device__ float& Kg(int t, int r) const { return K[(t * NU * NX + r) * Bp]; }
  __device__ float r(int t, int i) const { return refs[(t * NX + i) * Bp]; }
};

// Constraint rows in the reference's order: u - ub (2), lb - u (2), then with
// the state box x - ub (nx), lb - x (nx). Returns the row count.
template <int NX>
__device__ __forceinline__ int constraint_rows(const Consts& c, bool sbox, const float* x,
                                               const float* u, float* cr) {
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[j] = u[j] - c.ubu[j];
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[NU + j] = c.lbu[j] - u[j];
  if (!sbox) return 2 * NU;
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[2 * NU + i] = x[i] - c.ubx[i];
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[2 * NU + NX + i] = c.lbx[i] - x[i];
  return 2 * NU + 2 * NX;
}

template <int NX>
__device__ __forceinline__ float quad_err(const Consts& c, const float* x, const float* r) {
  float q = c.qd[0] * (x[0] - r[0]) * (x[0] - r[0]);
#pragma unroll
  for (int i = 1; i < NX; ++i) q = q + c.qd[i] * (x[i] - r[i]) * (x[i] - r[i]);
  return q;
}

// Tracking cost plus the AL penalty sum_r (act_r^2 - lam_r^2) / (2 mu).
template <int NX>
__device__ __forceinline__ float stage_cost(const Consts& c, bool sbox, const float* x,
                                            const float* u, const float* r,
                                            const float* lam, float mu) {
  float cr[2 * NU + 2 * NX];
  const int nc = constraint_rows<NX>(c, sbox, x, u, cr);
  const float quad = quad_err<NX>(c, x, r) + (c.rd[0] * u[0] * u[0] + c.rd[1] * u[1] * u[1]);
  float phi = 0.0f;
#pragma unroll
  for (int q = 0; q < 2 * NU + 2 * NX; ++q) {
    if (q < nc) {
      const float act = relu(lam[q] + mu * cr[q]);
      const float term = act * act - lam[q] * lam[q];
      phi = q == 0 ? term : phi + term;
    }
  }
  return quad + phi / (2.0f * mu);
}

template <int NX>
__device__ __forceinline__ void load_x(const LaneView<NX>& w, int t, float* x) {
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = w.x(t, i);
}
template <int NX>
__device__ __forceinline__ void load_r(const LaneView<NX>& w, int t, float* r) {
#pragma unroll
  for (int i = 0; i < NX; ++i) r[i] = w.r(t, i);
}
template <int NX>
__device__ __forceinline__ void load_lam(const LaneView<NX>& w, int t, bool sbox, float* l) {
#pragma unroll
  for (int q = 0; q < 2 * NU + 2 * NX; ++q) l[q] = (q < 2 * NU || sbox) ? w.l(t, q) : 0.0f;
}

template <int NX>
__device__ __forceinline__ float total_cost(const Consts& c, const LaneView<NX>& w, bool sbox,
                                            float mu) {
  float x[NX], r[NX], l[2 * NU + 2 * NX];
  float cost = 0.0f;
  for (int t = 0; t < w.N; ++t) {
    load_x(w, t, x);
    load_r(w, t, r);
    load_lam(w, t, sbox, l);
    const float u[NU] = {w.u(t, 0), w.u(t, 1)};
    const float sc = stage_cost<NX>(c, sbox, x, u, r, l, mu);
    cost = t == 0 ? sc : cost + sc;
  }
  load_x(w, w.N, x);
  load_r(w, w.N, r);
  return cost + c.qn * quad_err<NX>(c, x, r);
}

// Riccati sweep over the stored trajectory; writes the gains and returns
// whether every stage's regularised Quu was positive definite, and max|Qu|.
template <class M, bool RK4>
__device__ __forceinline__ void backward(const Consts& c, const LaneView<M::NX>& w,
                                         const float* p, int substeps, bool sbox, float mu,
                                         float reg, bool& ok_out, float& grad_out) {
  constexpr int NX = M::NX;
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
    float X[NX], R[NX], L[2 * NU + 2 * NX];
    load_x(w, t, X);
    load_r(w, t, R);
    load_lam(w, t, sbox, L);
    const float U[NU] = {w.u(t, 0), w.u(t, 1)};
    float A[NX][NX], Bm[NX][NU];
    jacobian<M, RK4>(c, substeps, X, U, p, A, Bm);

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
      const float act_u = relu(L[j] + mu * (U[j] - c.ubu[j]));
      const float act_l = relu(L[NU + j] + mu * (c.lbu[j] - U[j]));
      lu[j] = lu[j] + act_u - act_l;
      const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
      huu[j] = c.rd2[j] + mu * ind;
    }
    if (sbox) {
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
    // regularised 2x2 solve in closed form
    const float q00r = quu[0][0] + reg;
    const float q11r = quu[1][1] + reg;
    const float q01 = quu[0][1];
    const float det = q00r * q11r - q01 * q01;
    ok = ok && (q00r > 0.0f) && (det > 0.0f);
    const float det_safe = det > 0.0f ? det : 1.0f;
    const float inv[NU][NU] = {{q11r / det_safe, -q01 / det_safe},
                               {-q01 / det_safe, q00r / det_safe}};
    float kg[NU], Kg[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      kg[a] = -(inv[a][0] * Qu[0] + inv[a][1] * Qu[1]);
#pragma unroll
      for (int j = 0; j < NX; ++j) Kg[a][j] = -(inv[a][0] * Qux[0][j] + inv[a][1] * Qux[1][j]);
    }
    // Vx, Vxx with the unregularised Quu
    float g[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) g[a] = (quu[a][0] * kg[0] + quu[a][1] * kg[1]) + Qu[a];
#pragma unroll
    for (int j = 0; j < NX; ++j)
      Vx[j] = (Qx[j] + (Kg[0][j] * g[0] + Kg[1][j] * g[1])) +
              (Qux[0][j] * kg[0] + Qux[1][j] * kg[1]);
    float KQ[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) KQ[a][j] = quu[a][0] * Kg[0][j] + quu[a][1] * Kg[1][j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        V[i][j] = ((V[i][j] + (Kg[0][i] * KQ[0][j] + Kg[1][i] * KQ[1][j])) +
                   (Kg[0][i] * Qux[0][j] + Kg[1][i] * Qux[1][j])) +
                  (Qux[0][i] * Kg[0][j] + Qux[1][i] * Kg[1][j]);
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      w.kg(t, a) = kg[a];
#pragma unroll
      for (int j = 0; j < NX; ++j) w.Kg(t, a * NX + j) = Kg[a][j];
    }
    grad = nmax(grad, nmax(fabsf(Qu[0]), fabsf(Qu[1])));
  }
  ok_out = ok;
  grad_out = grad;
}

// Control of one line-search candidate at a stage: u = (uh + alpha k) + K dx.
template <int NX>
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

template <int NX>
__device__ __forceinline__ void load_stage(const LaneView<NX>& w, int t, float* xh, float* uh,
                                           float* kg, float* Kg) {
  load_x(w, t, xh);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    uh[j] = w.u(t, j);
    kg[j] = w.kg(t, j);
  }
#pragma unroll
  for (int q = 0; q < NU * NX; ++q) Kg[q] = w.Kg(t, q);
}

// Costs of the closed-loop rollouts under every line-search step, in one
// pass over the stages.
template <class M, bool RK4>
__device__ __forceinline__ void forward_costs(const Consts& c, const LaneView<M::NX>& w,
                                              const float* x0, const float* p, int substeps,
                                              bool sbox, float mu, float* cost) {
  constexpr int NX = M::NX;
  float x[NALPHA][NX];
#pragma unroll
  for (int s = 0; s < NALPHA; ++s) {
#pragma unroll
    for (int i = 0; i < NX; ++i) x[s][i] = x0[i];
    cost[s] = 0.0f;
  }
  float xh[NX], uh[NU], kg[NU], Kg[NU * NX], r[NX], l[2 * NU + 2 * NX];
  for (int t = 0; t < w.N; ++t) {
    load_stage(w, t, xh, uh, kg, Kg);
    load_r(w, t, r);
    load_lam(w, t, sbox, l);
#pragma unroll
    for (int s = 0; s < NALPHA; ++s) {
      float u[NU];
      ls_control<NX>(c.alpha[s], xh, uh, kg, Kg, x[s], u);
      const float sc = stage_cost<NX>(c, sbox, x[s], u, r, l, mu);
      cost[s] = t == 0 ? sc : cost[s] + sc;
      step<M, RK4>(c, substeps, x[s], u, p);
    }
  }
  load_r(w, w.N, r);
#pragma unroll
  for (int s = 0; s < NALPHA; ++s) cost[s] = cost[s] + c.qn * quad_err<NX>(c, x[s], r);
}

// Re-roll the accepted step, writing the new trajectory over the stored one
// (each stage is read before it is overwritten).
template <class M, bool RK4>
__device__ __forceinline__ void accept_step(const Consts& c, const LaneView<M::NX>& w,
                                            const float* x0, const float* p, int substeps,
                                            float alpha) {
  constexpr int NX = M::NX;
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i];
  float xh[NX], uh[NU], kg[NU], Kg[NU * NX];
  for (int t = 0; t < w.N; ++t) {
    load_stage(w, t, xh, uh, kg, Kg);
    float u[NU];
    ls_control<NX>(alpha, xh, uh, kg, Kg, x, u);
#pragma unroll
    for (int i = 0; i < NX; ++i) w.x(t, i) = x[i];
#pragma unroll
    for (int j = 0; j < NU; ++j) w.u(t, j) = u[j];
    step<M, RK4>(c, substeps, x, u, p);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) w.x(w.N, i) = x[i];
}

template <class M, bool RK4>
__global__ void tracker_tile_kernel(const Args g, const Consts c) {
  constexpr int NX = M::NX, NP = M::NP > 0 ? M::NP : 1;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int Bp = g.Bp, N = g.N;
  const bool sbox = g.sbox != 0;
  const int nc = 2 * NU + (sbox ? 2 * NX : 0);
  LaneView<NX> w;
  w.xs = g.xs + lane;
  w.us = g.us + lane;
  w.lam = g.lam + lane;
  w.k = g.work + lane;
  w.K = g.work + (size_t)NU * N * Bp + lane;
  w.refs = g.refs + lane;
  w.Bp = Bp;
  w.nc = nc;
  w.N = N;
  float p[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) p[q] = M::NP > 0 ? g.par[q * Bp + lane] : 0.0f;
  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = g.x0[i * Bp + lane];

  // init: controls from the warm start, multipliers zero, then a rollout
  for (int t = 0; t < N; ++t) {
#pragma unroll
    for (int j = 0; j < NU; ++j) w.u(t, j) = g.u0[(t * NU + j) * Bp + lane];
    for (int q = 0; q < nc; ++q) w.l(t, q) = 0.0f;
  }
  {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    for (int t = 0; t < N; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w.x(t, i) = x[i];
      const float u[NU] = {w.u(t, 0), w.u(t, 1)};
      step<M, RK4>(c, g.substeps, x, u, p);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) w.x(N, i) = x[i];
  }

  float mu = c.mu_init, viol = INFINITY, lam_step = INFINITY;
  int ni_total = 0;
  for (int oi = 0; oi < g.outer; ++oi) {
    if (__syncthreads_and((viol < c.viol_tol) && (lam_step < 1e-3f))) break;
    // inner Levenberg-iLQR on the current multipliers
    float cost = total_cost<NX>(c, w, sbox, mu);
    float reg = c.reg_init, grad = INFINITY;
    int it = 0;
    for (; it < g.inner; ++it) {
      if (__syncthreads_and(grad < c.grad_tol)) break;
      bool ok;
      backward<M, RK4>(c, w, p, g.substeps, sbox, mu, reg, ok, grad);
      float costs[NALPHA];
      forward_costs<M, RK4>(c, w, x0, p, g.substeps, sbox, mu, costs);
      float best = INFINITY;
#pragma unroll
      for (int s = 0; s < NALPHA; ++s) {
        if (!isfinite(costs[s])) costs[s] = INFINITY;
        best = fminf(best, costs[s]);
      }
      int pick = 0;  // ties go to the largest step: the first at the minimum
#pragma unroll
      for (int s = NALPHA - 1; s >= 0; --s)
        if (costs[s] <= best) pick = s;
      const bool improved = (best < cost - 1e-12f) && ok;
      if (improved) {
        accept_step<M, RK4>(c, w, x0, p, g.substeps, c.alpha[pick]);
        cost = best;
        reg = fmaxf(reg * 0.5f, c.reg_min);
      } else {
        reg = fminf(reg * 10.0f, c.reg_max);
      }
    }
    ni_total += it;
    // multiplier sweep: violation, lam update, lam step
    float v_n = 0.0f, step_n = 0.0f, lmax = 0.0f;
    float x[NX], cr[2 * NU + 2 * NX];
    for (int t = 0; t < N; ++t) {
      load_x(w, t, x);
      const float u[NU] = {w.u(t, 0), w.u(t, 1)};
      constraint_rows<NX>(c, sbox, x, u, cr);
#pragma unroll
      for (int q = 0; q < 2 * NU + 2 * NX; ++q) {
        if (q < nc) {
          const float lam = w.l(t, q);
          const float lam_n = relu(lam + mu * cr[q]);
          w.l(t, q) = lam_n;
          v_n = nmax(v_n, relu(cr[q]));
          step_n = nmax(step_n, fabsf(lam_n - lam));
          lmax = nmax(lmax, fabsf(lam_n));
        }
      }
    }
    viol = v_n;
    lam_step = step_n / (1.0f + lmax);
    if (viol > c.viol_tol) mu = fminf(mu * c.mu_scale, c.mu_max);
  }
  g.viol[lane] = viol;
  g.conv[lane] = viol < c.viol_tol ? 1.0f : 0.0f;
  g.ni[lane] = (float)ni_total;
}

template <class M>
static int launch(const float* x0, const float* u0, const float* refs, const float* par,
                  float* us, float* xs, float* viol, float* conv, float* lam, float* ni,
                  float* work, const float* consts, int n_consts, int N, int substeps,
                  int rk4, int sbox, int outer, int inner, int tile, int n_tiles,
                  void* stream) {
  if (n_consts * sizeof(float) != sizeof(Consts) || N < 1 || substeps < 1 || tile < 1 ||
      n_tiles < 1 || (M::NP > 0 && par == nullptr))
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Args g;
  g.x0 = x0; g.u0 = u0; g.refs = refs; g.par = par;
  g.us = us; g.xs = xs; g.viol = viol; g.conv = conv; g.lam = lam; g.ni = ni;
  g.work = work;
  g.N = N; g.substeps = substeps; g.sbox = sbox; g.outer = outer; g.inner = inner;
  g.Bp = tile * n_tiles;
  cudaStream_t s = (cudaStream_t)stream;
  if (rk4)
    tracker_tile_kernel<M, true><<<n_tiles, tile, 0, s>>>(g, c);
  else
    tracker_tile_kernel<M, false><<<n_tiles, tile, 0, s>>>(g, c);
  return (int)cudaGetLastError();
}

#define TRACKER_ENTRY(NAME, MODEL)                                                         \
  extern "C" int NAME(const float* x0, const float* u0, const float* refs, const float* par, \
                      float* us, float* xs, float* viol, float* conv, float* lam, float* ni, \
                      float* work, const float* consts, int n_consts, int N, int substeps,   \
                      int rk4, int sbox, int outer, int inner, int tile, int n_tiles,        \
                      void* stream) {                                                        \
    return launch<MODEL>(x0, u0, refs, par, us, xs, viol, conv, lam, ni, work, consts,      \
                         n_consts, N, substeps, rk4, sbox, outer, inner, tile, n_tiles,     \
                         stream);                                                           \
  }

TRACKER_ENTRY(tracker_kinematic_launch, KinematicRows)
TRACKER_ENTRY(tracker_pacejka_launch, PacejkaRows)

extern "C" const char* tracker_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
