// Fused batched stagewise Riccati interior-point solve of an LTI
// box-constrained LQ optimal-control problem: one thread per scenario lane,
// one CTA per tile of T lanes, the whole Mehrotra predictor-corrector solve
// and its active-set polish in one launch.
//
// Replaces the Pallas TPU kernel _stagewise_ip_tile_kernel in
// model_predictive_control_tpu/experimental/riccati_ip_kernel.py (wrapper
// stagewise_ip_solve_pallas). Plain twin: stagewise_ip_tiles_reference in
// model_predictive_control_tpu_torch/ops/cuda/riccati_ip_kernel.py, which does
// each element's operations in the same order.
//
// What it computes, per lane, in the equilibrated space: a rollout of the
// warm controls with balanced slacks (s = clip(distance, 1, 1e20), lam = 1/s);
// then up to `iters` iterations, each one backward Riccati sweep over the
// barrier-modified costs (gains K, Quu^-1, Qux), a predictor affine sweep
// (sigma = 0), the fraction-to-boundary step and the centering
// sigma = clip((mu_aff / mu)^3, 1e-8, 1), a corrector affine sweep with
// Mehrotra's second-order terms on the same factorization, a step of
// tau alpha_max, and finiteness guards on the direction and the candidate. A
// lane with mu < 50 eps freezes, a lane with a non-finite direction or
// candidate is latched dead; both keep their state by select; the loop ends
// when every lane of the tile is done (__syncthreads_and). Then the active set
// is read off lam > s, the problem is re-solved twice with an
// augmented-Lagrangian penalty (rho = 1e4) on the active bounds, and the
// polished trajectory is accepted if finite, feasible and sign-consistent.
//
// What bounds it: latency, not bytes or FLOPs. A lane's working set is
// 30 N floats at nx = 2, nu = 1 (12 KB at N = 100): it fits neither registers
// nor shared memory at a useful T, and each of the ~10 sweeps of an iteration
// is a dependent chain over the N stages (a division per stage in the
// factorization). At 4,096 lanes the card holds ~31 threads per SM. The
// design therefore:
//   - keeps every per-stage quantity in global memory laid out
//     [stage][row][lane], so that a warp's accesses coalesce (49 MB at 4,096
//     lanes and N = 100, about the size of the L2); xs and us live directly in
//     the output buffers;
//   - keeps the Riccati matrix P, the affine carries and the per-stage algebra
//     in registers, with NX and NU compile-time (-DNX, -DNU: one library per
//     size), the problem matrices and bounds in a kernel-argument struct and
//     the finite-bound masks as uniform flags (a bound that is not finite is
//     never read and contributes exactly nothing);
//   - recomputes the Newton slack/dual steps from the stored primal direction
//     in every sweep that needs them (step length, gap, guards, update)
//     instead of storing them: 4 fewer rows per bound and stage;
//   - takes T as a runtime parameter: smaller tiles let the tile-wide exit
//     fire earlier and put more CTAs on the SMs.
// Making it fast (several stages in flight per lane, fusing the elementwise
// sweeps, shared-memory staging) is left for later work.
//
// Built with nvcc -O3 for sm_90a with --fmad=false and without
// --use_fast_math: divisions are IEEE, denormals are kept, and the kernel is
// the same float program as its twin.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#ifndef NX
#define NX 2
#endif
#ifndef NU
#define NU 1
#endif

// Literals go through double, as the twin's Python floats do.
#define F(x) ((float)(x))

// Float constants, in the order ops/cuda/riccati_ip_kernel.py::_consts writes
// them; the problem data are the equilibrated ones.
struct Consts {
  float A[NX][NX], B[NX][NU], Q[NX][NX], R[NU][NU], Pf[NX][NX];
  float xlb[NX], xub[NX], ulb[NU], uub[NU];  // 0 where the bound is not finite
  float inv_count, tau, eps50, rho;
};

// 1 where the bound is finite.
struct Flags {
  int xl[NX], xu[NX], ul[NU], uu[NU];
};

struct Args {
  const float *x0, *u0;  // (NX, Bp), (N, NU, Bp)
  float *us, *xs, *mu, *prim, *succ, *it;  // outputs; us and xs are the state
  float* work;  // (workspace_rows, Bp)
  int N, iters, Bp;
};

// min / max that propagate NaN from either side (as torch.minimum/maximum)
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
// clip that keeps NaN (as torch.clamp)
__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One bound group (states x_1..x_N with n = NX, inputs u_0..u_{N-1} with
// n = NU): lane-offset views of its z rows and its slack and dual buffers,
// all (N, n, Bp), with its bounds and finite-bound flags.
template <int n>
struct Group {
  float *z, *sl, *su, *ll, *lu;
  const float *lb, *ub;
  const int *ml, *mu;
  int Bp;
  __device__ size_t at(int m, int i) const { return ((size_t)m * n + i) * Bp; }
};

struct Entry {
  float z, sl, su, ll, lu;
};

template <int n>
__device__ __forceinline__ Entry load(const Group<n>& g, int m, int i) {
  const size_t k = g.at(m, i);
  Entry e = {g.z[k], 1.0f, 1.0f, 0.0f, 0.0f};
  if (g.ml[i]) {
    e.sl = g.sl[k];
    e.ll = g.ll[k];
  }
  if (g.mu[i]) {
    e.su = g.su[k];
    e.lu = g.lu[k];
  }
  return e;
}

struct Step {
  float ds_l, ds_u, dl_l, dl_u;
};

// Newton slack and dual updates of one entry given its primal direction dz;
// CORR adds Mehrotra's second-order term from the predictor direction dza.
template <bool CORR>
__device__ __forceinline__ Step newton_step(const Entry& e, bool ml, bool mu, float lb,
                                            float ub, float dz, float dza, float sig_mu) {
  Step s = {0.0f, 0.0f, 0.0f, 0.0f};
  if (ml) {
    const float r_pl = e.z - e.sl - lb;
    float c_l = 0.0f;
    if (CORR) {
      const float ds_a = dza + r_pl;
      c_l = (-e.ll - (e.ll / e.sl) * ds_a) * ds_a;
    }
    s.ds_l = dz + r_pl;
    s.dl_l = (sig_mu - c_l - e.ll * e.sl - e.ll * s.ds_l) / e.sl;
  }
  if (mu) {
    const float r_pu = e.z + e.su - ub;
    float c_u = 0.0f;
    if (CORR) {
      const float ds_a = -dza - r_pu;
      c_u = (-e.lu - (e.lu / e.su) * ds_a) * ds_a;
    }
    s.ds_u = -dz - r_pu;
    s.dl_u = (sig_mu - c_u - e.lu * e.su - e.lu * s.ds_u) / e.su;
  }
  return s;
}

// The bound group's share of the Newton-system gradient at one entry.
template <bool CORR>
__device__ __forceinline__ float barrier_grad(const Entry& e, bool ml, bool mu, float lb,
                                              float ub, float dza, float sig_mu) {
  float acc = 0.0f;
  if (ml) {
    const float r_pl = e.z - e.sl - lb;
    float c_l = 0.0f;
    if (CORR) {
      const float ds_a = dza + r_pl;
      c_l = (-e.ll - (e.ll / e.sl) * ds_a) * ds_a;
    }
    acc = acc - (sig_mu - c_l) / e.sl + (e.ll / e.sl) * r_pl;
  }
  if (mu) {
    const float r_pu = e.z + e.su - ub;
    float c_u = 0.0f;
    if (CORR) {
      const float ds_a = -dza - r_pu;
      c_u = (-e.lu - (e.lu / e.su) * ds_a) * ds_a;
    }
    acc = acc + (sig_mu - c_u) / e.su + (e.lu / e.su) * r_pu;
  }
  return acc;
}

// Active-set read of one entry: active (0/1), active at the upper bound,
// the bound it sits on, the multiplier estimate.
struct Active {
  float act;
  bool a_u;
  float tgt, lh;
};

__device__ __forceinline__ Active active_set(const Entry& e, bool ml, bool mu, float lb,
                                             float ub) {
  const bool a_l = ml && (e.ll > e.sl);
  Active a;
  a.a_u = mu && (e.lu > e.su);
  a.act = (a_l || a.a_u) ? 1.0f : 0.0f;
  a.tgt = a.a_u ? ub : (ml ? lb : 0.0f);
  a.lh = (a.a_u ? e.lu : -e.ll) * a.act;
  return a;
}

// ---- sweeps without a carry between stages, one group at a time ------------

template <int n>
__device__ __forceinline__ void gap_add(const Group<n>& g, int m, float& tot) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const Entry e = load(g, m, i);
    if (g.ml[i]) tot = tot + e.sl * e.ll;
    if (g.mu[i]) tot = tot + e.su * e.lu;
  }
}

template <int n, bool CORR>
__device__ __forceinline__ void gap_after_add(const Group<n>& g, int m, const float* d,
                                              const float* da, float alpha, float sig_mu,
                                              float& tot) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const Entry e = load(g, m, i);
    const size_t k = g.at(m, i);
    const Step s = newton_step<CORR>(e, g.ml[i], g.mu[i], g.lb[i], g.ub[i], d[k],
                                     CORR ? da[k] : 0.0f, sig_mu);
    if (g.ml[i]) tot = tot + (e.sl + alpha * s.ds_l) * (e.ll + alpha * s.dl_l);
    if (g.mu[i]) tot = tot + (e.su + alpha * s.ds_u) * (e.lu + alpha * s.dl_u);
  }
}

__device__ __forceinline__ void ratio_test(float v, float dv, float& acc, bool& okf) {
  const float r = dv < 0.0f ? -v / (dv < F(-1e-30) ? dv : F(-1e-30)) : F(1e20);
  acc = nmin(acc, r);
  okf = okf && isfinite(dv);
}

template <int n, bool CORR>
__device__ __forceinline__ void alpha_add(const Group<n>& g, int m, const float* d,
                                          const float* da, float sig_mu, float& acc,
                                          bool& okf) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const Entry e = load(g, m, i);
    const size_t k = g.at(m, i);
    const float dz = d[k];
    const Step s = newton_step<CORR>(e, g.ml[i], g.mu[i], g.lb[i], g.ub[i], dz,
                                     CORR ? da[k] : 0.0f, sig_mu);
    if (g.ml[i]) ratio_test(e.sl, s.ds_l, acc, okf);
    if (g.mu[i]) ratio_test(e.su, s.ds_u, acc, okf);
    if (g.ml[i]) ratio_test(e.ll, s.dl_l, acc, okf);
    if (g.mu[i]) ratio_test(e.lu, s.dl_u, acc, okf);
    okf = okf && isfinite(dz);
  }
}

// Candidate-finiteness check (APPLY = false) or the update by select
// (APPLY = true) of one group's stage.
template <int n, bool APPLY>
__device__ __forceinline__ void candidate(const Group<n>& g, int m, const float* d,
                                          const float* da, float alpha, float sig_mu,
                                          bool sel, bool& fin) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const Entry e = load(g, m, i);
    const size_t k = g.at(m, i);
    const float dz = d[k];
    const Step s =
        newton_step<true>(e, g.ml[i], g.mu[i], g.lb[i], g.ub[i], dz, da[k], sig_mu);
    const float z_n = e.z + alpha * dz;
    const float sl_n = e.sl + alpha * s.ds_l, ll_n = e.ll + alpha * s.dl_l;
    const float su_n = e.su + alpha * s.ds_u, lu_n = e.lu + alpha * s.dl_u;
    if (APPLY) {
      if (sel) {
        g.z[k] = z_n;
        if (g.ml[i]) {
          g.sl[k] = sl_n;
          g.ll[k] = ll_n;
        }
        if (g.mu[i]) {
          g.su[k] = su_n;
          g.lu[k] = lu_n;
        }
      }
    } else {
      fin = fin && isfinite(z_n);
      if (g.ml[i]) fin = fin && isfinite(sl_n) && isfinite(ll_n);
      if (g.mu[i]) fin = fin && isfinite(su_n) && isfinite(lu_n);
    }
  }
}

template <int n>
__device__ __forceinline__ float violation(const Group<n>& g, const float* z, int m) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float zi = z[g.at(m, i)];
    if (g.ml[i]) v = nmax(v, g.lb[i] - zi);
    if (g.mu[i]) v = nmax(v, zi - g.ub[i]);
  }
  return v;
}

// ---- the linear terms of the affine sweeps ----------------------------------

enum Mode { PRED, CORR_, POLISH };

// Diagonal additions to the stage cost: the barrier Hessian lam/s, or the
// polish's penalty rho on the active entries.
template <int n, bool POL>
__device__ __forceinline__ void sigma_rows(const Group<n>& g, int m, float rho, float* out) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const Entry e = load(g, m, i);
    if (POL) {
      out[i] = active_set(e, g.ml[i], g.mu[i], g.lb[i], g.ub[i]).act * rho;
    } else {
      float acc = 0.0f;
      if (g.ml[i]) acc = acc + e.ll / e.sl;
      if (g.mu[i]) acc = acc + e.lu / e.su;
      out[i] = acc;
    }
  }
}

// Linear term of group g at stage-index m: cost gradient (W z, with W the
// stage's weight) plus barrier gradient, or the polish's act (lh - rho tgt).
template <int n, Mode MODE>
__device__ __forceinline__ void linear_term(const Group<n>& g, int m, const float (*W)[n],
                                            const float* da, const float* lh, float sig_mu,
                                            float rho, float* out) {
  if (MODE == POLISH) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const Active a = active_set(load(g, m, i), g.ml[i], g.mu[i], g.lb[i], g.ub[i]);
      out[i] = a.act * (lh[g.at(m, i)] - rho * a.tgt);
    }
  } else {
    Entry e[n];
#pragma unroll
    for (int i = 0; i < n; ++i) e[i] = load(g, m, i);
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float quad = W[j][0] * e[0].z;
#pragma unroll
      for (int i = 1; i < n; ++i) quad = quad + W[j][i] * e[i].z;
      const float bar =
          barrier_grad<MODE == CORR_>(e[j], g.ml[j], g.mu[j], g.lb[j], g.ub[j],
                                      MODE == CORR_ ? da[g.at(m, j)] : 0.0f, sig_mu);
      out[j] = quad + bar;
    }
  }
}

// Everything a sweep needs, with the lane offset applied to every pointer.
struct Lane {
  Group<NX> gx;
  Group<NU> gu;
  float *K, *Qi, *Qux, *kff;  // (N, NU NX), (N, NU NU), (N, NU NX), (N, NU)
  float *dx, *du, *dxa, *dua;  // directions at x_{m+1} / u_m: (N, NX), (N, NU)
  float *lhx, *lhu;            // polish multipliers
  int N, Bp;
};

// Backward Riccati over the modified costs; fills K, Qi, Qux. P's upper
// triangle is computed and mirrored.
template <bool POL>
__device__ __forceinline__ void factor_sweep(const Consts& c, const Lane& w) {
  const int N = w.N, Bp = w.Bp;
  float P[NX][NX], sx[NX], su[NU];
  sigma_rows<NX, POL>(w.gx, N - 1, c.rho, sx);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = c.Pf[i][j];
    P[i][i] = P[i][i] + sx[i];
  }
  for (int t = N - 1; t >= 0; --t) {
    sigma_rows<NU, POL>(w.gu, t, c.rho, su);
    float PB[NX][NU], Quu[NU][NU], Qi[NU][NU], PA[NX][NX], Qux[NU][NX], K[NU][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        float acc = P[i][0] * c.B[0][a];
#pragma unroll
        for (int j = 1; j < NX; ++j) acc = acc + P[i][j] * c.B[j][a];
        PB[i][a] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int b = a; b < NU; ++b) {
        float acc = c.R[a][b];
        if (a == b) acc = acc + su[a];
#pragma unroll
        for (int i = 0; i < NX; ++i) acc = acc + c.B[i][a] * PB[i][b];
        Quu[a][b] = acc;
        Quu[b][a] = acc;
      }
    }
    if (NU == 1) {
      Qi[0][0] = 1.0f / Quu[0][0];
    } else {
      const float det = Quu[0][0] * Quu[NU - 1][NU - 1] - Quu[0][NU - 1] * Quu[0][NU - 1];
      const float inv_det = 1.0f / det;
      const float off = -Quu[0][NU - 1] * inv_det;
      Qi[0][0] = Quu[NU - 1][NU - 1] * inv_det;
      Qi[0][NU - 1] = off;
      Qi[NU - 1][0] = off;
      Qi[NU - 1][NU - 1] = Quu[0][0] * inv_det;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float acc = P[i][0] * c.A[0][j];
#pragma unroll
        for (int m = 1; m < NX; ++m) acc = acc + P[i][m] * c.A[m][j];
        PA[i][j] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float acc = c.B[0][a] * PA[0][j];
#pragma unroll
        for (int i = 1; i < NX; ++i) acc = acc + c.B[i][a] * PA[i][j];
        Qux[a][j] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float acc = Qi[a][0] * Qux[0][j];
#pragma unroll
        for (int b = 1; b < NU; ++b) acc = acc + Qi[a][b] * Qux[b][j];
        K[a][j] = -acc;
        w.K[((size_t)t * NU * NX + a * NX + j) * Bp] = K[a][j];
        w.Qux[((size_t)t * NU * NX + a * NX + j) * Bp] = Qux[a][j];
      }
#pragma unroll
      for (int b = 0; b < NU; ++b) w.Qi[((size_t)t * NU * NU + a * NU + b) * Bp] = Qi[a][b];
    }
    if (t == 0) break;  // dx_0 is fixed: no cost-to-go at stage 0
    sigma_rows<NX, POL>(w.gx, t - 1, c.rho, sx);
    float Pn[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j) {
        float acc = c.Q[i][j];
        if (i == j) acc = acc + sx[i];
#pragma unroll
        for (int m = 0; m < NX; ++m) acc = acc + c.A[m][i] * PA[m][j];
#pragma unroll
        for (int a = 0; a < NU; ++a) acc = acc + Qux[a][i] * K[a][j];
        Pn[i][j] = acc;
        Pn[j][i] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) P[i][j] = Pn[i][j];
  }
}

template <Mode MODE>
__device__ __forceinline__ void linear_terms(const Consts& c, const Lane& w, int m,
                                             float sig_mu, float* q, float* r) {
  linear_term<NX, MODE>(w.gx, m, m == w.N - 1 ? c.Pf : c.Q, w.dxa, w.lhx, sig_mu, c.rho, q);
  linear_term<NU, MODE>(w.gu, m, c.R, w.dua, w.lhu, sig_mu, c.rho, r);
}

// The affine backward and forward sweeps over the current factorization;
// the direction at x_{m+1} goes to dxs[m], the one at u_m to dus[m]. x_init
// is the forward sweep's start (nullptr: zero).
template <Mode MODE>
__device__ __forceinline__ void affine_solve(const Consts& c, const Lane& w, float sig_mu,
                                             float* dxs, float* dus, const float* x_init) {
  const int N = w.N, Bp = w.Bp;
  float p[NX], q[NX], r[NU], kff[NU];
  linear_terms<MODE>(c, w, N - 1, sig_mu, p, r);
  for (int t = N - 1; t >= 0; --t) {
    if (t < N - 1) linear_term<NU, MODE>(w.gu, t, c.R, w.dua, w.lhu, sig_mu, c.rho, r);
    float qu[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = c.B[0][a] * p[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) acc = acc + c.B[i][a] * p[i];
      qu[a] = r[a] + acc;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = w.Qi[((size_t)t * NU * NU + a * NU) * Bp] * qu[0];
#pragma unroll
      for (int b = 1; b < NU; ++b) acc = acc + w.Qi[((size_t)t * NU * NU + a * NU + b) * Bp] * qu[b];
      kff[a] = -acc;
      w.kff[((size_t)t * NU + a) * Bp] = kff[a];
    }
    if (t == 0) break;
    linear_term<NX, MODE>(w.gx, t - 1, c.Q, w.dxa, w.lhx, sig_mu, c.rho, q);
    float pn[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float acc = q[j];
#pragma unroll
      for (int i = 0; i < NX; ++i) acc = acc + c.A[i][j] * p[i];
#pragma unroll
      for (int a = 0; a < NU; ++a) acc = acc + w.Qux[((size_t)t * NU * NX + a * NX + j) * Bp] * kff[a];
      pn[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) p[j] = pn[j];
  }
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = x_init ? x_init[i] : 0.0f;
  for (int t = 0; t < N; ++t) {
    float du[NU], dn[NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = w.K[((size_t)t * NU * NX + a * NX) * Bp] * dx[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + w.K[((size_t)t * NU * NX + a * NX + j) * Bp] * dx[j];
      du[a] = w.kff[((size_t)t * NU + a) * Bp] + acc;
      dus[((size_t)t * NU + a) * Bp] = du[a];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = c.A[i][0] * dx[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + c.A[i][j] * dx[j];
#pragma unroll
      for (int a = 0; a < NU; ++a) acc = acc + c.B[i][a] * du[a];
      dn[i] = acc;
      dxs[((size_t)t * NX + i) * Bp] = acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = dn[i];
  }
}

__device__ __forceinline__ float gap_sweep(const Consts& c, const Lane& w) {
  float tot = 0.0f;
  for (int m = 0; m < w.N; ++m) {
    gap_add(w.gx, m, tot);
    gap_add(w.gu, m, tot);
  }
  return tot * c.inv_count;
}

template <bool CORR>
__device__ __forceinline__ float gap_after_sweep(const Consts& c, const Lane& w,
                                                 const float* dxs, const float* dus,
                                                 float alpha, float sig_mu) {
  float tot = 0.0f;
  for (int m = 0; m < w.N; ++m) {
    gap_after_add<NX, CORR>(w.gx, m, dxs, w.dxa, alpha, sig_mu, tot);
    gap_after_add<NU, CORR>(w.gu, m, dus, w.dua, alpha, sig_mu, tot);
  }
  return tot * c.inv_count;
}

template <bool CORR>
__device__ __forceinline__ float alpha_sweep(const Lane& w, const float* dxs, const float* dus,
                                             float sig_mu, bool& okf) {
  float acc = F(1e20);
  okf = true;
  for (int m = 0; m < w.N; ++m) {
    alpha_add<NX, CORR>(w.gx, m, dxs, w.dxa, sig_mu, acc, okf);
    alpha_add<NU, CORR>(w.gu, m, dus, w.dua, sig_mu, acc, okf);
  }
  return acc > 1.0f ? 1.0f : acc;
}

__global__ void stagewise_ip_tile_kernel(const Args g, const Consts c, const Flags f) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int Bp = g.Bp, N = g.N;
  const size_t S = (size_t)N * Bp;  // one row block of the workspace

  Lane w;
  w.N = N;
  w.Bp = Bp;
  float* p = g.work + lane;
  w.gx.z = g.xs + (size_t)NX * Bp + lane;  // x_1 ..
  w.gx.sl = p; p += NX * S;
  w.gx.su = p; p += NX * S;
  w.gx.ll = p; p += NX * S;
  w.gx.lu = p; p += NX * S;
  w.gx.lb = c.xlb; w.gx.ub = c.xub; w.gx.ml = f.xl; w.gx.mu = f.xu; w.gx.Bp = Bp;
  w.gu.z = g.us + lane;
  w.gu.sl = p; p += NU * S;
  w.gu.su = p; p += NU * S;
  w.gu.ll = p; p += NU * S;
  w.gu.lu = p; p += NU * S;
  w.gu.lb = c.ulb; w.gu.ub = c.uub; w.gu.ml = f.ul; w.gu.mu = f.uu; w.gu.Bp = Bp;
  w.K = p; p += NU * NX * S;
  w.Qi = p; p += NU * NU * S;
  w.Qux = p; p += NU * NX * S;
  w.kff = p; p += NU * S;
  w.dx = p; p += NX * S;
  w.du = p; p += NU * S;
  w.dxa = p; p += NX * S;
  w.dua = p; p += NU * S;
  w.lhx = p; p += NX * S;
  w.lhu = p;

  // ---- init: rollout of the warm controls, balanced slacks -----------------
  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    x0[i] = g.x0[(size_t)i * Bp + lane];
    g.xs[(size_t)i * Bp + lane] = x0[i];
  }
  {
    float x[NX], u[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    for (int t = 0; t < N; ++t) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        u[a] = g.u0[((size_t)t * NU + a) * Bp + lane];
        w.gu.z[w.gu.at(t, a)] = u[a];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = c.A[i][0] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) acc = acc + c.A[i][j] * x[j];
#pragma unroll
        for (int a = 0; a < NU; ++a) acc = acc + c.B[i][a] * u[a];
        xn[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        x[i] = xn[i];
        const size_t k = w.gx.at(t, i);
        w.gx.z[k] = x[i];
        if (f.xl[i]) {
          const float s = clipf(x[i] - c.xlb[i], 1.0f, F(1e20));
          w.gx.sl[k] = s;
          w.gx.ll[k] = 1.0f / s;
        }
        if (f.xu[i]) {
          const float s = clipf(c.xub[i] - x[i], 1.0f, F(1e20));
          w.gx.su[k] = s;
          w.gx.lu[k] = 1.0f / s;
        }
      }
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const size_t k = w.gu.at(t, a);
        if (f.ul[a]) {
          const float s = clipf(u[a] - c.ulb[a], 1.0f, F(1e20));
          w.gu.sl[k] = s;
          w.gu.ll[k] = 1.0f / s;
        }
        if (f.uu[a]) {
          const float s = clipf(c.uub[a] - u[a], 1.0f, F(1e20));
          w.gu.su[k] = s;
          w.gu.lu[k] = 1.0f / s;
        }
      }
    }
  }

  // ---- Mehrotra predictor-corrector loop, tile-wide exit -------------------
  bool done = false, dead = false;
  float mu = gap_sweep(c, w);
  int it = 0;
  for (; it < g.iters; ++it) {
    if (__syncthreads_and(done)) break;
    const bool frozen = mu < c.eps50;
    factor_sweep<false>(c, w);
    // predictor: pure Newton (sigma = 0)
    affine_solve<PRED>(c, w, 0.0f, w.dxa, w.dua, nullptr);
    bool okf;
    const float alpha_aff = alpha_sweep<false>(w, w.dxa, w.dua, 0.0f, okf);
    const float mu_aff = gap_after_sweep<false>(c, w, w.dxa, w.dua, alpha_aff, 0.0f);
    const float ratio = mu_aff / (mu < F(1e-30) ? F(1e-30) : mu);
    const float sigma = clipf(ratio * ratio * ratio, F(1e-8), 1.0f);
    const float sig_mu = sigma * mu;
    // corrector: recenter + second-order terms, same factorization
    affine_solve<CORR_>(c, w, sig_mu, w.dx, w.du, nullptr);
    const float alpha_raw = alpha_sweep<true>(w, w.dx, w.du, sig_mu, okf);
    const float alpha = c.tau * alpha_raw;
    okf = okf && isfinite(alpha);
    bool fin = true;
    for (int m = 0; m < N; ++m) {
      candidate<NX, false>(w.gx, m, w.dx, w.dxa, alpha, sig_mu, false, fin);
      candidate<NU, false>(w.gu, m, w.du, w.dua, alpha, sig_mu, false, fin);
    }
    okf = okf && fin;
    // a rejected lane recomputes the same direction forever: latch it dead
    dead = dead || !okf;
    const bool sel = !frozen && okf;
    for (int m = 0; m < N; ++m) {
      candidate<NX, true>(w.gx, m, w.dx, w.dxa, alpha, sig_mu, sel, fin);
      candidate<NU, true>(w.gu, m, w.du, w.dua, alpha, sig_mu, sel, fin);
    }
    mu = gap_sweep(c, w);
    done = (mu < c.eps50) || dead;
  }
  const float mu_final = mu;

  // ---- active-set polish (augmented Lagrangian, two passes) ----------------
  for (int m = 0; m < N; ++m) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      w.lhx[w.gx.at(m, i)] = active_set(load(w.gx, m, i), f.xl[i], f.xu[i], c.xlb[i], c.xub[i]).lh;
#pragma unroll
    for (int a = 0; a < NU; ++a)
      w.lhu[w.gu.at(m, a)] = active_set(load(w.gu, m, a), f.ul[a], f.uu[a], c.ulb[a], c.uub[a]).lh;
  }
  factor_sweep<true>(c, w);
  for (int pass = 0; pass < 2; ++pass) {
    affine_solve<POLISH>(c, w, 0.0f, w.dx, w.du, x0);
    for (int m = 0; m < N; ++m) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const size_t k = w.gx.at(m, i);
        const Active a = active_set(load(w.gx, m, i), f.xl[i], f.xu[i], c.xlb[i], c.xub[i]);
        w.lhx[k] = w.lhx[k] + c.rho * a.act * (w.dx[k] - a.tgt);
      }
#pragma unroll
      for (int b = 0; b < NU; ++b) {
        const size_t k = w.gu.at(m, b);
        const Active a = active_set(load(w.gu, m, b), f.ul[b], f.uu[b], c.ulb[b], c.uub[b]);
        w.lhu[k] = w.lhu[k] + c.rho * a.act * (w.du[k] - a.tgt);
      }
    }
  }

  // ---- polish acceptance and final status -----------------------------------
  float scale_m = 0.0f, pviol = 0.0f;
  bool pfin = true, dual_ok = true;
#pragma unroll
  for (int i = 0; i < NX; ++i) scale_m = nmax(scale_m, fabsf(x0[i]));
  for (int m = 0; m < N; ++m) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const size_t k = w.gx.at(m, i);
      const Entry e = load(w.gx, m, i);
      scale_m = nmax(scale_m, fabsf(e.z));
      pfin = pfin && isfinite(w.dx[k]);
      const Active a = active_set(e, f.xl[i], f.xu[i], c.xlb[i], c.xub[i]);
      const float lh = w.lhx[k];
      // the polished multiplier sits on its bound's side of zero
      if (a.act > 0.5f) dual_ok = dual_ok && (a.a_u ? lh >= 0.0f : lh <= 0.0f);
    }
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      const size_t k = w.gu.at(m, b);
      const Entry e = load(w.gu, m, b);
      scale_m = nmax(scale_m, fabsf(e.z));
      pfin = pfin && isfinite(w.du[k]);
      const Active a = active_set(e, f.ul[b], f.uu[b], c.ulb[b], c.uub[b]);
      const float lh = w.lhu[k];
      if (a.act > 0.5f) dual_ok = dual_ok && (a.a_u ? lh >= 0.0f : lh <= 0.0f);
    }
    pviol = nmax(pviol, violation(w.gx, w.dx, m));
    pviol = nmax(pviol, violation(w.gu, w.du, m));
  }
  const float scale = 1.0f + scale_m;
  const float feas_tol = F(1e-4) * scale;
  const bool polish_ok = pfin && (pviol < feas_tol) && (mu_final < F(1e-2) * scale) && dual_ok;
  float prim = 0.0f;
  for (int m = 0; m < N; ++m) {
    if (polish_ok) {
#pragma unroll
      for (int i = 0; i < NX; ++i) w.gx.z[w.gx.at(m, i)] = w.dx[w.gx.at(m, i)];
#pragma unroll
      for (int b = 0; b < NU; ++b) w.gu.z[w.gu.at(m, b)] = w.du[w.gu.at(m, b)];
    }
    prim = nmax(prim, violation(w.gx, w.gx.z, m));
    prim = nmax(prim, violation(w.gu, w.gu.z, m));
  }
  const bool success = polish_ok ? (prim < feas_tol) && (mu_final < F(1e-4) * scale)
                                 : (mu_final < feas_tol) && (prim < feas_tol);
  g.mu[lane] = mu_final;
  g.prim[lane] = prim;
  g.succ[lane] = success ? 1.0f : 0.0f;
  g.it[lane] = (float)it;
}

extern "C" long stagewise_ip_workspace_rows(int N) {
  return (long)N * (4 * (NX + NU) + 2 * NU * NX + NU * NU + NU + 2 * (NX + NU) + NX + NU);
}

extern "C" int stagewise_ip_tiles_launch(const float* x0, const float* u0, float* us, float* xs,
                                         float* mu, float* prim, float* succ, float* it,
                                         float* work, const float* consts, const int* flags,
                                         int n_consts, int n_flags, int nx, int nu, int N,
                                         int iters, int tile, int n_tiles, void* stream) {
  if (nx != NX || nu != NU || n_consts * sizeof(float) != sizeof(Consts) ||
      n_flags * sizeof(int) != sizeof(Flags) || N < 1 || tile < 1 || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Flags f;
  memcpy(&f, flags, sizeof(Flags));
  Args g;
  g.x0 = x0; g.u0 = u0;
  g.us = us; g.xs = xs; g.mu = mu; g.prim = prim; g.succ = succ; g.it = it;
  g.work = work;
  g.N = N; g.iters = iters; g.Bp = tile * n_tiles;
  cudaStream_t s = (cudaStream_t)stream;
  stagewise_ip_tile_kernel<<<n_tiles, tile, 0, s>>>(g, c, f);
  return (int)cudaGetLastError();
}

extern "C" const char* stagewise_ip_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
