// Native float64 NLP oracle for the session-4 parking OCP: single-shooting
// SQP with forward-mode (dual-number) AD and an ADMM box-QP subproblem solver.
//
// Role: the in-repo replacement for the reference's *nonlinear* native solver
// tier. The reference transcribes the parking OCP symbolically with CasADi
// (C++ autodiff) and solves it with IPOPT (C++/Fortran interior point) at
// session_4/main.py:39,116. This library plays both parts natively and
// in-repo: dual numbers give exact derivatives of the rolled-out dynamics
// (CasADi's role), and a Gauss-Newton SQP with an ℓ1-merit line search over
// ADMM+polish QP subproblems gives the constrained solve (IPOPT's role).
// It is the host-side float64 ground truth used by tests to certify the
// on-device JAX SQP path (solvers/sqp.py) independently of scipy.
//
// Problem (matches solvers/parking.py::make_parking_ocp exactly):
//   model     kinematic bicycle, forward-Euler discretization (main.py:76)
//   cost      Σ_{k=0}^{N-1} (x_kᵀQx_k + u_kᵀRu_k) + x_NᵀQ_N x_N  (main.py:72-74)
//   s.t.      state box on x_1..x_N (main.py:91-93)
//             9 covering-circle clearances per stage when an obstacle is
//             present: ‖c_i(x_k) − o_j‖² ≥ (r + r_p)²  (main.py:95-104)
//             input box on every u_k (main.py:68-69)
//   vars      stacked controls ū (single shooting, main.py:108)
//
// Build: g++ -O3 -shared -fPIC nlp_oracle.cpp qp_oracle.cpp (driven by
// oracle/native_nlp.py; links the ADMM QP solver from qp_oracle.cpp).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" int admm_box_qp(const double* P, const double* q, const double* A,
                           const double* l, const double* u, int n, int m,
                           double rho, double sigma, int iters, double eps_abs,
                           int do_polish, double* x, double* y,
                           uint8_t* converged);

namespace {

constexpr int NX = 4;  // (p_x, p_y, psi, v)
constexpr int NU = 2;  // (drive a, steer delta)
constexpr int W = NX + NU;

// ---- forward-mode dual numbers (value + gradient wrt one stage's (x, u)) ---

struct Dual {
  double v;
  double g[W];
  Dual() : v(0) { std::memset(g, 0, sizeof(g)); }
  explicit Dual(double val) : v(val) { std::memset(g, 0, sizeof(g)); }
};

inline Dual seed(double val, int idx) {
  Dual d(val);
  d.g[idx] = 1.0;
  return d;
}
inline Dual operator+(const Dual& a, const Dual& b) {
  Dual r(a.v + b.v);
  for (int i = 0; i < W; ++i) r.g[i] = a.g[i] + b.g[i];
  return r;
}
inline Dual operator-(const Dual& a, const Dual& b) {
  Dual r(a.v - b.v);
  for (int i = 0; i < W; ++i) r.g[i] = a.g[i] - b.g[i];
  return r;
}
inline Dual operator*(const Dual& a, const Dual& b) {
  Dual r(a.v * b.v);
  for (int i = 0; i < W; ++i) r.g[i] = a.g[i] * b.v + a.v * b.g[i];
  return r;
}
inline Dual operator*(double s, const Dual& a) {
  Dual r(s * a.v);
  for (int i = 0; i < W; ++i) r.g[i] = s * a.g[i];
  return r;
}
inline Dual operator+(const Dual& a, double s) {
  Dual r = a;
  r.v += s;
  return r;
}
// chain rule through a unary primitive with derivative `d` at a.v
inline Dual unary(const Dual& a, double val, double d) {
  Dual r(val);
  for (int i = 0; i < W; ++i) r.g[i] = d * a.g[i];
  return r;
}
inline Dual sin(const Dual& a) { return unary(a, std::sin(a.v), std::cos(a.v)); }
inline Dual cos(const Dual& a) { return unary(a, std::cos(a.v), -std::sin(a.v)); }
inline Dual tan(const Dual& a) {
  double t = std::tan(a.v);
  return unary(a, t, 1.0 + t * t);
}
inline Dual atan(const Dual& a) {
  return unary(a, std::atan(a.v), 1.0 / (1.0 + a.v * a.v));
}
// let the templated model below resolve the same calls for plain double
using std::atan;
using std::cos;
using std::sin;
using std::tan;

// ---- vehicle model (mirrors models/bicycle.py::kinematic_bicycle_ode) ------

struct VehicleParams {
  double axis_front, axis_rear, friction, acceleration;
  double length, width;
  double min_pos_x, max_pos_x, min_pos_y, max_pos_y;
  double min_heading, max_heading, min_vel, max_vel;
  double min_drive, max_drive, max_steer;
};

// continuous-time kinematic bicycle ODE; T = Dual (derivative path) or double
// (plain numeric path, e.g. the closed-loop plant — 1/7th the flops of duals)
template <typename T>
void bicycle_ode(const VehicleParams& p, const T x[NX], const T u[NU],
                 T out[NX]) {
  const T& psi = x[2];
  const T& v = x[3];
  const T& a = u[0];
  const T& delta = u[1];
  double lf = p.axis_front, lr = p.axis_rear;
  T beta = atan((lr / (lf + lr)) * tan(delta));
  T ang = psi + beta;
  out[0] = v * cos(ang);
  out[1] = v * sin(ang);
  out[2] = (1.0 / lr) * (v * sin(beta));
  out[3] = p.acceleration * a - p.friction * v;
}

// one discrete step x⁺ = F(x, u); integrator 0 = forward Euler (the reference
// prediction model, main.py:76), 1 = RK4 (the template variant, template.py:141)
template <typename T>
void step(const VehicleParams& p, double ts, int integrator, const T x[NX],
          const T u[NU], T out[NX]) {
  T k1[NX];
  bicycle_ode(p, x, u, k1);
  if (integrator == 0) {
    for (int i = 0; i < NX; ++i) out[i] = x[i] + ts * k1[i];
    return;
  }
  T x2[NX], k2[NX], x3[NX], k3[NX], x4[NX], k4[NX];
  for (int i = 0; i < NX; ++i) x2[i] = x[i] + (0.5 * ts) * k1[i];
  bicycle_ode(p, x2, u, k2);
  for (int i = 0; i < NX; ++i) x3[i] = x[i] + (0.5 * ts) * k2[i];
  bicycle_ode(p, x3, u, k3);
  for (int i = 0; i < NX; ++i) x4[i] = x[i] + ts * k3[i];
  bicycle_ode(p, x4, u, k4);
  for (int i = 0; i < NX; ++i)
    out[i] = x[i] + (ts / 6.0) * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]);
}

// ---- single-shooting evaluation --------------------------------------------

struct Workspace {
  int N, n, m_c, n_colli;
  std::vector<double> xs;    // (N, NX) rolled-out states x_1..x_N
  std::vector<double> S;     // (N, NX, n) sensitivities dx_k/dū
  std::vector<double> c;     // (m_c,) constraint values
  std::vector<double> Jc;    // (m_c, n) constraint Jacobian
  std::vector<double> g;     // (n,) cost gradient
  std::vector<double> H;     // (n, n) Gauss-Newton Hessian
  double cost;
};

// roll the dynamics, accumulating states and sensitivities
void rollout(const VehicleParams& p, double ts, int integrator, int N,
             const double* x0, const double* u, Workspace& ws) {
  int n = N * NU;
  ws.xs.assign(N * NX, 0.0);
  ws.S.assign(static_cast<size_t>(N) * NX * n, 0.0);
  double xk[NX];
  std::memcpy(xk, x0, sizeof(xk));
  std::vector<double> Sk(NX * n, 0.0);  // dx_k/dū, starts at 0 (x0 constant)
  Dual xd[NX], ud[NU], xn[NX];
  std::vector<double> Sn(NX * n);
  for (int k = 0; k < N; ++k) {
    for (int i = 0; i < NX; ++i) xd[i] = seed(xk[i], i);
    for (int j = 0; j < NU; ++j) ud[j] = seed(u[k * NU + j], NX + j);
    step(p, ts, integrator, xd, ud, xn);
    // S_{k+1} = Fx S_k + Fu E_k
    std::fill(Sn.begin(), Sn.end(), 0.0);
    for (int i = 0; i < NX; ++i) {
      double* Sni = Sn.data() + i * n;
      for (int a = 0; a < NX; ++a) {
        double fx = xn[i].g[a];
        if (fx == 0.0) continue;
        const double* Ska = Sk.data() + a * n;
        for (int c = 0; c < n; ++c) Sni[c] += fx * Ska[c];
      }
      for (int j = 0; j < NU; ++j) Sni[k * NU + j] += xn[i].g[NX + j];
    }
    for (int i = 0; i < NX; ++i) {
      xk[i] = xn[i].v;
      ws.xs[k * NX + i] = xk[i];
    }
    std::memcpy(ws.S.data() + static_cast<size_t>(k) * NX * n, Sn.data(),
                sizeof(double) * NX * n);
    Sk.swap(Sn);  // Sk now holds S_{k+1}
  }
}

// cost, gradient, GN Hessian, constraints, constraint Jacobian at u
void evaluate(const VehicleParams& p, double ts, int integrator, int N,
              const double* Qd, const double* Rd, double qn_scale,
              const double* x0, const double* x_obs, int has_obs,
              int n_circles, const double* u, Workspace& ws,
              bool want_hessian = true) {
  int n = N * NU;
  ws.N = N;
  ws.n = n;
  ws.n_colli = has_obs ? n_circles * n_circles : 0;
  ws.m_c = N * NX + N * ws.n_colli;
  rollout(p, ts, integrator, N, x0, u, ws);

  // cost & gradient & GN Hessian
  ws.g.assign(n, 0.0);
  ws.H.assign(static_cast<size_t>(n) * n, 0.0);
  double QN[NX];
  for (int i = 0; i < NX; ++i) QN[i] = qn_scale * Qd[i];
  double cost = 0.0;
  for (int i = 0; i < NX; ++i) cost += Qd[i] * x0[i] * x0[i];  // k = 0 stage
  for (int k = 0; k < N; ++k) {
    const double* xk = ws.xs.data() + k * NX;
    const double* Sk = ws.S.data() + static_cast<size_t>(k) * NX * n;
    // stage weight: Q for x_1..x_{N-1} (stage cost), Q_N for x_N; note the
    // x_k stage-cost sum runs k = 0..N-1, so rolled state k (= x_{k+1}) takes
    // Q when k+1 ≤ N-1 and Q_N when k+1 = N.
    const double* Wd = (k == N - 1) ? QN : Qd;
    for (int i = 0; i < NX; ++i) {
      cost += Wd[i] * xk[i] * xk[i];
      double gi = 2.0 * Wd[i] * xk[i];
      const double* Si = Sk + i * n;
      for (int c = 0; c < n; ++c) ws.g[c] += gi * Si[c];
      if (want_hessian)
        for (int a = 0; a < n; ++a) {
          double sa = 2.0 * Wd[i] * Si[a];
          if (sa == 0.0) continue;
          double* Hrow = ws.H.data() + static_cast<size_t>(a) * n;
          for (int b = 0; b < n; ++b) Hrow[b] += sa * Si[b];
        }
    }
  }
  for (int k = 0; k < N; ++k)
    for (int j = 0; j < NU; ++j) {
      double uv = u[k * NU + j];
      cost += Rd[j] * uv * uv;
      ws.g[k * NU + j] += 2.0 * Rd[j] * uv;
      if (want_hessian)
        ws.H[static_cast<size_t>(k * NU + j) * n + (k * NU + j)] +=
            2.0 * Rd[j];
    }
  ws.cost = cost;

  // constraints: states first (xs flattened), then collision clearances
  ws.c.assign(ws.m_c, 0.0);
  ws.Jc.assign(static_cast<size_t>(ws.m_c) * n, 0.0);
  for (int k = 0; k < N; ++k) {
    const double* Sk = ws.S.data() + static_cast<size_t>(k) * NX * n;
    for (int i = 0; i < NX; ++i) {
      int row = k * NX + i;
      ws.c[row] = ws.xs[k * NX + i];
      std::memcpy(ws.Jc.data() + static_cast<size_t>(row) * n, Sk + i * n,
                  sizeof(double) * n);
    }
  }
  if (has_obs) {
    int nc = n_circles;
    double d = p.length / (2.0 * nc);
    std::vector<double> off(nc);
    for (int k = 0; k < nc; ++k) off[k] = (2.0 * k + 1.0) * d - p.length / 2.0;
    // obstacle circle centers (fixed): pose rotate+translate
    double co = std::cos(x_obs[2]), so = std::sin(x_obs[2]);
    std::vector<double> obs(nc * 2);
    for (int j = 0; j < nc; ++j) {
      obs[j * 2 + 0] = x_obs[0] + co * off[j];
      obs[j * 2 + 1] = x_obs[1] + so * off[j];
    }
    int base = N * NX;
    for (int k = 0; k < N; ++k) {
      const double* xk = ws.xs.data() + k * NX;
      const double* Sk = ws.S.data() + static_cast<size_t>(k) * NX * n;
      double cv = std::cos(xk[2]), sv = std::sin(xk[2]);
      for (int i = 0; i < nc; ++i) {
        double cxw = xk[0] + cv * off[i];
        double cyw = xk[1] + sv * off[i];
        // d center / d (px, py, psi): [1,0,-sv*off], [0,1,cv*off]
        for (int j = 0; j < nc; ++j) {
          double dx = cxw - obs[j * 2 + 0];
          double dy = cyw - obs[j * 2 + 1];
          int row = base + k * ws.n_colli + i * nc + j;
          ws.c[row] = dx * dx + dy * dy;
          // ∇_x g = 2 (dx, dy) · dcenter/dx  (zero in v)
          double gx[NX] = {2.0 * dx, 2.0 * dy,
                           2.0 * (dx * (-sv * off[i]) + dy * (cv * off[i])),
                           0.0};
          double* Jrow = ws.Jc.data() + static_cast<size_t>(row) * n;
          for (int a = 0; a < NX; ++a) {
            if (gx[a] == 0.0) continue;
            const double* Sa = Sk + a * n;
            for (int c2 = 0; c2 < n; ++c2) Jrow[c2] += gx[a] * Sa[c2];
          }
        }
      }
    }
  }
}

double l1_violation(const double* c, const double* lc, const double* uc,
                    int m) {
  double s = 0.0;
  for (int i = 0; i < m; ++i) {
    if (std::isfinite(lc[i]) && c[i] < lc[i]) s += lc[i] - c[i];
    if (std::isfinite(uc[i]) && c[i] > uc[i]) s += c[i] - uc[i];
  }
  return s;
}

double max_violation(const double* c, const double* lc, const double* uc,
                     int m) {
  double s = 0.0;
  for (int i = 0; i < m; ++i) {
    if (std::isfinite(lc[i])) s = std::max(s, lc[i] - c[i]);
    if (std::isfinite(uc[i])) s = std::max(s, c[i] - uc[i]);
  }
  return s;
}

// SPD Cholesky solve (local copy; qp_oracle.cpp's helpers are internal there).
bool chol_spd_solve(std::vector<double>& M, int n, std::vector<double>& b) {
  for (int j = 0; j < n; ++j) {
    double d = M[static_cast<size_t>(j) * n + j];
    for (int k = 0; k < j; ++k) {
      double v = M[static_cast<size_t>(j) * n + k];
      d -= v * v;
    }
    if (d <= 0.0) return false;
    d = std::sqrt(d);
    M[static_cast<size_t>(j) * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double s = M[static_cast<size_t>(i) * n + j];
      for (int k = 0; k < j; ++k)
        s -= M[static_cast<size_t>(i) * n + k] *
             M[static_cast<size_t>(j) * n + k];
      M[static_cast<size_t>(i) * n + j] = s / d;
    }
  }
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= M[static_cast<size_t>(i) * n + k] * b[k];
    b[i] = s / M[static_cast<size_t>(i) * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k)
      s -= M[static_cast<size_t>(k) * n + i] * b[k];
    b[i] = s / M[static_cast<size_t>(i) * n + i];
  }
  return true;
}

// Partial-pivot LU solve for the (indefinite) polish KKT system; K destroyed.
bool lu_solve_local(std::vector<double>& K, int dim, std::vector<double>& b) {
  for (int col = 0; col < dim; ++col) {
    int piv = col;
    double best = std::fabs(K[static_cast<size_t>(col) * dim + col]);
    for (int r = col + 1; r < dim; ++r) {
      double v = std::fabs(K[static_cast<size_t>(r) * dim + col]);
      if (v > best) { best = v; piv = r; }
    }
    if (best < 1e-300) return false;
    if (piv != col) {
      for (int c = 0; c < dim; ++c)
        std::swap(K[static_cast<size_t>(col) * dim + c],
                  K[static_cast<size_t>(piv) * dim + c]);
      std::swap(b[col], b[piv]);
    }
    double d = K[static_cast<size_t>(col) * dim + col];
    for (int r = col + 1; r < dim; ++r) {
      double f = K[static_cast<size_t>(r) * dim + col] / d;
      if (f == 0.0) continue;
      for (int c = col; c < dim; ++c)
        K[static_cast<size_t>(r) * dim + c] -=
            f * K[static_cast<size_t>(col) * dim + c];
      b[r] -= f * b[col];
    }
  }
  for (int i = dim - 1; i >= 0; --i) {
    double s = b[i];
    for (int c = i + 1; c < dim; ++c)
      s -= K[static_cast<size_t>(i) * dim + c] * b[c];
    b[i] = s / K[static_cast<size_t>(i) * dim + i];
  }
  return true;
}

// Sound stationarity certificate at the *current* point, independent of the
// QP subproblem's dual accuracy: detect the active set from primal values,
// fit least-squares multipliers for it (ridge-regularized normal equations),
// clamp wrong-signed ones to zero, and report the true residual
// ‖g + Σ a_i y_i‖∞ for that sign-valid, complementary y.
double certified_kkt(const double* g, const double* A, const double* c,
                     const double* lc, const double* uc, int n, int m,
                     double* ymax_out, double* y_full = nullptr) {
  std::vector<int> act;
  std::vector<int> low;  // 1 = lower-active (y ≤ 0), 0 = upper-active (y ≥ 0)
  for (int i = 0; i < m; ++i) {
    double tol_a;
    if (std::isfinite(lc[i])) {
      tol_a = 1e-7 * (1.0 + std::fabs(lc[i]));
      if (c[i] <= lc[i] + tol_a) { act.push_back(i); low.push_back(1); }
    }
    if (std::isfinite(uc[i])) {
      tol_a = 1e-7 * (1.0 + std::fabs(uc[i]));
      if (c[i] >= uc[i] - tol_a) { act.push_back(i); low.push_back(0); }
    }
  }
  int k = static_cast<int>(act.size());
  std::vector<double> y(k, 0.0);
  if (k > 0) {
    // normal equations (Aact Aactᵀ + εI) y = −Aact g
    std::vector<double> G(static_cast<size_t>(k) * k, 0.0), rhs(k, 0.0);
    for (int a = 0; a < k; ++a) {
      const double* ra = A + static_cast<size_t>(act[a]) * n;
      for (int b = a; b < k; ++b) {
        const double* rb = A + static_cast<size_t>(act[b]) * n;
        double s = 0.0;
        for (int c2 = 0; c2 < n; ++c2) s += ra[c2] * rb[c2];
        G[static_cast<size_t>(a) * k + b] = s;
        G[static_cast<size_t>(b) * k + a] = s;
      }
      G[static_cast<size_t>(a) * k + a] += 1e-12;
      double s = 0.0;
      for (int c2 = 0; c2 < n; ++c2) s += ra[c2] * g[c2];
      rhs[a] = -s;
    }
    if (chol_spd_solve(G, k, rhs)) {
      for (int a = 0; a < k; ++a) {
        double v = rhs[a];
        if (low[a] && v > 0.0) v = 0.0;   // lower-active ⇒ y ≤ 0
        if (!low[a] && v < 0.0) v = 0.0;  // upper-active ⇒ y ≥ 0
        y[a] = v;
      }
    }
  }
  double kkt = 0.0;
  for (int c2 = 0; c2 < n; ++c2) {
    double s = g[c2];
    for (int a = 0; a < k; ++a)
      s += A[static_cast<size_t>(act[a]) * n + c2] * y[a];
    kkt = std::max(kkt, std::fabs(s));
  }
  if (ymax_out) {
    double ym = 0.0;
    for (int a = 0; a < k; ++a) ym = std::max(ym, std::fabs(y[a]));
    *ymax_out = ym;
  }
  if (y_full) {
    std::fill(y_full, y_full + m, 0.0);
    for (int a = 0; a < k; ++a) y_full[act[a]] += y[a];
  }
  return kkt;
}

}  // namespace

extern "C" {

// Solve the parking NLP. vp packs VehicleParams in declaration order (17
// doubles). Returns 0 on success (converged), 1 if the QP subproblem setup
// failed, 2 if max iterations were reached without meeting tol.
int parking_sqp_solve(const double* vp, int N, double ts, int integrator,
                      const double* Qdiag, const double* Rdiag,
                      double qn_scale, const double* x0, const double* x_obs,
                      int has_obs, int n_circles, const double* u_init,
                      int max_iters, int qp_iters, double tol, double* u_out,
                      double* cost_out, double* kkt_out, double* viol_out,
                      int* iters_out) {
  VehicleParams p;
  std::memcpy(&p, vp, sizeof(VehicleParams));
  int n = N * NU;
  int n_colli = has_obs ? n_circles * n_circles : 0;
  int m_c = N * NX + N * n_colli;
  int m = n + m_c;  // QP rows: input box + linearized constraints

  // constraint bounds (solvers/parking.py:120-124)
  std::vector<double> lc(m_c), uc(m_c);
  double lbs[NX] = {p.min_pos_x, p.min_pos_y, p.min_heading, p.min_vel};
  double ubs[NX] = {p.max_pos_x, p.max_pos_y, p.max_heading, p.max_vel};
  for (int k = 0; k < N; ++k)
    for (int i = 0; i < NX; ++i) {
      lc[k * NX + i] = lbs[i];
      uc[k * NX + i] = ubs[i];
    }
  if (has_obs) {
    double d = p.length / (2.0 * n_circles);
    double r = std::sqrt(d * d + p.width * p.width / 4.0);
    double r2 = (r + r) * (r + r);  // (r + r_p)², main.py:52
    for (int i = N * NX; i < m_c; ++i) {
      lc[i] = r2;
      uc[i] = HUGE_VAL;
    }
  }
  std::vector<double> lu(n), uu(n);
  for (int k = 0; k < N; ++k) {
    lu[k * NU + 0] = p.min_drive;
    uu[k * NU + 0] = p.max_drive;
    lu[k * NU + 1] = -p.max_steer;
    uu[k * NU + 1] = p.max_steer;
  }

  std::vector<double> u(n, 0.0);
  if (u_init) std::memcpy(u.data(), u_init, sizeof(double) * n);
  for (int i = 0; i < n; ++i) u[i] = std::min(std::max(u[i], lu[i]), uu[i]);

  Workspace ws, ws_trial, ws_fd;
  std::vector<double> Aqp(static_cast<size_t>(m) * n, 0.0);
  std::vector<double> lqp(m), uqp(m), delta(n), y(m), Hreg;
  std::vector<double> u_trial(n);
  // combined row values/bounds for the certificate: [u-box rows; c rows]
  std::vector<double> cv(m), lcv(m), ucv(m);
  std::vector<double> y_ls(m, 0.0), gradL0(n);
  std::vector<double> HL(static_cast<size_t>(n) * n, 0.0);
  uint8_t qp_conv = 0;
  double kkt = HUGE_VAL, viol = HUGE_VAL;
  // Levenberg damping: grown on line-search failure so the QP re-solves with
  // a shorter, more gradient-like step; shrunk on success.
  double lam = 1e-9;
  // bounded emergency factor on the l1 penalty, armed only while line
  // searches fail at infeasible points (a monotone escalated penalty was
  // observed to over-weight feasibility until no step passes; a too-light
  // one converges to an infeasible merit minimum).
  double boost = 1.0;
  // trust region on the step box: keeps the linearization honest far from
  // the solution (the QP otherwise returns long zigzag steps).
  double trust = 0.5;
  bool verbose = std::getenv("MPC_NLP_VERBOSE") != nullptr;
  bool done = false;
  int it = 0;

  // Aqp (=[I; Jc]) + QP bounds + certificate rows for a given evaluation.
  auto build_rows = [&](const Workspace& w, const std::vector<double>& uref) {
    for (int i = 0; i < n; ++i) {
      std::fill(Aqp.begin() + static_cast<size_t>(i) * n,
                Aqp.begin() + static_cast<size_t>(i) * n + n, 0.0);
      Aqp[static_cast<size_t>(i) * n + i] = 1.0;
      lqp[i] = std::max(lu[i] - uref[i], -trust);
      uqp[i] = std::min(uu[i] - uref[i], trust);
      cv[i] = uref[i];
      lcv[i] = lu[i];
      ucv[i] = uu[i];
    }
    for (int r = 0; r < m_c; ++r) {
      std::memcpy(Aqp.data() + static_cast<size_t>(n + r) * n,
                  w.Jc.data() + static_cast<size_t>(r) * n,
                  sizeof(double) * n);
      lqp[n + r] = std::isfinite(lc[r]) ? lc[r] - w.c[r] : -HUGE_VAL;
      uqp[n + r] = std::isfinite(uc[r]) ? uc[r] - w.c[r] : HUGE_VAL;
      cv[n + r] = w.c[r];
      lcv[n + r] = lc[r];
      ucv[n + r] = uc[r];
    }
  };

  // exact Lagrangian Hessian at u with multipliers y_ls, by forward
  // differences of the stationarity vector dL = g + Jc^T y (box rows have
  // constant gradient and cancel in the difference)
  auto fd_lagrangian_hessian = [&]() {
    const double* yc = y_ls.data() + n;
    for (int c2 = 0; c2 < n; ++c2) {
      double s = ws.g[c2];
      for (int r = 0; r < m_c; ++r)
        s += ws.Jc[static_cast<size_t>(r) * n + c2] * yc[r];
      gradL0[c2] = s;
    }
    for (int j = 0; j < n; ++j) {
      double ej = 1e-6 * (1.0 + std::fabs(u[j]));
      std::memcpy(u_trial.data(), u.data(), sizeof(double) * n);
      u_trial[j] += ej;
      evaluate(p, ts, integrator, N, Qdiag, Rdiag, qn_scale, x0, x_obs,
               has_obs, n_circles, u_trial.data(), ws_fd, false);
      for (int c2 = 0; c2 < n; ++c2) {
        double s = ws_fd.g[c2];
        for (int r = 0; r < m_c; ++r)
          s += ws_fd.Jc[static_cast<size_t>(r) * n + c2] * yc[r];
        HL[static_cast<size_t>(c2) * n + j] = (s - gradL0[c2]) / ej;
      }
    }
    for (int a = 0; a < n; ++a)
      for (int b = a + 1; b < n; ++b) {
        double s = 0.5 * (HL[static_cast<size_t>(a) * n + b] +
                          HL[static_cast<size_t>(b) * n + a]);
        HL[static_cast<size_t>(a) * n + b] = s;
        HL[static_cast<size_t>(b) * n + a] = s;
      }
  };

  // ---- phase 1: globalized Gauss-Newton SQP --------------------------------
  // Reliable global progress; converges linearly near curved active
  // constraints, so it hands off to the Newton polish once feasible and
  // near-stationary instead of crawling the last decades itself.
  for (it = 0; it < max_iters && !done; ++it) {
    evaluate(p, ts, integrator, N, Qdiag, Rdiag, qn_scale, x0, x_obs, has_obs,
             n_circles, u.data(), ws);
    viol = max_violation(ws.c.data(), lc.data(), uc.data(), m_c);
    build_rows(ws, u);

    // convergence test at the CURRENT point - sound multipliers from the
    // active set, independent of the QP subproblem's dual accuracy
    double ymax_ls = 0.0;
    kkt = certified_kkt(ws.g.data(), Aqp.data(), cv.data(), lcv.data(),
                        ucv.data(), n, m, &ymax_ls, y_ls.data());
    if (kkt < tol && viol < tol) { done = true; break; }
    if (viol < tol && kkt < 5e-2 && it > 0) break;  // hand off to polish
    double mu = std::max(10.0, 2.0 * ymax_ls) * boost;

    bool stepped = false;
    double accepted_alpha = 0.0;
    for (int attempt = 0; attempt < 12 && !stepped; ++attempt) {
      // QP: min d'(H+lam I)d/2 + g'd  s.t. step box (trust) + linearized c
      Hreg = ws.H;
      for (int i = 0; i < n; ++i)
        Hreg[static_cast<size_t>(i) * n + i] += lam + 1e-9;
      if (admm_box_qp(Hreg.data(), ws.g.data(), Aqp.data(), lqp.data(),
                      uqp.data(), n, m, 10.0, 1e-6, qp_iters, 1e-11, 1,
                      delta.data(), y.data(), &qp_conv) != 0) {
        // The damped Gauss-Newton model is PSD by construction — if it fails
        // to factor, that is a solver-infrastructure failure (status 1), not
        // non-convergence.
        return 1;
      }

      // l1-merit backtracking (exact penalty mu >= ||y||inf)
      double ymax = 0.0;
      for (int r = 0; r < m; ++r) ymax = std::max(ymax, std::fabs(y[r]));
      mu = std::max(mu, 2.0 * ymax);
      double merit0 =
          ws.cost + mu * l1_violation(ws.c.data(), lc.data(), uc.data(), m_c);
      double alpha = 1.0;
      for (int ls = 0; ls < 24; ++ls, alpha *= 0.5) {
        for (int i = 0; i < n; ++i) {
          double v = u[i] + alpha * delta[i];
          u_trial[i] = std::min(std::max(v, lu[i]), uu[i]);
        }
        evaluate(p, ts, integrator, N, Qdiag, Rdiag, qn_scale, x0, x_obs,
                 has_obs, n_circles, u_trial.data(), ws_trial, false);
        double mt = ws_trial.cost + mu * l1_violation(ws_trial.c.data(),
                                                      lc.data(), uc.data(),
                                                      m_c);
        if (mt < merit0) {
          u.swap(u_trial);
          lam = std::max(lam * 0.25, 1e-9);
          if (viol < tol) boost = 1.0;
          accepted_alpha = alpha;
          stepped = true;
          break;
        }
        if (ls == 0) {
          // Second-order correction (Maratos remedy): the full step satisfies
          // the *linearized* constraints but curvature re-violates them by
          // O(||d||^2), which the l1 merit rejects at every alpha. Correct
          // with the least-norm dc restoring the violated rows at the trial:
          //   J_v dc = v_need,  dc = J_v' (J_v J_v' + eps I)^-1 v_need
          std::vector<int> vio;
          std::vector<double> need;
          for (int r = 0; r < m_c; ++r) {
            double ct = ws_trial.c[r];
            if (std::isfinite(lc[r]) && ct < lc[r]) {
              vio.push_back(r);
              need.push_back(lc[r] - ct);
            } else if (std::isfinite(uc[r]) && ct > uc[r]) {
              vio.push_back(r);
              need.push_back(uc[r] - ct);
            }
          }
          int kv = static_cast<int>(vio.size());
          if (kv > 0) {
            std::vector<double> G(static_cast<size_t>(kv) * kv, 0.0);
            std::vector<double> rhs2(need);
            for (int a = 0; a < kv; ++a) {
              const double* ra =
                  ws.Jc.data() + static_cast<size_t>(vio[a]) * n;
              for (int b = a; b < kv; ++b) {
                const double* rb =
                    ws.Jc.data() + static_cast<size_t>(vio[b]) * n;
                double s = 0.0;
                for (int c2 = 0; c2 < n; ++c2) s += ra[c2] * rb[c2];
                G[static_cast<size_t>(a) * kv + b] = s;
                G[static_cast<size_t>(b) * kv + a] = s;
              }
              G[static_cast<size_t>(a) * kv + a] += 1e-10;
            }
            if (chol_spd_solve(G, kv, rhs2)) {
              for (int i = 0; i < n; ++i) {
                double dc = 0.0;
                for (int a = 0; a < kv; ++a)
                  dc += ws.Jc[static_cast<size_t>(vio[a]) * n + i] * rhs2[a];
                double v = u[i] + delta[i] + dc;
                u_trial[i] = std::min(std::max(v, lu[i]), uu[i]);
              }
              evaluate(p, ts, integrator, N, Qdiag, Rdiag, qn_scale, x0,
                       x_obs, has_obs, n_circles, u_trial.data(), ws_trial,
                       false);
              double msoc =
                  ws_trial.cost + mu * l1_violation(ws_trial.c.data(),
                                                    lc.data(), uc.data(), m_c);
              if (msoc < merit0) {
                u.swap(u_trial);
                lam = std::max(lam * 0.25, 1e-9);
                if (viol < tol) boost = 1.0;
                accepted_alpha = 1.0;
                stepped = true;
                break;
              }
            }
          }
        }
      }
      if (!stepped) lam = std::max(lam, 1e-6) * 10.0;  // damp and re-solve
    }

    // trust-region adaptation: full steps grow it, rejected/short steps shrink
    if (accepted_alpha >= 1.0)
      trust = std::min(trust * 2.0, 2.0);
    else if (accepted_alpha < 0.25)
      trust = std::max(trust * 0.5, 1e-3);

    if (verbose)
      std::fprintf(stderr,
                   "[nlp] it=%3d kkt=%10.3e viol=%10.3e lam=%8.1e trust=%6.3f "
                   "alpha=%8.5f boost=%6.1f\n",
                   it, kkt, viol, lam, trust, accepted_alpha, boost);

    if (!stepped) {
      // damping exhausted: if still infeasible, retry under a heavier
      // penalty; otherwise hand off to the polish with the current KKT
      if (viol >= tol && boost < 1e5) {
        boost *= 10.0;
        lam = 1e-9;
        continue;
      }
      break;
    }
  }

  // ---- phase 2: Newton polish on the active-set KKT equations --------------
  // The NLP-level analog of the QP active-set polish: at the GN handoff the
  // active set is settled, so full Newton on
  //   [ grad^2 L   Ja' ] [du]   [ -g        ]
  //   [ Ja         0   ] [y ] = [ b_a - c_a ]
  // with the exact (finite-differenced) Lagrangian Hessian converges
  // quadratically to machine-precision stationarity. Steps are accepted only
  // if the certified KKT improves without losing feasibility.
  if (!done) {
    for (int pol = 0; pol < 10 && !done; ++pol) {
      evaluate(p, ts, integrator, N, Qdiag, Rdiag, qn_scale, x0, x_obs,
               has_obs, n_circles, u.data(), ws, false);
      viol = max_violation(ws.c.data(), lc.data(), uc.data(), m_c);
      build_rows(ws, u);
      double kkt_now = certified_kkt(ws.g.data(), Aqp.data(), cv.data(),
                                     lcv.data(), ucv.data(), n, m, nullptr,
                                     y_ls.data());
      kkt = kkt_now;
      if (kkt_now < tol && viol < tol) { done = true; break; }

      std::vector<int> act;
      std::vector<double> bact;
      std::vector<int> is_low;
      for (int i = 0; i < m; ++i) {
        if (std::isfinite(lcv[i]) &&
            cv[i] <= lcv[i] + 1e-7 * (1.0 + std::fabs(lcv[i]))) {
          act.push_back(i);
          bact.push_back(lcv[i]);
          is_low.push_back(1);
        } else if (std::isfinite(ucv[i]) &&
                   cv[i] >= ucv[i] - 1e-7 * (1.0 + std::fabs(ucv[i]))) {
          act.push_back(i);
          bact.push_back(ucv[i]);
          is_low.push_back(0);
        }
      }
      fd_lagrangian_hessian();
      // solve the equality KKT system; drop wrong-signed (falsely-active)
      // rows and re-solve — a pinned row whose true multiplier sign is
      // invalid otherwise caps the achievable stationarity (observed stall
      // at 7.7e-4 with one such row)
      std::vector<double> rhs;
      bool solved = false;
      for (int pass = 0; pass < 6; ++pass) {
        int ka = static_cast<int>(act.size());
        int dim = n + ka;
        std::vector<double> K(static_cast<size_t>(dim) * dim, 0.0);
        rhs.assign(dim, 0.0);
        for (int a = 0; a < n; ++a)
          for (int b = 0; b < n; ++b)
            K[static_cast<size_t>(a) * dim + b] =
                HL[static_cast<size_t>(a) * n + b];
        for (int a2 = 0; a2 < ka; ++a2) {
          const double* row = Aqp.data() + static_cast<size_t>(act[a2]) * n;
          for (int j = 0; j < n; ++j) {
            K[static_cast<size_t>(n + a2) * dim + j] = row[j];
            K[static_cast<size_t>(j) * dim + (n + a2)] = row[j];
          }
          // tiny dual regularization: weakly-active / duplicate rows
          // otherwise make the KKT matrix singular
          K[static_cast<size_t>(n + a2) * dim + (n + a2)] = -1e-11;
        }
        for (int j = 0; j < n; ++j) rhs[j] = -ws.g[j];
        for (int a2 = 0; a2 < ka; ++a2) rhs[n + a2] = bact[a2] - cv[act[a2]];
        if (!lu_solve_local(K, dim, rhs)) break;
        // sign check: lower-active ⇒ y ≤ 0, upper-active ⇒ y ≥ 0
        std::vector<int> keep;
        for (int a2 = 0; a2 < ka; ++a2) {
          double yv = rhs[n + a2];
          bool bad = (is_low[a2] && yv > 1e-8) || (!is_low[a2] && yv < -1e-8);
          if (!bad) keep.push_back(a2);
        }
        if (static_cast<int>(keep.size()) == ka) { solved = true; break; }
        std::vector<int> act2;
        std::vector<double> bact2;
        std::vector<int> low2;
        for (int idx : keep) {
          act2.push_back(act[idx]);
          bact2.push_back(bact[idx]);
          low2.push_back(is_low[idx]);
        }
        act.swap(act2);
        bact.swap(bact2);
        is_low.swap(low2);
      }
      if (!solved) break;

      bool accepted = false;
      for (double al : {1.0, 0.5, 0.25}) {
        for (int j = 0; j < n; ++j) {
          double v = u[j] + al * rhs[j];
          u_trial[j] = std::min(std::max(v, lu[j]), uu[j]);
        }
        evaluate(p, ts, integrator, N, Qdiag, Rdiag, qn_scale, x0, x_obs,
                 has_obs, n_circles, u_trial.data(), ws_trial, false);
        double v_t =
            max_violation(ws_trial.c.data(), lc.data(), uc.data(), m_c);
        build_rows(ws_trial, u_trial);
        double k_t = certified_kkt(ws_trial.g.data(), Aqp.data(), cv.data(),
                                   lcv.data(), ucv.data(), n, m, nullptr,
                                   nullptr);
        if (k_t < kkt_now && v_t <= std::max(viol, tol)) {
          u.swap(u_trial);
          accepted = true;
          break;
        }
      }
      if (verbose)
        std::fprintf(stderr, "[nlp] polish %d kkt=%10.3e viol=%10.3e act=%d %s\n",
                     pol, kkt_now, viol, static_cast<int>(act.size()),
                     accepted ? "step" : "stop");
      if (!accepted) break;
    }
  }

  evaluate(p, ts, integrator, N, Qdiag, Rdiag, qn_scale, x0, x_obs, has_obs,
           n_circles, u.data(), ws);
  viol = max_violation(ws.c.data(), lc.data(), uc.data(), m_c);
  build_rows(ws, u);
  kkt = certified_kkt(ws.g.data(), Aqp.data(), cv.data(), lcv.data(),
                      ucv.data(), n, m, nullptr, nullptr);
  std::memcpy(u_out, u.data(), sizeof(double) * n);
  *cost_out = ws.cost;
  *kkt_out = kkt;
  *viol_out = viol;
  *iters_out = it;
  return (kkt < tol && viol < tol) ? 0 : 2;
}

// Closed-loop driver: simulate `steps` plant steps under receding-horizon
// MPC, re-solving the NLP at every measured state with a shifted warm start
// (the reference's exercise-5 / main() loop, session4_sol.py:443-488). The
// plant uses the same model with `plant_substeps` RK4 substeps per ts (the
// odeint-accuracy tier) and optionally perturbed parameters (vp_plant).
int parking_mpc_closed_loop(const double* vp, const double* vp_plant, int N,
                            double ts, int integrator, const double* Qdiag,
                            const double* Rdiag, double qn_scale,
                            const double* x0, const double* x_obs, int has_obs,
                            int n_circles, int steps, int plant_substeps,
                            int max_iters, int qp_iters, double tol,
                            double* states_out,  // (steps+1, NX)
                            double* inputs_out,  // (steps, NU)
                            uint8_t* success_out) {  // (steps,)
  VehicleParams pp;
  std::memcpy(&pp, vp_plant, sizeof(VehicleParams));
  int n = N * NU;
  std::vector<double> u_warm(n, 0.0), u_sol(n);
  double x[NX];
  std::memcpy(x, x0, sizeof(x));
  std::memcpy(states_out, x, sizeof(x));
  double cost, kkt, viol;
  int iters;
  for (int t = 0; t < steps; ++t) {
    int st = parking_sqp_solve(vp, N, ts, integrator, Qdiag, Rdiag, qn_scale,
                               x, x_obs, has_obs, n_circles, u_warm.data(),
                               max_iters, qp_iters, tol, u_sol.data(), &cost,
                               &kkt, &viol, &iters);
    success_out[t] = (st == 0) ? 1 : 0;
    double u0[NU] = {u_sol[0], u_sol[1]};
    std::memcpy(inputs_out + t * NU, u0, sizeof(u0));
    // plant: RK4 substeps on the (possibly perturbed) plant parameters,
    // plain doubles — no derivatives needed on the plant side
    double h = ts / plant_substeps;
    double xn[NX];
    for (int s = 0; s < plant_substeps; ++s) {
      step(pp, h, 1, x, u0, xn);
      std::memcpy(x, xn, sizeof(xn));
    }
    std::memcpy(states_out + (t + 1) * NX, x, sizeof(x));
    // shift warm start one stage (solvers/parking.py:171)
    std::memcpy(u_warm.data(), u_sol.data() + NU, sizeof(double) * (n - NU));
    std::memcpy(u_warm.data() + (n - NU), u_sol.data() + (n - NU),
                sizeof(double) * NU);
  }
  return 0;
}

}  // extern "C"
