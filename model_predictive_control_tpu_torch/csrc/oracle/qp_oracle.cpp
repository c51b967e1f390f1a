// Native float64 box-QP oracle: dense OSQP-style ADMM with active-set polish.
//
// Role: the in-repo replacement for the reference's native solver tier —
// the reference outsources every QP/NLP solve to IPOPT (C++/Fortran, invoked
// via CasADi at session_4/main.py:39,116). This library plays that part for
// the new framework: an independent, host-side, float64 ground truth used by
// tests to certify the on-device (JAX/Pallas) solvers, plus an honest CPU
// throughput baseline for the solves/s benchmarks.
//
// Problem family (matches solvers/qp.py and oracle/qp_oracle.py conventions):
//     min ½ xᵀPx + qᵀx   s.t.  l ≤ Ax ≤ u      (entries of l/u may be ±inf)
// with the two-sided dual convention y_i > 0 ⇔ upper bound active.
//
// The "family" entry point factors the ADMM KKT matrix once for a shared
// (P, A) and then solves a batch of (q, l, u) instances — exactly the MPC
// structure (one condensed QP family per controller, one instance per
// measured state), mirroring qp_setup() on the TPU side.
//
// Build: g++ -O3 -shared -fPIC (driven by oracle/native_qp.py; no deps).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- dense linear algebra (column-major-free: plain row-major) -------------

// Cholesky factorization in place: M (n×n, row-major, SPD) -> lower L.
// Returns false if not positive definite.
bool cholesky(double* M, int n) {
  for (int j = 0; j < n; ++j) {
    double d = M[j * n + j];
    for (int k = 0; k < j; ++k) d -= M[j * n + k] * M[j * n + k];
    if (d <= 0.0) return false;
    d = std::sqrt(d);
    M[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double s = M[i * n + j];
      for (int k = 0; k < j; ++k) s -= M[i * n + k] * M[j * n + k];
      M[i * n + j] = s / d;
    }
  }
  return true;
}

// Solve L Lᵀ x = b given the Cholesky factor in the lower triangle of M.
void chol_solve(const double* M, int n, const double* b, double* x) {
  // forward: L w = b
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= M[i * n + k] * x[k];
    x[i] = s / M[i * n + i];
  }
  // backward: Lᵀ x = w
  for (int i = n - 1; i >= 0; --i) {
    double s = x[i];
    for (int k = i + 1; k < n; ++k) s -= M[k * n + i] * x[k];
    x[i] = s / M[i * n + i];
  }
}

// Gaussian elimination with partial pivoting: solves K z = b in place.
// K is (dim×dim) row-major, destroyed. Returns false if singular.
bool lu_solve(std::vector<double>& K, int dim, std::vector<double>& b) {
  std::vector<int> piv(dim);
  for (int i = 0; i < dim; ++i) piv[i] = i;
  for (int col = 0; col < dim; ++col) {
    int p = col;
    double best = std::fabs(K[col * dim + col]);
    for (int r = col + 1; r < dim; ++r) {
      double v = std::fabs(K[r * dim + col]);
      if (v > best) { best = v; p = r; }
    }
    if (best < 1e-300) return false;
    if (p != col) {
      for (int c = 0; c < dim; ++c) std::swap(K[col * dim + c], K[p * dim + c]);
      std::swap(b[col], b[p]);
    }
    double d = K[col * dim + col];
    for (int r = col + 1; r < dim; ++r) {
      double f = K[r * dim + col] / d;
      if (f == 0.0) continue;
      for (int c = col; c < dim; ++c) K[r * dim + c] -= f * K[col * dim + c];
      b[r] -= f * b[col];
    }
  }
  for (int i = dim - 1; i >= 0; --i) {
    double s = b[i];
    for (int c = i + 1; c < dim; ++c) s -= K[i * dim + c] * b[c];
    b[i] = s / K[i * dim + i];
  }
  return true;
}

void matvec(const double* M, int rows, int cols, const double* v, double* out) {
  for (int i = 0; i < rows; ++i) {
    double s = 0.0;
    for (int j = 0; j < cols; ++j) s += M[i * cols + j] * v[j];
    out[i] = s;
  }
}

void matvec_t(const double* M, int rows, int cols, const double* v, double* out) {
  for (int j = 0; j < cols; ++j) out[j] = 0.0;
  for (int i = 0; i < rows; ++i) {
    double vi = v[i];
    if (vi == 0.0) continue;
    for (int j = 0; j < cols; ++j) out[j] += M[i * cols + j] * vi;
  }
}

double inf_norm(const double* v, int n) {
  double m = 0.0;
  for (int i = 0; i < n; ++i) m = std::max(m, std::fabs(v[i]));
  return m;
}

// KKT residual max(stationarity, primal violation) for the certificate.
double kkt_residual(const double* P, const double* q, const double* A,
                    const double* l, const double* u, int n, int m,
                    const double* x, const double* y) {
  std::vector<double> Px(n), Aty(n), Ax(m);
  matvec(P, n, n, x, Px.data());
  matvec_t(A, m, n, y, Aty.data());
  matvec(A, m, n, x, Ax.data());
  double stat = 0.0;
  for (int i = 0; i < n; ++i)
    stat = std::max(stat, std::fabs(Px[i] + q[i] + Aty[i]));
  double prim = 0.0;
  for (int i = 0; i < m; ++i) {
    if (std::isfinite(u[i])) prim = std::max(prim, Ax[i] - u[i]);
    if (std::isfinite(l[i])) prim = std::max(prim, l[i] - Ax[i]);
  }
  return std::max(stat, prim);
}

// Active-set equality-KKT polish (the same validated-accept refinement the
// Python oracle does): solve [P Aactᵀ; Aact 0] [x; ν] = [−q; b_act].
// Accepts only if dual signs are consistent and the KKT residual improves.
void polish(const double* P, const double* q, const double* A,
            const double* l, const double* u, int n, int m,
            const double* z, double* x, double* y, double act_tol) {
  std::vector<int> act;
  std::vector<double> b_act;
  std::vector<int> kind;  // 0 = lower-active, 1 = upper-active, 2 = l≈u (either)
  for (int i = 0; i < m; ++i) {
    bool low = std::isfinite(l[i]) && z[i] <= l[i] + act_tol;
    bool up = std::isfinite(u[i]) && z[i] >= u[i] - act_tol;
    if (low || up) {
      act.push_back(i);
      b_act.push_back(low ? l[i] : u[i]);
      kind.push_back(low && up ? 2 : (low ? 0 : 1));
    }
  }
  int k = static_cast<int>(act.size());
  int dim = n + k;
  std::vector<double> K(dim * dim, 0.0), rhs(dim);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) K[i * dim + j] = P[i * n + j];
  for (int a = 0; a < k; ++a) {
    int row = act[a];
    for (int j = 0; j < n; ++j) {
      K[(n + a) * dim + j] = A[row * n + j];
      K[j * dim + (n + a)] = A[row * n + j];
    }
  }
  for (int i = 0; i < n; ++i) rhs[i] = -q[i];
  for (int a = 0; a < k; ++a) rhs[n + a] = b_act[a];

  if (!lu_solve(K, dim, rhs)) return;

  std::vector<double> x_r(rhs.begin(), rhs.begin() + n);
  std::vector<double> y_r(m, 0.0);
  bool signs_ok = true;
  for (int a = 0; a < k; ++a) {
    double nu = rhs[n + a];
    y_r[act[a]] = nu;
    if (kind[a] == 0 && nu > 1e-8) signs_ok = false;   // lower-active ⇒ y ≤ 0
    if (kind[a] == 1 && nu < -1e-8) signs_ok = false;  // upper-active ⇒ y ≥ 0
  }
  if (!signs_ok) return;
  double before = kkt_residual(P, q, A, l, u, n, m, x, y);
  double after = kkt_residual(P, q, A, l, u, n, m, x_r.data(), y_r.data());
  if (after < before) {
    std::memcpy(x, x_r.data(), n * sizeof(double));
    std::memcpy(y, y_r.data(), m * sizeof(double));
  }
}

}  // namespace

extern "C" {

// Solve a family of box QPs sharing (P, A): factor once, solve `batch`
// instances of (q, l, u). Outputs X (batch×n), Y (batch×m), converged flags.
// Returns 0 on success, 1 if the ADMM KKT matrix is not SPD.
int admm_box_qp_family(const double* P, const double* A, int n, int m,
                       const double* Q, const double* L, const double* U,
                       int batch, double rho, double sigma, int iters,
                       double eps_abs, int do_polish, double* X, double* Y,
                       uint8_t* converged) {
  // M = P + σI + ρ AᵀA, factored once for the whole family.
  std::vector<double> M(n * n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      double s = P[i * n + j];
      for (int r = 0; r < m; ++r) s += rho * A[r * n + i] * A[r * n + j];
      M[i * n + j] = s + (i == j ? sigma : 0.0);
    }
  if (!cholesky(M.data(), n)) return 1;

  std::vector<double> x(n), z(m), y(m), rhs(n), xt(n), Ax(m), zprev(m), tmp(n);

  for (int b = 0; b < batch; ++b) {
    const double* q = Q + b * n;
    const double* l = L + b * m;
    const double* u = U + b * m;
    std::fill(x.begin(), x.end(), 0.0);
    std::fill(z.begin(), z.end(), 0.0);
    std::fill(y.begin(), y.end(), 0.0);
    double prim = 1e30, dual = 1e30;

    for (int it = 0; it < iters; ++it) {
      // rhs = σx − q + Aᵀ(ρz − y)
      for (int i = 0; i < m; ++i) zprev[i] = rho * z[i] - y[i];
      matvec_t(A, m, n, zprev.data(), tmp.data());
      for (int i = 0; i < n; ++i) rhs[i] = sigma * x[i] - q[i] + tmp[i];
      chol_solve(M.data(), n, rhs.data(), xt.data());
      std::memcpy(x.data(), xt.data(), n * sizeof(double));

      matvec(A, m, n, x.data(), Ax.data());
      for (int i = 0; i < m; ++i) zprev[i] = z[i];
      for (int i = 0; i < m; ++i) {
        double v = Ax[i] + y[i] / rho;
        if (std::isfinite(l[i]) && v < l[i]) v = l[i];
        if (std::isfinite(u[i]) && v > u[i]) v = u[i];
        z[i] = v;
      }
      for (int i = 0; i < m; ++i) y[i] += rho * (Ax[i] - z[i]);

      if ((it & 15) == 15 || it == iters - 1) {
        prim = 0.0;
        for (int i = 0; i < m; ++i)
          prim = std::max(prim, std::fabs(Ax[i] - z[i]));
        for (int i = 0; i < m; ++i) zprev[i] = z[i] - zprev[i];
        matvec_t(A, m, n, zprev.data(), tmp.data());
        dual = rho * inf_norm(tmp.data(), n);
        if (prim < eps_abs && dual < eps_abs) break;
      }
    }

    double* xo = X + b * n;
    double* yo = Y + b * m;
    std::memcpy(xo, x.data(), n * sizeof(double));
    std::memcpy(yo, y.data(), m * sizeof(double));
    if (do_polish) {
      polish(P, q, A, l, u, n, m, z.data(), xo, yo,
             1e-6 * (1.0 + inf_norm(z.data(), m)));
    }
    // converged = ADMM residuals met the tolerance, or the (polished) solution
    // certifies optimality directly.
    bool admm_ok = prim < eps_abs && dual < eps_abs;
    converged[b] =
        (admm_ok ||
         kkt_residual(P, q, A, l, u, n, m, xo, yo) < std::max(eps_abs, 1e-8))
            ? 1
            : 0;
  }
  return 0;
}

// Single-instance convenience wrapper.
int admm_box_qp(const double* P, const double* q, const double* A,
                const double* l, const double* u, int n, int m, double rho,
                double sigma, int iters, double eps_abs, int do_polish,
                double* x, double* y, uint8_t* converged) {
  return admm_box_qp_family(P, A, n, m, q, l, u, 1, rho, sigma, iters,
                            eps_abs, do_polish, x, y, converged);
}

// KKT residual exposed for tests (certificate checks from Python).
double qp_kkt_residual(const double* P, const double* q, const double* A,
                       const double* l, const double* u, int n, int m,
                       const double* x, const double* y) {
  return kkt_residual(P, q, A, l, u, n, m, x, y);
}

}  // extern "C"
