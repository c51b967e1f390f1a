// Fused batched AL-iLQR for the kinematic-bicycle parking OCP: one thread per
// scenario lane, one CTA per tile of T lanes, the whole augmented-Lagrangian
// solve in one launch.
//
// Replaces the Pallas TPU kernel _alilqr_tile_kernel in
// model_predictive_control_tpu/ops/pallas/ilqr_kernel.py (wrapper
// al_ilqr_solve_pallas). Plain twin: al_ilqr_tiles_reference in
// model_predictive_control_tpu_torch/ops/cuda/ilqr_kernel.py, which does the
// same operations in the same order.
//
// What it computes, per lane: an outer PHR loop (multiplier update
// lam <- max(0, lam + mu c), mu x mu_scale where still infeasible) around an
// inner Levenberg-iLQR (hand-expanded 4x4 / 2x4 / 2x2 Riccati sweep with the
// analytic bicycle Jacobians and the exact clearance curvature, a closed-form
// regularized 2x2 solve) and a 7-step line search. Both loop exits are
// tile-wide (__syncthreads_and), as in the reference.
//
// What bounds it: latency, not bytes or FLOPs. At the contract size (2048
// lanes) the card holds about 15 threads per SM, each running a long
// dependent chain of FP32 and SFU (tan, sin, cos, sqrt) operations through
// N-stage sweeps inside data-dependent loops; a lane's state (about 1,100
// floats at N=30 with 21 constraint rows) does not fit in registers or in
// shared memory at a useful T. The design therefore:
//   - keeps the trajectory (xs, us), the multipliers and the gains (k, K) in
//     global memory laid out [stage][row][lane], so that a warp's accesses
//     coalesce; at 2048 lanes this is about 9 MB and stays in the 50 MB L2;
//     xs, us and lam live directly in the output buffers;
//   - keeps the Riccati carry (Vx, Vxx) and the per-stage algebra in
//     registers;
//   - runs the 7 line-search rollouts interleaved in one pass over the
//     stages (the stage's gains and multipliers are read once for all 7),
//     and re-rolls the accepted step to write xs and us, with the same
//     device function, instead of storing 7 candidate trajectories: that
//     saves 7x(N+1)x6 floats of traffic per lane and iteration, and the
//     re-roll gives the same numbers bit for bit because the file is built
//     without FMA contraction (--fmad=false);
//   - takes T as a runtime parameter: smaller tiles couple fewer stragglers
//     into a tile's loops and put more CTAs on the SMs.
// Making it fast (several lanes' stages in flight per thread, shared-memory
// staging of the gains, a persistent grid) is left for later work.
//
// Built with nvcc -O3 for sm_90a, without --use_fast_math: tanf, sinf, cosf,
// sqrtf and the divisions are the precise ones.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#define NX 4
#define NU 2
#define NALPHA 7
#define MAX_CIRCLES 3

// Float constants, in the order ops/cuda/ilqr_kernel.py::_consts writes them.
struct Consts {
  float ts, kb, kb2, inv_lr, r2;  // inv_lr: float32 1 / LR
  float ox[MAX_CIRCLES], qx[MAX_CIRCLES], qy[MAX_CIRCLES];
  float lbx[NX], ubx[NX], lbu[NU], ubu[NU];
  float qd[NX], rd[NU], qn;
  float qd2[NX], rd2[NU], qnqd2[NX];  // 2 Qd, 2 Rd, 2 qn Qd
  float mu_init, mu_scale, mu_max, viol_tol, grad_tol;
  float alpha[NALPHA];
  float reg_init, reg_min, reg_max;
};

struct Args {
  const float *x0, *u0, *pp, *lam0;  // (4, Bp), (N, 2, Bp), (2, Bp), (N, nc, Bp)
  float *us, *xs, *viol, *conv, *lam, *ni;  // outputs; us, xs, lam are the state
  float* work;  // (10 N, Bp): k (N, 2) then K (N, 8)
  int N, outer, inner, Bp;
};

// max that propagates NaN from either side (as jnp.maximum / torch.maximum)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// max(0, a) that keeps NaN (as jnp.maximum(0, a) / torch.clamp(a, min=0))
__device__ __forceinline__ float relu(float a) { return a < 0.0f ? 0.0f : a; }

// One Euler step of the kinematic bicycle; sin(beta) = K tan(d) / sqrt(1 +
// K^2 tan^2(d)), so no atan.
__device__ __forceinline__ void euler_step(const Consts& c, float acc, float fric,
                                           float& px, float& py, float& psi,
                                           float& v, float a, float dl) {
  const float t = tanf(dl);
  const float den = sqrtf(1.0f + c.kb2 * t * t);
  const float sinb = c.kb * t / den;
  const float cosb = 1.0f / den;
  const float sp = sinf(psi), cp = cosf(psi);
  const float s_pb = sp * cosb + cp * sinb;
  const float c_pb = cp * cosb - sp * sinb;
  const float npx = px + c.ts * v * c_pb;
  const float npy = py + c.ts * v * s_pb;
  const float npsi = psi + c.ts * v * sinb * c.inv_lr;
  const float nv = v + c.ts * (acc * a - fric * v);
  px = npx;
  py = npy;
  psi = npsi;
  v = nv;
}

// Constraint rows in the reference's order: x - ub (4), lb - x (4),
// u - ub (2), lb - u (2), then r2 - |c_i - o_j|^2 for pairs p = i n + j.
template <int NC>
__device__ __forceinline__ void constraint_rows(const Consts& c, float px, float py,
                                                float psi, float v, float a,
                                                float dl, float* cr) {
  const float xv[NX] = {px, py, psi, v};
  const float uv[NU] = {a, dl};
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[i] = xv[i] - c.ubx[i];
#pragma unroll
  for (int i = 0; i < NX; ++i) cr[NX + i] = c.lbx[i] - xv[i];
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[2 * NX + j] = uv[j] - c.ubu[j];
#pragma unroll
  for (int j = 0; j < NU; ++j) cr[2 * NX + NU + j] = c.lbu[j] - uv[j];
  if (NC > 0) {
    const float sp = sinf(psi), cp = cosf(psi);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float wx = px + c.ox[i] * cp - c.qx[j];
        const float wy = py + c.ox[i] * sp - c.qy[j];
        cr[2 * NX + 2 * NU + i * NC + j] = c.r2 - (wx * wx + wy * wy);
      }
    }
  }
}

__device__ __forceinline__ float quad_x(const Consts& c, float px, float py,
                                        float psi, float v) {
  return c.qd[0] * px * px + c.qd[1] * py * py + c.qd[2] * psi * psi +
         c.qd[3] * v * v;
}

// Quadratic cost plus the AL penalty sum_r (act_r^2 - lam_r^2) / (2 mu).
template <int NC>
__device__ __forceinline__ float stage_cost(const Consts& c, float px, float py,
                                            float psi, float v, float a, float dl,
                                            const float* lam, float mu) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
  float cr[NCON];
  constraint_rows<NC>(c, px, py, psi, v, a, dl, cr);
  const float quad = quad_x(c, px, py, psi, v) + (c.rd[0] * a * a + c.rd[1] * dl * dl);
  float phi = 0.0f;
#pragma unroll
  for (int r = 0; r < NCON; ++r) {
    const float act = relu(lam[r] + mu * cr[r]);
    phi = phi + (act * act - lam[r] * lam[r]);
  }
  return quad + phi / (2.0f * mu);
}

// Lane-offset views of the [stage][row][lane] buffers.
struct LaneView {
  float *xs, *us, *lam, *k, *K;
  int Bp, nc, N;
  __device__ float& x(int t, int i) const { return xs[(t * NX + i) * Bp]; }
  __device__ float& u(int t, int j) const { return us[(t * NU + j) * Bp]; }
  __device__ float& l(int t, int r) const { return lam[(t * nc + r) * Bp]; }
  __device__ float& kg(int t, int j) const { return k[(t * NU + j) * Bp]; }
  __device__ float& Kg(int t, int r) const { return K[(t * NU * NX + r) * Bp]; }
};

template <int NC>
__device__ __forceinline__ float total_cost(const Consts& c, const LaneView& w, float mu) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
  float lam[NCON];
  float cost = 0.0f;
  for (int t = 0; t < w.N; ++t) {
#pragma unroll
    for (int r = 0; r < NCON; ++r) lam[r] = w.l(t, r);
    cost = cost + stage_cost<NC>(c, w.x(t, 0), w.x(t, 1), w.x(t, 2), w.x(t, 3),
                                 w.u(t, 0), w.u(t, 1), lam, mu);
  }
  return cost + c.qn * quad_x(c, w.x(w.N, 0), w.x(w.N, 1), w.x(w.N, 2), w.x(w.N, 3));
}

// Riccati sweep over the stored trajectory; writes the gains and returns
// whether every stage's regularized Quu was positive definite, and max|Qu|.
template <int NC>
__device__ __forceinline__ void backward(const Consts& c, const LaneView& w, float acc, float fric,
                         float mu, float reg, bool& ok_out, float& grad_out) {
  constexpr int P = NC * NC;
  constexpr int NCD = NC > 0 ? NC : 1;  // divisor for the pair index
  constexpr int B0 = 2 * NX;          // first input-box row
  constexpr int BC = 2 * NX + 2 * NU;  // first clearance row
  const int N = w.N;
  float Vx[NX], V[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = c.qnqd2[i] * w.x(N, i);
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = i == j ? c.qnqd2[i] : 0.0f;
  }
  bool ok = true;
  float grad = 0.0f;
  for (int t = N - 1; t >= 0; --t) {
    const float X[NX] = {w.x(t, 0), w.x(t, 1), w.x(t, 2), w.x(t, 3)};
    const float U[NU] = {w.u(t, 0), w.u(t, 1)};
    const float psi = X[2], v = X[3], dl = U[1];
    // Jacobian entries of the Euler step (A = I + sparse, B sparse)
    const float tn = tanf(dl);
    const float den2 = 1.0f + c.kb2 * tn * tn;
    const float den = sqrtf(den2);
    const float sinb = c.kb * tn / den;
    const float cosb = 1.0f / den;
    const float sp = sinf(psi), cp = cosf(psi);
    const float s_pb = sp * cosb + cp * sinb;
    const float c_pb = cp * cosb - sp * sinb;
    const float bp = c.kb * (1.0f + tn * tn) / den2;
    const float a02 = -c.ts * v * s_pb;
    const float a03 = c.ts * c_pb;
    const float a12 = c.ts * v * c_pb;
    const float a13 = c.ts * s_pb;
    const float a23 = c.ts * sinb * c.inv_lr;
    const float a33 = 1.0f - c.ts * fric;
    const float b01 = -c.ts * v * s_pb * bp;
    const float b11 = c.ts * v * c_pb * bp;
    const float b21 = c.ts * v * cosb * bp * c.inv_lr;
    const float b30 = c.ts * acc;

    // stage derivatives: quadratic cost plus Gauss-Newton box rows
    float lx[NX], hd[NX], lu[NU], huu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float act_u = relu(w.l(t, i) + mu * (X[i] - c.ubx[i]));
      const float act_l = relu(w.l(t, NX + i) + mu * (c.lbx[i] - X[i]));
      lx[i] = c.qd2[i] * X[i] + act_u - act_l;
      const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
      hd[i] = c.qd2[i] + mu * ind;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float act_u = relu(w.l(t, B0 + j) + mu * (U[j] - c.ubu[j]));
      const float act_l = relu(w.l(t, B0 + NU + j) + mu * (c.lbu[j] - U[j]));
      lu[j] = c.rd2[j] * U[j] + act_u - act_l;
      const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
      huu[j] = c.rd2[j] + mu * ind;
    }
    float h01 = 0.0f, h02 = 0.0f, h12 = 0.0f;
    if (P > 0) {
      // clearance rows: ind g g^T plus the exact curvature act d2c, summed
      // over the pairs in order
      float s[9];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float ox = c.ox[p / NCD];
        const float ex = -ox * sp;
        const float ey = ox * cp;
        const float wx = X[0] + ox * cp - c.qx[p % NCD];
        const float wy = X[1] + ox * sp - c.qy[p % NCD];
        const float cc = c.r2 - (wx * wx + wy * wy);
        const float act = relu(w.l(t, BC + p) + mu * cc);
        const float ind = mu * (act > 0.0f ? 1.0f : 0.0f);
        const float gx = -2.0f * wx;
        const float gy = -2.0f * wy;
        const float gpsi = -2.0f * (wx * ex + wy * ey);
        const float d2psi = -2.0f * (ox * ox - ox * (wx * cp + wy * sp));
        const float term[9] = {
            act * gx,
            act * gy,
            act * gpsi,
            ind * gx * gx - 2.0f * act,
            ind * gx * gy,
            ind * gx * gpsi - 2.0f * act * ex,
            ind * gy * gy - 2.0f * act,
            ind * gy * gpsi - 2.0f * act * ey,
            ind * gpsi * gpsi + act * d2psi,
        };
#pragma unroll
        for (int q = 0; q < 9; ++q) s[q] = p == 0 ? term[q] : s[q] + term[q];
      }
      lx[0] = lx[0] + s[0];
      lx[1] = lx[1] + s[1];
      lx[2] = lx[2] + s[2];
      hd[0] = hd[0] + s[3];
      h01 = h01 + s[4];
      h02 = h02 + s[5];
      hd[1] = hd[1] + s[6];
      h12 = h12 + s[7];
      hd[2] = hd[2] + s[8];
    }

    // Qx = lx + A^T Vx, Qu = lu + B^T Vx
    const float Qx[NX] = {
        lx[0] + Vx[0],
        lx[1] + Vx[1],
        lx[2] + Vx[2] + a02 * Vx[0] + a12 * Vx[1],
        lx[3] + a03 * Vx[0] + a13 * Vx[1] + a23 * Vx[2] + a33 * Vx[3],
    };
    const float Qu0 = lu[0] + b30 * Vx[3];
    const float Qu1 = lu[1] + b01 * Vx[0] + b11 * Vx[1] + b21 * Vx[2];
    // M = Vxx A
    float M[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      M[i][0] = V[i][0];
      M[i][1] = V[i][1];
      M[i][2] = V[i][0] * a02 + V[i][1] * a12 + V[i][2];
      M[i][3] = V[i][0] * a03 + V[i][1] * a13 + V[i][2] * a23 + V[i][3] * a33;
    }
    // Qxx = lxx + A^T M, symmetrized
    float Q[NX][NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      Q[0][j] = M[0][j];
      Q[1][j] = M[1][j];
      Q[2][j] = a02 * M[0][j] + a12 * M[1][j] + M[2][j];
      Q[3][j] = a03 * M[0][j] + a13 * M[1][j] + a23 * M[2][j] + a33 * M[3][j];
    }
    const float h[NX][NX] = {
        {hd[0], h01, h02, 0.0f},
        {h01, hd[1], h12, 0.0f},
        {h02, h12, hd[2], 0.0f},
        {0.0f, 0.0f, 0.0f, hd[3]},
    };
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j) {
        Q[i][j] = Q[i][j] + h[i][j];
        if (i != j) Q[j][i] = Q[j][i] + h[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i + 1; j < NX; ++j) {
        const float sym = 0.5f * (Q[i][j] + Q[j][i]);
        Q[i][j] = sym;
        Q[j][i] = sym;
      }
    }
    // Quu = luu + B^T Vxx B, Qux = B^T M
    const float q00 = huu[0] + b30 * b30 * V[3][3];
    const float q01 = b30 * (V[3][0] * b01 + V[3][1] * b11 + V[3][2] * b21);
    const float q11 = huu[1] + (b01 * (V[0][0] * b01 + V[0][1] * b11 + V[0][2] * b21) +
                                b11 * (V[1][0] * b01 + V[1][1] * b11 + V[1][2] * b21) +
                                b21 * (V[2][0] * b01 + V[2][1] * b11 + V[2][2] * b21));
    float Qux0[NX], Qux1[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      Qux0[j] = b30 * M[3][j];
      Qux1[j] = b01 * M[0][j] + b11 * M[1][j] + b21 * M[2][j];
    }
    // regularized 2x2 solve in closed form
    const float q00r = q00 + reg;
    const float q11r = q11 + reg;
    const float det = q00r * q11r - q01 * q01;
    ok = ok && (q00r > 0.0f) && (det > 0.0f);
    const float det_safe = det > 0.0f ? det : 1.0f;
    const float i00 = q11r / det_safe;
    const float i11 = q00r / det_safe;
    const float i01 = -q01 / det_safe;
    const float k0 = -(i00 * Qu0 + i01 * Qu1);
    const float k1 = -(i01 * Qu0 + i11 * Qu1);
    float K0[NX], K1[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      K0[j] = -(i00 * Qux0[j] + i01 * Qux1[j]);
      K1[j] = -(i01 * Qux0[j] + i11 * Qux1[j]);
    }
    // Vx, Vxx with the unregularized Quu
    const float g0 = q00 * k0 + q01 * k1 + Qu0;
    const float g1 = q01 * k0 + q11 * k1 + Qu1;
    float KQ0[NX], KQ1[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      Vx[j] = Qx[j] + K0[j] * g0 + K1[j] * g1 + Qux0[j] * k0 + Qux1[j] * k1;
      KQ0[j] = q00 * K0[j] + q01 * K1[j];
      KQ1[j] = q01 * K0[j] + q11 * K1[j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        V[i][j] = Q[i][j] + K0[i] * KQ0[j] + K1[i] * KQ1[j] + K0[i] * Qux0[j] +
                  K1[i] * Qux1[j] + Qux0[i] * K0[j] + Qux1[i] * K1[j];
      }
    }
    w.kg(t, 0) = k0;
    w.kg(t, 1) = k1;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      w.Kg(t, j) = K0[j];
      w.Kg(t, NX + j) = K1[j];
    }
    grad = nmax(grad, nmax(fabsf(Qu0), fabsf(Qu1)));
  }
  ok_out = ok;
  grad_out = grad;
}

// Control of one line-search candidate at a stage: u = uh + alpha k + K dx.
__device__ __forceinline__ void ls_control(float alpha, const float* xh, const float* uh,
                                           const float* kg, const float* Kg, float px,
                                           float py, float psi, float v, float& a,
                                           float& dl) {
  const float dx0 = px - xh[0], dx1 = py - xh[1], dx2 = psi - xh[2], dx3 = v - xh[3];
  const float du0 = alpha * kg[0] + (Kg[0] * dx0 + Kg[1] * dx1 + Kg[2] * dx2 + Kg[3] * dx3);
  const float du1 = alpha * kg[1] + (Kg[4] * dx0 + Kg[5] * dx1 + Kg[6] * dx2 + Kg[7] * dx3);
  a = uh[0] + du0;
  dl = uh[1] + du1;
}

__device__ __forceinline__ void load_stage(const LaneView& w, int t, float* xh, float* uh,
                                           float* kg, float* Kg) {
#pragma unroll
  for (int i = 0; i < NX; ++i) xh[i] = w.x(t, i);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    uh[j] = w.u(t, j);
    kg[j] = w.kg(t, j);
  }
#pragma unroll
  for (int r = 0; r < NU * NX; ++r) Kg[r] = w.Kg(t, r);
}

// Costs of the closed-loop rollouts under every line-search step, in one
// pass over the stages.
template <int NC>
__device__ __forceinline__ void forward_costs(const Consts& c, const LaneView& w, const float* x0,
                              float acc, float fric, float mu, float* cost) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
  float px[NALPHA], py[NALPHA], psi[NALPHA], v[NALPHA];
#pragma unroll
  for (int s = 0; s < NALPHA; ++s) {
    px[s] = x0[0];
    py[s] = x0[1];
    psi[s] = x0[2];
    v[s] = x0[3];
    cost[s] = 0.0f;
  }
  float xh[NX], uh[NU], kg[NU], Kg[NU * NX], lam[NCON];
  for (int t = 0; t < w.N; ++t) {
    load_stage(w, t, xh, uh, kg, Kg);
#pragma unroll
    for (int r = 0; r < NCON; ++r) lam[r] = w.l(t, r);
#pragma unroll
    for (int s = 0; s < NALPHA; ++s) {
      float a, dl;
      ls_control(c.alpha[s], xh, uh, kg, Kg, px[s], py[s], psi[s], v[s], a, dl);
      cost[s] = cost[s] + stage_cost<NC>(c, px[s], py[s], psi[s], v[s], a, dl, lam, mu);
      euler_step(c, acc, fric, px[s], py[s], psi[s], v[s], a, dl);
    }
  }
#pragma unroll
  for (int s = 0; s < NALPHA; ++s) cost[s] = cost[s] + c.qn * quad_x(c, px[s], py[s], psi[s], v[s]);
}

// Re-roll the accepted step, writing the new trajectory over the stored one
// (each stage is read before it is overwritten).
__device__ __forceinline__ void accept_step(const Consts& c, const LaneView& w, const float* x0,
                            float acc, float fric, float alpha) {
  float px = x0[0], py = x0[1], psi = x0[2], v = x0[3];
  float xh[NX], uh[NU], kg[NU], Kg[NU * NX];
  for (int t = 0; t < w.N; ++t) {
    load_stage(w, t, xh, uh, kg, Kg);
    float a, dl;
    ls_control(alpha, xh, uh, kg, Kg, px, py, psi, v, a, dl);
    w.x(t, 0) = px;
    w.x(t, 1) = py;
    w.x(t, 2) = psi;
    w.x(t, 3) = v;
    w.u(t, 0) = a;
    w.u(t, 1) = dl;
    euler_step(c, acc, fric, px, py, psi, v, a, dl);
  }
  w.x(w.N, 0) = px;
  w.x(w.N, 1) = py;
  w.x(w.N, 2) = psi;
  w.x(w.N, 3) = v;
}

template <int NC>
__global__ void alilqr_tile_kernel(const Args g, const Consts c) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int Bp = g.Bp, N = g.N;
  LaneView w;
  w.xs = g.xs + lane;
  w.us = g.us + lane;
  w.lam = g.lam + lane;
  w.k = g.work + lane;
  w.K = g.work + (size_t)NU * N * Bp + lane;
  w.Bp = Bp;
  w.nc = NCON;
  w.N = N;
  const float acc = g.pp[lane], fric = g.pp[Bp + lane];
  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = g.x0[i * Bp + lane];

  // init: controls and multipliers from the warm start, then a rollout
  for (int t = 0; t < N; ++t) {
#pragma unroll
    for (int j = 0; j < NU; ++j) w.u(t, j) = g.u0[(t * NU + j) * Bp + lane];
    for (int r = 0; r < NCON; ++r) w.l(t, r) = g.lam0[(t * NCON + r) * Bp + lane];
  }
  {
    float px = x0[0], py = x0[1], psi = x0[2], v = x0[3];
    for (int t = 0; t < N; ++t) {
      w.x(t, 0) = px;
      w.x(t, 1) = py;
      w.x(t, 2) = psi;
      w.x(t, 3) = v;
      euler_step(c, acc, fric, px, py, psi, v, w.u(t, 0), w.u(t, 1));
    }
    w.x(N, 0) = px;
    w.x(N, 1) = py;
    w.x(N, 2) = psi;
    w.x(N, 3) = v;
  }

  float mu = c.mu_init, viol = INFINITY, lam_step = INFINITY;
  int ni_total = 0;
  for (int oi = 0; oi < g.outer; ++oi) {
    if (__syncthreads_and((viol < c.viol_tol) && (lam_step < 1e-3f))) break;
    // inner Levenberg-iLQR on the current multipliers
    float cost = total_cost<NC>(c, w, mu);
    float reg = c.reg_init, grad = INFINITY;
    int it = 0;
    for (; it < g.inner; ++it) {
      if (__syncthreads_and(grad < c.grad_tol)) break;
      bool ok;
      backward<NC>(c, w, acc, fric, mu, reg, ok, grad);
      float costs[NALPHA];
      forward_costs<NC>(c, w, x0, acc, fric, mu, costs);
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
        accept_step(c, w, x0, acc, fric, c.alpha[pick]);
        cost = best;
        reg = fmaxf(reg * 0.5f, c.reg_min);
      } else {
        reg = fminf(reg * 10.0f, c.reg_max);
      }
    }
    ni_total += it;
    // multiplier sweep: violation, lam update, lam step
    float v_n = 0.0f, step = 0.0f, lmax = 0.0f;
    float cr[NCON];
    for (int t = 0; t < N; ++t) {
      constraint_rows<NC>(c, w.x(t, 0), w.x(t, 1), w.x(t, 2), w.x(t, 3), w.u(t, 0),
                          w.u(t, 1), cr);
#pragma unroll
      for (int r = 0; r < NCON; ++r) {
        const float lam = w.l(t, r);
        const float lam_n = relu(lam + mu * cr[r]);
        w.l(t, r) = lam_n;
        v_n = nmax(v_n, relu(cr[r]));
        step = nmax(step, fabsf(lam_n - lam));
        lmax = nmax(lmax, fabsf(lam_n));
      }
    }
    viol = v_n;
    lam_step = step / (1.0f + lmax);
    if (viol > c.viol_tol) mu = fminf(mu * c.mu_scale, c.mu_max);
  }
  g.viol[lane] = viol;
  g.conv[lane] = viol < c.viol_tol ? 1.0f : 0.0f;
  g.ni[lane] = (float)ni_total;
}

extern "C" long alilqr_workspace_rows(int N) { return (long)(NU + NU * NX) * N; }

extern "C" int alilqr_tiles_launch(const float* x0, const float* u0, const float* pp,
                                   const float* lam0, float* us, float* xs, float* viol,
                                   float* conv, float* lam, float* ni, float* work,
                                   const float* consts, int n_consts, int N, int n_circ,
                                   int outer, int inner, int tile, int n_tiles,
                                   void* stream) {
  if (n_consts * sizeof(float) != sizeof(Consts) || N < 1 || tile < 1 || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Args g;
  g.x0 = x0; g.u0 = u0; g.pp = pp; g.lam0 = lam0;
  g.us = us; g.xs = xs; g.viol = viol; g.conv = conv; g.lam = lam; g.ni = ni;
  g.work = work;
  g.N = N; g.outer = outer; g.inner = inner; g.Bp = tile * n_tiles;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_circ) {
    case 0: alilqr_tile_kernel<0><<<n_tiles, tile, 0, s>>>(g, c); break;
    case 3: alilqr_tile_kernel<3><<<n_tiles, tile, 0, s>>>(g, c); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* alilqr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
