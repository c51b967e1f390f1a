// Fused batched AL-iLQR for the kinematic-bicycle parking OCP: a group of G
// threads per scenario lane, one CTA per tile of T lanes (T x G threads), the
// whole augmented-Lagrangian solve in one launch.
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
// tile-wide (__syncthreads_and) over the same T lanes whatever G is, so a
// solve at tile T gives the same numbers for every G.
//
// What bounds it: latency, not bytes or FLOPs. The operands are ~0.7 k floats
// per lane and the algorithm needs ~3 k FP32 and SFU operations (tan, sin,
// cos, sqrt, division) per stage and inner iteration inside data-dependent
// loops. With one thread per lane, the sweep's 2,048 lanes put ~15 threads on
// each SM, each running ~92 k dependent operations per inner iteration with
// every operand a load through L2. Of those only the Riccati recursion and
// each rollout's own stages are true chains, so the design spreads the rest
// over the G members of a lane's group (ALILQR_GROUP, one library per G;
// thread threadIdx.x serves lane threadIdx.x / G as member threadIdx.x % G),
// as csrc/ilqr_factory.cu does for the tracker:
//   - a pre-pass computes, before the Riccati sweep, everything of a stage
//     that does not depend on the Riccati carry (the Jacobian entries, the
//     box rows' gradient and Gauss-Newton diagonal, the 9 clearance pairs'
//     gradient and curvature, summed in pair order inside one member): the N
//     stages are dealt to the members and written to a per-lane store of ND
//     floats a stage;
//   - the Riccati recursion runs on the store, computed by every member alike
//     (a warp's operation takes one scheduler slot whether one or all of its
//     threads run it, and replication saves a broadcast); only member 0
//     stores the gains. Dealing its dot products was measured slower for the
//     tracker (PERF.md) and is not done;
//   - members 0..6 each roll one line-search candidate and keep its
//     trajectory and its cost, summed in stage order; the pick reads the 7
//     costs with the reference's tie rule, and the accepted candidate is
//     copied into xs / us by all members (no re-roll: without FMA contraction
//     the kept candidate has the re-roll's bits);
//   - the total cost and the multiplier sweep's max-reductions run in every
//     member, the multiplier update is dealt by (stage, row);
//   - every split is `for (item = member; item < n; item += G)`, so G = 1
//     runs the same code in one thread. Phases are separated by __syncwarp
//     (G <= 32 divides the warp), the two loop votes by __syncthreads_and,
//     reached by every thread of the CTA, padded lanes included;
//   - a lane's working set (derivative store, gains, xs, us, lam, the 7
//     candidates: ~12.4 KB at N = 30 with the obstacle) lives in shared
//     memory as far as the tile allows, lane-major with an odd lane stride
//     (members reading neighbouring rows, or the same row of neighbouring
//     lanes, hit different banks; the candidate index is fastest where 7
//     members write together); the wrapper picks the regions that fit
//     (Args::smask) and the rest stays in global memory laid out [row][lane],
//     the outputs in their own buffers;
//   - __launch_bounds__ caps the registers so that T x G threads fit the
//     register file: 256 threads at G = 1, 512 at G > 1.
// Operand modes, chosen at compile time as the Pallas kernel's static track /
// has_dist / has_uref flags (template parameter MODE, bits M_TRACK, M_DIST,
// M_UREF): the state costs penalize x - ref_t, the Euler step adds the lane's
// offset d after the nominal update, the R-cost is on u - uref_t. Each mode's
// operands are a lane's regions like the rest (R_REF, R_UREF, R_DIST; empty
// in the modes that do not read them), so the regulation mode (MODE 0) runs
// the instructions and the layout it ran before the modes existed. Built:
// MODE 0, M_TRACK and all three, each without and with the obstacle rows; the
// wrapper gives any other combination as all three, the missing operands zero.
//
// On an NVIDIA H100 80GB HBM3 (700 W), 2,048 lanes, N = 30, at tile 16: a
// warm launch takes 5.4 ms at G = 8 (27.4 ms at G = 1, 10.2 ms at G = 32;
// 32.0 ms with one thread per lane and the working set in L2); the bound of
// its operations is 0.25 ms (PERF.md).
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

// operand modes (the template parameter MODE)
#define M_TRACK 1  // refs (N+1, 4): state costs on x - ref_t
#define M_DIST 2   // dist (4): x+ = F(x, u) + d
#define M_UREF 4   // urefs (N, 2): R-cost on u - uref_t
#define M_ALL (M_TRACK | M_DIST | M_UREF)

// Threads per lane; one library is built per value (-DALILQR_GROUP=G).
#ifndef ALILQR_GROUP
#define ALILQR_GROUP 1
#endif
constexpr int GROUP = ALILQR_GROUP;
static_assert(GROUP == 1 || GROUP == 8 || GROUP == 32, "a group must divide the warp");
// Threads per CTA (tile x GROUP) the launch bounds allow; the wrapper reads it.
constexpr int MAX_THREADS = GROUP == 1 ? 256 : 512;

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
  const float *refs, *dist, *urefs;  // (N+1, 4, Bp), (4, Bp), (N, 2, Bp); null when unused
  float *us, *xs, *viol, *conv, *lam, *ni;  // outputs; us, xs, lam are the state
  float* work;  // (rows, Bp): the workspace regions that are not in shared memory
  int N, outer, inner, Bp;
  int smask;  // bit r set: region r of a lane's working set lives in shared memory
};

// One stage of the derivative store: the Jacobian entries of the Euler step
// (A = I + sparse, B sparse; a33 and b30 are the lane's constants), then the
// stage cost's gradient and Hessian with the box and clearance rows.
enum {
  D_A02, D_A03, D_A12, D_A13, D_A23, D_B01, D_B11, D_B21,
  D_LX, D_HD = D_LX + NX, D_LU = D_HD + NX, D_HUU = D_LU + NU,
  D_H01 = D_HUU + NU, D_H02, D_H12, ND
};

// A lane's working set, by region, in the order the wrapper fills shared
// memory (ops/cuda/ilqr_kernel.py regions). xs, us and lam have their home in
// the output buffers, the mode's operands in their inputs; the derivative
// store, the gains and the candidates have theirs in `work`, in this order.
enum { R_DER, R_GAIN, R_XS, R_US, R_LAM, R_CAND, R_REF, R_UREF, R_DIST, N_REGIONS };

__host__ __device__ inline int region_floats(int r, int N, int nc, int mode) {
  switch (r) {
    case R_DER: return N * ND;
    case R_GAIN: return N * NU * (1 + NX);
    case R_XS: return (N + 1) * NX;
    case R_US: return N * NU;
    case R_LAM: return N * nc;
    case R_CAND: return NALPHA * ((N + 1) * NX + N * NU + 1);
    case R_REF: return mode & M_TRACK ? (N + 1) * NX : 0;
    case R_UREF: return mode & M_UREF ? N * NU : 0;
    default: return mode & M_DIST ? NX : 0;
  }
}

// Floats of one lane's block in shared memory: its regions in `smask`, padded
// to an odd count (neighbouring lanes then start on different banks).
__host__ __device__ inline int lane_floats(int smask, int N, int nc, int mode) {
  int n = 0;
  for (int r = 0; r < N_REGIONS; ++r)
    if (smask >> r & 1) n += region_floats(r, N, nc, mode);
  return n | 1;
}

// max that propagates NaN from either side (as jnp.maximum / torch.maximum)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// max(0, a) that keeps NaN (as jnp.maximum(0, a) / torch.clamp(a, min=0))
__device__ __forceinline__ float relu(float a) { return a < 0.0f ? 0.0f : a; }

// One Euler step of the kinematic bicycle; sin(beta) = K tan(d) / sqrt(1 +
// K^2 tan^2(d)), so no atan. With M_DIST the lane's offset dv is added after
// the nominal update.
template <int MODE>
__device__ __forceinline__ void euler_step(const Consts& c, float acc, float fric,
                                           const float* dv, float& px, float& py,
                                           float& psi, float& v, float a, float dl) {
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
  if (MODE & M_DIST) {
    px = npx + dv[0];
    py = npy + dv[1];
    psi = npsi + dv[2];
    v = nv + dv[3];
  } else {
    px = npx;
    py = npy;
    psi = npsi;
    v = nv;
  }
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

// The state cost Qd e e of e = x (e = x - r with M_TRACK).
template <int MODE>
__device__ __forceinline__ float state_cost(const Consts& c, float px, float py, float psi,
                                            float v, const float* ref) {
  if (MODE & M_TRACK) return quad_x(c, px - ref[0], py - ref[1], psi - ref[2], v - ref[3]);
  return quad_x(c, px, py, psi, v);
}

// Quadratic cost plus the AL penalty sum_r (act_r^2 - lam_r^2) / (2 mu); ref
// and uref are the stage's references (read with M_TRACK, M_UREF).
template <int NC, int MODE>
__device__ __forceinline__ float stage_cost(const Consts& c, float px, float py,
                                            float psi, float v, float a, float dl,
                                            const float* lam, float mu, const float* ref,
                                            const float* uref) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
  float cr[NCON];
  constraint_rows<NC>(c, px, py, psi, v, a, dl, cr);
  const float fa = MODE & M_UREF ? a - uref[0] : a;
  const float fd = MODE & M_UREF ? dl - uref[1] : dl;
  const float quad =
      state_cost<MODE>(c, px, py, psi, v, ref) + (c.rd[0] * fa * fa + c.rd[1] * fd * fd);
  float phi = 0.0f;
#pragma unroll
  for (int r = 0; r < NCON; ++r) {
    const float act = relu(lam[r] + mu * cr[r]);
    phi = phi + (act * act - lam[r] * lam[r]);
  }
  return quad + phi / (2.0f * mu);
}

// One region of a lane's working set: element i at p[i * stride] (stride 1 in
// the lane's shared-memory block, Bp in a [row][lane] global buffer).
struct Region {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int i) const { return p[(size_t)i * stride]; }
};

// A lane's views of its working set.
struct LaneView {
  Region der, gain, xs, us, lam, cand, ref, uref, dist;
  int nc, N;
  __device__ float& x(int t, int i) const { return xs[t * NX + i]; }
  __device__ float& r(int t, int i) const { return ref[t * NX + i]; }
  __device__ float& ur(int t, int j) const { return uref[t * NU + j]; }
  __device__ float& u(int t, int j) const { return us[t * NU + j]; }
  __device__ float& l(int t, int r) const { return lam[t * nc + r]; }
  __device__ float& d(int t, int k) const { return der[t * ND + k]; }
  __device__ float& kg(int t, int j) const { return gain[t * NU + j]; }
  __device__ float& Kg(int t, int r) const { return gain[N * NU + t * NU * NX + r]; }
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

// A stage's references, in registers (left unset in the modes that do not read them).
template <int MODE>
__device__ __forceinline__ void stage_refs(const LaneView& w, int t, float* r, float* ur) {
  if (MODE & M_TRACK) {
#pragma unroll
    for (int i = 0; i < NX; ++i) r[i] = w.r(t, i);
  }
  if ((MODE & M_UREF) && t < w.N) {
#pragma unroll
    for (int j = 0; j < NU; ++j) ur[j] = w.ur(t, j);
  }
}

template <int NC, int MODE>
__device__ __forceinline__ float total_cost(const Consts& c, const LaneView& w, float mu) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
  float lam[NCON], r[NX], ur[NU];
  float cost = 0.0f;
  for (int t = 0; t < w.N; ++t) {
#pragma unroll
    for (int q = 0; q < NCON; ++q) lam[q] = w.l(t, q);
    stage_refs<MODE>(w, t, r, ur);
    cost = cost + stage_cost<NC, MODE>(c, w.x(t, 0), w.x(t, 1), w.x(t, 2), w.x(t, 3),
                                       w.u(t, 0), w.u(t, 1), lam, mu, r, ur);
  }
  stage_refs<MODE>(w, w.N, r, ur);
  return cost + c.qn * state_cost<MODE>(c, w.x(w.N, 0), w.x(w.N, 1), w.x(w.N, 2),
                                        w.x(w.N, 3), r);
}

// The derivative store of every stage at the stored (x_t, u_t, lam_t): the
// stages are dealt to the group's members.
template <int NC, int MODE, int G>
__device__ __forceinline__ void derivatives(const Consts& c, const LaneView& w, float mu,
                                            int member) {
  constexpr int P = NC * NC;
  constexpr int NCD = NC > 0 ? NC : 1;  // divisor for the pair index
  constexpr int B0 = 2 * NX;          // first input-box row
  constexpr int BC = 2 * NX + 2 * NU;  // first clearance row
#pragma unroll 1
  for (int t = member; t < w.N; t += G) {
    const float X[NX] = {w.x(t, 0), w.x(t, 1), w.x(t, 2), w.x(t, 3)};
    const float U[NU] = {w.u(t, 0), w.u(t, 1)};
    float R[NX], UR[NU];
    stage_refs<MODE>(w, t, R, UR);
    const float psi = X[2], v = X[3], dl = U[1];
    // Jacobian entries of the Euler step
    const float tn = tanf(dl);
    const float den2 = 1.0f + c.kb2 * tn * tn;
    const float den = sqrtf(den2);
    const float sinb = c.kb * tn / den;
    const float cosb = 1.0f / den;
    const float sp = sinf(psi), cp = cosf(psi);
    const float s_pb = sp * cosb + cp * sinb;
    const float c_pb = cp * cosb - sp * sinb;
    const float bp = c.kb * (1.0f + tn * tn) / den2;
    w.d(t, D_A02) = -c.ts * v * s_pb;
    w.d(t, D_A03) = c.ts * c_pb;
    w.d(t, D_A12) = c.ts * v * c_pb;
    w.d(t, D_A13) = c.ts * s_pb;
    w.d(t, D_A23) = c.ts * sinb * c.inv_lr;
    w.d(t, D_B01) = -c.ts * v * s_pb * bp;
    w.d(t, D_B11) = c.ts * v * c_pb * bp;
    w.d(t, D_B21) = c.ts * v * cosb * bp * c.inv_lr;

    // stage derivatives: quadratic cost plus Gauss-Newton box rows
    float lx[NX], hd[NX], lu[NU], huu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float act_u = relu(w.l(t, i) + mu * (X[i] - c.ubx[i]));
      const float act_l = relu(w.l(t, NX + i) + mu * (c.lbx[i] - X[i]));
      lx[i] = c.qd2[i] * (MODE & M_TRACK ? X[i] - R[i] : X[i]) + act_u - act_l;
      const float ind = (act_u > 0.0f ? 1.0f : 0.0f) + (act_l > 0.0f ? 1.0f : 0.0f);
      hd[i] = c.qd2[i] + mu * ind;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const float act_u = relu(w.l(t, B0 + j) + mu * (U[j] - c.ubu[j]));
      const float act_l = relu(w.l(t, B0 + NU + j) + mu * (c.lbu[j] - U[j]));
      lu[j] = c.rd2[j] * (MODE & M_UREF ? U[j] - UR[j] : U[j]) + act_u - act_l;
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
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      w.d(t, D_LX + i) = lx[i];
      w.d(t, D_HD + i) = hd[i];
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      w.d(t, D_LU + j) = lu[j];
      w.d(t, D_HUU + j) = huu[j];
    }
    w.d(t, D_H01) = h01;
    w.d(t, D_H02) = h02;
    w.d(t, D_H12) = h12;
  }
}

// Riccati sweep over the derivative store; returns whether every stage's
// regularized Quu was positive definite, and max|Qu|. Every member of the
// group computes it alike; `store` (one member) writes the gains.
template <int MODE>
__device__ __forceinline__ void backward(const Consts& c, const LaneView& w, float acc,
                                         float fric, float reg, bool store, bool& ok_out,
                                         float& grad_out) {
  const int N = w.N;
  const float a33 = 1.0f - c.ts * fric;
  const float b30 = c.ts * acc;
  float Vx[NX], V[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = c.qnqd2[i] * (MODE & M_TRACK ? w.x(N, i) - w.r(N, i) : w.x(N, i));
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = i == j ? c.qnqd2[i] : 0.0f;
  }
  bool ok = true;
  float grad = 0.0f;
  for (int t = N - 1; t >= 0; --t) {
    const float a02 = w.d(t, D_A02), a03 = w.d(t, D_A03), a12 = w.d(t, D_A12);
    const float a13 = w.d(t, D_A13), a23 = w.d(t, D_A23);
    const float b01 = w.d(t, D_B01), b11 = w.d(t, D_B11), b21 = w.d(t, D_B21);
    float lx[NX], hd[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      lx[i] = w.d(t, D_LX + i);
      hd[i] = w.d(t, D_HD + i);
    }
    const float lu[NU] = {w.d(t, D_LU), w.d(t, D_LU + 1)};
    const float huu[NU] = {w.d(t, D_HUU), w.d(t, D_HUU + 1)};
    const float h01 = w.d(t, D_H01), h02 = w.d(t, D_H02), h12 = w.d(t, D_H12);

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
    if (store) {
      w.kg(t, 0) = k0;
      w.kg(t, 1) = k1;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        w.Kg(t, j) = K0[j];
        w.Kg(t, NX + j) = K1[j];
      }
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

// The closed-loop rollouts of the line search, one candidate per member
// (members 0..6 at G >= 8): candidate s keeps its trajectory in cx / cu and
// its cost, summed in stage order, in cc.
template <int NC, int MODE, int G>
__device__ __forceinline__ void rollouts(const Consts& c, const LaneView& w, const float* x0,
                                         const float* dv, float acc, float fric, float mu,
                                         int member) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
#pragma unroll 1
  for (int s = member; s < NALPHA; s += G) {
    const float alpha = c.alpha[s];
    float px = x0[0], py = x0[1], psi = x0[2], v = x0[3];
    float cost = 0.0f;
    float xh[NX], uh[NU], kg[NU], Kg[NU * NX], lam[NCON], r[NX], ur[NU];
#pragma unroll 1
    for (int t = 0; t < w.N; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) xh[i] = w.x(t, i);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        uh[j] = w.u(t, j);
        kg[j] = w.kg(t, j);
      }
#pragma unroll
      for (int r = 0; r < NU * NX; ++r) Kg[r] = w.Kg(t, r);
#pragma unroll
      for (int q = 0; q < NCON; ++q) lam[q] = w.l(t, q);
      stage_refs<MODE>(w, t, r, ur);
      float a, dl;
      ls_control(alpha, xh, uh, kg, Kg, px, py, psi, v, a, dl);
      w.cx(s, t, 0) = px;
      w.cx(s, t, 1) = py;
      w.cx(s, t, 2) = psi;
      w.cx(s, t, 3) = v;
      w.cu(s, t, 0) = a;
      w.cu(s, t, 1) = dl;
      cost = cost + stage_cost<NC, MODE>(c, px, py, psi, v, a, dl, lam, mu, r, ur);
      euler_step<MODE>(c, acc, fric, dv, px, py, psi, v, a, dl);
    }
    w.cx(s, w.N, 0) = px;
    w.cx(s, w.N, 1) = py;
    w.cx(s, w.N, 2) = psi;
    w.cx(s, w.N, 3) = v;
    stage_refs<MODE>(w, w.N, r, ur);
    w.cc(s) = cost + c.qn * state_cost<MODE>(c, px, py, psi, v, r);
  }
}

// Row q of the constraints at stage t (constraint_rows' order and operations).
template <int NC>
__device__ __forceinline__ float constraint_row(const Consts& c, const LaneView& w, int t,
                                                int q) {
  constexpr int NCD = NC > 0 ? NC : 1;
  constexpr int BC = 2 * NX + 2 * NU;
  if (q < NX) return w.x(t, q) - c.ubx[q];
  if (q < 2 * NX) return c.lbx[q - NX] - w.x(t, q - NX);
  if (q < 2 * NX + NU) return w.u(t, q - 2 * NX) - c.ubu[q - 2 * NX];
  if (q < BC) return c.lbu[q - 2 * NX - NU] - w.u(t, q - 2 * NX - NU);
  const int i = (q - BC) / NCD, j = (q - BC) % NCD;
  const float psi = w.x(t, 2);
  const float sp = sinf(psi), cp = cosf(psi);
  const float wx = w.x(t, 0) + c.ox[i] * cp - c.qx[j];
  const float wy = w.x(t, 1) + c.ox[i] * sp - c.qy[j];
  return c.r2 - (wx * wx + wy * wy);
}

extern __shared__ float lane_blocks[];  // T blocks of lane_floats() floats

template <int NC, int MODE, int G>
__global__ void __launch_bounds__(MAX_THREADS) alilqr_tile_kernel(const Args g, const Consts c) {
  constexpr int NCON = 2 * NX + 2 * NU + NC * NC;
  const int member = threadIdx.x % G, slot = threadIdx.x / G;
  const int lane = blockIdx.x * (blockDim.x / G) + slot;
  // the threads of this warp: all of them are here, none has diverged yet
  const unsigned warp = G > 1 ? __activemask() : 0u;
  const int Bp = g.Bp, N = g.N;

  // place the regions: in the lane's shared block, in its home, or in `work`
  LaneView w;
  w.nc = NCON;
  w.N = N;
  float* const block = lane_blocks + (size_t)slot * lane_floats(g.smask, N, NCON, MODE);
  int in_block = 0, in_work = 0;
  auto place = [&](int r, float* home) {  // called once per region, in region order
    const int n = region_floats(r, N, NCON, MODE);
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
  w.der = place(R_DER, nullptr);
  w.gain = place(R_GAIN, nullptr);
  w.xs = place(R_XS, g.xs);
  w.us = place(R_US, g.us);
  w.lam = place(R_LAM, g.lam);
  w.cand = place(R_CAND, nullptr);
  // the mode's operands: read where they are, or copied into the lane's block
  w.ref = place(R_REF, const_cast<float*>(g.refs));
  w.uref = place(R_UREF, const_cast<float*>(g.urefs));
  w.dist = place(R_DIST, const_cast<float*>(g.dist));
  const float acc = g.pp[lane], fric = g.pp[Bp + lane];
  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = g.x0[i * Bp + lane];

  // init: controls and multipliers from the warm start (and the mode's
  // operands kept in shared memory), then a rollout (a chain: one member)
  for (int i = member; i < N * NU; i += G) w.us[i] = g.u0[(size_t)i * Bp + lane];
  for (int i = member; i < N * NCON; i += G) w.lam[i] = g.lam0[(size_t)i * Bp + lane];
  if ((MODE & M_TRACK) && (g.smask >> R_REF & 1))
    for (int i = member; i < (N + 1) * NX; i += G) w.ref[i] = g.refs[(size_t)i * Bp + lane];
  if ((MODE & M_UREF) && (g.smask >> R_UREF & 1))
    for (int i = member; i < N * NU; i += G) w.uref[i] = g.urefs[(size_t)i * Bp + lane];
  if ((MODE & M_DIST) && (g.smask >> R_DIST & 1))
    for (int i = member; i < NX; i += G) w.dist[i] = g.dist[(size_t)i * Bp + lane];
  group_sync<G>(warp);
  float dv[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dv[i] = MODE & M_DIST ? w.dist[i] : 0.0f;
  if (member == 0) {
    float px = x0[0], py = x0[1], psi = x0[2], v = x0[3];
    for (int t = 0; t < N; ++t) {
      w.x(t, 0) = px;
      w.x(t, 1) = py;
      w.x(t, 2) = psi;
      w.x(t, 3) = v;
      euler_step<MODE>(c, acc, fric, dv, px, py, psi, v, w.u(t, 0), w.u(t, 1));
    }
    w.x(N, 0) = px;
    w.x(N, 1) = py;
    w.x(N, 2) = psi;
    w.x(N, 3) = v;
  }
  group_sync<G>(warp);

  // mu, viol, lam_step, cost, reg, grad and the counters are computed by
  // every member alike, so both votes see a lane's value G times
  float mu = c.mu_init, viol = INFINITY, lam_step = INFINITY;
  int ni_total = 0;
  for (int oi = 0; oi < g.outer; ++oi) {
    if (__syncthreads_and((viol < c.viol_tol) && (lam_step < 1e-3f))) break;
    // inner Levenberg-iLQR on the current multipliers
    float cost = total_cost<NC, MODE>(c, w, mu);
    float reg = c.reg_init, grad = INFINITY;
    int it = 0;
    for (; it < g.inner; ++it) {
      if (__syncthreads_and(grad < c.grad_tol)) break;
      derivatives<NC, MODE, G>(c, w, mu, member);
      group_sync<G>(warp);
      bool ok;
      backward<MODE>(c, w, acc, fric, reg, member == 0, ok, grad);
      group_sync<G>(warp);
      rollouts<NC, MODE, G>(c, w, x0, dv, acc, fric, mu, member);
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
    float v_n = 0.0f, step = 0.0f, lmax = 0.0f;
    float cr[NCON];
    for (int t = 0; t < N; ++t) {
      constraint_rows<NC>(c, w.x(t, 0), w.x(t, 1), w.x(t, 2), w.x(t, 3), w.u(t, 0),
                          w.u(t, 1), cr);
#pragma unroll
      for (int r = 0; r < NCON; ++r) {
        const float lam = w.l(t, r);
        const float lam_n = relu(lam + mu * cr[r]);
        v_n = nmax(v_n, relu(cr[r]));
        step = nmax(step, fabsf(lam_n - lam));
        lmax = nmax(lmax, fabsf(lam_n));
      }
    }
    group_sync<G>(warp);
    for (int item = member; item < N * NCON; item += G) {
      const int t = item / NCON, r = item - t * NCON;
      w.l(t, r) = relu(w.l(t, r) + mu * constraint_row<NC>(c, w, t, r));
    }
    group_sync<G>(warp);
    viol = v_n;
    lam_step = step / (1.0f + lmax);
    if (viol > c.viol_tol) mu = fminf(mu * c.mu_scale, c.mu_max);
  }
  // regions kept in shared memory go to their outputs
  if (g.smask >> R_XS & 1)
    for (int i = member; i < (N + 1) * NX; i += G) g.xs[(size_t)i * Bp + lane] = w.xs[i];
  if (g.smask >> R_US & 1)
    for (int i = member; i < N * NU; i += G) g.us[(size_t)i * Bp + lane] = w.us[i];
  if (g.smask >> R_LAM & 1)
    for (int i = member; i < N * NCON; i += G) g.lam[(size_t)i * Bp + lane] = w.lam[i];
  if (member == 0) {
    g.viol[lane] = viol;
    g.conv[lane] = viol < c.viol_tol ? 1.0f : 0.0f;
    g.ni[lane] = (float)ni_total;
  }
}

template <int NC, int MODE>
static int launch_kernel(const Args& g, const Consts& c, int n_tiles, int tile, size_t bytes,
                         cudaStream_t s) {
  auto kernel = alilqr_tile_kernel<NC, MODE, GROUP>;
  if (bytes > 48 * 1024) {  // beyond the default, dynamic shared memory is opt-in
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, tile * GROUP, bytes, s>>>(g, c);
  return (int)cudaGetLastError();
}

extern "C" int alilqr_tiles_launch(const float* x0, const float* u0, const float* pp,
                                   const float* lam0, const float* refs, const float* dist,
                                   const float* urefs, float* us, float* xs, float* viol,
                                   float* conv, float* lam, float* ni, float* work,
                                   const float* consts, int n_consts, int N, int n_circ,
                                   int mode, int outer, int inner, int tile, int n_tiles,
                                   int group, int smask, void* stream) {
  if (n_consts * sizeof(float) != sizeof(Consts) || N < 1 || tile < 1 || n_tiles < 1 ||
      group != GROUP || tile * GROUP > MAX_THREADS || smask < 0 || smask >= 1 << N_REGIONS ||
      ((mode & M_TRACK) != 0) != (refs != nullptr) || ((mode & M_DIST) != 0) != (dist != nullptr) ||
      ((mode & M_UREF) != 0) != (urefs != nullptr))
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Args g;
  g.x0 = x0; g.u0 = u0; g.pp = pp; g.lam0 = lam0;
  g.refs = refs; g.dist = dist; g.urefs = urefs;
  g.us = us; g.xs = xs; g.viol = viol; g.conv = conv; g.lam = lam; g.ni = ni;
  g.work = work;
  g.N = N; g.outer = outer; g.inner = inner; g.Bp = tile * n_tiles;
  g.smask = smask;
  const int nc = 2 * NX + 2 * NU + n_circ * n_circ;
  const size_t bytes =
      smask ? (size_t)tile * lane_floats(smask, N, nc, mode) * sizeof(float) : 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_circ * 8 + mode) {
    case 0: return launch_kernel<0, 0>(g, c, n_tiles, tile, bytes, s);
    case M_TRACK: return launch_kernel<0, M_TRACK>(g, c, n_tiles, tile, bytes, s);
    case M_ALL: return launch_kernel<0, M_ALL>(g, c, n_tiles, tile, bytes, s);
    case 24: return launch_kernel<3, 0>(g, c, n_tiles, tile, bytes, s);
    case 24 + M_TRACK: return launch_kernel<3, M_TRACK>(g, c, n_tiles, tile, bytes, s);
    case 24 + M_ALL: return launch_kernel<3, M_ALL>(g, c, n_tiles, tile, bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The group this library was built for, and the threads per CTA it allows.
extern "C" int alilqr_group() { return GROUP; }
extern "C" int alilqr_max_threads() { return MAX_THREADS; }

extern "C" const char* alilqr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
