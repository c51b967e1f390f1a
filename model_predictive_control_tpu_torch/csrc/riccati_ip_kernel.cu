// Fused batched stagewise Riccati interior-point solve of an LTI
// box-constrained LQ optimal-control problem: a group of G threads per
// scenario lane, one CTA per tile of T lanes (T x G threads), the whole
// Mehrotra predictor-corrector solve and its active-set polish in one launch.
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
// What bounds it: latency, not bytes or FLOPs. Per iteration a lane runs
// three true recursions over its N stages (the Riccati factorization, with a
// division a stage, and the affine backward and forward sweeps, twice), and
// everything else is elementwise over the stages: the barrier diagonals and
// linear terms that feed the recursions, the Newton slack/dual steps with
// their ratio test, the gap products, the candidate check and the update.
// With one thread per lane (the first port) all of it ran in one thread, ~10
// dependent passes over the stages with every operand in global memory:
// 23.5 ms per warm launch at 4,096 lanes, N = 100, against a bound of 0.034 ms.
// The design (the lane groups of csrc/ilqr_kernel.cu and csrc/ilqr_factory.cu,
// laid out member-major):
//   - a group of G threads serves a lane (IP_GROUP, one library per G):
//     thread threadIdx.x is member threadIdx.x / T of lane threadIdx.x % T,
//     so that a warp holds one member of up to 32 lanes (its loads and stores
//     touch neighbouring lanes) and the members of a lane sit in different
//     warps; every elementwise pass is dealt by stage,
//     `for (t = member; t < N; t += G)`, a stage's loads issued together
//     before the pass stores into it, so G = 1 runs the same code in one
//     thread;
//   - the stage-parallel inputs of the recursions (the barrier diagonals and
//     the linear terms) are written into a per-stage scratch store before the
//     chain runs, so that a chain does only its dependent algebra; the
//     predictor's affine backward sweep runs inside the factorization's loop
//     (both walk t = N-1..0 and the affine pass needs only that stage's Qi
//     and Qux); the next iteration's scratch is written by the update pass,
//     and the gap sum of the updated state runs in the next factorization's
//     loop, interleaved with it. The Newton dual steps (a division each) and
//     the Mehrotra terms are computed once per iteration and kept in free
//     slots for the passes that read them again;
//   - the recursions and the ordered gap sums run in member 0 alone (its warp
//     issues them; the other members' warps wait at the barrier), a
//     recursion's operands loaded one stage ahead; the gap sums add the
//     products in the twin's order (stage, group, entry, lower then upper);
//   - the order-free reductions (the ratio test's min, the violation's max,
//     the finiteness flags) and member 0's sums reach every member through a
//     per-lane exchange area of G floats, between two CTA barriers; every
//     member reads the same values in the same order;
//   - a lane's working set (33 N floats at nx = 2, nu = 1, and the exchange
//     area) lives in shared memory as far as the tile allows, lane-major with
//     an odd lane stride, each region [stage][row]; the wrapper picks the
//     regions that fit (Args::smask) and the rest stays in global memory laid
//     out [stage][row][lane], xs and us in their output buffers. The solve is
//     instantiated three times (solve_lane): with the exchange area, gains,
//     scratch and directions, or the whole working set, as offsets from the
//     shared array (so that the compiler addresses them as shared memory,
//     32-bit and without the generic window's test), or all generic;
//   - __launch_bounds__ caps the registers so that T x G threads fit the
//     register file: 256 threads at G = 1, 512 at G > 1.
// Problem matrices and bounds are in a kernel-argument struct with NX and NU
// compile-time (-DNX, -DNU: one library per size); a bound that is not finite
// has a zero flag, is never read and contributes exactly nothing.
//
// Built with nvcc -O3 for sm_90a with --fmad=false and without
// --use_fast_math: divisions are IEEE, denormals are kept, and the kernel is
// the same float program as its twin at every G.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#ifndef NX
#define NX 2
#endif
#ifndef NU
#define NU 1
#endif

// Threads per lane; one library is built per value (-DIP_GROUP=G).
#ifndef IP_GROUP
#define IP_GROUP 1
#endif
constexpr int GROUP = IP_GROUP;
static_assert(GROUP == 1 || GROUP == 8 || GROUP == 32, "a group must divide the warp");
// Threads per CTA (tile x GROUP) the launch bounds allow; the wrapper reads it.
constexpr int MAX_THREADS = GROUP == 1 ? 256 : 512;

constexpr int NE = NX + NU;                    // entries of a stage: x_{t+1}, then u_t
constexpr int GR = 2 * NU * NX + NU * NU + NU;  // gain rows of a stage: K, Qi, Qux, kff

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
  float *us, *xs, *mu, *prim, *succ, *it;  // outputs; us and xs are homes of the state
  float* work;  // (rows, Bp): the workspace regions that are not in shared memory
  int N, iters, Bp;
  int smask;  // bit r set: region r of a lane's working set lives in shared memory
  Flags f;
};

// A lane's working set, by region, in the order the wrapper fills shared
// memory (ops/cuda/riccati_ip_kernel.py::regions); each but the first holds
// `region_rows` floats a stage. The exchange area of the group's reductions
// (one float per member); the gains (K, Qi, Qux, kff); the scratch store
// (per entry e a low and a high slot: the barrier diagonal and the linear
// term of the next chain, the Newton dual steps or the Mehrotra terms of the
// ratio test, or the lower and the upper gap product); the directions (per
// entry the corrector's d and the predictor's da, which gives way to the
// corrector's upper Mehrotra term and dual step once read; after an update
// the new gap products, in the polish the solution and the multiplier
// estimate); x_1 .. x_N and u_0 .. u_{N-1}, at home in the output buffers;
// the slacks and duals (s_l, s_u, lam_l, lam_u). All but the state have
// their home in `work`, in this order.
enum { R_RED, R_GAIN, R_SCR, R_DIR, R_ZX, R_ZU, R_SD, N_REGIONS };

__host__ __device__ inline int region_rows(int r) {
  switch (r) {
    case R_GAIN: return GR;
    case R_SCR: return 2 * NE;
    case R_DIR: return 2 * NE;
    case R_ZX: return NX;
    case R_ZU: return NU;
    default: return 4 * NE;
  }
}

// Floats of region r for one lane: its rows at every stage, or for the
// exchange area R_RED one float per member.
__host__ __device__ inline int region_floats(int r, int N) {
  return r == R_RED ? GROUP : N * region_rows(r);
}

// Floats of one lane's block in shared memory: its regions in `smask`, padded
// to an odd count (neighbouring lanes then start on different banks).
__host__ __device__ inline int lane_floats(int smask, int N) {
  int n = 0;
  for (int r = 0; r < N_REGIONS; ++r)
    if (smask >> r & 1) n += region_floats(r, N);
  return n | 1;
}

// min / max that propagate NaN from either side (as torch.minimum/maximum)
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
// clip that keeps NaN (as torch.clamp)
__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- the lane group ---------------------------------------------------------

// Phase boundary inside a lane's group: what a member wrote before it, every
// member reads after it. A lane's members sit in different warps (thread
// threadIdx.x is member threadIdx.x / T of lane threadIdx.x % T), so the CTA
// barrier does; every thread of the CTA reaches every one.
__device__ __forceinline__ void group_sync() {
  if (GROUP > 1) __syncthreads();
}

// One element of a lane's working set: k at p[k * stride] (stride 1 in the
// lane's shared-memory block, Bp in a [row][lane] global buffer; 32-bit
// indices, which the wrapper checks).
struct Region {
  float* p;
  int stride;
  __device__ __forceinline__ float& operator[](int k) const { return p[k * stride]; }
};

// A region known to lie in the lane's shared-memory block: element k at p[k],
// p an offset from the shared array, so that the compiler addresses it as
// shared memory.
struct SharedRegion {
  float* p;
  __device__ __forceinline__ float& operator[](int k) const { return p[k]; }
};

// Reductions over a lane's group through its exchange area `red`: every
// member posts its value, then reads all of them in member order, so that
// every member ends with the same bits.
template <class R>
__device__ __forceinline__ float group_min(float v, const R& red, int member) {
  if (GROUP == 1) return v;
  red[member] = v;
  __syncthreads();
  v = red[0];
  for (int m = 1; m < GROUP; ++m) v = nmin(v, red[m]);
  __syncthreads();
  return v;
}
template <class R>
__device__ __forceinline__ float group_max(float v, const R& red, int member) {
  if (GROUP == 1) return v;
  red[member] = v;
  __syncthreads();
  v = red[0];
  for (int m = 1; m < GROUP; ++m) v = nmax(v, red[m]);
  __syncthreads();
  return v;
}
template <class R>
__device__ __forceinline__ bool group_all(bool b, const R& red, int member) {
  return group_min(b ? 1.0f : 0.0f, red, member) > 0.5f;
}
// member 0's value, to every member
template <class R>
__device__ __forceinline__ float group_bcast(float v, const R& red, int member) {
  if (GROUP == 1) return v;
  if (member == 0) red[0] = v;
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// ---- a lane's views ---------------------------------------------------------

// A lane's views: the exchange area, gains, scratch and directions of type R,
// the state and the slacks of type S; SharedRegion where the launch keeps
// them in shared memory.
template <class R, class S = Region>
struct Lane {
  R red, gain, scr, dir;
  S zx, zu, sd;
  __device__ __forceinline__ float& z(int t, int e) const {
    return e < NX ? zx[t * NX + e] : zu[t * NU + e - NX];
  }
  __device__ __forceinline__ float& sl(int t, int e) const { return sd[t * 4 * NE + e]; }
  __device__ __forceinline__ float& su(int t, int e) const { return sd[t * 4 * NE + NE + e]; }
  __device__ __forceinline__ float& ll(int t, int e) const { return sd[t * 4 * NE + 2 * NE + e]; }
  __device__ __forceinline__ float& lu(int t, int e) const { return sd[t * 4 * NE + 3 * NE + e]; }
  __device__ __forceinline__ float& d(int t, int e) const { return dir[t * 2 * NE + e]; }
  __device__ __forceinline__ float& da(int t, int e) const { return dir[t * 2 * NE + NE + e]; }
  __device__ __forceinline__ float& lo(int t, int e) const { return scr[t * 2 * NE + e]; }
  __device__ __forceinline__ float& hi(int t, int e) const { return scr[t * 2 * NE + NE + e]; }
  __device__ __forceinline__ float& K(int t, int a, int j) const { return gain[t * GR + a * NX + j]; }
  __device__ __forceinline__ float& Qi(int t, int a, int b) const {
    return gain[t * GR + NU * NX + a * NU + b];
  }
  __device__ __forceinline__ float& Qux(int t, int a, int j) const {
    return gain[t * GR + NU * NX + NU * NU + a * NX + j];
  }
  __device__ __forceinline__ float& kff(int t, int a) const {
    return gain[t * GR + 2 * NU * NX + NU * NU + a];
  }
};

// Entry e's bounds: finite flags and values (e < NX: a state, else an input).
struct Bound {
  bool ml, mu;
  float lb, ub;
};

__device__ __forceinline__ Bound bound(const Consts& c, const Flags& f, int e) {
  if (e < NX) return Bound{f.xl[e] != 0, f.xu[e] != 0, c.xlb[e], c.xub[e]};
  return Bound{f.ul[e - NX] != 0, f.uu[e - NX] != 0, c.ulb[e - NX], c.uub[e - NX]};
}

struct Entry {
  float z, sl, su, ll, lu;
};

// Every slot is read (one without a bound holds whatever was there) and the
// flags select after the loads, so that the loads of a stage are issued
// together instead of each after its flag.
template <class L>
__device__ __forceinline__ Entry load(const L& w, const Bound& b, int t, int e) {
  const float z = w.z(t, e), sl = w.sl(t, e), su = w.su(t, e), ll = w.ll(t, e), lu = w.lu(t, e);
  return Entry{z, b.ml ? sl : 1.0f, b.mu ? su : 1.0f, b.ml ? ll : 0.0f, b.mu ? lu : 0.0f};
}

// A stage's state and its slots, loaded before a pass stores anything of the
// stage (what a pass does not read, the compiler drops).
struct Stage {
  Entry x[NE];
  float d[NE], da[NE], lo[NE], hi[NE];
};

template <class L>
__device__ __forceinline__ Stage load_stage(const Consts& c, const Flags& f, const L& w, int t) {
  Stage st;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    st.x[e] = load(w, bound(c, f, e), t, e);
    st.d[e] = w.d(t, e);
    st.da[e] = w.da(t, e);
    st.lo[e] = w.lo(t, e);
    st.hi[e] = w.hi(t, e);
  }
  return st;
}

// ---- elementwise pieces -----------------------------------------------------

struct Step {
  float ds_l, ds_u, dl_l, dl_u;
};

// Mehrotra's second-order terms of one entry (lower, upper).
struct Corr {
  float c_l, c_u;
};

// The Newton slack steps of one entry given its primal direction dz.
__device__ __forceinline__ Step slack_step(const Entry& e, const Bound& b, float dz) {
  Step s = {0.0f, 0.0f, 0.0f, 0.0f};
  if (b.ml) {
    const float r_pl = e.z - e.sl - b.lb;
    s.ds_l = dz + r_pl;
  }
  if (b.mu) {
    const float r_pu = e.z + e.su - b.ub;
    s.ds_u = -dz - r_pu;
  }
  return s;
}

// Mehrotra's terms of one entry from the predictor direction dza.
__device__ __forceinline__ Corr mehrotra(const Entry& e, const Bound& b, float dza) {
  Corr k = {0.0f, 0.0f};
  if (b.ml) {
    const float r_pl = e.z - e.sl - b.lb;
    const float ds_a = dza + r_pl;
    k.c_l = (-e.ll - (e.ll / e.sl) * ds_a) * ds_a;
  }
  if (b.mu) {
    const float r_pu = e.z + e.su - b.ub;
    const float ds_a = -dza - r_pu;
    k.c_u = (-e.lu - (e.lu / e.su) * ds_a) * ds_a;
  }
  return k;
}

// The Newton dual steps of one entry after its slack steps s, with the
// terms k (zero for the predictor) and the centering sig_mu.
__device__ __forceinline__ void dual_step(const Entry& e, const Bound& b, const Corr& k,
                                          float sig_mu, Step& s) {
  if (b.ml) s.dl_l = (sig_mu - k.c_l - e.ll * e.sl - e.ll * s.ds_l) / e.sl;
  if (b.mu) s.dl_u = (sig_mu - k.c_u - e.lu * e.su - e.lu * s.ds_u) / e.su;
}

// The bound's share of the Newton-system gradient at one entry.
__device__ __forceinline__ float barrier_grad(const Entry& e, const Bound& b, const Corr& k,
                                              float sig_mu) {
  float acc = 0.0f;
  if (b.ml) {
    const float r_pl = e.z - e.sl - b.lb;
    acc = acc - (sig_mu - k.c_l) / e.sl + (e.ll / e.sl) * r_pl;
  }
  if (b.mu) {
    const float r_pu = e.z + e.su - b.ub;
    acc = acc + (sig_mu - k.c_u) / e.su + (e.lu / e.su) * r_pu;
  }
  return acc;
}

// The barrier Hessian lam / s of one entry.
__device__ __forceinline__ float barrier_diag(const Entry& e, const Bound& b) {
  float acc = 0.0f;
  if (b.ml) acc = acc + e.ll / e.sl;
  if (b.mu) acc = acc + e.lu / e.su;
  return acc;
}

// Linear terms of stage t (entries x_{t+1}, u_t): the cost gradient (W z, W
// the terminal weight Pf at the last stage, else Q; R for the inputs) plus the
// barrier gradient with the terms k.
__device__ __forceinline__ void linear_terms(const Consts& c, const Flags& f, int t, int N,
                                             const Entry* x, const Corr* k, float sig_mu,
                                             float* out) {
  const bool last = t == N - 1;
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    float quad = (last ? c.Pf[j][0] : c.Q[j][0]) * x[0].z;
#pragma unroll
    for (int i = 1; i < NX; ++i) quad = quad + (last ? c.Pf[j][i] : c.Q[j][i]) * x[i].z;
    out[j] = quad + barrier_grad(x[j], bound(c, f, j), k[j], sig_mu);
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    float quad = c.R[a][0] * x[NX].z;
#pragma unroll
    for (int b = 1; b < NU; ++b) quad = quad + c.R[a][b] * x[NX + b].z;
    out[NX + a] = quad + barrier_grad(x[NX + a], bound(c, f, NX + a), k[NX + a], sig_mu);
  }
}

__device__ __forceinline__ void ratio_test(float v, float dv, float& acc, bool& okf) {
  const float r = dv < 0.0f ? -v / (dv < F(-1e-30) ? dv : F(-1e-30)) : F(1e20);
  acc = nmin(acc, r);
  okf = okf && isfinite(dv);
}

// Active-set read of one entry: active (0/1), active at the upper bound,
// the bound it sits on, the multiplier estimate.
struct Active {
  float act;
  bool a_u;
  float tgt, lh;
};

__device__ __forceinline__ Active active_set(const Entry& e, const Bound& b) {
  const bool a_l = b.ml && (e.ll > e.sl);
  Active a;
  a.a_u = b.mu && (e.lu > e.su);
  a.act = (a_l || a.a_u) ? 1.0f : 0.0f;
  a.tgt = a.a_u ? b.ub : (b.ml ? b.lb : 0.0f);
  a.lh = (a.a_u ? e.lu : -e.ll) * a.act;
  return a;
}

__device__ __forceinline__ float violation(const Bound& b, float z) {
  float v = 0.0f;
  if (b.ml) v = nmax(v, b.lb - z);
  if (b.mu) v = nmax(v, z - b.ub);
  return v;
}

// What the update pass leaves for the next iteration at stage t, from the
// stage's state x: the gap products (lower in d, upper in da) and the
// predictor's scratch (barrier diagonal in lo, linear term in hi).
template <class L>
__device__ __forceinline__ void next_stage_inputs(const Consts& c, const Flags& f, const L& w,
                                                  int t, int N, const Entry* x) {
  Corr zero[NE];
  float lin[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) zero[e] = Corr{0.0f, 0.0f};
  linear_terms(c, f, t, N, x, zero, 0.0f, lin);
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const Bound b = bound(c, f, e);
    if (b.ml) w.d(t, e) = x[e].sl * x[e].ll;
    if (b.mu) w.da(t, e) = x[e].su * x[e].lu;
    w.lo(t, e) = barrier_diag(x[e], b);
    w.hi(t, e) = lin[e];
  }
}

// Stage t's share of a gap sum over the products in (lo slot, hi slot), in
// the twin's order: entries, lower then upper (all slots loaded first).
template <class R>
__device__ __forceinline__ float gap_add(const Flags& f, const R& r, int t, float tot) {
  float v[2 * NE];
#pragma unroll
  for (int k = 0; k < 2 * NE; ++k) v[k] = r[t * 2 * NE + k];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const bool ml = e < NX ? f.xl[e] != 0 : f.ul[e - NX] != 0;
    const bool mu = e < NX ? f.xu[e] != 0 : f.uu[e - NX] != 0;
    if (ml) tot = tot + v[e];
    if (mu) tot = tot + v[NE + e];
  }
  return tot;
}

// A whole gap sum (the mean complementarity) over the products in r.
template <class R>
__device__ __forceinline__ float gap_sum(const Consts& c, const Flags& f, const R& r, int N) {
  float tot = 0.0f;
#pragma unroll 4
  for (int t = 0; t < N; ++t) tot = gap_add(f, r, t, tot);
  return tot * c.inv_count;
}

// ---- the recursions ---------------------------------------------------------

// Backward Riccati over the stored barrier diagonals (lo) fused with the
// affine backward sweep over the stored linear terms (hi): the gains K, Qi,
// Qux and the feedforward kff of every stage. P's upper triangle is computed
// and mirrored. With GAP, the gap sum of the products in the d / da slots
// runs in the same loop (stage N-1-t while the recursion is at t) and is
// returned.
template <bool GAP, class L>
__device__ __forceinline__ float factor_backward(const Consts& c, const Flags& f, const L& w, int N) {
  float P[NX][NX], p[NX], sxu[NE], qr[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    sxu[e] = w.lo(N - 1, e);
    qr[e] = w.hi(N - 1, e);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = c.Pf[i][j];
    P[i][i] = P[i][i] + sxu[i];
    p[i] = qr[i];
  }
  float tot = 0.0f;
#pragma unroll 1
  for (int t = N - 1; t >= 0; --t) {
    if (GAP) tot = gap_add(f, w.dir, N - 1 - t, tot);
    // this stage's input rows; the state rows of stage t-1, for the step below
    float su[NU], r[NU], sx[NX], q[NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      su[a] = sxu[NX + a];
      r[a] = qr[NX + a];
    }
    if (t > 0) {
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        sxu[e] = w.lo(t - 1, e);
        qr[e] = w.hi(t - 1, e);
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      sx[i] = sxu[i];
      q[i] = qr[i];
    }
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
      }
    }
    // the affine backward sweep at this stage
    float qu[NU], kff[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = c.B[0][a] * p[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) acc = acc + c.B[i][a] * p[i];
      qu[a] = r[a] + acc;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = Qi[a][0] * qu[0];
#pragma unroll
      for (int b = 1; b < NU; ++b) acc = acc + Qi[a][b] * qu[b];
      kff[a] = -acc;
    }
    {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          w.K(t, a, j) = K[a][j];
          w.Qux(t, a, j) = Qux[a][j];
        }
#pragma unroll
        for (int b = 0; b < NU; ++b) w.Qi(t, a, b) = Qi[a][b];
        w.kff(t, a) = kff[a];
      }
    }
    if (t > 0) {  // dx_0 is fixed: no cost-to-go at stage 0
      float Pn[NX][NX], pn[NX];
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
      for (int j = 0; j < NX; ++j) {
        float acc = q[j];
#pragma unroll
        for (int i = 0; i < NX; ++i) acc = acc + c.A[i][j] * p[i];
#pragma unroll
        for (int a = 0; a < NU; ++a) acc = acc + Qux[a][j] * kff[a];
        pn[j] = acc;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        p[i] = pn[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = Pn[i][j];
      }
    }
  }
  return tot * c.inv_count;
}

// The affine backward sweep over the stored factorization and the linear
// terms in hi: kff of every stage. A stage's operands are loaded one stage
// ahead, so that the loads do not wait on the recursion.
template <class L>
__device__ __forceinline__ void affine_backward(const Consts& c, const L& w, int N) {
  float p[NX], qr[NE], Qi[NU][NU], Qux[NU][NX];
#pragma unroll
  for (int e = 0; e < NE; ++e) qr[e] = w.hi(N - 1, e);
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int b = 0; b < NU; ++b) Qi[a][b] = w.Qi(N - 1, a, b);
#pragma unroll
    for (int j = 0; j < NX; ++j) Qux[a][j] = w.Qux(N - 1, a, j);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) p[i] = qr[i];
#pragma unroll 2
  for (int t = N - 1; t >= 0; --t) {
    float r[NU], q[NX], Qi_t[NU][NU], Qux_t[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      r[a] = qr[NX + a];
#pragma unroll
      for (int b = 0; b < NU; ++b) Qi_t[a][b] = Qi[a][b];
#pragma unroll
      for (int j = 0; j < NX; ++j) Qux_t[a][j] = Qux[a][j];
    }
    if (t > 0) {
#pragma unroll
      for (int e = 0; e < NE; ++e) qr[e] = w.hi(t - 1, e);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
#pragma unroll
        for (int b = 0; b < NU; ++b) Qi[a][b] = w.Qi(t - 1, a, b);
#pragma unroll
        for (int j = 0; j < NX; ++j) Qux[a][j] = w.Qux(t - 1, a, j);
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) q[i] = qr[i];
    float qu[NU], kff[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = c.B[0][a] * p[0];
#pragma unroll
      for (int i = 1; i < NX; ++i) acc = acc + c.B[i][a] * p[i];
      qu[a] = r[a] + acc;
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = Qi_t[a][0] * qu[0];
#pragma unroll
      for (int b = 1; b < NU; ++b) acc = acc + Qi_t[a][b] * qu[b];
      kff[a] = -acc;
      w.kff(t, a) = kff[a];
    }
    if (t > 0) {
      float pn[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float acc = q[j];
#pragma unroll
        for (int i = 0; i < NX; ++i) acc = acc + c.A[i][j] * p[i];
#pragma unroll
        for (int a = 0; a < NU; ++a) acc = acc + Qux_t[a][j] * kff[a];
        pn[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) p[j] = pn[j];
    }
  }
}

// The affine forward sweep from dx_0 = x_init (nullptr: zero): the direction
// at x_{t+1} and u_t goes to the da slots (PRED) or the d slots of stage t.
// A stage's gains are loaded one stage ahead.
template <bool PRED, class L>
__device__ __forceinline__ void affine_forward(const Consts& c, const L& w, int N,
                                               const float* x_init) {
  float dx[NX], K[NU][NX], kff[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = x_init ? x_init[i] : 0.0f;
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    kff[a] = w.kff(0, a);
#pragma unroll
    for (int j = 0; j < NX; ++j) K[a][j] = w.K(0, a, j);
  }
#pragma unroll 2
  for (int t = 0; t < N; ++t) {
    float Kt[NU][NX], kt[NU], du[NU], dn[NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      kt[a] = kff[a];
#pragma unroll
      for (int j = 0; j < NX; ++j) Kt[a][j] = K[a][j];
    }
    if (t + 1 < N) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        kff[a] = w.kff(t + 1, a);
#pragma unroll
        for (int j = 0; j < NX; ++j) K[a][j] = w.K(t + 1, a, j);
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      float acc = Kt[a][0] * dx[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + Kt[a][j] * dx[j];
      du[a] = kt[a] + acc;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float acc = c.A[i][0] * dx[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) acc = acc + c.A[i][j] * dx[j];
#pragma unroll
      for (int a = 0; a < NU; ++a) acc = acc + c.B[i][a] * du[a];
      dn[i] = acc;
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float v = e < NX ? dn[e] : du[e - NX];
      if (PRED) w.da(t, e) = v;
      else w.d(t, e) = v;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = dn[i];
  }
}

extern __shared__ float lane_blocks[];  // T blocks of lane_floats() floats

// Phase clocks, in a measurement build only (-DIP_PHASE_CLOCKS): thread 0 of
// every CTA adds the cycles of each phase of its solve, and its executed
// iterations, to ip_phase_cycles (chip_smoke.py --long-horizon-phases).
#ifdef IP_PHASE_CLOCKS
constexpr int N_PHASES = 14;
__device__ unsigned long long ip_phase_cycles[N_PHASES + 1];
#define PHASE_START long long phase_t0 = clock64()
#define PHASE(k)                                                                    \
  {                                                                                 \
    const long long now = clock64();                                                \
    if (threadIdx.x == 0) atomicAdd(&ip_phase_cycles[k], (unsigned long long)(now - phase_t0)); \
    phase_t0 = now;                                                                 \
  }
#define PHASE_ITERATIONS(n) \
  if (threadIdx.x == 0) atomicAdd(&ip_phase_cycles[N_PHASES], (unsigned long long)(n))
extern "C" int stagewise_ip_phase_cycles(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ip_phase_cycles, sizeof(ip_phase_cycles));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[N_PHASES + 1] = {};
    e = cudaMemcpyToSymbol(ip_phase_cycles, zero, sizeof(zero));
  }
  return (int)e;
}
#else
#define PHASE_START
#define PHASE(k)
#define PHASE_ITERATIONS(n)
#endif

// The whole solve of one lane by one member of its group, over the views w.
template <class L>
__device__ __forceinline__ void solve_lane(const Args& g, const Consts& c, const L& w, int member,
                                           int lane) {
  const Flags& f = g.f;
  const int Bp = g.Bp, N = g.N;
  const bool chain = member == 0;  // the member that runs the recursions
  PHASE_START;

  // ---- init: rollout of the warm controls (a chain), balanced slacks -------
  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = g.x0[(size_t)i * Bp + lane];
  for (int t = member; t < N; t += GROUP) {
#pragma unroll
    for (int a = 0; a < NU; ++a) w.z(t, NX + a) = g.u0[((size_t)t * NU + a) * Bp + lane];
  }
  group_sync();
  if (chain) {
    float x[NX], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = x0[i];
      g.xs[(size_t)i * Bp + lane] = x0[i];
    }
#pragma unroll 1
    for (int t = 0; t < N; ++t) {
      float u[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) u[a] = w.z(t, NX + a);
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
        w.z(t, i) = x[i];
      }
    }
  }
  group_sync();
  for (int t = member; t < N; t += GROUP) {
    Entry x[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) x[e] = Entry{w.z(t, e), 1.0f, 1.0f, 0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const Bound b = bound(c, f, e);
      if (b.ml) {
        x[e].sl = clipf(x[e].z - b.lb, 1.0f, F(1e20));
        x[e].ll = 1.0f / x[e].sl;
        w.sl(t, e) = x[e].sl;
        w.ll(t, e) = x[e].ll;
      }
      if (b.mu) {
        x[e].su = clipf(b.ub - x[e].z, 1.0f, F(1e20));
        x[e].lu = 1.0f / x[e].su;
        w.su(t, e) = x[e].su;
        w.lu(t, e) = x[e].lu;
      }
    }
    next_stage_inputs(c, f, w, t, N, x);
  }
  group_sync();

  PHASE(0);
  // ---- Mehrotra predictor-corrector loop, tile-wide exit -------------------
  // At the top of iteration `it` member 0 sums the gap of the current state
  // (the products in the d / da slots), inside the next factorization when
  // there is one; a lane is done once that gap is below 50 eps or it died,
  // and the tile leaves when all its lanes are (not before the first
  // iteration). A pass's slots are named where it writes them.
  bool dead = false;
  float mu = 0.0f;
  int it = 0;
  for (;; ++it) {
    const bool more = it < g.iters;
    if (chain) {
      mu = more ? factor_backward<true>(c, f, w, N) : gap_sum(c, f, w.dir, N);
    }
    mu = group_bcast(mu, w.red, member);
    PHASE(1);
    if (!more || (it > 0 && __syncthreads_and((mu < c.eps50) || dead))) break;
    const bool frozen = mu < c.eps50;

    // predictor: pure Newton (sigma = 0); the affine backward sweep ran above
    if (chain) affine_forward<true>(c, w, N, nullptr);
    group_sync();
    PHASE(2);
    const Corr none = {0.0f, 0.0f};
    float acc = F(1e20);
    bool okf = true;
    for (int t = member; t < N; t += GROUP) {  // dual steps -> lo, hi
      const Stage st = load_stage(c, f, w, t);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const Bound b = bound(c, f, e);
        const Entry& x = st.x[e];
        Step s = slack_step(x, b, st.da[e]);
        dual_step(x, b, none, 0.0f, s);
        if (b.ml) ratio_test(x.sl, s.ds_l, acc, okf);
        if (b.mu) ratio_test(x.su, s.ds_u, acc, okf);
        if (b.ml) ratio_test(x.ll, s.dl_l, acc, okf);
        if (b.mu) ratio_test(x.lu, s.dl_u, acc, okf);
        if (b.ml) w.lo(t, e) = s.dl_l;
        if (b.mu) w.hi(t, e) = s.dl_u;
      }
    }
    acc = group_min(acc, w.red, member);
    PHASE(3);
    const float alpha_aff = acc > 1.0f ? 1.0f : acc;
    for (int t = member; t < N; t += GROUP) {  // gap products -> lo, hi
      const Stage st = load_stage(c, f, w, t);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const Bound b = bound(c, f, e);
        const Entry& x = st.x[e];
        const Step s = slack_step(x, b, st.da[e]);
        if (b.ml) w.lo(t, e) = (x.sl + alpha_aff * s.ds_l) * (x.ll + alpha_aff * st.lo[e]);
        if (b.mu) w.hi(t, e) = (x.su + alpha_aff * s.ds_u) * (x.lu + alpha_aff * st.hi[e]);
      }
    }
    group_sync();
    PHASE(4);
    const float mu_aff = group_bcast(chain ? gap_sum(c, f, w.scr, N) : 0.0f, w.red, member);
    PHASE(5);
    const float ratio = mu_aff / (mu < F(1e-30) ? F(1e-30) : mu);
    const float sigma = clipf(ratio * ratio * ratio, F(1e-8), 1.0f);
    const float sig_mu = sigma * mu;

    // corrector: recenter + second-order terms, same factorization
    for (int t = member; t < N; t += GROUP) {  // linear terms -> hi, terms -> lo, da
      const Stage st = load_stage(c, f, w, t);
      Corr k[NE];
      float lin[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) k[e] = mehrotra(st.x[e], bound(c, f, e), st.da[e]);
      linear_terms(c, f, t, N, st.x, k, sig_mu, lin);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const Bound b = bound(c, f, e);
        w.hi(t, e) = lin[e];
        if (b.ml) w.lo(t, e) = k[e].c_l;
        if (b.mu) w.da(t, e) = k[e].c_u;
      }
    }
    group_sync();
    PHASE(6);
    if (chain) affine_backward(c, w, N);
    group_sync();
    PHASE(7);
    if (chain) affine_forward<false>(c, w, N, nullptr);
    group_sync();
    PHASE(8);
    acc = F(1e20);
    okf = true;
    for (int t = member; t < N; t += GROUP) {  // dual steps -> lo, da
      const Stage st = load_stage(c, f, w, t);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const Bound b = bound(c, f, e);
        const Entry& x = st.x[e];
        const float dz = st.d[e];
        Step s = slack_step(x, b, dz);
        dual_step(x, b, Corr{b.ml ? st.lo[e] : 0.0f, b.mu ? st.da[e] : 0.0f}, sig_mu, s);
        if (b.ml) ratio_test(x.sl, s.ds_l, acc, okf);
        if (b.mu) ratio_test(x.su, s.ds_u, acc, okf);
        if (b.ml) ratio_test(x.ll, s.dl_l, acc, okf);
        if (b.mu) ratio_test(x.lu, s.dl_u, acc, okf);
        okf = okf && isfinite(dz);
        if (b.ml) w.lo(t, e) = s.dl_l;
        if (b.mu) w.da(t, e) = s.dl_u;
      }
    }
    acc = group_min(acc, w.red, member);
    okf = group_all(okf, w.red, member);
    PHASE(9);
    const float alpha_raw = acc > 1.0f ? 1.0f : acc;
    const float alpha = c.tau * alpha_raw;
    okf = okf && isfinite(alpha);
    bool fin = true;
    for (int t = member; t < N; t += GROUP) {
      const Stage st = load_stage(c, f, w, t);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const Bound b = bound(c, f, e);
        const Entry& x = st.x[e];
        const float dz = st.d[e];
        const Step s = slack_step(x, b, dz);
        fin = fin && isfinite(x.z + alpha * dz);
        if (b.ml) fin = fin && isfinite(x.sl + alpha * s.ds_l) && isfinite(x.ll + alpha * st.lo[e]);
        if (b.mu) fin = fin && isfinite(x.su + alpha * s.ds_u) && isfinite(x.lu + alpha * st.da[e]);
      }
    }
    fin = group_all(fin, w.red, member);  // every member reduces: no short circuit
    okf = okf && fin;
    PHASE(10);
    // a rejected lane recomputes the same direction forever: latch it dead
    dead = dead || !okf;
    const bool sel = !frozen && okf;
    // the update by select, and what the next iteration reads of the state
    for (int t = member; t < N; t += GROUP) {
      const Stage st = load_stage(c, f, w, t);
      Entry x[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const Bound b = bound(c, f, e);
        x[e] = st.x[e];
        const float dz = st.d[e], dl_l = st.lo[e], dl_u = st.da[e];
        const Step s = slack_step(x[e], b, dz);
        if (sel) {
          x[e].z = x[e].z + alpha * dz;
          w.z(t, e) = x[e].z;
          if (b.ml) {
            x[e].sl = x[e].sl + alpha * s.ds_l;
            x[e].ll = x[e].ll + alpha * dl_l;
            w.sl(t, e) = x[e].sl;
            w.ll(t, e) = x[e].ll;
          }
          if (b.mu) {
            x[e].su = x[e].su + alpha * s.ds_u;
            x[e].lu = x[e].lu + alpha * dl_u;
            w.su(t, e) = x[e].su;
            w.lu(t, e) = x[e].lu;
          }
        }
      }
      next_stage_inputs(c, f, w, t, N, x);
    }
    group_sync();
    PHASE(11);
  }
  const float mu_final = mu;

  // ---- active-set polish (augmented Lagrangian, two passes) ----------------
  // The multiplier estimates live in the da slots, the penalty diagonal and
  // the linear term in the scratch store, the solution in the d slots.
  for (int t = member; t < N; t += GROUP) {
    const Stage st = load_stage(c, f, w, t);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const Active a = active_set(st.x[e], bound(c, f, e));
      w.da(t, e) = a.lh;
      w.lo(t, e) = a.act * c.rho;
      w.hi(t, e) = a.act * (a.lh - c.rho * a.tgt);
    }
  }
  group_sync();
  if (chain) factor_backward<false>(c, f, w, N);
  group_sync();
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      if (chain) affine_backward(c, w, N);
      group_sync();
    }
    if (chain) affine_forward<false>(c, w, N, x0);
    group_sync();
    for (int t = member; t < N; t += GROUP) {
      const Stage st = load_stage(c, f, w, t);
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const Active a = active_set(st.x[e], bound(c, f, e));
        const float lh = st.da[e] + c.rho * a.act * (st.d[e] - a.tgt);
        w.da(t, e) = lh;
        if (pass == 0) w.hi(t, e) = a.act * (lh - c.rho * a.tgt);
      }
    }
    group_sync();
  }

  PHASE(12);
  // ---- polish acceptance and final status -----------------------------------
  float scale_m = 0.0f, pviol = 0.0f;
  bool pfin = true, dual_ok = true;
#pragma unroll
  for (int i = 0; i < NX; ++i) scale_m = nmax(scale_m, fabsf(x0[i]));
  for (int t = member; t < N; t += GROUP) {
    const Stage st = load_stage(c, f, w, t);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const Bound b = bound(c, f, e);
      const Entry& x = st.x[e];
      const float dz = st.d[e];
      scale_m = nmax(scale_m, fabsf(x.z));
      pfin = pfin && isfinite(dz);
      const Active a = active_set(x, b);
      const float lh = st.da[e];
      // the polished multiplier sits on its bound's side of zero
      if (a.act > 0.5f) dual_ok = dual_ok && (a.a_u ? lh >= 0.0f : lh <= 0.0f);
      pviol = nmax(pviol, violation(b, dz));
    }
  }
  scale_m = group_max(scale_m, w.red, member);
  pviol = group_max(pviol, w.red, member);
  pfin = group_all(pfin, w.red, member);
  dual_ok = group_all(dual_ok, w.red, member);
  const float scale = 1.0f + scale_m;
  const float feas_tol = F(1e-4) * scale;
  const bool polish_ok = pfin && (pviol < feas_tol) && (mu_final < F(1e-2) * scale) && dual_ok;
  float prim = 0.0f;
  for (int t = member; t < N; t += GROUP) {
    const Stage st = load_stage(c, f, w, t);
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float z = polish_ok ? st.d[e] : st.x[e].z;
      if (polish_ok) w.z(t, e) = z;
      prim = nmax(prim, violation(bound(c, f, e), z));
      // a state kept in shared memory goes to its output
      if (e < NX && (g.smask >> R_ZX & 1)) g.xs[((size_t)(t + 1) * NX + e) * Bp + lane] = z;
      if (e >= NX && (g.smask >> R_ZU & 1)) g.us[((size_t)t * NU + e - NX) * Bp + lane] = z;
    }
  }
  prim = group_max(prim, w.red, member);
  const bool success = polish_ok ? (prim < feas_tol) && (mu_final < F(1e-4) * scale)
                                 : (mu_final < feas_tol) && (prim < feas_tol);
  PHASE(13);
  if (chain) {
    g.mu[lane] = mu_final;
    g.prim[lane] = prim;
    g.succ[lane] = success ? 1.0f : 0.0f;
    g.it[lane] = (float)it;
    PHASE_ITERATIONS(it);
  }
}

__global__ void __launch_bounds__(MAX_THREADS) stagewise_ip_tile_kernel(const Args g, const Consts c) {
  const int T = blockDim.x / GROUP;
  const int member = threadIdx.x / T, slot = threadIdx.x % T;
  const int lane = blockIdx.x * T + slot;
  const int Bp = g.Bp, N = g.N;

  // place the regions: in the lane's shared block, in its home, or in `work`
  float* const block = lane_blocks + (size_t)slot * lane_floats(g.smask, N);
  int in_block = 0, in_work = 0, offset[N_REGIONS];
  auto place = [&](int r, float* home) {  // called once per region, in region order
    const int n = region_floats(r, N);
    Region v;
    offset[r] = in_block;
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
  Lane<Region> w;
  w.red = place(R_RED, nullptr);
  w.gain = place(R_GAIN, nullptr);
  w.scr = place(R_SCR, nullptr);
  w.dir = place(R_DIR, nullptr);
  w.zx = place(R_ZX, g.xs + (size_t)NX * Bp);  // x_1 ..
  w.zu = place(R_ZU, g.us);
  w.sd = place(R_SD, nullptr);
  // the regions kept in shared memory are addressed as such: by the smask,
  // uniform over the CTA, one of three instantiations of the solve
  constexpr int ALL = (1 << N_REGIONS) - 1;
  constexpr int TRANSIENTS = 1 << R_RED | 1 << R_GAIN | 1 << R_SCR | 1 << R_DIR;
  const auto shared = [&](int r) { return SharedRegion{block + offset[r]}; };
  if ((g.smask & TRANSIENTS) != TRANSIENTS) {
    solve_lane(g, c, w, member, lane);
  } else if (g.smask != ALL) {
    const Lane<SharedRegion> ws = {shared(R_RED), shared(R_GAIN), shared(R_SCR), shared(R_DIR),
                                   w.zx, w.zu, w.sd};
    solve_lane(g, c, ws, member, lane);
  } else {
    const Lane<SharedRegion, SharedRegion> wa = {shared(R_RED), shared(R_GAIN), shared(R_SCR),
                                                 shared(R_DIR), shared(R_ZX), shared(R_ZU),
                                                 shared(R_SD)};
    solve_lane(g, c, wa, member, lane);
  }
}

static int launch_kernel(const Args& g, const Consts& c, int n_tiles, int tile, size_t bytes,
                         cudaStream_t s) {
  auto kernel = stagewise_ip_tile_kernel;
  if (bytes > 48 * 1024) {  // beyond the default, dynamic shared memory is opt-in
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, tile * GROUP, bytes, s>>>(g, c);
  return (int)cudaGetLastError();
}

extern "C" int stagewise_ip_tiles_launch(const float* x0, const float* u0, float* us, float* xs,
                                         float* mu, float* prim, float* succ, float* it,
                                         float* work, const float* consts, const int* flags,
                                         int n_consts, int n_flags, int nx, int nu, int N,
                                         int iters, int tile, int n_tiles, int group, int smask,
                                         void* stream) {
  if (nx != NX || nu != NU || n_consts * sizeof(float) != sizeof(Consts) ||
      n_flags * sizeof(int) != sizeof(Flags) || N < 1 || tile < 1 || n_tiles < 1 ||
      group != GROUP || tile * GROUP > MAX_THREADS || smask < 0 || smask >= 1 << N_REGIONS)
    return (int)cudaErrorInvalidValue;
  Consts c;
  memcpy(&c, consts, sizeof(Consts));
  Args g;
  memcpy(&g.f, flags, sizeof(Flags));
  g.x0 = x0; g.u0 = u0;
  g.us = us; g.xs = xs; g.mu = mu; g.prim = prim; g.succ = succ; g.it = it;
  g.work = work;
  g.N = N; g.iters = iters; g.Bp = tile * n_tiles;
  g.smask = smask;
  const size_t bytes = smask ? (size_t)tile * lane_floats(smask, N) * sizeof(float) : 0;
  return launch_kernel(g, c, n_tiles, tile, bytes, (cudaStream_t)stream);
}

// The group this library was built for, the threads per CTA it allows, and
// a lane's shared-memory floats for a region mask (the wrapper checks its
// own reckoning against them).
extern "C" int stagewise_ip_group() { return GROUP; }
extern "C" int stagewise_ip_max_threads() { return MAX_THREADS; }
extern "C" int stagewise_ip_lane_floats(int smask, int N) { return lane_floats(smask, N); }

extern "C" const char* stagewise_ip_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
