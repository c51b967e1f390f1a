// Fused batched ADMM for the condensed box-QP, one CTA per tile of T
// scenarios, the whole solve in one launch.
//
// Replaces the Pallas TPU kernel _admm_tile_kernel in
// model_predictive_control_tpu/ops/pallas/admm_kernel.py (wrapper
// admm_solve_pallas). Plain twin: admm_solve_tiles_reference in
// model_predictive_control_tpu_torch/ops/cuda/admm_kernel.py.
//
// Work per iteration and scenario: G·W with G = [x | rho z - y] (1 x K) and
// W (K x K), K = n + m: 2 K^2 FP32 FLOPs, all operands in shared memory.
// Then relaxation, clip and dual update on K lanes. What bounds it is the
// shared-memory read of W (one 128-byte row segment per FMA column triple)
// and FMA latency, not device memory: a solve reads q, l, u and the warm
// start once and writes x, z, y once.
//
// Design:
//   - W and Wq of the active rho level sit in shared memory and are reloaded
//     only when rho moves; S and inv(P) replace them for the polish.
//   - A warp owns one scenario row at a time. The row's iterate lives in
//     registers (lane j holds columns j, j+32, ...), G in a per-warp buffer,
//     so an iteration needs only warp barriers.
//   - Block barriers come once per chunk: tile-wide maxima for the rho move,
//     and the all-rows exit test. The CG polish has one per CG iteration for
//     its tile-wide stop.
//   - FP32 with FMA everywhere; no reduced precision.
//
// The chunk schedule is computed on the host and passed in Params.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_CHUNKS 64
#define MAX_LANES 4  // K <= 32 * MAX_LANES
#define WARPS 8
#define BIG 1e19f

struct Params {
  const float *W, *Wq, *A, *P, *Pinv, *S, *rho, *Einv, *Dcinv;
  const float *q, *l, *u, *x0, *y0;
  float *x_out, *z_out, *y_out, *ni_out;
  int chunk_lens[MAX_CHUNKS];
  int n_chunks, probe, max_rho_moves, init_idx, polish, cg_iters;
  int n, m, R, T;
  float eps_abs, alpha;
};

// max that propagates NaN from either side (as jnp.maximum / torch.amax do)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static size_t smem_floats(int n, int m, int T, int polish) {
  const size_t K = n + m;
  size_t f = K * K + n * K                 // W (S), Wq (Pinv)
             + 2 * (size_t)m * n + n * n   // A, At, P
             + (size_t)T * K + (size_t)T * m  // [x | z], y
             + WARPS * 3 * K               // per-warp row buffers
             + 5 * (size_t)T               // scale_u, res0, rs, rs0, ytol
             + WARPS * 8;                  // warp partials
  if (polish) f += 3 * (size_t)T * m;      // CG nu, r, p
  return f;
}

__global__ void __launch_bounds__(32 * WARPS) admm_tile_kernel(const Params p) {
  extern __shared__ float sm[];
  const int n = p.n, m = p.m, K = n + m, T = p.T;
  float* Wb = sm;
  float* Wqb = Wb + K * K;
  float* As = Wqb + n * K;   // A, row-major (m, n)
  float* Ats = As + m * n;   // A transposed, (n, m)
  float* Ps = Ats + n * m;   // P, (n, n)
  float* Cb = Ps + n * n;    // per row [x | z], (T, K)
  float* Yb = Cb + T * K;    // per row y, (T, m)
  float* rowbuf = Yb + T * m;
  float* scale_u = rowbuf + WARPS * 3 * K;
  float* res0 = scale_u + T;
  float* rs_s = res0 + T;
  float* rs0_s = rs_s + T;
  float* ytol_s = rs0_s + T;
  float* part = ytol_s + T;
  float* nu_s = part + WARPS * 8;
  float* r_s = nu_s + T * m;
  float* p_s = r_s + T * m;

  __shared__ int s_idx, s_ci, s_moves, s_conv, s_go;
  __shared__ float s_exec, s_qmax;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;  // min(WARPS, T) warps
  const size_t row0 = (size_t)blockIdx.x * T;
  const float* q = p.q + row0 * n;
  const float* l = p.l + row0 * m;
  const float* u = p.u + row0 * m;
  float* G = rowbuf + warp * 3 * K;
  float* H = G + K;
  float* X = H + K;

  for (int e = tid; e < m * n; e += nthr) {
    const float a = p.A[e];
    As[e] = a;
    Ats[(e % n) * m + e / n] = a;
  }
  for (int e = tid; e < n * n; e += nthr) Ps[e] = p.P[e];

  // rows: x = x0, y = y0, per-row exit scale 1 + max|q * Dcinv|
  float qm = 0.f;
  for (int t = warp; t < T; t += nwarps) {
    const float* qt = q + t * n;
    float sc = 0.f;
    for (int k = lane; k < n; k += 32) {
      Cb[t * K + k] = p.x0[(row0 + t) * n + k];
      sc = nmax(sc, fabsf(qt[k]) * p.Dcinv[k]);
      qm = nmax(qm, fabsf(qt[k]));
    }
    for (int i = lane; i < m; i += 32) Yb[t * m + i] = p.y0[(row0 + t) * m + i];
    sc = warp_max(sc);
    if (lane == 0) scale_u[t] = 1.f + sc;
  }
  qm = warp_max(qm);
  if (lane == 0) part[warp * 8] = qm;
  __syncthreads();
  // z = clip(A x, l, u)
  for (int t = warp; t < T; t += nwarps) {
    for (int i = lane; i < m; i += 32) {
      float a = 0.f;
      for (int k = 0; k < n; ++k) a = fmaf(Cb[t * K + k], Ats[k * m + i], a);
      Cb[t * K + n + i] = fminf(fmaxf(a, l[t * m + i]), u[t * m + i]);
    }
  }
  if (tid == 0) {
    float v = part[0];
    for (int w = 1; w < nwarps; ++w) v = nmax(v, part[w * 8]);
    s_qmax = v;
    s_idx = p.init_idx;
    s_ci = 0;
    s_moves = 0;
    s_conv = 0;
    s_exec = 0.f;
  }
  __syncthreads();

  const float alpha = p.alpha, beta = 1.f - alpha;
  int loaded = -1;
  while (true) {
    const int ci = s_ci, idx = s_idx;
    if (s_conv || ci >= p.n_chunks) break;
    if (idx != loaded) {
      const float* Wsrc = p.W + (size_t)idx * K * K;
      const float* Wqsrc = p.Wq + (size_t)idx * n * K;
      for (int e = tid; e < K * K; e += nthr) Wb[e] = Wsrc[e];
      for (int e = tid; e < n * K; e += nthr) Wqb[e] = Wqsrc[e];
      loaded = idx;
      __syncthreads();
    }
    const float rho = p.rho[idx], inv_rho = 1.f / rho;
    const int L = p.chunk_lens[ci];

    float w_rp = 0.f, w_ax = 0.f, w_z = 0.f, w_rd = 0.f, w_px = 0.f, w_aty = 0.f;
    int w_conv = 1;
    for (int t = warp; t < T; t += nwarps) {
      float* Ct = Cb + t * K;
      float* Yt = Yb + t * m;
      const float* qt = q + t * n;
      const float* lt = l + t * m;
      const float* ut = u + t * m;
      float c[MAX_LANES], yv[MAX_LANES], lo[MAX_LANES], hi[MAX_LANES], xzq[MAX_LANES];
#pragma unroll
      for (int jj = 0; jj < MAX_LANES; ++jj) {
        const int j = lane + 32 * jj;
        c[jj] = yv[jj] = lo[jj] = hi[jj] = xzq[jj] = 0.f;
        if (j < K) {
          c[jj] = Ct[j];
          if (j >= n) {
            yv[jj] = Yt[j - n];
            lo[jj] = lt[j - n];
            hi[jj] = ut[j - n];
          }
          float a = 0.f;
          for (int k = 0; k < n; ++k) a = fmaf(qt[k], Wqb[k * K + j], a);
          xzq[jj] = a;
          G[j] = j < n ? c[jj] : rho * c[jj] - yv[jj];
        }
      }
      __syncwarp();
      for (int it = 0; it < L; ++it) {
        float acc[MAX_LANES];
#pragma unroll
        for (int jj = 0; jj < MAX_LANES; ++jj) acc[jj] = 0.f;
        for (int k = 0; k < K; ++k) {
          const float g = G[k];
          const float* Wk = Wb + k * K + lane;
#pragma unroll
          for (int jj = 0; jj < MAX_LANES; ++jj)
            if (lane + 32 * jj < K) acc[jj] = fmaf(g, Wk[32 * jj], acc[jj]);
        }
        __syncwarp();
#pragma unroll
        for (int jj = 0; jj < MAX_LANES; ++jj) {
          const int j = lane + 32 * jj;
          if (j < K) {
            const float Tj = alpha * (acc[jj] + xzq[jj]) + beta * c[jj];
            if (j < n) {
              c[jj] = Tj;
              G[j] = Tj;
            } else {
              const float cn = fminf(fmaxf(Tj + inv_rho * yv[jj], lo[jj]), hi[jj]);
              yv[jj] = yv[jj] + rho * (Tj - cn);
              c[jj] = cn;
              G[j] = rho * cn - yv[jj];
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int jj = 0; jj < MAX_LANES; ++jj) {
        const int j = lane + 32 * jj;
        if (j < K) {
          Ct[j] = c[jj];
          if (j >= n) Yt[j - n] = yv[jj];
        }
      }
      __syncwarp();

      // residuals of this row: A x - z, P x + q + A^T y
      float rp = 0.f, ax = 0.f, zz = 0.f, rpu = 0.f;
      for (int i = lane; i < m; i += 32) {
        float a = 0.f;
        for (int k = 0; k < n; ++k) a = fmaf(Ct[k], Ats[k * m + i], a);
        const float zi = Ct[n + i];
        const float d = fabsf(a - zi);
        rp = nmax(rp, d);
        ax = nmax(ax, fabsf(a));
        zz = nmax(zz, fabsf(zi));
        rpu = nmax(rpu, d * p.Einv[i]);
      }
      float rd = 0.f, px = 0.f, aty = 0.f, rdu = 0.f;
      for (int j = lane; j < n; j += 32) {
        float a = 0.f, b = 0.f;
        for (int k = 0; k < n; ++k) a = fmaf(Ct[k], Ps[k * n + j], a);
        for (int i = 0; i < m; ++i) b = fmaf(Yt[i], As[i * n + j], b);
        const float d = fabsf(a + qt[j] + b);
        rd = nmax(rd, d);
        px = nmax(px, fabsf(a));
        aty = nmax(aty, fabsf(b));
        rdu = nmax(rdu, d * p.Dcinv[j]);
      }
      rp = warp_max(rp);
      ax = warp_max(ax);
      zz = warp_max(zz);
      rpu = warp_max(rpu);
      rd = warp_max(rd);
      px = warp_max(px);
      aty = warp_max(aty);
      rdu = warp_max(rdu);
      const float sc = scale_u[t];
      w_conv &= (rpu < p.eps_abs * sc) && (rdu < p.eps_abs * sc);
      if (lane == 0) res0[t] = nmax(rp, rd);
      w_rp = nmax(w_rp, rp);
      w_ax = nmax(w_ax, ax);
      w_z = nmax(w_z, zz);
      w_rd = nmax(w_rd, rd);
      w_px = nmax(w_px, px);
      w_aty = nmax(w_aty, aty);
    }
    if (lane == 0) {
      float* pw = part + warp * 8;
      pw[0] = w_rp; pw[1] = w_ax; pw[2] = w_z; pw[3] = w_rd;
      pw[4] = w_px; pw[5] = w_aty; pw[6] = (float)w_conv;
    }
    __syncthreads();
    if (tid == 0) {
      float v[7];
      for (int s = 0; s < 7; ++s) v[s] = part[s];
      for (int w = 1; w < nwarps; ++w) {
        for (int s = 0; s < 6; ++s) v[s] = nmax(v[s], part[w * 8 + s]);
        v[6] = fminf(v[6], part[w * 8 + 6]);
      }
      const bool conv = v[6] > 0.5f;
      // OSQP-style target rho from tile-wide normalized residuals
      const float rp_rel = v[0] / nmax(nmax(v[1], v[2]), 1e-10f);
      const float rd_rel = v[3] / nmax(nmax(v[4], v[5]), nmax(s_qmax, 1e-10f));
      const float target = rho * sqrtf(rp_rel / nmax(rd_rel, 1e-16f));
      const float lt = logf(nmax(target, 1e-12f));
      int cand = 0;
      float best = fabsf(logf(p.rho[0]) - lt);
      for (int r = 1; r < p.R; ++r) {
        const float d = fabsf(logf(p.rho[r]) - lt);
        if (d < best) {
          best = d;
          cand = r;
        }
      }
      const bool is_probe = ci == 0 && p.probe;
      const bool move = (target > 5.f * rho || 5.f * target < rho) && !is_probe &&
                        s_moves < p.max_rho_moves && !conv;
      if (move) {
        s_idx = cand;
        s_moves += 1;
      }
      s_exec += (float)L;
      s_ci = ci + 1;
      s_conv = conv;
    }
    __syncthreads();
  }

  const float executed = s_exec;
  if (!p.polish) {
    for (int t = warp; t < T; t += nwarps) {
      const size_t r = row0 + t;
      for (int k = lane; k < n; k += 32) p.x_out[r * n + k] = Cb[t * K + k];
      for (int i = lane; i < m; i += 32) {
        p.z_out[r * m + i] = Cb[t * K + n + i];
        p.y_out[r * m + i] = Yb[t * m + i];
      }
      if (lane == 0) p.ni_out[r] = executed;
    }
    return;
  }

  // ---- CG active-set polish in scaled space ----
  // M nu = -d∘(b + A P^-1 q),  M v = d∘(S (d∘v)) + (1-d)∘v, per row; the CG
  // stops tile-wide on max(rs / rs0) <= 1e-12 or after cg_iters.
  float* Sb = Wb;      // (m, m)
  float* Pinvb = Wqb;  // (n, n)
  for (int e = tid; e < m * m; e += nthr) Sb[e] = p.S[e];
  for (int e = tid; e < n * n; e += nthr) Pinvb[e] = p.Pinv[e];
  __syncthreads();

  for (int t = warp; t < T; t += nwarps) {
    const float* Yt = Yb + t * m;
    const float* qt = q + t * n;
    float ym = 0.f;
    for (int i = lane; i < m; i += 32) ym = nmax(ym, fabsf(Yt[i]));
    const float ytol = 1e-6f * nmax(warp_max(ym), 1e-6f);
    for (int j = lane; j < n; j += 32) {
      float a = 0.f;
      for (int k = 0; k < n; ++k) a = fmaf(qt[k], Pinvb[k * n + j], a);
      H[j] = a;  // (P^-1 q)_j
    }
    __syncwarp();
    float rsum = 0.f;
    for (int i = lane; i < m; i += 32) {
      float apq = 0.f;
      for (int j = 0; j < n; ++j) apq = fmaf(H[j], Ats[j * m + i], apq);
      const float yi = Yt[i], li = l[t * m + i], ui = u[t * m + i];
      const bool low = yi < -ytol && li > -BIG;
      const bool up = yi > ytol && ui < BIG;
      const float d = (low || up) ? 1.f : 0.f;
      const float b = low ? li : (up ? ui : 0.f);
      const float rhs = -d * (b + apq);
      nu_s[t * m + i] = 0.f;
      r_s[t * m + i] = rhs;
      p_s[t * m + i] = rhs;
      rsum = fmaf(rhs, rhs, rsum);
    }
    rsum = warp_sum(rsum);
    if (lane == 0) {
      rs_s[t] = rsum;
      rs0_s[t] = rsum;
      ytol_s[t] = ytol;
    }
    __syncwarp();
  }

  for (int it = 0; it < p.cg_iters; ++it) {
    float mx = 0.f;
    for (int t = warp; t < T; t += nwarps) mx = nmax(mx, rs_s[t] / fmaxf(rs0_s[t], 1e-30f));
    if (lane == 0) part[warp * 8] = mx;
    __syncthreads();
    if (tid == 0) {
      float v = part[0];
      for (int w = 1; w < nwarps; ++w) v = nmax(v, part[w * 8]);
      s_go = v > 1e-12f;
    }
    __syncthreads();
    if (!s_go) break;
    for (int t = warp; t < T; t += nwarps) {
      const float* Yt = Yb + t * m;
      const float ytol = ytol_s[t];
      float* pt = p_s + t * m;
      float* rt = r_s + t * m;
      float* nut = nu_s + t * m;
      for (int i = lane; i < m; i += 32) {
        const float yi = Yt[i];
        const bool act = (yi < -ytol && l[t * m + i] > -BIG) || (yi > ytol && u[t * m + i] < BIG);
        G[i] = act ? pt[i] : 0.f;  // d∘p
      }
      __syncwarp();
      float pmp = 0.f;
      for (int i = lane; i < m; i += 32) {
        float sv = 0.f;
        for (int k = 0; k < m; ++k) sv = fmaf(G[k], Sb[k * m + i], sv);
        const float yi = Yt[i];
        const bool act = (yi < -ytol && l[t * m + i] > -BIG) || (yi > ytol && u[t * m + i] < BIG);
        const float Mp = act ? sv : pt[i];
        H[i] = Mp;
        pmp = fmaf(pt[i], Mp, pmp);
      }
      pmp = warp_sum(pmp);
      const float rs = rs_s[t];
      const float a = rs / fmaxf(pmp, 1e-30f);
      float rsn = 0.f;
      for (int i = lane; i < m; i += 32) {
        nut[i] = fmaf(a, pt[i], nut[i]);
        const float ri = rt[i] - a * H[i];
        rt[i] = ri;
        rsn = fmaf(ri, ri, rsn);
      }
      rsn = warp_sum(rsn);
      const float bet = rsn / fmaxf(rs, 1e-30f);
      for (int i = lane; i < m; i += 32) pt[i] = rt[i] + bet * pt[i];
      __syncwarp();
      if (lane == 0) rs_s[t] = rsn;
      __syncwarp();
    }
  }

  // candidate (x_p, z_p, y_p); accept per row if finite, dual signs hold and
  // max(primal, dual) residual beats the last chunk's res0
  for (int t = warp; t < T; t += nwarps) {
    const float* Yt = Yb + t * m;
    const float* Ct = Cb + t * K;
    const float* qt = q + t * n;
    const float ytol = ytol_s[t];
    float* ypt = nu_s + t * m;  // y_p = d∘nu, in place
    float* zpt = r_s + t * m;   // z_p
    int sign_bad = 0;
    for (int i = lane; i < m; i += 32) {
      const float yi = Yt[i];
      const bool low = yi < -ytol && l[t * m + i] > -BIG;
      const bool up = yi > ytol && u[t * m + i] < BIG;
      const float yp = (low || up) ? ypt[i] : 0.f;
      ypt[i] = yp;
      sign_bad |= (low && yp > 1e-7f) || (up && yp < -1e-7f);
    }
    __syncwarp();
    for (int j = lane; j < n; j += 32) {
      float b = 0.f;
      for (int i = 0; i < m; ++i) b = fmaf(ypt[i], As[i * n + j], b);
      H[j] = b;           // (A^T y_p)_j
      G[j] = qt[j] + b;   // q + A^T y_p
    }
    __syncwarp();
    for (int j = lane; j < n; j += 32) {
      float a = 0.f;
      for (int k = 0; k < n; ++k) a = fmaf(G[k], Pinvb[k * n + j], a);
      X[j] = -a;  // x_p
    }
    __syncwarp();
    float r1 = 0.f;
    int nonfinite = 0;
    for (int i = lane; i < m; i += 32) {
      float a = 0.f;
      for (int k = 0; k < n; ++k) a = fmaf(X[k], Ats[k * m + i], a);
      nonfinite |= !isfinite(a);
      const float zp = fminf(fmaxf(a, l[t * m + i]), u[t * m + i]);
      zpt[i] = zp;
      r1 = nmax(r1, fabsf(a - zp));
    }
    for (int j = lane; j < n; j += 32) {
      float a = 0.f;
      for (int k = 0; k < n; ++k) a = fmaf(X[k], Ps[k * n + j], a);
      r1 = nmax(r1, fabsf(a + qt[j] + H[j]));
    }
    r1 = warp_max(r1);
    sign_bad = __any_sync(0xffffffffu, sign_bad);
    nonfinite = __any_sync(0xffffffffu, nonfinite);
    const bool accept = r1 < res0[t] && !sign_bad && !nonfinite;
    __syncwarp();
    const size_t r = row0 + t;
    for (int k = lane; k < n; k += 32) p.x_out[r * n + k] = accept ? X[k] : Ct[k];
    for (int i = lane; i < m; i += 32) {
      p.z_out[r * m + i] = accept ? zpt[i] : Ct[n + i];
      p.y_out[r * m + i] = accept ? ypt[i] : Yt[i];
    }
    if (lane == 0) p.ni_out[r] = executed;
    __syncwarp();
  }
}

// Dynamic shared memory one CTA needs, in bytes (the wrapper checks it
// against the card's opt-in limit before launching).
extern "C" long admm_smem_bytes(int n, int m, int T, int polish) {
  return (long)(4 * smem_floats(n, m, T, polish));
}

extern "C" int admm_tiles_launch(
    const float* W, const float* Wq, const float* A, const float* P,
    const float* Pinv, const float* S, const float* rho, const float* Einv,
    const float* Dcinv, const float* q, const float* l, const float* u,
    const float* x0, const float* y0, float* x_out, float* z_out, float* y_out,
    float* ni_out, const int* chunk_lens, int n_chunks, int probe,
    int max_rho_moves, int init_idx, int polish, int cg_iters, int n, int m,
    int R, int T, int n_tiles, float eps_abs, float alpha, void* stream) {
  if (n_chunks < 1 || n_chunks > MAX_CHUNKS || n + m > 32 * MAX_LANES)
    return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)admm_smem_bytes(n, m, T, polish);
  Params p;
  p.W = W; p.Wq = Wq; p.A = A; p.P = P; p.Pinv = Pinv; p.S = S; p.rho = rho;
  p.Einv = Einv; p.Dcinv = Dcinv; p.q = q; p.l = l; p.u = u; p.x0 = x0;
  p.y0 = y0; p.x_out = x_out; p.z_out = z_out; p.y_out = y_out;
  p.ni_out = ni_out;
  for (int c = 0; c < MAX_CHUNKS; ++c) p.chunk_lens[c] = c < n_chunks ? chunk_lens[c] : 0;
  p.n_chunks = n_chunks; p.probe = probe; p.max_rho_moves = max_rho_moves;
  p.init_idx = init_idx; p.polish = polish; p.cg_iters = cg_iters;
  p.n = n; p.m = m; p.R = R; p.T = T; p.eps_abs = eps_abs; p.alpha = alpha;
  cudaError_t e = cudaFuncSetAttribute(
      admm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int threads = 32 * (T < WARPS ? T : WARPS);
  admm_tile_kernel<<<n_tiles, threads, smem_bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* admm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
