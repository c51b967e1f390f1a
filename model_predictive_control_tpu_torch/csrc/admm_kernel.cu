// Fused batched ADMM for the condensed box-QP: persistent CTAs whose groups
// of lanes pull scenario tiles from a queue, the whole solve in one launch.
//
// Replaces the Pallas TPU kernel _admm_tile_kernel in
// model_predictive_control_tpu/ops/pallas/admm_kernel.py (wrapper
// admm_solve_pallas). Plain twin: admm_solve_tiles_reference in
// model_predictive_control_tpu_torch/ops/cuda/admm_kernel.py; the launch is
// planned by launch_plan there.
//
// Work per iteration and scenario: G·W with G = [x | rho z - y] (1 x K) and
// W (K x K), K = n + m: 2 K^2 FP32 operations, then relaxation, clip and
// dual update on the K columns. A solve reads q, l, u and the warm start
// once and writes x, z, y once, so device memory does not bound it. What
// bounds it is the issue of shared-memory loads and FMAs in the product.
// The first version (one warp per scenario row) loaded a 128-byte segment
// of W for every three FMAs and re-read all of W for every row: ~320
// shared-memory wavefronts per scenario-iteration for 200 warp-FMAs.
//
// Design:
//   - Register-blocked product. A half-warp serves 4 rows; lane c of it
//     keeps the 4 x C outputs of columns c, c + 16, ..., c + 16 (C - 1)
//     (C = ceil(K / 16), a library per C; W is staged with its columns
//     zero-padded to 16 C, so the loop has no masks). Per k a lane loads C
//     values of W and the 4 rows' G[k] in one float4 (G is kept k-major)
//     and issues 4 C FMAs:
//     every W element loaded from shared memory feeds 4 rows, and both
//     halves of a warp load the same W addresses. Each output keeps the
//     first version's chain: 0, then fmaf over k ascending, then the same
//     epilogue expressions, so the iterates are that kernel's bit for bit.
//   - A tile (the scenarios that share the exit test, the rho level, the
//     probe and the CG stop) is served by a group: half a warp for up to 4
//     rows, one warp for up to 8, ceil(T / 8) warps beyond. Rows past T in
//     the group's last quad are zero rows that never move, never bind a
//     vote and are not written. Within a quad the iteration syncs only its
//     own lanes (__syncwarp); the chunk end reduces over lanes by shuffles
//     and, for groups of several warps, through a small exchange area
//     between named barriers (bar.sync id, count). There is no
//     __syncthreads after the staging.
//   - One copy of W per CTA serves many tiles. The CTAs are persistent (as
//     many as the occupancy calculator lets the card hold), and each group
//     pulls its next tile from a device counter with atomicAdd, in the
//     order of the wrapper's rows (the compaction sort's). Tiles that exit
//     early free their group for the next one instead of idling a CTA.
//   - The CTA stages W and Wq of the initial rho level, A, A^T and P (and S,
//     P^-1 with the polish) once. A tile whose rho level moves (only the
//     presolve allows moves) reads its level's W and Wq from device memory
//     through the read-only cache (all 7 levels are 224 KB and stay in L2):
//     a second staged level was not built, because the groups of a CTA sit
//     at different levels and phases, and a level per group would cost
//     25.6 KB of shared memory each. Measured on an H100 (chip_smoke.py):
//     the presolve launch (160 iterations, rho moves, CG polish) at 65,536
//     scenarios takes ~9.2 ms, against ~19.4 ms for the first version.
//   - The chunk end deals the residuals A x - z and P x + q + A^T y over
//     the lanes by (row, column), each element's chain as before; maxima
//     use the NaN-propagating nmax, so the exit and rho decisions are the
//     first version's. Every lane computes the rho choice itself.
//   - FP32 with FMA contraction as nvcc's default; no reduced precision.
//
// What bounds it now (H100, K = 80, tile 8): the warm launch at 65,536
// scenarios takes ~0.90 ms (first version 2.46) against a 0.255 ms FP32
// bound. The launch bounds are 256 threads so that a lane's block, the
// loads of the next k in flight and the polish's vectors fit 229
// registers without spills (at 128 registers, 512-thread bounds, ptxas
// spilled and the launch was much slower). A CTA of 8 warps
// takes 120 KB of shared memory (the operator 43 KB, 16 quads of row
// buffers 77 KB), so an SM holds one: 2 warps a scheduler leave the
// loads' latency partly exposed. Both limits come from the register and
// shared-memory footprint, not from the product's issue rate.
//
// Panel mode (LN = 32, a library of its own built with -DADMM_LANES=32), for
// every operator whose staged copy does not fit shared memory (the soft-state
// MPC at N = 20, 30 and 100: n + m = 200, 300 and 1,000; the condensed hard
// box at N = 100: 400). W of one level alone is 160 KB at n + m = 200 and
// 4 MB at 1,000, so it cannot stay in shared memory, and read from L2 by
// every quad of rows at every use it would bound the launch by L2 traffic
// twice over. The design:
//   - Column split. A quad of 4 rows is served by S = ceil(K / 256) warps;
//     lane c of the quad (c < 32 S) keeps columns c, c + 32 S, ...,
//     c + 32 S (C - 1) with C = ceil(K / 32 S) <= MAX_COLS, so the 4 x C
//     block stays in registers at any K. The quad's per-row reductions go
//     through warp shuffles and, for S > 1, the group's exchange area.
//   - Operator staging. One tile group per CTA (threads: 32 S per quad of
//     the tile; CTAs beyond MAX_THREADS take a build with larger launch
//     bounds). W of the tile's current rho level and Wq stream through a
//     two-stage ring of panels (panel_rows rows x all columns) in shared
//     memory, copied with cp.async by all the CTA's threads while the
//     previous panel is consumed: a panel is read from L2 once per CTA and
//     iteration and feeds every quad of the tile. With one tile per CTA the
//     CTA's stream always follows its tile's level, so a moved rho level
//     reads its own panels and no two levels compete for the ring (several
//     tiles a CTA would sit at different levels and phases; occupancy comes
//     from several CTAs per SM instead). launch_plan sizes the panel depth
//     against the quads' row buffers (halving it from 16 down to 1).
//   - A, P, S and P^-1 of the chunk ends and the polish are read through the
//     read-only path (row stride n or m): they run a few times a solve.
//   - Each output element keeps the staged mode's chain: 0, then fmaf over k
//     ascending (the panels are consumed in order), then the same epilogue.
// What bounds it (H100, tile 8, chip_smoke.py): L2 reads. Each W element
// read from L2 feeds the tile's 8 rows, 2-3 TB/s at the measured times: the
// MHE loop's n + m = 200 launch ~3.8-4.0 ms, 12-17% of the FP32 bound at
// n + m = 200 to 1,000 (the wide mode, W from L2 by every quad, 9.06 ms).

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <math.h>
#include <stdint.h>

#define MAX_CHUNKS 64
#define MAX_COLS 8  // columns per lane
#define RB 4        // rows per lane (and per quad of lanes)
#ifndef ADMM_MAX_THREADS
#define ADMM_MAX_THREADS 256
#endif
#define MAX_THREADS ADMM_MAX_THREADS
#define BIG 1e19f

struct Params {
  const float *W, *Wq, *A, *P, *Pinv, *S, *rho, *Einv, *Dcinv;
  const float *q, *l, *u, *x0, *y0;
  float *x_out, *z_out, *y_out, *ni_out;
  int* next_tile;
  int chunk_lens[MAX_CHUNKS];
  int n_chunks, probe, max_rho_moves, init_idx, polish, cg_iters;
  int n, m, R, T, n_tiles, quads_per_tile, tiles_per_cta, warps_per_quad, panel_rows;
  float eps_abs, alpha;
};

// max that propagates NaN from either side (as jnp.maximum / torch.amax do)
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(count) : "memory");
}

// Warps serving a quad of rows: one (a half-warp in the staged mode), or
// ceil(K / (32 MAX_COLS)) in the panel mode.
__host__ __device__ static int warps_per_quad(int n, int m, int lanes) {
  return lanes == 32 ? (n + m + 32 * MAX_COLS - 1) / (32 * MAX_COLS) : 1;
}

// The columns a quad's lanes span, LQ ceil(K / LQ) with LQ = lanes a quad.
__host__ __device__ static size_t padded_cols(int n, int m, int lanes) {
  const size_t lq = (size_t)lanes * warps_per_quad(n, m, lanes);
  return lq * ((n + m + lq - 1) / lq);
}

// Shared memory of one CTA, in floats: the staged operator (the panel ring
// in the panel mode: two stages of panel_rows x the padded columns), then
// per quad of rows G, q, a scratch vector (k-major, 4 rows a float4) and l,
// u; then per tile group an exchange area for two barrier phases and the
// pulled tile index. `lanes` is LN: 16, or 32 in the panel mode.
__host__ __device__ static size_t operator_floats(int n, int m, int polish, int lanes,
                                                  int panel_rows) {
  const size_t K = n + m, Kp = padded_cols(n, m, lanes);
  if (lanes == 32) return 2 * (size_t)panel_rows * Kp;
  size_t f = K * Kp + n * Kp + 2 * (size_t)m * n + (size_t)n * n;
  if (polish) f += (size_t)m * m + (size_t)n * n;
  return (f + 3) & ~(size_t)3;  // the quads' float4 start aligned
}

__host__ __device__ static size_t quad_floats(int n, int m) { return 4 * (2 * (size_t)(n + m) + n + 2 * (size_t)m); }

// half-warp quads: one up to 4 rows, else an even number (whole warps);
// panel-mode quads: one per 4 rows
__host__ __device__ static int quads_per_tile(int T, int lanes) {
  if (lanes == 32) return (T + 3) / 4;
  return T <= 4 ? 1 : 2 * ((T + 7) / 8);
}

__host__ __device__ static int warps_per_group(int qpg, int lanes, int wpq) {
  if (lanes == 32) return qpg * wpq;
  return qpg > 2 ? qpg / 2 : 1;
}

static size_t smem_floats(int n, int m, int T, int polish, int tiles_per_cta, int lanes,
                          int panel_rows) {
  const int qpg = quads_per_tile(T, lanes);
  return operator_floats(n, m, polish, lanes, panel_rows) +
         (size_t)tiles_per_cta * qpg * quad_floats(n, m) +
         (size_t)tiles_per_cta * (2 * warps_per_group(qpg, lanes, warps_per_quad(n, m, lanes)) * 8 + 2);
}

// The lanes of one tile group, as one lane sees them.
struct Group {
  unsigned mask;  // lanes of this warp that sync and shuffle together
  int qpg, gid, warps, nthr, first;  // quads, index in the CTA, warps, threads, first lane's tid
  int wpq;        // warps a quad (the panel mode's column split; 1 otherwise)
  float* xch;     // exchange area: 2 phases x warps x 8
  int* slot;      // 2 pulled-tile slots
  int phase;
};

// The lanes of a quad meet: a half-warp or warp; the whole group where a
// quad spans several warps (its quads move in step).
__device__ __forceinline__ void quad_sync(const Group& g) {
  if (g.wpq > 1)
    named_sync(1 + g.gid, g.nthr);
  else
    __syncwarp(g.mask);
}

// Per-row reduction over the lanes of a quad, V values at once (V <= 8):
// sums (SUM) or NaN-propagating maxima; every lane of the quad gets the
// result. Within a warp by shuffles; across a quad's warps through the
// exchange area, combined in warp order.
template <bool SUM, int V, int LN>
__device__ __forceinline__ void quad_reduce(Group& g, float* v) {
#pragma unroll
  for (int s = 0; s < V; ++s) {
#pragma unroll
    for (int o = LN / 2; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(g.mask, v[s], o);
      v[s] = SUM ? v[s] + w : nmax(v[s], w);
    }
  }
  if (g.wpq > 1) {
    const int lane = threadIdx.x & 31, wig = ((int)threadIdx.x - g.first) >> 5;
    const int w0 = wig - wig % g.wpq;  // the quad's first warp in the group
    float* x = g.xch + (g.phase & 1) * g.warps * 8;
    if (lane == 0)
      for (int s = 0; s < V; ++s) x[wig * 8 + s] = v[s];
    named_sync(1 + g.gid, g.nthr);
    for (int s = 0; s < V; ++s) {
      float r = x[w0 * 8 + s];
      for (int w = 1; w < g.wpq; ++w) r = SUM ? r + x[(w0 + w) * 8 + s] : nmax(r, x[(w0 + w) * 8 + s]);
      v[s] = r;
    }
    g.phase += 1;
  }
}

// Tile-wide reduction of V lane values: nmax for the first NM, fminf for
// the rest; every lane of the group gets the result.
template <int V, int NM, int LN>
__device__ __forceinline__ void group_reduce(Group& g, float* v) {
#pragma unroll
  for (int s = 0; s < V; ++s) {
#pragma unroll
    for (int o = LN / 2; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(g.mask, v[s], o);
      v[s] = s < NM ? nmax(v[s], w) : fminf(v[s], w);
    }
    if (LN == 16 && g.qpg >= 2) {
      const float w = __shfl_xor_sync(0xffffffffu, v[s], 16);
      v[s] = s < NM ? nmax(v[s], w) : fminf(v[s], w);
    }
  }
  if (g.warps > 1) {
    const int lane = threadIdx.x & 31, wig = ((int)threadIdx.x - g.first) >> 5;
    float* x = g.xch + (g.phase & 1) * g.warps * 8;
    if (lane == 0)
      for (int s = 0; s < V; ++s) x[wig * 8 + s] = v[s];
    named_sync(1 + g.gid, g.nthr);
    for (int s = 0; s < V; ++s) {
      float r = x[s];
      for (int w = 1; w < g.warps; ++w) r = s < NM ? nmax(r, x[w * 8 + s]) : fminf(r, x[w * 8 + s]);
      v[s] = r;
    }
    g.phase += 1;
  }
}

// The group's next tile from the queue.
template <int LN>
__device__ __forceinline__ int pull_tile(Group& g, int* next_tile) {
  const int lane = threadIdx.x & 31;
  if (g.warps > 1) {
    int* s = g.slot + (g.phase & 1);
    if ((int)threadIdx.x == g.first) *s = atomicAdd(next_tile, 1);
    named_sync(1 + g.gid, g.nthr);
    g.phase += 1;
    return *s;
  }
  const int src = LN == 16 && g.qpg == 1 ? (lane & 16) : 0;
  int t = 0;
  if (lane == src) t = atomicAdd(next_tile, 1);
  return __shfl_sync(g.mask, t, src);
}

// The panel mode's ring: two stages of `rows` rows x Kp columns in shared
// memory, filled from a (., K) matrix in device memory (row stride K) by all
// the CTA's threads, 16 bytes a copy where K and the operands allow, else 4.
struct Ring {
  float* buf;
  int rows, Kp, K;
  int units, row0, rstep, col, cstep;  // this thread's copies: rows row0 + i rstep, units col + j cstep
  bool vec;
};

__device__ __forceinline__ Ring make_ring(float* buf, int rows, int Kp, int K, bool vec, int tid,
                                          int nthr) {
  Ring r;
  r.buf = buf; r.rows = rows; r.Kp = Kp; r.K = K; r.vec = vec;
  r.units = vec ? K >> 2 : K;
  if (nthr >= r.units) {  // several rows a pass; threads past the last whole row idle
    r.rstep = nthr / r.units;
    r.row0 = tid / r.units;
    r.col = tid - r.row0 * r.units;
    r.cstep = r.units;
    if (r.row0 >= r.rstep) r.row0 = 1 << 30;
  } else {
    r.rstep = 1; r.row0 = 0; r.col = tid; r.cstep = nthr;
  }
  return r;
}

// Start copying rows [k0, k0 + rows) of M into `stage` (one commit group).
__device__ __forceinline__ void ring_load(const Ring& r, float* stage, const float* M, int k0,
                                          int rows) {
  for (int kk = r.row0; kk < rows; kk += r.rstep) {
    const float* src = M + (size_t)(k0 + kk) * r.K;
    float* dst = stage + kk * r.Kp;
    if (r.vec) {
      for (int c = r.col; c < r.units; c += r.cstep) __pipeline_memcpy_async(dst + 4 * c, src + 4 * c, 16);
    } else {
      for (int c = r.col; c < r.units; c += r.cstep) __pipeline_memcpy_async(dst + c, src + c, 4);
    }
  }
  __pipeline_commit();
}

// acc[r][jj] += sum over k < rows_total of V[k].r M[k][col0 + LQ jj], k
// ascending, with M streamed through the ring one panel ahead of its use.
// Every thread of the CTA calls it (it holds CTA barriers); it leaves the
// ring free.
template <int C>
__device__ __forceinline__ void panel_product(const Ring& r, const float* M, int rows_total,
                                              const float4* V, int col0, int LQ,
                                              float (&acc)[RB][C]) {
  const int np = (rows_total + r.rows - 1) / r.rows, stage_floats = r.rows * r.Kp;
  ring_load(r, r.buf, M, 0, min(r.rows, rows_total));
  for (int pi = 0; pi < np; ++pi) {
    const int k0 = pi * r.rows, rows = min(r.rows, rows_total - k0);
    if (pi + 1 < np) {
      // the other stage was last read before the previous panel's closing barrier
      ring_load(r, r.buf + ((pi + 1) & 1) * stage_floats, M, k0 + r.rows,
                min(r.rows, rows_total - k0 - r.rows));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // every thread's copies of this panel have landed
    const float* st = r.buf + (pi & 1) * stage_floats + col0;
#pragma unroll 4
    for (int kk = 0; kk < rows; ++kk) {
      const float4 gk = V[k0 + kk];
      float w[C];
#pragma unroll
      for (int jj = 0; jj < C; ++jj) w[jj] = st[kk * r.Kp + LQ * jj];
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        acc[0][jj] = fmaf(gk.x, w[jj], acc[0][jj]);
        acc[1][jj] = fmaf(gk.y, w[jj], acc[1][jj]);
        acc[2][jj] = fmaf(gk.z, w[jj], acc[2][jj]);
        acc[3][jj] = fmaf(gk.w, w[jj], acc[3][jj]);
      }
    }
    __syncthreads();  // every thread is past its reads of this stage
  }
}

// Where a chunk's product reads W: the staged copy (row stride LN C), device
// memory through the read-only path (a moved rho level of the staged mode,
// row stride K), or the panel ring (the panel mode).
enum { FROM_STAGED, FROM_GLOBAL, FROM_PANELS };

// One chunk's L iterations on a lane's 4 x C block (columns col0 + LQ jj).
template <int C, int SRC, int LN>
__device__ __forceinline__ void iterate(const Group& g, const Ring& ring, int L, int K, int n,
                                        const float* Wsrc, const float4* LO, const float4* HI,
                                        const float4* XZQ, float4* G4, int col0, int LQ,
                                        float rho, float inv_rho, float alpha, float beta,
                                        float (&c)[RB][C], float (&yv)[RB][C]) {
  const int Kp = LQ * C;
  for (int it = 0; it < L; ++it) {
    float acc[RB][C];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int jj = 0; jj < C; ++jj) acc[r][jj] = 0.f;
    if (SRC == FROM_PANELS) {
      panel_product<C>(ring, Wsrc, K, G4, col0, LQ, acc);
    } else {
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 gk = G4[k];
        float w[C];
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {
          const int j = col0 + LQ * jj;
          if (SRC == FROM_GLOBAL)
            w[jj] = j < K ? __ldg(Wsrc + (size_t)k * K + j) : 0.f;
          else
            w[jj] = Wsrc[k * Kp + j];
        }
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {
          acc[0][jj] = fmaf(gk.x, w[jj], acc[0][jj]);
          acc[1][jj] = fmaf(gk.y, w[jj], acc[1][jj]);
          acc[2][jj] = fmaf(gk.z, w[jj], acc[2][jj]);
          acc[3][jj] = fmaf(gk.w, w[jj], acc[3][jj]);
        }
      }
    }
    quad_sync(g);
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
      if (j >= K) continue;
      float gn[RB];
      const float4 xq4 = XZQ[j];
      const float xzq[RB] = {xq4.x, xq4.y, xq4.z, xq4.w};
      if (j < n) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float Tj = alpha * (acc[r][jj] + xzq[r]) + beta * c[r][jj];
          c[r][jj] = Tj;
          gn[r] = Tj;
        }
      } else {
        const float4 lo4 = LO[j - n], hi4 = HI[j - n];
        const float lo[RB] = {lo4.x, lo4.y, lo4.z, lo4.w}, hi[RB] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float Tj = alpha * (acc[r][jj] + xzq[r]) + beta * c[r][jj];
          const float cn = fminf(fmaxf(Tj + inv_rho * yv[r][jj], lo[r]), hi[r]);
          yv[r][jj] = yv[r][jj] + rho * (Tj - cn);
          c[r][jj] = cn;
          gn[r] = rho * cn - yv[r][jj];
        }
      }
      G4[j] = make_float4(gn[0], gn[1], gn[2], gn[3]);
    }
    quad_sync(g);
  }
}


template <int C, int LN>
__global__ void __launch_bounds__(MAX_THREADS) admm_tile_kernel(const Params p) {
  extern __shared__ float sm[];
  constexpr bool PANEL = LN == 32;  // the operator streamed through panels
  const int n = p.n, m = p.m, K = n + m, T = p.T;
  const int wpq = PANEL ? p.warps_per_quad : 1, LQ = LN * wpq, Kp = LQ * C;
  float* Wb = sm;             // (K, Kp) W of the initial level, zero-padded columns
  float* Wqb = Wb + K * Kp;   // (n, Kp)
  float* As = Wqb + n * Kp;   // A, row-major (m, n)
  float* Ats = As + m * n;    // A transposed, (n, m)
  float* Ps = Ats + n * m;    // P, (n, n)
  float* Sb = Ps + n * n;     // S (m, m), with the polish
  float* Pinvb = Sb + m * m;  // P^-1 (n, n), with the polish
  // the operator's elements: the staged copies, or device memory in the
  // panel mode (A^T read as A with its indices swapped)
  auto a_at = [&](int i, int j) { return PANEL ? __ldg(p.A + i * n + j) : As[i * n + j]; };
  auto at_at = [&](int k, int i) { return PANEL ? __ldg(p.A + i * n + k) : Ats[k * m + i]; };
  auto p_at = [&](int k, int j) { return PANEL ? __ldg(p.P + k * n + j) : Ps[k * n + j]; };
  auto s_at = [&](int k, int i) { return PANEL ? __ldg(p.S + k * m + i) : Sb[k * m + i]; };
  auto pinv_at = [&](int k, int j) { return PANEL ? __ldg(p.Pinv + k * n + j) : Pinvb[k * n + j]; };
  const int qpg = p.quads_per_tile, wpg = warps_per_group(qpg, LN, wpq);
  float* quad_base = sm + operator_floats(n, m, p.polish, LN, p.panel_rows);
  float* xch_base = quad_base + (size_t)p.tiles_per_cta * qpg * quad_floats(n, m);
  int* slot_base = (int*)(xch_base + (size_t)p.tiles_per_cta * 2 * wpg * 8);

  const int tid = threadIdx.x, nthr = blockDim.x;
  // the panel mode streams whole rows in 16-byte copies where every row
  // start is 16-byte aligned
  const bool vec = (K & 3) == 0 && (((uintptr_t)p.W | (uintptr_t)p.Wq) & 15) == 0;
  const Ring ring = make_ring(sm, p.panel_rows, Kp, K, vec, tid, nthr);
  if (PANEL) {
    // the padded columns K..Kp-1 of both stages stay zero (copies write 0..K-1)
    for (int e = tid; e < 2 * p.panel_rows * Kp; e += nthr) sm[e] = 0.f;
  } else {
    const float* Wsrc = p.W + (size_t)p.init_idx * K * K;
    const float* Wqsrc = p.Wq + (size_t)p.init_idx * n * K;
    for (int e = tid; e < K * Kp; e += nthr) {
      const int k = e / Kp, j = e - k * Kp;
      Wb[e] = j < K ? Wsrc[k * K + j] : 0.f;
    }
    for (int e = tid; e < n * Kp; e += nthr) {
      const int k = e / Kp, j = e - k * Kp;
      Wqb[e] = j < K ? Wqsrc[k * K + j] : 0.f;
    }
    for (int e = tid; e < m * n; e += nthr) {
      const float a = p.A[e];
      As[e] = a;
      Ats[(e % n) * m + e / n] = a;
    }
    for (int e = tid; e < n * n; e += nthr) Ps[e] = p.P[e];
    if (p.polish) {
      for (int e = tid; e < m * m; e += nthr) Sb[e] = p.S[e];
      for (int e = tid; e < n * n; e += nthr) Pinvb[e] = p.Pinv[e];
    }
  }
  __syncthreads();

  // this lane's quad of rows in the CTA and its first column: half-warp
  // quads in the staged mode; quads of wpq warps, warp-major, in the panel mode
  const int lane = tid & 31, warp = tid >> 5, half = lane >> 4;
  const int quad = PANEL ? warp / wpq : 2 * warp + half;
  const int col0 = PANEL ? (warp - quad * wpq) * 32 + lane : lane & 15;
  Group g;
  g.qpg = qpg;
  g.gid = quad / qpg;
  g.warps = wpg;
  g.nthr = 32 * wpg;
  g.wpq = wpq;
  g.first = !PANEL && qpg == 1 ? (tid & ~15) : g.gid * g.nthr;
  g.mask = !PANEL && qpg == 1 ? 0xffffu << (16 * half) : 0xffffffffu;
  g.xch = xch_base + g.gid * 2 * wpg * 8;
  g.slot = slot_base + 2 * g.gid;
  g.phase = 0;
  const int row0 = 4 * (quad % qpg);  // the quad's first row in the tile
  float4* G4 = (float4*)(quad_base + (size_t)quad * quad_floats(n, m));  // (K) [x | rho z - y]
  float4* Q4 = G4 + K;    // (n) q
  float4* S4 = Q4 + n;    // (K) scratch: q Wq in a chunk, y at its end; the polish's vectors
  float4* LO = S4 + K;    // (m) l
  float4* HI = LO + m;    // (m) u
  const float alpha = p.alpha, beta = 1.f - alpha;

  for (;;) {
    const int tile = pull_tile<LN>(g, p.next_tile);
    if (tile >= p.n_tiles) break;
    const size_t rbase = (size_t)tile * T + row0;  // global index of the quad's row 0
    bool valid[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) valid[r] = row0 + r < T;
    quad_sync(g);  // the last tile's reads of the quad's buffers are done

    // the rows' q, l, u and warm start (zero rows past T); per-row exit
    // scale 1 + max|q * Dcinv|; tile max |q|
    float sc[RB], qm = 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) sc[r] = 0.f;
    for (int k = col0; k < n; k += LQ) {
      float qv[RB], xv[RB];
      const float dc = p.Dcinv[k];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        qv[r] = valid[r] ? p.q[(rbase + r) * n + k] : 0.f;
        xv[r] = valid[r] ? p.x0[(rbase + r) * n + k] : 0.f;
        sc[r] = nmax(sc[r], fabsf(qv[r]) * dc);
        qm = nmax(qm, fabsf(qv[r]));
      }
      Q4[k] = make_float4(qv[0], qv[1], qv[2], qv[3]);
      G4[k] = make_float4(xv[0], xv[1], xv[2], xv[3]);
    }
    for (int i = col0; i < m; i += LQ) {
      float lv[RB], uv[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        lv[r] = valid[r] ? p.l[(rbase + r) * m + i] : 0.f;
        uv[r] = valid[r] ? p.u[(rbase + r) * m + i] : 0.f;
      }
      LO[i] = make_float4(lv[0], lv[1], lv[2], lv[3]);
      HI[i] = make_float4(uv[0], uv[1], uv[2], uv[3]);
    }
    quad_reduce<false, RB, LN>(g, sc);
#pragma unroll
    for (int r = 0; r < RB; ++r) sc[r] = 1.f + sc[r];
    {
      float v[1] = {qm};
      group_reduce<1, 1, LN>(g, v);
      qm = v[0];
    }
    quad_sync(g);

    // the lane's block: x = x0, z = clip(A x0, l, u), y = y0
    float c[RB][C], yv[RB][C];
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
#pragma unroll
      for (int r = 0; r < RB; ++r) c[r][jj] = yv[r][jj] = 0.f;
      if (j >= K) continue;
      if (j < n) {
        const float4 x4 = G4[j];
        c[0][jj] = x4.x; c[1][jj] = x4.y; c[2][jj] = x4.z; c[3][jj] = x4.w;
      } else {
        const int i = j - n;
        float a[RB] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < n; ++k) {
          const float4 x4 = G4[k];
          const float w = at_at(k, i);
          a[0] = fmaf(x4.x, w, a[0]); a[1] = fmaf(x4.y, w, a[1]);
          a[2] = fmaf(x4.z, w, a[2]); a[3] = fmaf(x4.w, w, a[3]);
        }
        const float4 lo4 = LO[i], hi4 = HI[i];
        const float lo[RB] = {lo4.x, lo4.y, lo4.z, lo4.w}, hi[RB] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          c[r][jj] = fminf(fmaxf(a[r], lo[r]), hi[r]);
          yv[r][jj] = valid[r] ? p.y0[(rbase + r) * m + i] : 0.f;
        }
      }
    }

    int idx = p.init_idx, moves = 0;
    float executed = 0.f, res0[RB];
    for (int ci = 0; ci < p.n_chunks; ++ci) {
      const float rho = p.rho[idx], inv_rho = 1.f / rho;
      const int L = p.chunk_lens[ci];
      const bool staged = !PANEL && idx == p.init_idx;
      const float* Wqg = p.Wq + (size_t)idx * n * K;
      // q Wq of this level into the scratch vector, and G = [x | rho z - y]
      quad_sync(g);  // every lane is past its reads of G and of the scratch vector
      if (PANEL) {
        float xzq[RB][C];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int jj = 0; jj < C; ++jj) xzq[r][jj] = 0.f;
        panel_product<C>(ring, Wqg, n, Q4, col0, LQ, xzq);
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {
          const int j = col0 + LQ * jj;
          if (j < K) S4[j] = make_float4(xzq[0][jj], xzq[1][jj], xzq[2][jj], xzq[3][jj]);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {
          const int j = col0 + LQ * jj;
          float xzq[RB] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < n; ++k) {
            const float4 q4 = Q4[k];
            const float w = staged ? Wqb[k * Kp + j] : (j < K ? __ldg(Wqg + (size_t)k * K + j) : 0.f);
            xzq[0] = fmaf(q4.x, w, xzq[0]); xzq[1] = fmaf(q4.y, w, xzq[1]);
            xzq[2] = fmaf(q4.z, w, xzq[2]); xzq[3] = fmaf(q4.w, w, xzq[3]);
          }
          if (j < K) S4[j] = make_float4(xzq[0], xzq[1], xzq[2], xzq[3]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const int j = col0 + LQ * jj;
        if (j >= K) continue;
        float gv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) gv[r] = j < n ? c[r][jj] : rho * c[r][jj] - yv[r][jj];
        G4[j] = make_float4(gv[0], gv[1], gv[2], gv[3]);
      }
      quad_sync(g);
      const float* Wlevel = p.W + (size_t)idx * K * K;
      if (PANEL)
        iterate<C, FROM_PANELS, LN>(g, ring, L, K, n, Wlevel, LO, HI, S4, G4, col0, LQ, rho, inv_rho,
                                    alpha, beta, c, yv);
      else if (staged)
        iterate<C, FROM_STAGED, LN>(g, ring, L, K, n, Wb, LO, HI, S4, G4, col0, LQ, rho, inv_rho,
                                    alpha, beta, c, yv);
      else
        iterate<C, FROM_GLOBAL, LN>(g, ring, L, K, n, Wlevel, LO, HI, S4, G4, col0, LQ, rho,
                                    inv_rho, alpha, beta, c, yv);

      // residuals A x - z (z columns) and P x + q + A^T y (x columns), dealt
      // by (row, column); G holds x in its first n entries. y goes into the
      // scratch vector (q Wq is spent): every lane is past its reads of it
      // (the iteration ends with a sync)
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const int j = col0 + LQ * jj;
        if (j >= n && j < K) S4[j - n] = make_float4(yv[0][jj], yv[1][jj], yv[2][jj], yv[3][jj]);
      }
      quad_sync(g);
      // tile maxima rp, |Ax|, |z|, rd, |Px|, |A^T y|, and the exit vote
      float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
      float rowres[RB] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const int j = col0 + LQ * jj;
        if (j >= K) continue;
        if (j < n) {
          float a[RB] = {0.f, 0.f, 0.f, 0.f}, b[RB] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < n; ++k) {
            const float4 x4 = G4[k];
            const float w = p_at(k, j);
            a[0] = fmaf(x4.x, w, a[0]); a[1] = fmaf(x4.y, w, a[1]);
            a[2] = fmaf(x4.z, w, a[2]); a[3] = fmaf(x4.w, w, a[3]);
          }
          for (int i = 0; i < m; ++i) {
            const float4 y4 = S4[i];
            const float w = a_at(i, j);
            b[0] = fmaf(y4.x, w, b[0]); b[1] = fmaf(y4.y, w, b[1]);
            b[2] = fmaf(y4.z, w, b[2]); b[3] = fmaf(y4.w, w, b[3]);
          }
          const float4 q4 = Q4[j];
          const float qv[RB] = {q4.x, q4.y, q4.z, q4.w};
          const float dc = p.Dcinv[j];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float d = fabsf(a[r] + qv[r] + b[r]);
            v[3] = nmax(v[3], d);
            v[4] = nmax(v[4], fabsf(a[r]));
            v[5] = nmax(v[5], fabsf(b[r]));
            if (!(d * dc < p.eps_abs * sc[r])) v[6] = 0.f;
            rowres[r] = nmax(rowres[r], d);
          }
        } else {
          const int i = j - n;
          float a[RB] = {0.f, 0.f, 0.f, 0.f};
          for (int k = 0; k < n; ++k) {
            const float4 x4 = G4[k];
            const float w = at_at(k, i);
            a[0] = fmaf(x4.x, w, a[0]); a[1] = fmaf(x4.y, w, a[1]);
            a[2] = fmaf(x4.z, w, a[2]); a[3] = fmaf(x4.w, w, a[3]);
          }
          const float ei = p.Einv[i];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float zi = c[r][jj];
            const float d = fabsf(a[r] - zi);
            v[0] = nmax(v[0], d);
            v[1] = nmax(v[1], fabsf(a[r]));
            v[2] = nmax(v[2], fabsf(zi));
            if (!(d * ei < p.eps_abs * sc[r])) v[6] = 0.f;
            rowres[r] = nmax(rowres[r], d);
          }
        }
      }
      if (p.polish) {
        quad_reduce<false, RB, LN>(g, rowres);
#pragma unroll
        for (int r = 0; r < RB; ++r) res0[r] = rowres[r];
      }
      group_reduce<7, 6, LN>(g, v);
      const bool conv = v[6] > 0.5f;
      // OSQP-style target rho from tile-wide normalized residuals
      const float rp_rel = v[0] / nmax(nmax(v[1], v[2]), 1e-10f);
      const float rd_rel = v[3] / nmax(nmax(v[4], v[5]), nmax(qm, 1e-10f));
      const float target = rho * sqrtf(rp_rel / nmax(rd_rel, 1e-16f));
      const bool is_probe = ci == 0 && p.probe;
      const bool move = (target > 5.f * rho || 5.f * target < rho) && !is_probe &&
                        moves < p.max_rho_moves && !conv;
      if (move) {
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
        idx = cand;
        moves += 1;
      }
      executed += (float)L;
      if (conv) break;
    }

    // the ADMM iterate out (the polish overwrites the rows it improves)
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
      if (j >= K) continue;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (!valid[r]) continue;
        if (j < n) {
          p.x_out[(rbase + r) * n + j] = c[r][jj];
        } else {
          p.z_out[(rbase + r) * m + j - n] = c[r][jj];
          p.y_out[(rbase + r) * m + j - n] = yv[r][jj];
        }
      }
    }
    if (col0 < RB && valid[col0]) p.ni_out[rbase + col0] = executed;
    if (!p.polish) continue;

    // ---- CG active-set polish in scaled space ----
    // M nu = -d∘(b + A P^-1 q),  M v = d∘(S (d∘v)) + (1-d)∘v, per row; the
    // CG stops tile-wide on max(rs / rs0) <= 1e-12 or after cg_iters. The
    // lane keeps nu, r and p of its z columns; d and the bound sides as
    // bit masks.
    float ytol[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float ym = 0.f;
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const int j = col0 + LQ * jj;
        if (j >= n && j < K) ym = nmax(ym, fabsf(yv[r][jj]));
      }
      ytol[r] = ym;
    }
    quad_reduce<false, RB, LN>(g, ytol);
#pragma unroll
    for (int r = 0; r < RB; ++r) ytol[r] = 1e-6f * nmax(ytol[r], 1e-6f);
    unsigned low = 0, up = 0;  // bit r * C + jj
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
      if (j < n || j >= K) continue;
      const float4 lo4 = LO[j - n], hi4 = HI[j - n];
      const float lo[RB] = {lo4.x, lo4.y, lo4.z, lo4.w}, hi[RB] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (yv[r][jj] < -ytol[r] && lo[r] > -BIG) low |= 1u << (r * C + jj);
        if (yv[r][jj] > ytol[r] && hi[r] < BIG) up |= 1u << (r * C + jj);
      }
    }
    const unsigned act = low | up;
    // (P^-1 q) into the scratch vector
    quad_sync(g);  // every lane is past its reads of y there
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
      if (j >= n) continue;
      float a[RB] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float4 q4 = Q4[k];
        const float w = pinv_at(k, j);
        a[0] = fmaf(q4.x, w, a[0]); a[1] = fmaf(q4.y, w, a[1]);
        a[2] = fmaf(q4.z, w, a[2]); a[3] = fmaf(q4.w, w, a[3]);
      }
      S4[j] = make_float4(a[0], a[1], a[2], a[3]);
    }
    quad_sync(g);
    float nu[RB][C], rr[RB][C], pp[RB][C], rs[RB], rs0[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) rs[r] = 0.f;
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
#pragma unroll
      for (int r = 0; r < RB; ++r) nu[r][jj] = rr[r][jj] = pp[r][jj] = 0.f;
      if (j < n || j >= K) continue;
      const int i = j - n;
      float apq[RB] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float4 h4 = S4[k];
        const float w = at_at(k, i);
        apq[0] = fmaf(h4.x, w, apq[0]); apq[1] = fmaf(h4.y, w, apq[1]);
        apq[2] = fmaf(h4.z, w, apq[2]); apq[3] = fmaf(h4.w, w, apq[3]);
      }
      const float4 lo4 = LO[i], hi4 = HI[i];
      const float lo[RB] = {lo4.x, lo4.y, lo4.z, lo4.w}, hi[RB] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const unsigned bit = 1u << (r * C + jj);
        const float d = (act & bit) ? 1.f : 0.f;
        const float b = (low & bit) ? lo[r] : ((up & bit) ? hi[r] : 0.f);
        const float rhs = -d * (b + apq[r]);
        rr[r][jj] = pp[r][jj] = rhs;
        rs[r] = fmaf(rhs, rhs, rs[r]);
      }
    }
    quad_reduce<true, RB, LN>(g, rs);
#pragma unroll
    for (int r = 0; r < RB; ++r) rs0[r] = rs[r];

    for (int it = 0; it < p.cg_iters; ++it) {
      float v[1] = {0.f};
#pragma unroll
      for (int r = 0; r < RB; ++r) v[0] = nmax(v[0], rs[r] / fmaxf(rs0[r], 1e-30f));
      group_reduce<1, 1, LN>(g, v);
      if (!(v[0] > 1e-12f)) break;
      quad_sync(g);  // the last pass's reads of G are done
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const int j = col0 + LQ * jj;
        if (j < n || j >= K) continue;
        float dp[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) dp[r] = (act >> (r * C + jj) & 1u) ? pp[r][jj] : 0.f;
        G4[j - n] = make_float4(dp[0], dp[1], dp[2], dp[3]);  // d∘p
      }
      quad_sync(g);
      float Mp[RB][C], pmp[RB] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const int j = col0 + LQ * jj;
#pragma unroll
        for (int r = 0; r < RB; ++r) Mp[r][jj] = 0.f;
        if (j < n || j >= K) continue;
        const int i = j - n;
        float sv[RB] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < m; ++k) {
          const float4 d4 = G4[k];
          const float w = s_at(k, i);
          sv[0] = fmaf(d4.x, w, sv[0]); sv[1] = fmaf(d4.y, w, sv[1]);
          sv[2] = fmaf(d4.z, w, sv[2]); sv[3] = fmaf(d4.w, w, sv[3]);
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          Mp[r][jj] = (act >> (r * C + jj) & 1u) ? sv[r] : pp[r][jj];
          pmp[r] = fmaf(pp[r][jj], Mp[r][jj], pmp[r]);
        }
      }
      quad_reduce<true, RB, LN>(g, pmp);
      float a[RB], rsn[RB] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < RB; ++r) a[r] = rs[r] / fmaxf(pmp[r], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          nu[r][jj] = fmaf(a[r], pp[r][jj], nu[r][jj]);
          rr[r][jj] = rr[r][jj] - a[r] * Mp[r][jj];
          rsn[r] = fmaf(rr[r][jj], rr[r][jj], rsn[r]);
        }
      }
      quad_reduce<true, RB, LN>(g, rsn);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float bet = rsn[r] / fmaxf(rs[r], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < C; ++jj) pp[r][jj] = rr[r][jj] + bet * pp[r][jj];
        rs[r] = rsn[r];
      }
    }

    // candidate (x_p, z_p, y_p); accept per row if finite, dual signs hold
    // and max(primal, dual) residual beats the last chunk's res0
    float bad[RB] = {0.f, 0.f, 0.f, 0.f};  // row r's signs or finiteness fail
    quad_sync(g);      // the CG's reads of G and of the scratch are done
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
      if (j < n || j >= K) continue;
      float yp[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const unsigned bit = 1u << (r * C + jj);
        yp[r] = (act & bit) ? nu[r][jj] : 0.f;
        nu[r][jj] = yp[r];
        if (((low & bit) && yp[r] > 1e-7f) || ((up & bit) && yp[r] < -1e-7f)) bad[r] = 1.f;
      }
      S4[j - n] = make_float4(yp[0], yp[1], yp[2], yp[3]);  // y_p
    }
    quad_sync(g);
    float hx[RB][C];  // (A^T y_p)_j, then x_p on the x columns
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
#pragma unroll
      for (int r = 0; r < RB; ++r) hx[r][jj] = 0.f;
      if (j >= n) continue;
      float b[RB] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < m; ++i) {
        const float4 y4 = S4[i];
        const float w = a_at(i, j);
        b[0] = fmaf(y4.x, w, b[0]); b[1] = fmaf(y4.y, w, b[1]);
        b[2] = fmaf(y4.z, w, b[2]); b[3] = fmaf(y4.w, w, b[3]);
      }
      const float4 q4 = Q4[j];
      G4[j] = make_float4(q4.x + b[0], q4.y + b[1], q4.z + b[2], q4.w + b[3]);  // q + A^T y_p
#pragma unroll
      for (int r = 0; r < RB; ++r) hx[r][jj] = b[r];
    }
    quad_sync(g);
    float xp[RB][C];
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
#pragma unroll
      for (int r = 0; r < RB; ++r) xp[r][jj] = 0.f;
      if (j >= n) continue;
      float a[RB] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float4 g4 = G4[k];
        const float w = pinv_at(k, j);
        a[0] = fmaf(g4.x, w, a[0]); a[1] = fmaf(g4.y, w, a[1]);
        a[2] = fmaf(g4.z, w, a[2]); a[3] = fmaf(g4.w, w, a[3]);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) xp[r][jj] = -a[r];
    }
    quad_sync(g);  // y_p's reads of the scratch are done
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
      if (j < n) S4[j] = make_float4(xp[0][jj], xp[1][jj], xp[2][jj], xp[3][jj]);  // x_p
    }
    quad_sync(g);
    float r1[2 * RB] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, zp[RB][C];  // residual, then bad
#pragma unroll
    for (int jj = 0; jj < C; ++jj) {
      const int j = col0 + LQ * jj;
#pragma unroll
      for (int r = 0; r < RB; ++r) zp[r][jj] = 0.f;
      if (j >= K) continue;
      float a[RB] = {0.f, 0.f, 0.f, 0.f};
      if (j < n) {
        for (int k = 0; k < n; ++k) {
          const float4 x4 = S4[k];
          const float w = p_at(k, j);
          a[0] = fmaf(x4.x, w, a[0]); a[1] = fmaf(x4.y, w, a[1]);
          a[2] = fmaf(x4.z, w, a[2]); a[3] = fmaf(x4.w, w, a[3]);
        }
        const float4 q4 = Q4[j];
        const float qv[RB] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int r = 0; r < RB; ++r) r1[r] = nmax(r1[r], fabsf(a[r] + qv[r] + hx[r][jj]));
      } else {
        const int i = j - n;
        for (int k = 0; k < n; ++k) {
          const float4 x4 = S4[k];
          const float w = at_at(k, i);
          a[0] = fmaf(x4.x, w, a[0]); a[1] = fmaf(x4.y, w, a[1]);
          a[2] = fmaf(x4.z, w, a[2]); a[3] = fmaf(x4.w, w, a[3]);
        }
        const float4 lo4 = LO[i], hi4 = HI[i];
        const float lo[RB] = {lo4.x, lo4.y, lo4.z, lo4.w}, hi[RB] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (!isfinite(a[r])) bad[r] = 1.f;
          zp[r][jj] = fminf(fmaxf(a[r], lo[r]), hi[r]);
          r1[r] = nmax(r1[r], fabsf(a[r] - zp[r][jj]));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) r1[RB + r] = bad[r];
    quad_reduce<false, 2 * RB, LN>(g, r1);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const bool accept = r1[r] < res0[r] && !(r1[RB + r] > 0.5f);
      if (!accept || !valid[r]) continue;
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        const int j = col0 + LQ * jj;
        if (j >= K) continue;
        if (j < n) {
          p.x_out[(rbase + r) * n + j] = xp[r][jj];
        } else {
          p.z_out[(rbase + r) * m + j - n] = zp[r][jj];
          p.y_out[(rbase + r) * m + j - n] = nu[r][jj];
        }
      }
    }
  }
}

typedef void (*kernel_fn)(const Params);

// One library per column count and mode: built with -DADMM_COLS=C and
// -DADMM_LANES=LN (16, or 32 for the panel mode), it serves the operators
// whose lanes a quad LQ (16, or 32 ceil(K / 256)) give C = ceil(K / LQ);
// -DADMM_MAX_THREADS sets its launch bounds (256, or 1024 for the panel
// mode's CTAs beyond 256 threads).
#ifndef ADMM_COLS
#define ADMM_COLS 5
#endif
#ifndef ADMM_LANES
#define ADMM_LANES 16
#endif
static_assert(ADMM_COLS >= 1 && ADMM_COLS <= MAX_COLS, "ADMM_COLS out of range");
static_assert(ADMM_LANES == 16 || ADMM_LANES == 32, "ADMM_LANES is 16 or 32");

static kernel_fn kernel_for(int n, int m) {
  const int lq = ADMM_LANES * warps_per_quad(n, m, ADMM_LANES);
  return (n + m + lq - 1) / lq == ADMM_COLS ? admm_tile_kernel<ADMM_COLS, ADMM_LANES> : nullptr;
}

// Dynamic shared memory one CTA needs, in bytes, for `lanes` lanes a quad
// and panel_rows rows a panel (launch_plan reckons the same; a test holds
// the two together).
extern "C" long admm_smem_bytes(int n, int m, int T, int polish, int tiles_per_cta, int lanes,
                                int panel_rows) {
  return (long)(4 * smem_floats(n, m, T, polish, tiles_per_cta, lanes, panel_rows));
}

// CTAs of `threads` threads and `smem` bytes the card holds per SM, and its
// SM count; returns a CUDA error code.
extern "C" int admm_occupancy(int n, int m, int threads, long smem, int* ctas_per_sm, int* sms) {
  kernel_fn kernel = kernel_for(n, m);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

extern "C" int admm_tiles_launch(
    const float* W, const float* Wq, const float* A, const float* P,
    const float* Pinv, const float* S, const float* rho, const float* Einv,
    const float* Dcinv, const float* q, const float* l, const float* u,
    const float* x0, const float* y0, float* x_out, float* z_out, float* y_out,
    float* ni_out, int* next_tile, const int* chunk_lens, int n_chunks, int probe,
    int max_rho_moves, int init_idx, int polish, int cg_iters, int n, int m,
    int R, int T, int n_tiles, int tiles_per_cta, int panel_rows, int threads, int grid,
    float eps_abs, float alpha, void* stream) {
  kernel_fn kernel = kernel_for(n, m);
  const int qpg = quads_per_tile(T, ADMM_LANES), wpq = warps_per_quad(n, m, ADMM_LANES);
  const int wpg = warps_per_group(qpg, ADMM_LANES, wpq);
  const bool panel = ADMM_LANES == 32;
  if (n_chunks < 1 || n_chunks > MAX_CHUNKS || kernel == nullptr || threads > MAX_THREADS ||
      threads != tiles_per_cta * (panel ? 32 * wpg : 16 * qpg) || threads % 32 != 0 ||
      (wpg > 1 && tiles_per_cta > 15) || (panel && (tiles_per_cta != 1 || panel_rows < 1)) ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const int smem_bytes = (int)admm_smem_bytes(n, m, T, polish, tiles_per_cta, ADMM_LANES, panel_rows);
  Params p;
  p.W = W; p.Wq = Wq; p.A = A; p.P = P; p.Pinv = Pinv; p.S = S; p.rho = rho;
  p.Einv = Einv; p.Dcinv = Dcinv; p.q = q; p.l = l; p.u = u; p.x0 = x0;
  p.y0 = y0; p.x_out = x_out; p.z_out = z_out; p.y_out = y_out;
  p.ni_out = ni_out; p.next_tile = next_tile;
  for (int c = 0; c < MAX_CHUNKS; ++c) p.chunk_lens[c] = c < n_chunks ? chunk_lens[c] : 0;
  p.n_chunks = n_chunks; p.probe = probe; p.max_rho_moves = max_rho_moves;
  p.init_idx = init_idx; p.polish = polish; p.cg_iters = cg_iters;
  p.n = n; p.m = m; p.R = R; p.T = T; p.n_tiles = n_tiles;
  p.quads_per_tile = qpg; p.tiles_per_cta = tiles_per_cta;
  p.warps_per_quad = wpq; p.panel_rows = panel ? panel_rows : 0;
  p.eps_abs = eps_abs; p.alpha = alpha;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* admm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
