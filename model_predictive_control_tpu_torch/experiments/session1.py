"""Session-1 experiments: finite-horizon LQR on the cruise-control double
integrator (port of ``experiments/session1.py``).

The reference drivers' constants (``session_1/FHC.py:134-151``: Ts = 0.5,
Q = CᵀC + 1e-3·I with C = [1, −2/3], R = [[0.1]], Pf = Q, x0 = [10, 10]):

- :func:`horizon_sweep`: per horizon N, the Riccati recursion, the
  receding-horizon closed loop and the open-loop prediction made at every
  step (short horizons, N = 4, destabilize; long ones converge);
- :func:`cost_to_go_comparison`: the finite-horizon ``x0ᵀ P_N x0`` converges
  to the DARE value ``V∞``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..control.simulate import simulate
from ..models.linear import double_integrator_discrete
from ..ops.riccati import dare_sda, lqr_gain
from ..solvers.lqr import cost_to_go, receding_horizon_policy, solve_finite_horizon
from ..utils.device import resolve_device

DEFAULT_TS = 0.5  # FHC.py:136
DEFAULT_X0 = (10.0, 10.0)  # FHC.py:143


def session1_weights(dtype=torch.float32, device=None):
    """Q = CᵀC + 1e-3·I with C = [1, −2/3]; R = [[0.1]] (FHC.py:139-142)."""
    device = resolve_device(device)
    C = np.array([[1.0, -2.0 / 3.0]])
    Q = torch.as_tensor(C.T @ C + 1e-3 * np.eye(2), dtype=dtype, device=device)
    R = torch.tensor([[0.1]], dtype=dtype, device=device)
    return Q, R


def horizon_sweep(horizons=(4, 6, 10, 20), steps: int = 30, ts: float = DEFAULT_TS,
                  x0=DEFAULT_X0, dtype=torch.float32, device=None):
    """Closed-loop receding-horizon LQR per horizon, with the prediction
    made at each step. Returns ``{N: {"states": (steps+1, 2), "predictions":
    (steps, N+1, 2), "unstable": bool, "cost_to_go": float}}``."""
    device = resolve_device(device)
    sys = double_integrator_discrete(ts, dtype=dtype, device=device)
    Q, R = session1_weights(dtype, device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    results = {}
    for N in horizons:
        sol = solve_finite_horizon(sys, Q, R, Pf=Q, N=N)
        res = simulate(x0, sys, steps=steps, policy=receding_horizon_policy(sol))
        # the open-loop rollout under the time-varying gains K_t from every
        # closed-loop state (FHC.py:85-90), all states at once
        x = res.states[:-1]
        preds = [x]
        for K in sol.K:
            x = sys(x, x @ K.T)
            preds.append(x)
        results[int(N)] = {
            "states": res.states,
            "predictions": torch.stack(preds, dim=1),
            "unstable": bool(res.unstable),
            "cost_to_go": float(cost_to_go(sol, x0)),
        }
    return results


def cost_to_go_comparison(horizons=tuple(range(1, 10)), ts: float = DEFAULT_TS,
                          x0=DEFAULT_X0, dtype=torch.float32, device=None):
    """Finite-horizon ``x0ᵀ P_N x0`` per N and the DARE value ``V∞`` (the
    structure-preserving doubling). Returns ``(horizons, finite_costs,
    v_inf, K_inf)``."""
    device = resolve_device(device)
    sys = double_integrator_discrete(ts, dtype=dtype, device=device)
    Q, R = session1_weights(dtype, device)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    finite = [float(cost_to_go(solve_finite_horizon(sys, Q, R, Pf=Q, N=N), x0))
              for N in horizons]
    P_inf = dare_sda(sys.A, sys.B, Q, R)
    K_inf = lqr_gain(sys.A, sys.B, R, P_inf)
    return list(horizons), finite, float(x0 @ P_inf @ x0), K_inf


def run(outdir: str | None = None, steps: int = 30, device=None) -> dict:
    """The session-1 driver: the sweep and the cost-to-go, plots when
    ``outdir`` is given. Returns a JSON-able summary."""
    sweep = horizon_sweep(steps=steps, device=device)
    hs, finite, v_inf, _ = cost_to_go_comparison(device=device)
    if outdir is not None:
        import os

        from ..viz import plot_cost_to_go_comparison, plot_phase_trajectory

        os.makedirs(outdir, exist_ok=True)
        for N, r in sweep.items():
            plot_phase_trajectory(
                r["states"].cpu().numpy(), predictions=r["predictions"].cpu().numpy(),
                save=os.path.join(outdir, f"session1_phase_N{N}.png"))
        plot_cost_to_go_comparison(hs, finite, v_inf,
                                   save=os.path.join(outdir, "session1_cost_to_go.png"))
    return {
        "unstable_by_horizon": {N: r["unstable"] for N, r in sweep.items()},
        "final_norm_by_horizon": {N: float(torch.linalg.vector_norm(r["states"][-1]))
                                  for N, r in sweep.items()},
        "cost_to_go": dict(zip(hs, finite)),
        "v_inf": v_inf,
    }
