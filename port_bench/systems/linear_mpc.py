"""Drives the port's linear MPC through its public entries, as a user's
closed loop does: the episode head sorts the fleet by
``parallel/batch.py::boundary_compaction_key`` and presolves it with
``LinearMPC.presolve_batch_carry``; the loop is
``control/batch_loop.py::simulate_batch`` with
``LinearMPC.batched_policy(backend="cuda")`` and ``problem.system()`` as
the plant. A configuration with a ``chance`` block is the chance-constrained
MPC (``solvers/stochastic.py::make_stochastic_mpc``), whose policy is the
same on its tightened QP.

The configuration's ``solver`` states what is built: ``method`` ``admm``,
``dtype`` ``float32``, ``tf32`` false; anything else is refused.

``solve_entry`` and ``kernel_entries`` name where the traced run puts its
``solve`` span (the solve entry the policy calls) and where it reads the
kernel's executed iterations (K1's launch, and its plain twin on the CPU).
"""

from __future__ import annotations

import torch


class Program:
    def __init__(self, cfg: dict, steps: int, device):
        import model_predictive_control_tpu_torch as port
        from model_predictive_control_tpu_torch.ops.cuda import admm_kernel
        from model_predictive_control_tpu_torch.solvers import linear_mpc

        p, s = cfg["problem"], cfg["solver"]
        stated = (s["method"], s["dtype"], s["tf32"])
        if stated != ("admm", "float32", False):
            raise ValueError(f"the program builds a float32 ADMM with TF32 off, not {stated}")
        self.port, self.steps, self.solver = port, steps, s
        self.problem = linear_mpc.Problem(
            Ts=p["Ts"], Q=tuple(p["Q"]), R=tuple(p["R"]), p_min=p["p_min"], p_max=p["p_max"],
            v_min=p["v_min"], v_max=p["v_max"], u_min=p["u_min"], u_max=p["u_max"], N=p["N"],
        )
        kw = dict(iters=s["iters"], rho=s["rho"], dtype=torch.float32, device=device,
                  terminal=p.get("terminal", "Q"))
        if "chance" in p:
            from model_predictive_control_tpu_torch.solvers.stochastic import make_stochastic_mpc

            chance = make_stochastic_mpc(self.problem, p["chance"]["sigma_w"],
                                         eps=p["chance"]["eps"], **kw)
            self.ctrl = chance.inner
        else:
            self.ctrl = port.make_linear_mpc(self.problem, **kw)
        if torch.backends.cuda.matmul.allow_tf32:
            raise ValueError("TF32 is on: the configuration states float32 products")
        self.plant = self.problem.system(torch.float32, device)
        self.policy = self.ctrl.batched_policy(
            backend="cuda", tile=s["tile"], max_rho_moves=s["max_rho_moves"], polish=s["polish"],
            probe_iters=s["probe_iters"],
        )
        self.solve_entry = (linear_mpc._TILED, "cuda")
        self.kernel_entries = [(admm_kernel, "_launch"), (admm_kernel, "admm_solve_tiles_reference")]

    def head(self, draw: dict):
        """The fleet sorted (each scenario's disturbances follow it) and the
        presolved warm-start carry."""
        x0 = draw["x0"]
        order = torch.argsort(self.port.boundary_compaction_key(self.problem.p_max, x0), stable=True)
        draw = dict(draw, x0=x0[order], w=None if draw["w"] is None else draw["w"][:, order])
        carry = self.ctrl.presolve_batch_carry(draw["x0"], iters_mult=self.solver["presolve_mult"],
                                               backend="cuda", tile=self.solver["tile"])
        return draw, carry

    def episode(self, draw, carry, policy, plant):
        return self.port.simulate_batch(draw["x0"], plant, self.steps, policy, carry,
                                        batched_dynamics=True, disturbances=draw["w"])

    @staticmethod
    def launch_record(args, kwargs, out) -> dict:
        """What the readers need of one K1 launch (or of its twin): its rows,
        the executed iterations of every row (a tensor, read after the
        window), its FP32 operations (a function of those, called after the
        window) and the bytes of its operands and results."""
        from port_bench import counts

        q, l = args[9], args[10]
        n, m, rows = q.shape[1], l.shape[1], q.shape[0]
        ends = torch.tensor(kwargs["chunk_lens"], dtype=torch.float64).cumsum(0)
        iters = out[3]

        def flops() -> float:
            ni = iters.double().cpu()
            checks = torch.searchsorted(ends, ni, right=True).sum()
            return counts.admm_flops(n, m, float(ni.sum()), float(checks), rows)

        nbytes = sum(t.numel() * t.element_size() for t in (*args, *out) if torch.is_tensor(t))
        return {"kernel": "admm", "rows": rows, "iters": iters, "flops": flops, "bytes": nbytes}
