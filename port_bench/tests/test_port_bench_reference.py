"""The plain reference against the port's CPU twin: the same QP worked out
again from the configuration, the interior point at its optimum, the judge
passing the port's closed loop on a tiny fleet, and TF32's rounding."""

import time

import pytest
import torch

import model_predictive_control_tpu_torch as port
from port_bench import harness
from port_bench.reference import linear_mpc as ref

CFG = harness.find_cell("cruise_n20.fleet128k").config


@pytest.mark.parametrize("N", [3, 20])
def test_reference_qp_is_the_ports_qp(N):
    """The reference's cost and rows, worked out from the configuration, are
    the port's condensed QP (its cost is twice the reference's)."""
    cfg = dict(CFG, problem=dict(CFG["problem"], N=N))
    p = cfg["problem"]
    problem = port.make_linear_mpc(
        port.session2_problem(N=N), iters=80, rho=0.035, dtype=torch.float64, device="cpu")
    prob = ref.Problem(cfg)
    qp = problem.qp
    assert p["Ts"] == 0.3 and tuple(p["Q"]) == (10.0, 1.0) and tuple(p["R"]) == (0.01,)
    torch.testing.assert_close(qp.P, 2.0 * prob.H, rtol=1e-12, atol=1e-9)
    x0 = torch.tensor([[-100.0, 12.0], [-25.0, -3.0]], dtype=torch.float64)
    q, l, u = qp.qp_vectors(x0)
    f, h = prob.vectors(x0)
    torch.testing.assert_close(q, 2.0 * f, rtol=1e-12, atol=1e-9)
    n = prob.n
    # G z <= h stacks z <= u_box, -z <= -l_box, Γz <= x_ub - Φx0, -Γz <= -(x_lb - Φx0)
    torch.testing.assert_close(prob.G[:n], qp.A_c[:n])
    torch.testing.assert_close(prob.G[2 * n:2 * n + qp.A_c.shape[0] - n], qp.A_c[n:])
    torch.testing.assert_close(h[:, :n], u[:, :n])
    torch.testing.assert_close(h[:, n:2 * n], -l[:, :n])
    m_st = qp.A_c.shape[0] - n
    torch.testing.assert_close(h[:, 2 * n:2 * n + m_st], u[:, n:])
    torch.testing.assert_close(h[:, 2 * n + m_st:], -l[:, n:])


def test_reference_chance_qp_is_the_ports_tightened_qp():
    """With the chance block and the DARE terminal, the reference's QP
    (worked out again from the configuration) is the port's stochastic MPC's
    tightened QP."""
    from model_predictive_control_tpu_torch.solvers.stochastic import make_stochastic_mpc

    cfg = harness.find_cell("cruise_n20_chance.stochastic64k").config
    p = cfg["problem"]
    assert p["terminal"] == "dare" and p["chance"] == {"sigma_w": [0.0, 0.0144], "eps": 0.1}
    qp = make_stochastic_mpc(port.session2_problem(N=p["N"]), p["chance"]["sigma_w"],
                             eps=p["chance"]["eps"], iters=200, rho=0.01, dtype=torch.float64,
                             device="cpu").inner.qp
    prob = ref.Problem(cfg)
    torch.testing.assert_close(qp.P, 2.0 * prob.H, rtol=1e-9, atol=1e-7)
    x0 = torch.tensor([[-100.0, 12.0], [-75.0, 19.5]], dtype=torch.float64)
    q, l, u = qp.qp_vectors(x0)
    f, h = prob.vectors(x0)
    torch.testing.assert_close(q, 2.0 * f, rtol=1e-9, atol=1e-7)
    n, m_st = prob.n, qp.A_c.shape[0] - prob.n
    torch.testing.assert_close(h[:, :n], u[:, :n])
    torch.testing.assert_close(h[:, n:2 * n], -l[:, :n])
    torch.testing.assert_close(h[:, 2 * n:2 * n + m_st], u[:, n:])
    torch.testing.assert_close(h[:, 2 * n + m_st:], -l[:, n:])
    # the tightening is there: the first input's box is whole, v_max's is not
    assert h[0, 0] == p["u_max"] and h[0, 2 * n + 1] < p["v_max"] - 0.1


def test_interior_point_reaches_the_optimum():
    prob = ref.Problem(CFG)
    x0 = torch.tensor([[-140.0, 24.0], [-20.0, 23.0], [-60.0, -15.0], [0.0, 0.0]],
                      dtype=torch.float64)
    f, h = prob.vectors(x0)
    z, rd, viol, comp = ref.ipm(prob.H, f, prob.G, h)
    scale = 1.0 + f.abs().amax(1)
    assert (rd < 1e-9 * scale).all() and (viol < 1e-9).all() and (comp < 1e-9 * scale).all()
    # no feasible point nearby does better
    cost = lambda v: 0.5 * ((v @ prob.H) * v).sum(1) + (f * v).sum(1)
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        v = z + 1e-2 * torch.randn(z.shape, generator=g, dtype=z.dtype)
        feasible = ((v @ prob.G.T) <= h).all(1)
        assert (cost(v)[feasible] >= cost(z)[feasible] - 1e-9).all()
    assert torch.allclose(z[3], torch.zeros_like(z[3]), atol=1e-8)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-13, 1.0 + 2.0**-12, -3.0 - 2.0**-12])
    assert ref.tf32(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -3.0]


@pytest.mark.parametrize("workload", ["cruise_n20.fleet128k", "cruise_n20_chance.stochastic64k"])
def test_port_twin_passes_the_judge_on_a_tiny_fleet(workload):
    """The port's CPU twin through the whole run: correct, every reading
    under its limit and a number."""
    result, info = harness.run_cell(workload, 20261018, 1.0, False, "cpu", time.perf_counter(),
                                    mix_override={"scenarios": 96, "steps": 12})
    assert result["correct"], result["checks"]
    assert info["readings"]["judged"] > 0 and info["readings"]["unjudged"] == 0
    assert result["attempted"] > 0 and 0 <= result["failed"] < result["attempted"]
