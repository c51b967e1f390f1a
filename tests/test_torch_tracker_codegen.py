"""K3's code generator (``ops/cuda/tracker_codegen.py``) on the CPU.

Every row function of the port (the seven model ODEs of the tracker's hand
instantiations, the constant-parameter kinematic ODE, the gated MHE ODE, the
parking clearance rows), the torch versions of the JAX tests'
``quad_clearance_rows`` and ``keepout_rows``, and one function that uses
every operation of the twin's table:

- the trace replayed in torch equals the row function bit for bit, on
  seeded float32 values, on ``Dual`` tangents (the step Jacobians through
  each integrator) and, for constraint rows, on the nested duals of the
  curvature pass;
- the emitted functor, compiled for the host with ``g++ -ffp-contract=off``
  and a float shim for the ``d*`` helpers, agrees with the torch rows within
  2 ulp (the torch CPU rows divide by a number where the functor multiplies
  by its float32 reciprocal, as torch does on the card). The shim's
  transcendental functions call back into torch, as the host kernel tests'
  do: with glibc's, the Pacejka rows part by up to 40 ulp, the last bits of
  ``atan`` and ``sin`` amplified by cancellation;
- an operation outside the table raises ``NotImplementedError`` while
  tracing, naming it, on the CPU and on the card before any build;
- a generated instantiation of the generalized solver, built for the host
  as ``test_torch_ilqr_factory_host.py`` builds ``csrc/ilqr_factory_ext.cu``
  (a CTA's threads as host threads, the math routed to torch), equals the
  twin bit for bit through the real wrapper.
"""

import contextlib
import ctypes
import functools
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from model_predictive_control_tpu_torch.estimation_nl import _gated_ode_rows
from model_predictive_control_tpu_torch.models.benchmarks import (
    QUADROTOR_PARAMS,
    make_cartpole_ode_rows,
    make_omnibase_ode_rows,
    make_omnibase_param_ode_rows,
    make_planar_quadrotor_ode_rows,
    make_thruster_ode_rows,
)
from model_predictive_control_tpu_torch.models.bicycle import make_kinematic_ode_rows
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
from model_predictive_control_tpu_torch.ops.cuda import tracker_codegen as G
from model_predictive_control_tpu_torch.ops.cuda.ilqr_dyn_kernel import (
    make_pacejka_ode_rows,
    model_tuple,
)
from model_predictive_control_tpu_torch.ops.cuda.parking_factory import (
    make_clearance_rows,
    make_parking_ode_rows,
)

from test_torch_ilqr_kernel_host import _torch_unary

OBS_X, OBS_Z, OBS_R = 0.55, -0.05, 0.3
MATH_CALLBACKS = [_torch_unary(f) for f in (torch.sin, torch.cos, torch.tan, torch.sqrt,
                                            torch.atan, torch.tanh)]
KEEPOUT = (0.45, 0.0, 0.1, 0.25)


def quad_clearance_rows(xr, ur):
    """The JAX tests' disc row (``tests/test_ilqr_factory_constrained.py``)."""
    wx = xr[0] - OBS_X
    wz = xr[1] - OBS_Z
    return (OBS_R * OBS_R - (wx * wx + wz * wz),)


def keepout_rows(xr, ur):
    """The JAX tests' spherical keep-out of the thrust cluster."""
    ox, oy, oz, orad = KEEPOUT
    wx, wy, wz = xr[0] - ox, xr[1] - oy, xr[2] - oz
    return (orad * orad - (wx * wx + wy * wy + wz * wz),)


def all_ops_rows(xr, ur, pr):
    """Every operation of the table: the seven functions, clamp from each
    side, where on each comparison (and a condition's &), + - * / and unary
    -, numbers on either side, and a parameter row on either side (the
    Tensor.add/sub/mul/div swaps of the twin)."""
    x0, x1, x2 = xr
    (u0,) = ur
    (p0,) = pr
    a = torch.sin(x0) * torch.cos(x1) + torch.tan(0.3 * x2)
    b = torch.sqrt(1.0 + x0 * x0) - torch.atan(x1 / 3.0) * torch.tanh(u0)
    c = torch.abs(x2 - 0.1) + torch.clamp(x0, min=-0.5) - torch.clamp(u0, max=0.7)
    d = torch.where(x1 >= 0.0, x1, -x1) + torch.where(x0 < 0.2, 2.0 * x0, x2 * 0.5)
    e = torch.where((x2 > -1.0) & (u0 <= 1.0), 1.5 / (2.0 + x0 * x0), p0)
    f = p0 + x0 - (p0 * u0) / (3.0 + x1 * x1) + p0 / (2.0 + x2 * x2) - 1.0 / p0 * x2
    return (a + b, c - d, e * f - 0.25)


_VP = VehicleParameters()
# name: (row function, nx, n rows in, n params, kind); kind "ode", "gated"
# (additive: the second argument is the exogenous rows) or "rows"
CASES = {
    "kinematic": (make_parking_ode_rows(0.5, 0.1), 4, 2, 2, "ode"),
    "pacejka": (make_pacejka_ode_rows(model_tuple(_VP)), 6, 2, 0, "ode"),
    "cartpole": (make_cartpole_ode_rows(), 4, 1, 0, "ode"),
    "quadrotor": (make_planar_quadrotor_ode_rows(QUADROTOR_PARAMS), 6, 2, 0, "ode"),
    "omnibase": (make_omnibase_ode_rows(), 6, 3, 0, "ode"),
    "omnibase_param": (make_omnibase_param_ode_rows(), 6, 3, 1, "ode"),
    "thruster": (make_thruster_ode_rows(), 6, 4, 0, "ode"),
    "kinematic_const": (make_kinematic_ode_rows(0.5, 0.1, 1.2, 0.3), 4, 2, 0, "ode"),
    "gated_mhe": (_gated_ode_rows(make_kinematic_ode_rows(0.5, 0.1, 1.2, 0.3).rows, 2), 4, 3, 0,
                  "gated"),
    "all_ops": (all_ops_rows, 3, 1, 1, "ode"),
    "clearance": (make_clearance_rows((0.1, 0.0, -0.1), 0.04, ((0.3, 0.1), (0.5, -0.2),
                                                                  (0.0, 0.4))), 4, 2, 0, "rows"),
    "quad_clearance": (quad_clearance_rows, 6, 2, 0, "rows"),
    "keepout": (keepout_rows, 6, 4, 0, "rows"),
}
L = 64  # lanes of the seeded inputs


def _inputs(name, seed=0):
    """Seeded float32 rows (x, u, p) inside each function's domain."""
    fn, nx, nin, n_p, kind = CASES[name]
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    x = [f(rng.uniform(-1.0, 1.0, L)) for _ in range(nx)]
    if name == "pacejka":
        x[3] = f(rng.uniform(0.3, 2.0, L))
        x[3][:4] = torch.tensor([0.0, 0.01, -0.01, -0.5])  # both sides of vx's clamp, ties
    u = [f(rng.uniform(-0.4, 0.4, L)) for _ in range(nin)]
    if kind == "gated":
        u[0] = f(rng.integers(0, 2, L))  # γ ∈ {0, 1}
    p = [f(rng.uniform(0.5, 1.5, L)) for _ in range(n_p)]
    return x, u, p


def _call(fn, x, u, p):
    return tuple(fn(x, u, p) if p else fn(x, u))


def _trace(name):
    fn, nx, nin, n_p, kind = CASES[name]
    return G.trace(fn, nx, nin, n_p, u_kind=G.F if kind == "gated" else G.S)


@pytest.mark.parametrize("name", list(CASES))
def test_replay_equals_rows_bitwise(name):
    """Values, the step Jacobians' tangents and (rows) the curvature pass's
    nested duals: the replayed trace gives the row function's bits."""
    fn, nx, nin, n_p, kind = CASES[name]
    tr = _trace(name)
    x, u, p = _inputs(name)
    rep = lambda xr, ur, pr=(): G.replay(tr, xr, ur, pr)
    for a, b in zip(_call(fn, x, u, p), _call(rep, x, u, p)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    if kind == "ode":
        for integ, sub in (("euler", 1), ("rk4", 2)):
            want = F.step_jacobian(fn, x, u, p or None, ts=0.1, substeps=sub, integrator=integ)
            got = F.step_jacobian(rep, x, u, p or None, ts=0.1, substeps=sub, integrator=integ)
            assert all(torch.equal(a, b) for a, b in zip(want, got))
        return
    NZ = nx + nin
    eye = torch.eye(NZ).reshape(NZ, NZ, 1).expand(NZ, NZ, L)
    if kind == "gated":  # the additive mode differentiates in x only
        xd = [F.Dual(x[i], eye[i][:nx]) for i in range(nx)]
        for a, b in zip(fn(xd, u), rep(xd, u)):
            assert torch.equal(a.v, b.v) and torch.equal(a.d, b.d)
        return
    # order 2: Dual(Dual(z, seed), Dual(e_q, 0)), the twin's curvature pass
    q = 1
    zero = torch.zeros(NZ, L)
    z = x + u
    zh = [F.Dual(F.Dual(z[c], eye[c]), F.Dual(torch.full((L,), float(c == q)), zero))
          for c in range(NZ)]
    for a, b in zip(fn(zh[:nx], zh[nx:]), rep(zh[:nx], zh[nx:])):
        for s, t in ((a.v.v, b.v.v), (a.v.d, b.v.d), (a.d.v, b.d.v), (a.d.d, b.d.d)):
            assert torch.equal(s, t)


SHIM = r"""
#include <math.h>
#define __device__
#define __host__
#define __forceinline__ inline
typedef float (*unary_fn)(float);
static unary_fn host_math[6];
extern "C" void set_host_math(int k, unary_fn f) { host_math[k] = f; }
static inline float dsin(float a) { return host_math[0](a); }
static inline float dcos(float a) { return host_math[1](a); }
static inline float dtan(float a) { return host_math[2](a); }
static inline float dsqrt(float a) { return host_math[3](a); }
static inline float datan(float a) { return host_math[4](a); }
static inline float dtanh(float a) { return host_math[5](a); }
static inline float dabs(float a) { return fabsf(a); }
static inline float dclamp_min(float a, float c) { return a < c ? c : a; }
static inline float dclamp_max(float a, float c) { return a > c ? c : a; }
static inline float dwhere(bool m, float a, float b) { return m ? a : b; }
static inline float val(float a) { return a; }
template <class S> static inline S lift(float c) { return c; }
static inline float rdiv(float c, float a) { return (1.0f / a) * c; }
"""


@pytest.fixture(scope="module")
def host_functors(tmp_path_factory):
    """Every case's emitted functor, built once for the host with g++, an
    ``eval_<name>(x, u, p, out)`` entry each (lanes one by one)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emitted functors for the host")
    parts = [SHIM]
    for name, (fn, nx, nin, n_p, kind) in CASES.items():
        tr = _trace(name)
        struct = "M_" + name
        if kind == "rows":
            parts.append(G.emit_rows(tr, struct, tuple(range(nx))))
        else:
            parts.append(G.emit_model(tr, struct, nx=nx, nu=nin, n_p=n_p,
                                      additive=kind == "gated", n_exo=nin))
        parts.append(f'extern "C" void eval_{name}(const float* x, const float* u, '
                     f"const float* p, float* out) {{ {struct}::rows<float>(x, u, p, nullptr, "
                     "out); }")
    d = tmp_path_factory.mktemp("functors")
    (d / "f.cpp").write_text("\n".join(parts))
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-w",
                    str(d / "f.cpp"), "-o", str(d / "libf.so")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "libf.so"))
    for k, fn in enumerate(MATH_CALLBACKS):
        lib.set_host_math(k, fn)
    return lib


@pytest.mark.parametrize("name", list(CASES))
def test_host_functor_within_two_ulp(host_functors, name):
    fn, nx, nin, n_p, kind = CASES[name]
    x, u, p = _inputs(name, seed=1)
    want = torch.stack([torch.as_tensor(r).expand(L) for r in _call(fn, x, u, p)]).numpy()
    X, U = torch.stack(x).T.contiguous().numpy(), torch.stack(u).T.contiguous().numpy()
    P = torch.stack(p).T.contiguous().numpy() if p else np.zeros((L, 1), np.float32)
    out = np.zeros((L, want.shape[0]), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    entry = getattr(host_functors, f"eval_{name}")
    for k in range(L):
        entry(ptr(X[k]), ptr(U[k]), ptr(P[k]), ptr(out[k]))
    got = out.T
    ulp = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32))
    print(f"{name}: max {ulp.max():.2f} ulp")
    assert np.isfinite(got).all() and ulp.max() <= 2.0


def _exp_rows(xr, ur):
    return (torch.exp(xr[0]),)


@pytest.mark.parametrize("rows, op", [
    (_exp_rows, "exp"),
    (lambda xr, ur: (xr[0] ** 2,), r"\*\*"),
    (lambda xr, ur: (torch.maximum(xr[0], xr[1]),), "maximum"),
    (lambda xr, ur: (xr[0].sin(),), "Tensor.sin"),
    (lambda xr, ur: (torch.clamp(xr[0], -1.0, 1.0),), "one constant bound"),
])
def test_operation_outside_the_table_raises_at_trace_time(rows, op):
    with pytest.raises(NotImplementedError, match=op):
        G.trace(rows, 2, 1)
    with pytest.raises(NotImplementedError, match="control flow"):
        G.trace(lambda xr, ur: (xr[0] if xr[1] > 0 else xr[0],), 2, 1)


def test_operation_outside_the_table_raises_on_the_card_before_a_build(monkeypatch):
    """On CUDA tensors the wrapper traces the rows and raises before any
    library is built or a launch counted."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(F, "_generated_library", lambda *a: pytest.fail("built a library"))
    monkeypatch.setattr(F, "_build_library", lambda *a, **k: pytest.fail("built a library"))
    before = F.LAUNCHES
    with pytest.raises(NotImplementedError, match="exp"):
        F.fused_tracker_solve_cuda(
            torch.zeros(2, 2), torch.zeros(2, 3, 1), None,
            ode_rows=lambda xr, ur: (xr[1], torch.exp(ur[0])), nx=2, nu=1, N=3, ts=0.1,
            substeps=1, limits=((-1.0,), (1.0,)), weights=((1.0, 1.0), (0.1,), 1.0))
    assert F.LAUNCHES == before


# ---------------------------------------------------------------------------
# a generated instantiation of the whole solver, built for the host
# ---------------------------------------------------------------------------


def _host_solver(inst, d):
    """``group -> library``: ``inst``'s translation unit for the host (the
    ext source patched as ``test_torch_ilqr_factory_host.py`` patches it,
    its math routed to torch), built once per group."""
    from test_torch_ilqr_factory_host import GRID, STUB
    from test_torch_ilqr_kernel_host import CALLBACKS, MATH

    src = F._EXT_SOURCES[0].read_text().replace("#include <cuda_runtime.h>", STUB + MATH)
    src, n = re.subn(r"kernel<<<n_tiles, tile \* GROUP, bytes, s>>>\(g, c\)",
                     "host_grid(kernel, n_tiles, tile * GROUP, g, c)", src)
    assert n == 1
    marker = "template <class M, bool RK4>\nstatic int launch_kernel"
    src = src.replace(marker, GRID + "\n" + marker)
    gen = inst.source().replace('#include "ilqr_factory_ext.cu"', src)
    (d / "g.cpp").write_text(gen)

    @functools.lru_cache(maxsize=None)
    def build(group):
        lib = d / f"libg{group}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
             "-w", f"-DTRACKER_GROUP={group}", str(d / "g.cpp"), "-o", str(lib)],
            check=True, capture_output=True)
        lib = ctypes.CDLL(str(lib))
        F._configure(lib)
        for k, fn in enumerate(CALLBACKS):
            lib.set_host_math(k, fn)
        return lib

    return build


QUAD_LIMITS = ((0.0, 0.0), (1.5 * 0.5 * 9.81, 1.5 * 0.5 * 9.81))
QUAD_WEIGHTS = ((5.0, 5.0, 1.0, 0.5, 0.5, 0.1), (0.02, 0.02), 10.0)
X_BOX = ((-2.0, -2.0, -1.0, -1.0), (2.0, 2.0, 1.0, 1.0))
GEN_CASES = {
    # the disc row at order 2, Euler
    "quadrotor_disc_o2": dict(
        ode_rows=make_planar_quadrotor_ode_rows(QUADROTOR_PARAMS), nx=6, nu=2, N=5, ts=0.1,
        substeps=1, integrator="euler", limits=QUAD_LIMITS, weights=QUAD_WEIGHTS,
        extra_constraints=quad_clearance_rows, n_extra=1, extra_deps="x", extra_order=2),
    # nu = 4 (the unrolled Cholesky) with the keep-out on three columns, RK4
    "thruster_keepout": dict(
        ode_rows=make_thruster_ode_rows(), nx=6, nu=4, N=4, ts=0.1, substeps=1,
        integrator="rk4", limits=((0.0,) * 4, (6.0,) * 4),
        weights=((5.0, 5.0, 5.0, 0.5, 0.5, 0.5), (0.02,) * 4, 10.0),
        extra_constraints=keepout_rows, n_extra=1, extra_deps=(0, 1, 2), extra_order=2),
    # the kinematic rows passed bare, under RK4 (no hand instantiation of either)
    "kinematic_bare_rk4": dict(
        ode_rows=make_parking_ode_rows(0.5, 0.1).rows, nx=4, nu=2, N=5, ts=0.1, substeps=2,
        integrator="rk4", limits=((-1.0, -0.5), (1.0, 0.5)),
        weights=((1.0, 1.0, 0.5, 0.1), (0.1, 0.1), 5.0), n_params=2),
    # the first library's kinematic model with a multiplier warm start and a
    # state box: the hand instantiation takes no lam_init
    "kinematic_lam_init": dict(
        ode_rows=make_parking_ode_rows(0.5, 0.1), nx=4, nu=2, N=5, ts=0.1, substeps=1,
        integrator="euler", limits=((-1.0, -0.5), (1.0, 0.5)), state_limits=X_BOX,
        weights=((1.0, 1.0, 0.5, 0.1), (0.1, 0.1), 5.0), n_params=2),
    # a user ODE gated in the additive mode, with terminal rows and Rd per
    # stage: the nonlinear MHE windows' shape
    "gated_user_ode": dict(
        ode_rows=_gated_ode_rows(make_kinematic_ode_rows(0.5, 0.1, 1.2, 0.3).rows, 2), nx=4,
        nu=4, N=4, ts=0.1, substeps=1, integrator="rk4", limits=None, state_limits=X_BOX,
        terminal_state_limits=X_BOX, weights=((1.0, 1.0, 0.0, 0.0), (0.0,) * 4, 1.0),
        input_mode="additive", n_exo=3),
}


def _gen_args(case, B=4, seed=0):
    kw = dict(GEN_CASES[case])
    rng = np.random.default_rng(seed)
    nx, nu, N = kw["nx"], kw["nu"], kw["N"]
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    if nx == 6:
        x0 = f(np.array([1.1, -0.1, 0.0, -0.3, 0.0, 0.0]) + rng.uniform(-0.1, 0.1, (B, 6)))
    else:
        x0 = f(np.array([0.5, -0.2, 0.1, 0.2]) + rng.uniform(-0.1, 0.1, (B, 4)))
    if kw.get("n_params"):
        kw["params"] = f(rng.uniform(0.8, 1.2, (B, 2)))
    if case == "kinematic_lam_init":
        kw["lam_init"] = f(rng.uniform(0, 2, (B, N, 12)) * (rng.uniform(size=(B, N, 12)) < 0.3))
    if kw.get("input_mode") == "additive":
        exo = np.concatenate([np.ones((B, N, 1)), rng.uniform(-0.3, 0.3, (B, N, 2))], -1)
        exo[:, 0, 0] = 0.0  # the identity stage
        kw["exo"] = f(exo)
        kw["input_weights_rt"] = f(rng.uniform(10.0, 100.0, (B, N, 4)))
    return (x0, torch.zeros(B, N, nu), None), kw


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generated_solver_on_the_host_matches_twin_bitwise(case, tmp_path, monkeypatch):
    """The wrapper's generated route, its library built for the host: all
    six outputs equal the twin's bit for bit at group 1 (tile 2), and group
    8 equals group 1."""
    args, kw = _gen_args(case)
    seen = []

    def lib_for(inst, group):
        seen.append(inst.key)
        return build(group)

    x0s = args[0]
    inst = F.generated_instantiation(
        kw["ode_rows"], nx=kw["nx"], nu=kw["nu"], n_params=2 if kw.get("n_params") else 0,
        integrator=kw["integrator"], limits=kw["limits"],
        extra_constraints=kw.get("extra_constraints"), n_extra=kw.get("n_extra", 0),
        extra_deps=F._resolve_deps(kw.get("extra_deps", "xu"), kw["nx"], kw["nu"]),
        extra_order=kw.get("extra_order", 2), input_mode=kw.get("input_mode", "ode"),
        n_exo=kw.get("n_exo", 0), rw="input_weights_rt" in kw,
        terminal_state_limits=kw.get("terminal_state_limits"))
    build = _host_solver(inst, tmp_path)
    monkeypatch.setattr(F, "_generated_library", lib_for)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    solve = lambda group, **extra: F._solve_tiled(
        lambda *a, **k: F._launch(*a, group=group, **k), *args, tile=2, outer_iters=2,
        inner_iters=3, **kw, **extra)
    before = F.LAUNCHES_BY_KERNEL.get(inst.key, 0)
    got = solve(1)
    assert seen == [inst.key] and F.LAUNCHES_BY_KERNEL[inst.key] == before + 1
    ref = F._solve_tiled(F.tracker_tiles_reference, *args, tile=2, outer_iters=2, inner_iters=3,
                         **kw)
    eight = solve(8)
    for name in ("us", "xs", "viol", "converged", "lam", "inner_iters_executed"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert torch.equal(getattr(eight, name), getattr(got, name)), name
    assert x0s.shape[0] == got.us.shape[0]
