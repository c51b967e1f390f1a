"""The port's public surface against the JAX package's.

(a) Every public top-level name of the JAX package, and every public name
each of its modules defines, resolves on the port's counterpart module.
(b) For each module pair, the parameter names of JAX's functions, classes
and public methods are a subset of the port's counterparts'. (c) Every
``mpc.<name>`` of ``docs/MIGRATION.md`` resolves on the port. The written
:data:`ALLOWLIST` holds what the port leaves out, each with its reason: TPU
workarounds (and the pytree registration JAX's transformations need), and
:data:`RENAMES` the names the port spells otherwise. (d) Each item this
surface gained holds against JAX on seeded inputs: ``LinearSystem``'s output
map (mirroring ``tests/test_lqr.py::test_output_equation``), the bicycle
callables, ``euler_fine`` and ``get_integrator``, ``qp_setup``'s
``equilibrate`` and ``setup_admm``, ``step_jacobian_pattern`` on the
kinematic bicycle and the five benchmark models, and ``weak_scaling``'s
``devices``.
"""

import ast
import importlib
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_predictive_control_tpu as mpc
import model_predictive_control_tpu_torch as port

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "model_predictive_control_tpu"
PORT_PKG = "model_predictive_control_tpu_torch"

# What the port leaves out, by (JAX module relative to the package, name);
# the name "*" stands for the whole module.
ALLOWLIST = {
    ("", "matan"): "a polynomial atan for Mosaic, which has no atan lowering; CUDA has atanf",
    ("ops.pallas.ilqr_factory", "matan"): "as above",
    ("ops.pallas.ilqr_dyn_kernel", "NZ"): "the jvp basis-pack width, sized to the VPU's 8 sublanes",
    ("obs.roofline", "MXU_BF16_PEAK"): "a TPU MXU peak; the port's roofline holds the H100's",
    ("obs.roofline", "MXU_TILE"): "the TPU MXU tile",
    ("obs.roofline", "VPU_F32_PEAK"): "a TPU VPU peak",
    ("obs.roofline", "KernelRoofline.mxu_flops_issued"): "MXU work with its emulation passes",
    ("obs.roofline", "KernelRoofline.bound"): "MXU or VPU; the port's is derived from the "
                                              "H100's peaks (a property)",
    ("utils.precision", "solver_precision"): "raises TPU matmuls from their bf16 passes to "
                                             "HIGHEST; the port turns TF32 off once "
                                             "(set_solver_precision)",
    ("utils.pytree", "*"): "registers dataclasses as JAX pytrees; the port's are plain "
                           "dataclasses",
}
# parameters the port never takes, whatever the function
ALLOWED_PARAMS = {
    "interpret": "Pallas's interpret mode (the kernel emulated on the CPU); the port's "
                 "wrappers run their plain twin on CPU tensors",
}
RENAMES = {
    "fused_tracker_solve": "fused_tracker_solve_cuda",  # the kernel's entry; twin on CPU
}
PARAM_RENAMES = {"key": "generator"}  # a JAX PRNG key is a torch.Generator


def _rel(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT / JAX_PKG).with_suffix("")
    parts = [p for p in rel.parts if p != "__init__"]
    return ".".join(parts)


JAX_MODULES = sorted(_rel(p) for p in (ROOT / JAX_PKG).rglob("*.py"))


def _port_module(rel: str) -> str:
    for old, new in (("ops.pallas", "ops.cuda"),
                     ("experimental.riccati_ip_kernel", "ops.cuda.riccati_ip_kernel"),
                     ("experimental", "ops.cuda")):
        if rel == old or rel.startswith(old + "."):
            rel = new + rel[len(old):]
            break
    return PORT_PKG + ("." + rel if rel else "")


def _port_name(name: str, rel: str) -> str:
    """The port's name in the counterpart module (the package root binds
    JAX's names as they are)."""
    if not rel:
        return name
    if name in RENAMES:
        return RENAMES[name]
    return name[: -len("_pallas")] + "_cuda" if name.endswith("_pallas") else name


def _defined_names(rel: str) -> list[str]:
    """Public names the JAX module's source binds: its defs, classes and
    assignments, and for the package root its imports too."""
    path = ROOT / JAX_PKG / pathlib.Path(*rel.split(".")) if rel else ROOT / JAX_PKG
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif isinstance(node, ast.ImportFrom) and not rel and node.level:
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


def _allowed(rel: str, name: str) -> bool:
    return (rel, name) in ALLOWLIST or (rel, "*") in ALLOWLIST


def test_allowlist_entries_exist_in_jax():
    """Every entry names something the JAX package has, and says why."""
    for (rel, name), reason in ALLOWLIST.items():
        assert reason
        mod = importlib.import_module(JAX_PKG + ("." + rel if rel else ""))
        if name == "*":
            continue
        owner, _, field = name.partition(".")
        assert hasattr(mod, owner), (rel, name)
        if field:
            assert field in getattr(mod, owner).__dataclass_fields__, (rel, name)


def test_top_level_names_resolve():
    """(a) the package root: every public name JAX's ``__init__`` binds."""
    missing = [n for n in _defined_names("") if not _allowed("", n)
               and not hasattr(port, n)]
    assert not missing, missing
    assert port.fused_tracker_solve is port.ops.cuda.ilqr_factory.fused_tracker_solve_cuda


@pytest.mark.parametrize("rel", [r for r in JAX_MODULES if r])
def test_module_names_resolve(rel):
    """(a) each module: every public name it defines, on the port's module."""
    if _allowed(rel, "*"):
        return
    pmod = importlib.import_module(_port_module(rel))
    missing = [n for n in _defined_names(rel) if not _allowed(rel, n)
               and not hasattr(pmod, _port_name(n, rel))]
    assert not missing, (rel, missing)


def _params(obj) -> list[str] | None:
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _missing_params(rel, label, jobj, pobj) -> list[str]:
    want, have = _params(jobj), _params(pobj)
    if want is None or have is None:
        return []
    return [f"{label}({p})" for p in want
            if PARAM_RENAMES.get(p, p) not in have and p not in ALLOWED_PARAMS
            and not _allowed(rel, f"{label}.{p}")]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_parameters_are_a_subset(rel):
    """(b) JAX's parameter names ⊆ the port's, for the module's functions,
    classes and the classes' public methods."""
    if _allowed(rel, "*"):
        return
    jmod = importlib.import_module(JAX_PKG + ("." + rel if rel else ""))
    pmod = importlib.import_module(_port_module(rel))
    missing = []
    for name in _defined_names(rel):
        jobj, pobj = getattr(jmod, name, None), getattr(pmod, _port_name(name, rel), None)
        if _allowed(rel, name) or not callable(jobj) or pobj is None:
            continue
        missing += _missing_params(rel, name, jobj, pobj)
        if inspect.isclass(jobj):
            for meth, jm in vars(jobj).items():
                if not meth.startswith("_") and callable(jm) and hasattr(pobj, meth):
                    missing += _missing_params(rel, f"{name}.{meth}", jm, getattr(pobj, meth))
    assert not missing, (rel, missing)


def test_migration_names_resolve():
    """(c) the names ``docs/MIGRATION.md`` tells a user to reach as
    ``mpc.<name>``."""
    names = sorted(set(re.findall(r"mpc\.([A-Za-z_]\w*)", (ROOT / "docs" / "MIGRATION.md")
                                  .read_text())))
    assert len(names) >= 25
    assert [n for n in names if not hasattr(port, n)] == []


# ---------------------------------------------------------------------------
# (d) parity of the new items
# ---------------------------------------------------------------------------


def test_linear_system_output_equation():
    """``tests/test_lqr.py::test_output_equation`` on row vectors: y = Cx + Du,
    identity when unset, dynamics unchanged by ``with_output``."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    base = port.LinearSystem(A=t(np.eye(2)), B=t([[0.0], [1.0]]))
    sys_ = base.with_output(C=t([[1.0, 0.0]]), D=t([[2.0]]))
    x, u = t([[3.0, -1.0]]), t([[0.5]])
    np.testing.assert_allclose(sys_.output(x, u).numpy(), [[4.0]])
    np.testing.assert_allclose(sys_.output(x).numpy(), [[3.0]])
    np.testing.assert_allclose(base.output(x).numpy(), x.numpy())
    np.testing.assert_allclose(sys_(x, u).numpy(), base(x, u).numpy())
    assert sys_.D.dtype == torch.float64 and base.C is None and base.D is None


def test_linear_system_output_matches_jax_on_seeded_rows():
    rng = np.random.default_rng(0)
    A, B = rng.normal(size=(3, 3)), rng.normal(size=(3, 2))
    C, D = rng.normal(size=(2, 3)), rng.normal(size=(2, 2))
    xs, us = rng.normal(size=(5, 3)), rng.normal(size=(5, 2))
    jsys = mpc.LinearSystem(A=jnp.asarray(A), B=jnp.asarray(B)).with_output(C, D)
    tsys = port.LinearSystem(A=torch.as_tensor(A), B=torch.as_tensor(B)).with_output(C, D)
    want = np.stack([np.asarray(jsys.output(jnp.asarray(x), jnp.asarray(u)))
                     for x, u in zip(xs, us)])
    got = tsys.output(torch.as_tensor(xs), torch.as_tensor(us)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,nx", [("KinematicBicycle", 4), ("DynamicBicycle", 6)])
def test_bicycle_callables_match_jax(kind, nx):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.0, 1.0, (8, nx))
    x[:, 3] = rng.uniform(0.2, 1.0, 8)  # forward speed (the Pacejka slip angles)
    u = rng.uniform(-0.3, 0.3, (8, 2))
    f_j = getattr(mpc, kind)(mpc.VehicleParameters(friction=0.8))
    f_t = getattr(port, kind)(port.VehicleParameters(friction=0.8))
    assert getattr(port, kind)().params == port.VehicleParameters()
    want = np.stack([np.asarray(f_j(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(x, u)])
    np.testing.assert_allclose(f_t(torch.as_tensor(x), torch.as_tensor(u)).numpy(), want,
                               rtol=1e-12, atol=1e-12)


def test_euler_fine_and_get_integrator_match_jax():
    from model_predictive_control_tpu.ops import integrators as JI
    from model_predictive_control_tpu_torch.ops import integrators as TI

    rng = np.random.default_rng(2)
    x, u = rng.uniform(-0.5, 0.5, (6, 4)), rng.uniform(-0.3, 0.3, (6, 2))
    f_j, f_t = mpc.KinematicBicycle(), port.KinematicBicycle()
    step_j, step_t = JI.euler_fine(f_j, 0.1, 4), TI.euler_fine(f_t, 0.1, 4)
    want = np.stack([np.asarray(step_j(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(x, u)])
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(step_t(xt, ut).numpy(), want, rtol=0, atol=1e-13)
    assert torch.equal(TI.euler_fine(f_t, 0.1)(xt, ut), TI.euler(f_t, 0.1)(xt, ut))
    assert sorted(TI.INTEGRATORS) == sorted(JI.INTEGRATORS)
    for name in TI.INTEGRATORS:
        assert port.get_integrator(name) is getattr(TI, name)
    errors = []
    for get in (JI.get_integrator, port.get_integrator):
        with pytest.raises(ValueError) as err:
            get("rk5")
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("equilibrate,setup_admm", [(False, True), (True, False), (False, False)])
def test_qp_setup_options_match_jax(equilibrate, setup_admm):
    from model_predictive_control_tpu.solvers.qp import qp_setup as jax_qp_setup

    rng = np.random.default_rng(3)
    G = rng.normal(size=(6, 6))
    P = G @ G.T + 0.5 * np.eye(6)
    A = np.vstack([np.eye(6), 3.0 * rng.normal(size=(4, 6))])
    kw = dict(rho=0.2, equilibrate=equilibrate, setup_admm=setup_admm)
    op_j = jax_qp_setup(jnp.asarray(P), jnp.asarray(A), **kw)
    op_t = port.qp_setup(torch.as_tensor(P), torch.as_tensor(A), **kw)
    for field in ("P_s", "A_s", "D", "E", "c", "rho_levels", "sigma", "Minv_stack", "Pinv_s",
                  "S"):
        want, got = np.asarray(getattr(op_j, field)), getattr(op_t, field).numpy()
        assert got.shape == want.shape, field
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12, err_msg=field)
    assert op_t.rho_init_idx == int(op_j.rho_init_idx)
    if not equilibrate:
        assert (op_t.D == 1).all() and (op_t.E == 1).all() and float(op_t.c) == 1.0
    if not setup_admm:
        assert op_t.Minv_stack.shape == (0, 6, 6)


def _row_models():
    from model_predictive_control_tpu.models import benchmarks as JBM
    from model_predictive_control_tpu.models.bicycle import make_kinematic_ode_rows as jax_kin
    from model_predictive_control_tpu_torch.models import benchmarks as TBM

    models = {"kinematic": (jax_kin(0.5, 0.05, 2.0, 1.0),
                            port.make_kinematic_ode_rows(0.5, 0.05, 2.0, 1.0))}
    for name in ("cartpole", "planar_quadrotor", "omnibase", "omnibase_param", "thruster"):
        fn = f"make_{name}_ode_rows"
        models[name] = (getattr(JBM, fn)(), getattr(TBM, fn)())
    return models


@pytest.mark.parametrize("model", ["kinematic", "cartpole", "planar_quadrotor", "omnibase",
                                   "omnibase_param", "thruster"])
def test_step_jacobian_pattern_matches_jax(model):
    from model_predictive_control_tpu.ops.pallas.ilqr_factory import (
        step_jacobian_pattern as jax_pattern,
    )

    rows_j, rows_t = _row_models()[model]
    dims = (rows_t.nx, rows_t.nu, rows_t.n_params)
    got = port.step_jacobian_pattern(rows_t, *dims)
    assert got == jax_pattern(rows_j, *dims)
    A_pat, B_pat = got
    assert len(A_pat) == rows_t.nx and all(len(r) == rows_t.nu for r in B_pat)
    assert not all(all(r) for r in A_pat)  # structure found, not the dense fallback


def test_step_jacobian_pattern_dense_where_untraceable():
    """A row function the tracer refuses (here Python control flow on a
    traced value) gets the fully dense pattern, as JAX's analysis gives
    when its trace fails."""

    def rows(xr, ur):
        return (xr[1] if xr[0] > 0 else xr[0], ur[0])

    A_pat, B_pat = port.step_jacobian_pattern(rows, 2, 1)
    assert all(all(r) for r in A_pat) and all(all(r) for r in B_pat)


def test_weak_scaling_devices_plumbing():
    """``weak_scaling(devices=[...])``: one device per rank (one rank here),
    the JAX harness's report at a tiny batch; CPU numbers are labelled
    non-performance."""
    from model_predictive_control_tpu_torch.parallel.podscale import weak_scaling

    out = weak_scaling(batch_per_device=8, steps=2, iters=40, tile=8, devices=["cpu"])
    assert out["non_performance"] is True and out["platform"] == "cpu"
    assert [p["devices"] for p in out["points"]] == [1]
    point = out["points"][0]
    assert point["batch"] == 8 and point["solves_per_s"] > 0
    assert 0.0 <= point["success_rate"] <= 1.0 and point["efficiency_vs_1"] == 1.0
    with pytest.raises(ValueError, match="not both"):
        weak_scaling(batch_per_device=8, devices=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="2 devices for 1 ranks"):
        weak_scaling(batch_per_device=8, devices=["cpu", "cpu"])
