"""The port's roofline (``obs/roofline.py``) against the JAX package's: the
algorithmic counts are equal at the same arguments (the work is the same
whatever implements it), ``achieved()`` is checked by hand at the H100's
peaks, and ``chip_smoke.bound`` reads its peaks from the module."""

import importlib.util
import pathlib

import pytest
import torch

from model_predictive_control_tpu.obs import roofline as jax_roofline

from model_predictive_control_tpu_torch.obs import roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTS = ("flops_per_solve", "flops_main_loop", "hbm_bytes_per_solve")
CASES = [
    ("admm_kernel_roofline", {}),
    ("admm_kernel_roofline", {"n": 20, "m": 60, "iters": 80, "probe_iters": 8}),
    ("admm_kernel_roofline", {"n": 4, "m": 12, "iters": 60, "chunks": 4, "probe_iters": 0}),
    ("al_ilqr_kernel_roofline", {}),
    ("al_ilqr_kernel_roofline", {"N": 30, "outer_iters": 6, "inner_iters": 14, "n_pairs": 0}),
    ("al_ilqr_dyn_kernel_roofline", {}),
    ("al_ilqr_dyn_kernel_roofline", {"N": 15, "substeps": 4, "outer_iters": 3,
                                     "inner_iters": 8}),
]


@pytest.mark.parametrize("fn, kw", CASES)
def test_counts_equal_the_jax_package(fn, kw):
    port, ref = getattr(roofline, fn)(**kw), getattr(jax_roofline, fn)(**kw)
    assert port.name == ref.name
    for key in COUNTS:
        assert getattr(port, key) == getattr(ref, key), key


def test_peaks_are_the_h100s():
    assert roofline.FP32_PEAK == 67e12 and roofline.HBM_BW_PEAK == 3.35e12
    assert not hasattr(roofline, "MXU_BF16_PEAK") and not hasattr(roofline, "MXU_TILE")


def test_achieved_by_hand():
    r = roofline.admm_kernel_roofline(n=20, m=60, iters=80, probe_iters=8)
    # 80 iterations of 2·80² + setup 2·20·80 + 2·60·20 + 3 checks of
    # 2(2·20·60 + 400) + 40 CG iterations of 2(400 + 2400) + 120
    flops = 80 * 2 * 80 * 80 + 3200 + 2400 + 3 * 2 * 2800 + 40 * (2 * 2800 + 120)
    bytes_ = 4 * (140 + 80 + 140)
    assert r.flops_per_solve == flops and r.hbm_bytes_per_solve == bytes_
    assert r.bound == "FP32"  # 1.27 MFLOP against 1.44 KB
    out = r.achieved(50e6)
    assert out["achieved_gflops"] == round(flops * 50e6 / 1e9, 1)
    assert out["frac_of_peak"] == round(flops * 50e6 / 67e12, 4)
    assert out["roofline_ceiling_solves_per_s"] == round(67e12 / flops, 1)
    assert out["frac_of_ceiling"] == round(50e6 * flops / 67e12, 4)
    assert out["hbm_gb_per_s"] == round(bytes_ * 50e6 / 1e9, 2)
    assert out["frac_of_hbm_peak"] == round(bytes_ * 50e6 / 3.35e12, 5)
    # a byte-heavy model is bound by the memory rate
    heavy = roofline.KernelRoofline("bytes", 1.0, 1.0, 1e6)
    assert heavy.bound == "HBM"
    assert heavy.achieved(1.0)["roofline_ceiling_solves_per_s"] == round(3.35e12 / 1e6, 1)


def test_chip_smoke_bound_reads_the_module_peaks(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    out = chip_smoke.bound(torch, 2 * roofline.FP32_PEAK, [])
    assert out == {"bound_ms": 2000.0, "bound_by": "operations", "library_ms": None}
    b = chip_smoke.bound(torch, 0.0, [torch.zeros(1000)])
    assert b["bound_ms"] == 1e3 * 4000 / roofline.HBM_BW_PEAK and b["bound_by"] == "bytes"
    monkeypatch.setattr(roofline, "FP32_PEAK", 1e3)
    assert chip_smoke.bound(torch, 1e3, [])["bound_ms"] == 1000.0
