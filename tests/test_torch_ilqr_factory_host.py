"""The tracker kernel's CUDA source, compiled for the host, against its twin.

``csrc/ilqr_factory.cu`` is plain C++ apart from its CUDA qualifiers,
``__syncthreads_and`` and the launch. Built by g++ with those stubbed and one
lane per tile (so a tile-wide vote is the lane's own), it runs the kernel's
arithmetic on the CPU through the real wrapper (``prepare_tiles``,
``_launch``, the constants struct). Held against the twin at tile 1 after one
inner iteration, both models and both integrators, it must agree bit for bit
where the host's libm agrees with torch (the kinematic tier, whose
transcendentals are sin, cos, tan and sqrt) and within 1e-3 for the Pacejka
tier, whose glibc ``atanf`` and ``tanhf`` round apart from torch's own (2.7e-4
measured on the speed-deficit lane, whose drive bound is active). At the
dynamic sweep's 3 × 8 budget converged masks must agree and controls stay
within 2e-2, the JAX package's bar between its two float32 implementations of
the dynamic tier (``tests/test_pallas_ilqr_dyn.py:205``). On the card the
kernel is held to the twin bit for bit (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import contextlib
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from model_predictive_control_tpu_torch.experiments.racing import (
    Q_DYNAMIC,
    QN_SCALE,
    R_DYNAMIC,
    ellipse_reference,
)
from model_predictive_control_tpu_torch.models.parameters import VehicleParameters
from model_predictive_control_tpu_torch.ops.cuda import ilqr_factory as F
from model_predictive_control_tpu_torch.ops.cuda.ilqr_dyn_kernel import (
    make_pacejka_ode_rows,
    model_tuple,
)
from model_predictive_control_tpu_torch.ops.cuda.parking_factory import make_parking_ode_rows

STUB = """
#include <math.h>
#include <string.h>
#define __device__
#define __global__
#define __forceinline__ inline
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
inline int __syncthreads_and(int vote) { return vote; }
"""

GRID = """
template <class M, bool RK4>
static void host_grid(int n_tiles, const Args& g, const Consts& c) {
  for (int b = 0; b < n_tiles; ++b) {
    blockIdx.x = b; blockDim.x = 1; threadIdx.x = 0;
    tracker_tile_kernel<M, RK4>(g, c);
  }
}
"""

B = 6


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = F._SOURCES[0].read_text().replace("#include <cuda_runtime.h>", STUB)
    src, n = re.subn(
        r"tracker_tile_kernel<M, (true|false)><<<n_tiles, tile, 0, s>>>\(g, c\)",
        r"host_grid<M, \1>(n_tiles, g, c)", src,
    )
    assert n == 2, "the launch lines of csrc/ilqr_factory.cu changed"
    src = src.replace("template <class M>\nstatic int launch", GRID + "\ntemplate <class M>\nstatic int launch")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "k.cpp").write_text(src)
    lib = d / "libk.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-w",
         str(d / "k.cpp"), "-o", str(lib)],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(lib))


@pytest.fixture
def host_launch(host_kernel, monkeypatch):
    """``ilqr_factory._launch`` running the host build on CPU tensors."""
    F._configure(host_kernel)
    monkeypatch.setattr(F, "_build_library", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return F._launch


def _case(model, seed=0):
    rng = np.random.default_rng(seed)
    N = 10 if model == "kinematic" else 6
    dynamic = model == "pacejka"
    ref = ellipse_reference(80, speed=1.2 if dynamic else 0.35, dynamic=dynamic, device="cpu").numpy()
    refs = np.stack([ref[o : o + N + 1] for o in rng.integers(0, 60, B)]).astype(np.float32)
    nx = refs.shape[-1]
    scale = [0.05, 0.05, 0.1, 0.05, 0.01, 0.05] if dynamic else [0.08, 0.08, 0.15, 0.05]
    x0 = (refs[:, 0] + rng.uniform(-1, 1, (B, nx)) * np.array(scale)).astype(np.float32)
    kw = dict(N=N, ts=0.05, limits=((-1.0, -0.384), (1.0, 0.384)), mu_init=10.0, mu_scale=10.0,
              mu_max=1e8, viol_tol=1e-4, tol=1e-6, tile=1, nu=2, nx=nx)
    if dynamic:
        x0[0, 3] -= 0.6
        kw.update(ode_rows=make_pacejka_ode_rows(model_tuple(VehicleParameters())), state_limits=None,
                  weights=(Q_DYNAMIC, R_DYNAMIC, QN_SCALE))
        par = None
    else:
        par = np.stack([2.0 * (1 + 0.1 * rng.uniform(-1, 1, B)), 1 + 0.1 * rng.uniform(-1, 1, B)], -1)
        par = torch.as_tensor(par.astype(np.float32))
        kw.update(ode_rows=make_parking_ode_rows(0.05 / 0.097, 0.05),
                  state_limits=((-3.0, -2.0, -100.0, -0.5), (3.0, 2.0, 100.0, 0.5)),
                  weights=((40.0, 40.0, 4.0, 1.0), (0.5, 0.5), 5.0))
    args = F.prepare_tiles(torch.as_tensor(x0), torch.zeros(B, N, 2), torch.as_tensor(refs), par, tile=1)
    return args, kw


@pytest.mark.parametrize(
    "model, integrator, substeps",
    [("kinematic", "euler", 1), ("kinematic", "rk4", 2), ("pacejka", "rk4", 4), ("pacejka", "euler", 1)],
)
def test_host_build_matches_twin(host_launch, model, integrator, substeps):
    args, kw = _case(model)
    kw.update(integrator=integrator, substeps=substeps)
    before = F.LAUNCHES
    for outer, inner, tol in ((1, 1, 0.0 if model == "kinematic" else 1e-3), (3, 8, 2e-2)):
        got = host_launch(*args, outer_iters=outer, inner_iters=inner, **kw)
        want = F.tracker_tiles_reference(*args, outer_iters=outer, inner_iters=inner, **kw)
        assert torch.equal(got[3], want[3])  # converged
        du = (got[0] - want[0]).abs().max().item()
        print(f"{model} {integrator}x{substeps} {outer}x{inner}: max|du| {du:.3e} (tol {tol})")
        assert du <= tol
        if outer == 1:
            assert torch.equal(got[5], want[5])  # executed inner iterations
    assert F.LAUNCHES == before + 2
