"""The stagewise-IP kernel's CUDA source, compiled for the host, against its
twin.

``csrc/riccati_ip_kernel.cu`` is plain C++ apart from its CUDA qualifiers,
``__syncthreads_and`` and the launch. Built by g++ with those stubbed and one
lane per tile (so the tile-wide vote is the lane's own), without contraction
into fused multiply-adds, it runs the kernel's arithmetic on the CPU through
the real wrapper (``prepare_tiles``, ``_launch``, the constants and flags).
The kernel has no transcendental function, only IEEE add, multiply and divide
in the twin's order, so at tile 1 it must agree with the twin bit for bit:
controls, states, μ, residual, status and executed iterations, for both
shipped sizes ((nx, nu) = (2, 1), the long-horizon path, and (3, 2) with a
dense R and infinite bounds). On the card the kernel is held to the twin the
same way (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import contextlib
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from model_predictive_control_tpu_torch.ops.cuda import riccati_ip_kernel as K

STUB = """
#include <math.h>
#include <string.h>
#include <stddef.h>
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

LAUNCH = "stagewise_ip_tile_kernel<<<n_tiles, tile, 0, s>>>(g, c, f);"
HOST_GRID = """
  (void)s;
  for (int b = 0; b < n_tiles; ++b) {
    blockIdx.x = b; blockDim.x = 1; threadIdx.x = 0;
    stagewise_ip_tile_kernel(g, c, f);
  }
"""

SESSION2 = dict(
    A=[[1.0, 0.3], [0.0, 1.0]], B=[[0.0], [0.3]], Q=np.diag([10.0, 1.0]), R=[[0.01]],
    x_lb=[-150.0, -20.0], x_ub=[1.0, 25.0], u_lb=[-20.0], u_ub=[10.0],
)
SYNTHETIC = dict(  # tests/test_pallas_riccati_ip.py's nx=3 / nu=2 system
    A=[[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.95]],
    B=[[0.0, 0.005], [0.1, 0.0], [0.0, 0.1]],
    Q=np.diag([5.0, 1.0, 0.5]), R=[[0.1, 0.01], [0.01, 0.2]],
    x_lb=[-4.0, -2.0, -np.inf], x_ub=[4.0, 2.0, 1.5], u_lb=[-1.0, -0.8], u_ub=[1.0, 0.8],
)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = K._SOURCES[0].read_text().replace("#include <cuda_runtime.h>", STUB)
    assert src.count(LAUNCH) == 1, "the launch line of csrc/riccati_ip_kernel.cu changed"
    src = src.replace(LAUNCH, HOST_GRID)
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "k.cpp").write_text(src)
    libs = {}
    for nx, nu in ((2, 1), (3, 2)):
        lib = d / f"libk_{nx}_{nu}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-w",
             f"-DNX={nx}", f"-DNU={nu}", str(d / "k.cpp"), "-o", str(lib)],
            check=True, capture_output=True,
        )
        libs[nx, nu] = ctypes.CDLL(str(lib))
        K._configure(libs[nx, nu])
    return libs


@pytest.fixture
def host_launch(host_kernels, monkeypatch):
    """``riccati_ip_kernel._launch`` running the host build on CPU tensors."""
    monkeypatch.setattr(K, "_build_library", lambda nx=2, nu=1: host_kernels[nx, nu])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return K._launch


def _states(system, batch, seed):
    rng = np.random.default_rng(seed)
    if system is SESSION2:
        x0 = np.stack([rng.uniform(-140, -20, batch), rng.uniform(-15, 24, batch)], 1)
        x0[-1] = [50.0, 30.0]  # infeasible: the lane dies and reports failure
    else:
        x0 = rng.uniform(-1, 1, (batch, 3)) * np.array([3.5, 1.9, 1.4])
    return torch.as_tensor(x0.astype(np.float32))


@pytest.mark.parametrize(
    "system, N, iters, warm",
    [(SESSION2, 8, 1, False), (SESSION2, 8, 15, False), (SESSION2, 40, 20, False),
     (SESSION2, 10, 18, True), (SYNTHETIC, 12, 18, False), (SYNTHETIC, 12, 18, True)],
    ids=["s2-1it", "s2-N8", "s2-N40", "s2-warm", "nx3nu2", "nx3nu2-warm"],
)
def test_host_build_matches_twin(host_launch, system, N, iters, warm):
    data = dict(system, Pf=2.0 * np.asarray(system["Q"]))  # Pf != Q: the terminal branch
    order = ("A", "B", "Q", "R", "Pf", "x_lb", "x_ub", "u_lb", "u_ub")
    x0 = _states(system, 7, seed=N)
    nu = len(system["u_lb"])
    u_init = None
    if warm:
        rng = np.random.default_rng(1)
        u_init = torch.as_tensor(
            (rng.uniform(-0.5, 0.5, (7, N, nu)) * np.asarray(system["u_ub"])).astype(np.float32)
        )
    problem, x0_t, u0_t, _, _ = K.prepare_tiles(*(data[k] for k in order), x0, u_init, N=N, tile=1)
    kw = dict(N=N, problem=problem, iters=iters, tau=0.995, tile=1)
    before = K.LAUNCHES
    got = host_launch(x0_t, u0_t, **kw)
    want = K.stagewise_ip_tiles_reference(x0_t, u0_t, **kw)
    assert K.LAUNCHES == before + 1
    for name, g, w in zip(("us", "xs", "mu", "prim_res", "success", "iters"), got, want):
        assert torch.equal(g, w), f"{name}: max diff {(g.float() - w.float()).abs().max()}"
    if iters > 1:
        assert got[4].any()  # some lane converged: the polish and the status ran
