"""Runs one cell of the port's benchmark once and prints its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m port_bench.run ...`` from the repository's root). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``checks``, each compared number beside its limit, comes
last, and the same numbers are the last lines of standard error. An
earlier line gives the card's name, power limit and clocks, read after the
window.

Exits with another code than 0, printing no result, where there is no CUDA
device, and where the process holds a module of JAX or of the JAX package
once the window has closed.
"""

import time

T0 = time.perf_counter()  # the set-up time counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "model_predictive_control_tpu"}


def forbidden_modules(modules=None) -> list:
    """Modules loaded in this process (or named in ``modules``) whose
    top-level name, before the first dot and compared whole, is JAX's or
    the JAX package's."""
    return sorted({name.split(".")[0] for name in (sys.modules if modules is None else modules)}
                  & FORBIDDEN)


def card_line() -> str:
    """The card's name, power limit, clocks, draw and temperature, read with
    ``nvidia-smi`` (read-only)."""
    fields = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"card: nvidia-smi unavailable ({exc})"
    return f"card ({fields}): {out.stdout.strip()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(4)  # one process with few threads: steadier host timing
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    t_torch = time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_context = time.perf_counter()

    from port_bench import harness
    from model_predictive_control_tpu_torch.ops.cuda import _build

    result, info = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    "cuda", T0)
    info["built"] = dict(_build.BUILD_SECONDS)  # nvcc's seconds: a compiling first run
    info["torch_import_s"], info["cuda_context_s"] = t_torch - T0, t_context - t_torch
    print("info: " + json.dumps(info), flush=True)
    # after the window, so that nvidia-smi's seconds stay out of setup_s
    print(card_line(), flush=True)
    found = forbidden_modules()
    if found:
        print(f"refused: the process holds {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
