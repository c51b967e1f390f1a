"""The readings that the limits of ``correct`` are set from; the benchmark's
own runs do not run this.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13 \\
        [--program-seeds 1 2 ... --seconds 3] [--episodes 1]

For each of ``--program-seeds``: one run of the program as the benchmark
runs it (a window of ``--seconds``) and the judge's readings of it, the
lower readings. For each of ``--seeds``: the control, the cell's plain
reference in TF32 put in the program's place (``reference/<family>.py::
ControlLoop``) for ``--episodes`` episodes of the cell's own traffic, judged
alike, the upper readings. One JSON line per reading, all in one process.
"""

import argparse
import json
import pathlib
import sys
import time

T0 = time.perf_counter()
REPO = pathlib.Path(__file__).resolve().parents[1]


def control_readings(name: str, seed: int, device, episodes: int = 1,
                     mix_override: dict | None = None) -> dict:
    """The judge's readings of the control on ``episodes`` episodes of the
    cell's traffic drawn from ``seed``."""
    import torch

    from port_bench import generator, harness

    device = torch.device(device)
    cell = harness.find_cell(name)
    mix = generator.Mix(dict(cell.mix, **(mix_override or {})), device)
    loop = harness.family("reference", cell.config["family"]).ControlLoop(cell.config, device)
    rows_per_episode = int(cell.spec["check"]["rows_per_episode"])
    episodes_kept = []
    for k in range(episodes):
        gen = generator.generator(seed, k, device)
        draw = mix.draw(gen)
        x, w = draw["x0"], draw["w"]
        xs, us = [x], []
        for t in range(mix.steps):
            u, x = loop.step(x, None if w is None else w[t])
            xs.append(x)
            us.append(u)
        rows = torch.randperm(mix.scenarios, generator=gen, device=device)[:rows_per_episode]
        episodes_kept.append({"x": torch.stack(xs)[:, rows], "u": torch.stack(us)[:, rows],
                              "w": None if w is None else w[:, rows],
                              "params": {k: v[rows] for k, v in draw.items() if k not in ("x0", "w")}})
    samples = harness._samples(episodes_kept, [mix.steps] * episodes)
    readings = harness.judge(cell, samples, seed, device)
    return dict(readings, correct=harness.checks_of(cell, readings)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--episodes", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch

    from port_bench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.program_seeds:
        t = time.perf_counter()
        result, info = harness.run_cell(args.workload, seed, args.seconds, False, args.device, t)
        print(json.dumps({"side": "program", "seed": seed, "correct": result["correct"],
                          "failed": result["failed"], "attempted": result["attempted"],
                          **info["readings"]}), flush=True)
    for seed in args.seeds:
        t = time.perf_counter()
        readings = control_readings(args.workload, seed, args.device, args.episodes)
        print(json.dumps({"side": "control", "seed": seed, "seconds": time.perf_counter() - t,
                          **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
