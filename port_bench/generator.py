"""The benchmark's one traffic generator. A traffic mix is a data file,
``traffic/<name>.json``, that says how an episode's scenarios are drawn:

- ``scenarios``, ``steps``: the fleet and the episode's closed-loop steps;
- ``start``: one entry a state component, ``{"uniform": [lo, hi]}``;
- ``disturbance`` (optional, ``null`` for none): one entry a state
  component, ``{"normal": sigma}``, an additive disturbance drawn anew at
  every step of every scenario (``sigma`` 0: none on that component);
- ``params`` (optional): named parameters of each scenario's plant, each
  ``{"uniform": [lo, hi]}`` or ``{"normal": [mean, sigma]}``, drawn once an
  episode.

A family whose draws this cannot state (starts rejected by a clearance, say)
gives its ``systems`` file a ``draw(mix, gen)`` of its own, which the
harness calls in this one's place.

Every draw is made on the device from a generator seeded by ``(seed,
episode)``, so the same seed gives the same scenarios and no draw waits for
the host. Every seed draws the same sizes: only the values differ.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import torch

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"


def load(name: str, directory: pathlib.Path = TRAFFIC_DIR) -> dict:
    mix = json.loads((directory / f"{name}.json").read_text())
    for key in ("scenarios", "steps", "start"):
        if key not in mix:
            raise ValueError(f"traffic {name!r} has no {key!r}")
    for entry in mix["start"]:
        if set(entry) != {"uniform"}:
            raise ValueError(f"traffic {name!r}: a start component is {{'uniform': [lo, hi]}}")
    dist = mix.get("disturbance")
    if dist is not None:
        if len(dist) != len(mix["start"]) or any(set(e) != {"normal"} for e in dist):
            raise ValueError(f"traffic {name!r}: a disturbance component is {{'normal': sigma}}")
    for key, entry in mix.get("params", {}).items():
        if len(entry) != 1 or next(iter(entry)) not in ("uniform", "normal") or key in ("x0", "w"):
            raise ValueError(f"traffic {name!r}: parameter {key!r} is "
                             "{'uniform': [lo, hi]} or {'normal': [mean, sigma]}")
    return mix


def episode_seed(seed: int, episode: int) -> int:
    """A 63-bit generator seed for ``(seed, episode)``; any integer seed."""
    digest = hashlib.sha256(f"{int(seed)}:{int(episode)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, episode: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(episode_seed(seed, episode))
    return g


class Mix:
    """A traffic mix's bounds on the device, made once at set-up, so that
    drawing an episode copies nothing from the host."""

    def __init__(self, spec: dict, device):
        self.device = device
        self.scenarios, self.steps = int(spec["scenarios"]), int(spec["steps"])
        f32 = torch.float32
        self.lo = torch.tensor([e["uniform"][0] for e in spec["start"]], dtype=f32, device=device)
        self.hi = torch.tensor([e["uniform"][1] for e in spec["start"]], dtype=f32, device=device)
        dist = spec.get("disturbance")
        self.sigma = (None if dist is None else
                      torch.tensor([e["normal"] for e in dist], dtype=f32, device=device))
        self.params = {k: next(iter(e.items())) for k, e in spec.get("params", {}).items()}

    def draw(self, gen: torch.Generator) -> dict:
        """One episode's draws, float32: ``x0 (B, nx)``, ``w (steps, B, nx)``
        (``None`` without a disturbance) and each parameter ``(B,)``."""
        B, nx, dev = self.scenarios, self.lo.numel(), self.device
        out = {"x0": self.lo + (self.hi - self.lo) * torch.rand(B, nx, generator=gen, device=dev),
               "w": None}
        if self.sigma is not None:
            out["w"] = self.sigma * torch.randn(self.steps, B, nx, generator=gen, device=dev)
        for key, (kind, (a, b)) in self.params.items():
            r = (torch.rand if kind == "uniform" else torch.randn)(B, generator=gen, device=dev)
            out[key] = a + (b - a) * r if kind == "uniform" else a + b * r
        return out
