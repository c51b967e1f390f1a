"""Checkpoint and deterministic resume of long batch sweeps (port of
``obs/checkpoint.py``).

A sweep's loop state (the plant states, the warm-start carry, a generator's
state, the step index) is written as one ``.npz`` of flat arrays with a JSON
record of the step and the nest's structure; the closed loop is
deterministic given that state, so a resumed sweep continues bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch.utils import _pytree as pytree


def save_sweep_state(path: str, step: int, state_pytree) -> str:
    """Write the sweep state: ``state_pytree`` is a nest (tuples, lists,
    dicts) of tensors or arrays."""
    leaves, spec = pytree.tree_flatten(state_pytree)
    host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    arrays = {f"leaf_{i}": host(leaf) for i, leaf in enumerate(leaves)}
    np.savez(path, __meta__=json.dumps({"step": int(step), "treedef": str(spec)}), **arrays)
    return path


def load_sweep_state(path: str, like_pytree):
    """``(step, state_pytree)`` from ``path``; ``like_pytree`` gives the
    nest's structure and, where its leaves are tensors, their dtype and
    device (the caller rebuilds the same loop, so it has one at hand)."""
    like, spec = pytree.tree_flatten(like_pytree)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(len(like))]
    leaves = [torch.as_tensor(a, dtype=l.dtype, device=l.device) if torch.is_tensor(l) else a
              for a, l in zip(leaves, like)]
    return meta["step"], pytree.tree_unflatten(leaves, spec)
