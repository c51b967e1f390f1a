"""Where the port's entry points put their tensors.

The port runs on the card: an entry point that takes ``device`` and is given
none builds its tensors on ``"cuda"``, and raises where there is no CUDA
device. It never falls back to the CPU; the CPU is used only when the caller
passes ``device="cpu"``. Functions that take tensors follow their tensors.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"`` and
    raises ``RuntimeError`` where no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was given: the port runs "
            "on the card by default; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
