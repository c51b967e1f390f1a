"""Unrolled small symmetric positive-definite solves (port of
``utils/smallsolve.py``).

``solve_spd(S, B)`` solves ``S X = B`` by a closed form at n ≤ 2 and an
unrolled Cholesky with triangular solves up to :data:`SMALL_MAX`, written as
elementwise tensor operations, so a leading batch axis costs nothing extra;
beyond that it calls ``torch.linalg.solve``. ``S`` is ``(..., n, n)`` and
``B`` is ``(..., n)`` or ``(..., n, k)`` with the same leading axes.
"""

from __future__ import annotations

import torch

SMALL_MAX = 12


def solve_spd(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    n = S.shape[-1]
    vec = B.ndim == S.ndim - 1
    rows = [B[..., i] if vec else B[..., i, :] for i in range(n)]
    if n == 1:
        return B / (S[..., 0, :] if vec else S[..., 0, :, None])
    if n > SMALL_MAX:
        return torch.linalg.solve(S, B)
    s = lambda i, j: S[..., i, j] if vec else S[..., i, j, None]
    if n == 2:
        a, b, c, d = s(0, 0), s(0, 1), s(1, 0), s(1, 1)
        det = a * d - b * c
        x = [(d * rows[0] - b * rows[1]) / det, (a * rows[1] - c * rows[0]) / det]
    else:
        L = _chol_unrolled(s, n)
        x = _chol_solve_unrolled(L, rows, n)
    return torch.stack(x, dim=-1 if vec else -2)


def _chol_unrolled(s, n: int):
    """Lower Cholesky factor as a list-of-lists of elementwise tensors."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            v = s(i, j)
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(v) if i == j else v / L[j][j]
    return L


def _chol_solve_unrolled(L, b, n: int):
    """Solve ``L Lᵀ x = b`` with the unrolled triangle."""
    y = [None] * n
    for i in range(n):
        v = b[i]
        for k in range(i):
            v = v - L[i][k] * y[k]
        y[i] = v / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for k in range(i + 1, n):
            v = v - L[k][i] * x[k]
        x[i] = v / L[i][i]
    return x
