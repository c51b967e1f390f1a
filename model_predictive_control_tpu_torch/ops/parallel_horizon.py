"""Parallel-in-horizon primitives: O(log N)-depth rollouts and Riccati
recursions (port of ``ops/parallel_horizon.py``).

The linear rollout (a composition of affine maps) and the backward Riccati
pass (a composition of conditional value functions) are associative, so an
associative scan computes all N stages in O(log N) depth of batched
``(N, n, n)`` products and solves instead of a length-N chain of them. Torch
has no ``lax.associative_scan``: :func:`associative_scan` is its inclusive
scan over the leading axis, with the same ``combine(earlier, later)``
convention and the same odd/even recursion.

Riccati: stage k carries the conditional value function
``V_k(x_k, x_{k+1}) = ½ x_kᵀ J x_k + ½ (x_{k+1} − A x_k)ᵀ C⁻¹ (x_{k+1} − A x_k)``
(information form, so ``C = B R⁻¹ Bᵀ`` may be singular), the element
``(A, C, J)``. Eliminating the shared state gives the combine

    (A₁,C₁,J₁) ⊗ (A₂,C₂,J₂) = ( A₂ W A₁,  A₂ W C₁ A₂ᵀ + C₂,  A₁ᵀ J₂ W A₁ + J₁ ),
    W = (I + C₁ J₂)⁻¹                                   (1 earlier than 2)

and the suffix combination of stages k..N has ``J = P_k``, the cost-to-go.
:func:`lqt_solve_parallel` solves the LQ problem with linear cost terms (the
stagewise interior point's Newton system) by the same combine on states
augmented with a constant 1.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.precision import set_solver_precision


def associative_scan(combine: Callable, elems: tuple) -> tuple:
    """Inclusive scan of ``combine`` over the leading axis of every tensor
    of ``elems`` (a tuple of tensors with one leading length N, any N):
    ``out[k] = e_0 ⊗ e_1 ⊗ … ⊗ e_k`` with ``combine(earlier, later)``
    taking and returning tuples shaped like ``elems``. The recursion pairs
    neighbours, scans the pairs and fills in the even entries: O(log N)
    levels of two batched ``combine`` calls each."""
    n = elems[0].shape[0]
    if n < 2:
        return tuple(elems)
    odd = associative_scan(combine, combine(tuple(e[0:-1:2] for e in elems),
                                            tuple(e[1::2] for e in elems)))
    rest = tuple(e[2::2] for e in elems)
    if rest[0].shape[0] == 0:
        even = tuple(e[:1] for e in elems)
    else:
        head = tuple(o[:-1] for o in odd) if n % 2 == 0 else odd
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, combine(head, rest)))

    def interleave(a, b):  # a[0], b[0], a[1], b[1], … (a one longer when n is odd)
        pairs = torch.stack([a[: b.shape[0]], b], dim=1).reshape(2 * b.shape[0], *b.shape[1:])
        return pairs if a.shape[0] == b.shape[0] else torch.cat([pairs, a[-1:]])

    return tuple(interleave(a, b) for a, b in zip(even, odd))


def _T(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _compose_affine(first, second):
    """(M₁,v₁) then (M₂,v₂):  x ↦ M₂(M₁x + v₁) + v₂."""
    M1, v1 = first
    M2, v2 = second
    return M2 @ M1, _mv(M2, v1) + v2


def affine_rollout_parallel(A, B, x0, controls) -> torch.Tensor:
    """Open-loop LTI/LTV rollout ``x_{k+1} = A_k x_k + B_k u_k`` in O(log N)
    depth: states ``(N + 1, nx)`` including ``x0``. ``A``/``B`` are
    ``(nx, nx)`` / ``(nx, nu)`` or stacked ``(N, nx, nx)`` / ``(N, nx, nu)``."""
    set_solver_precision()
    N = controls.shape[0]
    As = A.expand(N, *A.shape[-2:])
    Bs = B.expand(N, *B.shape[-2:])
    # prefix[k] maps x0 to x_{k+1}; the scan's combine takes the earlier
    # prefix first, _compose_affine's convention
    Ms, vs = associative_scan(_compose_affine, (As, _mv(Bs, controls)))
    return torch.cat([x0[None], _mv(Ms, x0) + vs])


def _riccati_combine(first, second):
    """Suffix-combine two value-function elements; ``first`` is earlier in
    time. Batched over any dimensions before the last two."""
    A1, C1, J1 = first
    A2, C2, J2 = second
    I = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    M = I + C1 @ J2  # W = M⁻¹
    W_A1 = torch.linalg.solve(M, A1)
    W_C1 = torch.linalg.solve(M, C1)
    A = A2 @ W_A1
    C = A2 @ W_C1 @ _T(A2) + C2
    J = _T(A1) @ J2 @ W_A1 + J1
    return A, 0.5 * (C + _T(C)), 0.5 * (J + _T(J))


def _suffix_scan(elems):
    """Suffixes ``e_k ⊗ … ⊗ e_N`` of value-function elements: flip, prefix
    scan with the accumulated (later in time) operand second, flip back."""
    flipped = tuple(torch.flip(e, dims=(0,)) for e in elems)
    scanned = associative_scan(lambda acc, new: _riccati_combine(new, acc), flipped)
    return tuple(torch.flip(e, dims=(0,)) for e in scanned)


def riccati_recursion_parallel(A, B, Q, R, Pf, N: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`.riccati.riccati_recursion` in O(log N) depth: ``P (N + 1, nx,
    nx)`` and ``K (N, nu, nx)``, index 0 = stage 0. ``A``/``B``/``Q``/``R``
    may be stacked per stage ``(N, ...)`` (the time-varying recursion)."""
    set_solver_precision()
    nx = Pf.shape[-1]
    dt = Pf.dtype
    As = A.expand(N, nx, nx).to(dt)
    Bs = B.expand(N, nx, B.shape[-1]).to(dt)
    Qs = Q.expand(N, nx, nx).to(dt)
    Rs = R.expand(N, *R.shape[-2:]).to(dt)
    Cs = Bs @ torch.linalg.solve(Rs, _T(Bs))
    # stage elements e_0..e_{N-1} and the terminal element (0, 0, Pf)
    zeros = torch.zeros(1, nx, nx, dtype=dt, device=Pf.device)
    _, _, P = _suffix_scan((torch.cat([As, zeros]), torch.cat([Cs, zeros]),
                            torch.cat([Qs, Pf[None]])))
    # K_k = −(R + BᵀP_{k+1}B)⁻¹ BᵀP_{k+1}A, one batched solve
    BtP = _T(Bs) @ P[1:]
    K = -torch.linalg.solve(Rs + BtP @ Bs, BtP @ As)
    return P, K


def rollout_parallel(system, x0, controls, *, A=None, B=None) -> torch.Tensor:
    """Parallel open-loop rollout of a linear system: a ``LinearSystem``-like
    object with ``.A``/``.B``, or explicit ``A=`` and ``B=``."""
    if A is None or B is None:
        if system is None:
            raise ValueError(
                "rollout_parallel needs either a system with .A/.B or explicit "
                "A= and B= matrices"
            )
        A = system.A if A is None else A
        B = system.B if B is None else B
    return affine_rollout_parallel(A, B, x0, controls)


def lqt_solve_parallel(As, Bs, Qts, Rts, qts, rts, x_init) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve ``min Σₖ ½xₖᵀQ̃ₖxₖ + q̃ₖᵀxₖ + ½uₖᵀR̃ₖuₖ + r̃ₖᵀuₖ`` (with the
    terminal ``Q̃_N``, ``q̃_N``) s.t. ``x_{k+1} = Aₖxₖ + Bₖuₖ``, ``x₀ =
    x_init``, in O(log N) depth.

    The linear terms fold into the pure-quadratic combine by appending a
    constant-1 coordinate: with x̃ = [x; 1] they become the corner blocks of
    the augmented Q̃, and the control completion u = −R̃⁻¹r̃ + δ becomes the
    augmented dynamics [[A, Bu₀], [0, 1]]. J̃_k's (nx, nx) block is P_k and
    its last column the affine term p_k.

    Shapes: ``As (N, nx, nx)``, ``Bs (N, nx, nu)``; ``Qts (..., N+1, nx,
    nx)`` (index 0 unused), ``Rts (..., N, nu, nu)``, ``qts (..., N+1,
    nx)``, ``rts (..., N, nu)``, ``x_init (..., nx)``, where ``...`` are
    leading batch dimensions that broadcast (the batched interior point's
    lanes). Returns ``(xs (..., N+1, nx), us (..., N, nu))``, the sequential
    ``lq_factor`` / ``lq_affine_solve`` pair of ``solvers/riccati_ip.py`` to
    rounding."""
    set_solver_precision()
    N, nx, nu = Bs.shape
    dt, dev = x_init.dtype, x_init.device
    batch = torch.broadcast_shapes(Qts.shape[:-3], Rts.shape[:-3], qts.shape[:-2],
                                   rts.shape[:-2], x_init.shape[:-1])
    nb = len(batch)
    # horizon-first layout: (N, *batch, ...), the scan's leading axis
    front = lambda a, k: torch.movedim(a.expand(*batch, *a.shape[-k:]), nb, 0)
    Qts, Rts, qts, rts = front(Qts, 3), front(Rts, 3), front(qts, 2), front(rts, 2)
    x_init = x_init.expand(*batch, nx)
    shared = lambda a: a.reshape(N, *([1] * nb), *a.shape[-2:])
    As, Bs = shared(As), shared(Bs)

    u0 = -torch.linalg.solve(Rts, rts[..., None])[..., 0]  # (N, *batch, nu)
    Cs = Bs @ torch.linalg.solve(Rts, _T(Bs).expand(*Rts.shape[:-2], nu, nx))  # B R̃⁻¹ Bᵀ
    na = nx + 1
    zero = lambda n: torch.zeros(n, *batch, na, na, dtype=dt, device=dev)

    A_aug = zero(N)
    A_aug[..., :nx, :nx] = As
    A_aug[..., :nx, nx] = _mv(Bs, u0)
    A_aug[..., nx, nx] = 1.0
    C_aug = zero(N)
    C_aug[..., :nx, :nx] = Cs
    J_aug = zero(N + 1)
    J_aug[..., :nx, :nx] = Qts
    J_aug[..., :nx, nx] = qts
    J_aug[..., nx, :nx] = qts
    # stage 0's state cost is a constant (x₀ is fixed): zero it, so that the
    # suffix element at 0 is the value function seen from stage 0
    J_aug[0] = 0.0
    _, _, J = _suffix_scan((torch.cat([A_aug, zero(1)]), torch.cat([C_aug, zero(1)]), J_aug))
    P, p = J[..., :nx, :nx], J[..., :nx, nx]  # P[N] = Q̃_N, p[N] = q̃_N

    # the stage gains from (P_{k+1}, p_{k+1}), one batched solve
    BtP = _T(Bs) @ P[1:]
    Quu = Rts + BtP @ Bs
    Qux = BtP @ As
    qu = rts + _mv(_T(Bs), p[1:])
    K = -torch.linalg.solve(Quu, Qux)
    kff = -torch.linalg.solve(Quu, qu[..., None])[..., 0]

    # the closed-loop rollout x_{k+1} = (A + BK)x + B kff, an affine scan
    Ms = As + Bs @ K
    Mcum, vcum = associative_scan(_compose_affine, (Ms, _mv(Bs, kff)))
    xs = torch.cat([x_init[None], _mv(Mcum, x_init) + vcum])
    us = _mv(K, xs[:-1]) + kff
    return torch.movedim(xs, 0, nb), torch.movedim(us, 0, nb)
