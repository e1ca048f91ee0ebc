"""Parallel-in-time Riccati recursion by a suffix scan: the long-horizon
backward pass of the host-tier generic solver (``backward="parallel"``).

Port of ilqr_iterative_tasks_tpu/ops/parallel_riccati.py. With the value
convention V(x) = 0.5 x'P x + p'x, one LQR backward step with stage
(F, b, L, X, q, U) maps (P, p) to

    P_out = X + F' (I + P C)^{-1} P F,        C = L U^{-1} L'
    p_out = q + F' (I + P C)^{-1} (P b + p)

Elements e = (A, b, C, eta, J) of this family compose associatively, so all
suffix maps e_k o ... o e_N come from one scan, and each suffix evaluated at
P = 0, p = 0 gives (P_k, p_k). The JAX module runs
``jax.lax.associative_scan(reverse=True)``; torch has none, so
``_suffix_scan`` does the reverse scan by hand: ceil(log2(N+1)) rounds, each
one batched ``_combine`` of every element with the one ``d`` places later.
It keeps ``_combine_assoc``'s operand order (the later-in-time operand
first): the naive order diverges.

Regularization is control Tikhonov (U + lamb I), not the eigenvalue clamp
of the sequential pass, which no fixed element algebra can express; both
recover the Newton step as lamb -> 0. A linear-in-u stage cost is absorbed
by completing the square (a shift of u, which changes b).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class RiccatiElement(NamedTuple):
    A: torch.Tensor  # (..., n, n)
    b: torch.Tensor  # (..., n)
    C: torch.Tensor  # (..., n, n)
    eta: torch.Tensor  # (..., n)
    J: torch.Tensor  # (..., n, n)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _combine(e_later: RiccatiElement, e_earlier: RiccatiElement):
    """Compose value maps: (e_earlier o e_later), i.e. the earlier-in-time
    element is applied AFTER the later one (backward pass ordering)."""
    A1, b1, C1, eta1, J1 = e_earlier
    A2, b2, C2, eta2, J2 = e_later
    eye = _eye(A1.shape[-1], A1)
    m = torch.linalg.solve(eye + C1 @ J2,
                           eye.expand(C1.shape))  # (I + C1 J2)^{-1}
    mt = m.transpose(-1, -2)
    a1t = A1.transpose(-1, -2)
    A = A2 @ m @ A1
    b = (A2 @ m @ (b1[..., None] + C1 @ eta2[..., None]))[..., 0] + b2
    C = A2 @ m @ C1 @ A2.transpose(-1, -2) + C2
    eta = (a1t @ mt @ (eta2[..., None] - J2 @ b1[..., None]))[..., 0] + eta1
    J = a1t @ mt @ J2 @ A1 + J1
    return RiccatiElement(A, b, C, eta, J)


def _combine_assoc(ea, eb):
    """The reverse scan's combine: the first argument is the LATER-in-array
    (later-in-time) operand (the JAX module's verified order)."""
    return _combine(e_later=ea, e_earlier=eb)


def _suffix_scan(elems: RiccatiElement) -> RiccatiElement:
    """Reverse inclusive scan over the leading axis: out[k] combines
    elems[k], ..., elems[-1]. After the round with offset d, out[k] covers
    elements k .. k+2d-1."""
    length = elems.A.shape[0]
    out = elems
    for r in range(math.ceil(math.log2(length)) if length > 1 else 0):
        d = 1 << r
        head = _combine_assoc(
            RiccatiElement(*(t[d:] for t in out)),
            RiccatiElement(*(t[:length - d] for t in out)))
        out = RiccatiElement(*(torch.cat([h, t[length - d:]])
                               for h, t in zip(head, out)))
    return out


def make_stage_elements(F, b, L, X, q, U, bu, lamb=0.0):
    """Per-stage elements from LQR stage data (leading axis N).

    F: (N,n,n), b: (N,n), L: (N,n,m), X: (N,n,n), q: (N,n), U: (N,m,m),
    bu: (N,m) linear-in-u cost (absorbed by a u-shift), lamb: control
    Tikhonov."""
    m = U.shape[-1]
    eye_m = _eye(m, U)
    u_reg = U + lamb * eye_m
    u_inv = torch.linalg.solve(u_reg, eye_m.expand(u_reg.shape))
    # u-shift: u = v - U^{-1} bu  =>  effective drift b - L U^{-1} bu
    b_eff = b - (L @ (u_inv @ bu[..., None]))[..., 0]
    C = L @ u_inv @ L.transpose(-1, -2)
    # element convention: V = 0.5 x'Jx - eta'x, so eta_stage = -q
    return RiccatiElement(A=F, b=b_eff, C=C, eta=-q, J=X)


def terminal_element(P_T, p_T):
    z = torch.zeros_like(P_T)
    return RiccatiElement(A=z, b=torch.zeros_like(p_T), C=z, eta=-p_T,
                          J=P_T)


def parallel_riccati_backward(F, b, L, X, q, U, bu, P_T, p_T, lamb=0.0):
    """All suffix value functions (P_k, p_k), k = 0..N, in O(log N) depth.

    Returns (P (N+1,n,n), p (N+1,n)): V_k(x) = 0.5 x'P_k x + p_k'x is the
    cost-to-go of the (control-Tikhonov-regularized) LQR from step k."""
    elems = make_stage_elements(F, b, L, X, q, U, bu, lamb)
    term = terminal_element(P_T, p_T)
    elems = RiccatiElement(*(torch.cat([a, t[None]])
                             for a, t in zip(elems, term)))
    suffix = _suffix_scan(elems)
    # back from the element convention (V = 0.5 x'Jx - eta'x)
    return suffix.J, -suffix.eta


def parallel_lqr_gains(F, b, L, X, q, U, bu, P_T, p_T, lamb=0.0):
    """Feedforward and feedback gains of every stage from the parallel
    backward: u_k = k_k + K_k x_k with
      Quu = U + lamb I + L'P_{k+1}L,
      kff = -Quu^{-1}(bu + L'(P_{k+1}b + p_{k+1})),  K = -Quu^{-1} L'P_{k+1}F.
    Returns (kff (N,m), K (N,m,n), P (N+1,n,n), p (N+1,n))."""
    P, p = parallel_riccati_backward(F, b, L, X, q, U, bu, P_T, p_T, lamb)
    P1 = P[1:]
    p1 = p[1:]
    lt = L.transpose(-1, -2)
    quu = U + lamb * _eye(U.shape[-1], U) + lt @ P1 @ L
    rhs_ff = bu + (lt @ ((P1 @ b[..., None]) + p1[..., None]))[..., 0]
    kff = -torch.linalg.solve(quu, rhs_ff[..., None])[..., 0]
    big_k = -torch.linalg.solve(quu, lt @ P1 @ F)
    return kff, big_k, P, p


def sequential_riccati_backward(F, b, L, X, q, U, bu, P_T, p_T, lamb=0.0):
    """O(N)-depth oracle of the same regularized recursion."""
    eye_n = _eye(F.shape[-1], F)
    eye_m = _eye(U.shape[-1], U)
    P, p = P_T, p_T
    Ps, ps = [P_T], [p_T]
    for k in range(F.shape[0] - 1, -1, -1):
        f, bc, l, x, qv, u, buv = (F[k], b[k], L[k], X[k], q[k], U[k],
                                   bu[k])
        u_inv = torch.linalg.solve(u + lamb * eye_m, eye_m.expand(u.shape))
        b_eff = bc - (l @ u_inv @ buv[..., None])[..., 0]
        C = l @ u_inv @ l.transpose(-1, -2)
        M = eye_n + P @ C
        P_out = x + f.transpose(-1, -2) @ torch.linalg.solve(M, P) @ f
        p_out = qv + (f.transpose(-1, -2) @ torch.linalg.solve(
            M, (P @ b_eff[..., None]) + p[..., None]))[..., 0]
        P, p = P_out, p_out
        Ps.append(P)
        ps.append(p)
    return torch.stack(Ps[::-1]), torch.stack(ps[::-1])
