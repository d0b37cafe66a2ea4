"""Gauss-Lobatto-Legendre (GLL) nodes, weights and 1D Lagrange tabulation.

GLL nodes are the roots of (1-x^2) P'_N(x); weights are
w_i = 2 / (N(N+1) P_N(x_i)^2).  Setup-time host code in float64 numpy, on
the unit reference interval [0, 1] (weights summing to 1).  Vendored from
``fustpu/elements/gll.py``.
"""

from __future__ import annotations

import functools

import numpy as np


def _legendre_and_derivs(N: int, x: np.ndarray):
    """P_N(x), P'_N(x), P''_N(x) by the three-term recurrence + ODE."""
    P_prev = np.ones_like(x)
    P = x.copy()
    if N == 0:
        P = P_prev
        dP = np.zeros_like(x)
        return P, dP, np.zeros_like(x)
    for k in range(2, N + 1):
        P_prev, P = P, ((2 * k - 1) * x * P - (k - 1) * P_prev) / k
    # P' via (x^2-1)/N * P'_N = x P_N - P_{N-1}; endpoints (|x|=1) are never
    # used by callers, so clamp the denominator to avoid 0/0 warnings there.
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = x**2 - 1.0
        dP = np.where(denom != 0.0, N * (x * P - P_prev) / denom, 0.0)
        d2P = np.where(denom != 0.0,
                       (2.0 * x * dP - N * (N + 1) * P) / (-denom), 0.0)
    return P, dP, d2P


@functools.lru_cache(maxsize=None)
def gll_points_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n GLL points/weights on [-1, 1] (n >= 2), float64."""
    if n < 2:
        raise ValueError("GLL rule needs at least 2 points")
    N = n - 1
    if n == 2:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])
    # Interior nodes: roots of P'_N.  Chebyshev-Gauss-Lobatto initial guess.
    x_int = -np.cos(np.pi * np.arange(1, N) / N)
    for _ in range(100):
        _, dP, d2P = _legendre_and_derivs(N, x_int)
        dx = dP / d2P
        x_int = x_int - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    x = np.concatenate(([-1.0], x_int, [1.0]))
    P, _, _ = _legendre_and_derivs(N, np.clip(x, -1.0, 1.0))
    # Endpoint values: P_N(+-1) = (+-1)^N
    P[0] = (-1.0) ** N
    P[-1] = 1.0
    w = 2.0 / (N * (N + 1) * P**2)
    return x, w


@functools.lru_cache(maxsize=None)
def gll_points_weights_unit(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n GLL points/weights on the unit interval [0, 1]."""
    x, w = gll_points_weights(n)
    return (x + 1.0) / 2.0, w / 2.0


def barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


@functools.lru_cache(maxsize=None)
def derivative_matrix(n: int) -> np.ndarray:
    """D[q, i] = l_i'(x_q) at the unit-interval GLL nodes: the forward
    contraction is w[q] = sum_i D[q,i] u[i], the transposed one used on the
    way back is y[i] = sum_q D[q,i] f[q]."""
    x, _ = gll_points_weights_unit(n)
    b = barycentric_weights(x)
    D = np.zeros((n, n))
    for q in range(n):
        for i in range(n):
            if i != q:
                D[q, i] = (b[i] / b[q]) / (x[q] - x[i])
        D[q, q] = -np.sum(D[q])
    return D


def lagrange_tabulate(nodes: np.ndarray, pts: np.ndarray):
    """Values and first derivatives of the Lagrange basis on `nodes` at
    arbitrary points `pts` (stable barycentric form).

    Returns (vals, derivs) of shape (len(pts), len(nodes)).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    n = nodes.size
    b = barycentric_weights(nodes)
    vals = np.zeros((pts.size, n))
    ders = np.zeros((pts.size, n))
    # Nodal derivative matrix for coincident points
    Dn = np.zeros((n, n))
    for q in range(n):
        for i in range(n):
            if i != q:
                Dn[q, i] = (b[i] / b[q]) / (nodes[q] - nodes[i])
        Dn[q, q] = -np.sum(Dn[q])
    for p, t in enumerate(pts):
        d = t - nodes
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            q = int(np.argmax(hit))
            vals[p, q] = 1.0
            ders[p] = Dn[q]
        else:
            r = b / d
            L = r.sum()
            vals[p] = r / L
            # l_i'(t) = l_i(t) * (sum_j b_j/d_j^2 / L - 1/d_i)
            s2 = np.sum(b / d**2)
            ders[p] = vals[p] * (s2 / L - 1.0 / d)
    return vals, ders


@functools.lru_cache(maxsize=None)
def gll_nodes_unit(n: int) -> np.ndarray:
    return gll_points_weights_unit(n)[0]
