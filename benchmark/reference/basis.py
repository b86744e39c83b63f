"""One-dimensional Lagrange elements on Gauss-Lobatto nodes, in float64 NumPy.

The plain reference builds every table it needs from here: the nodes of an
order-p element (MFEM's default H1 node placement), a Gauss rule, the values
and derivatives of the Lagrange basis at any points, and the element
stiffness and mass matrices on [0, 1]. Nothing here comes from the program.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lobatto_nodes", "gauss_rule", "lagrange", "element_matrices"]


def _legendre(n: int, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(P_n(x), P_n'(x)) on [-1, 1] by the three-term recurrence."""
    p0, p1 = np.ones_like(x), x.copy()
    if n == 0:
        return p0, np.zeros_like(x)
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    dp = n * (x * p1 - p0) / (x * x - 1.0)
    return p1, dp


def lobatto_nodes(p: int) -> np.ndarray:
    """The p+1 Gauss-Lobatto points on [0, 1]: the ends and the roots of
    P_p', found by Newton's method from Chebyshev-Lobatto guesses."""
    if p < 1:
        raise ValueError("order p >= 1")
    x = -np.cos(np.pi * np.arange(p + 1) / p)
    inner = x[1:-1].copy()
    for _ in range(100):
        # (1 - x^2) P_p'' = 2x P_p' - p(p+1) P_p
        P, dP = _legendre(p, inner)
        d2P = (2.0 * inner * dP - p * (p + 1) * P) / (1.0 - inner * inner)
        step = dP / d2P
        inner = inner - step
        if np.max(np.abs(step), initial=0.0) < 1e-16:
            break
    x[1:-1] = inner
    return (x + 1.0) / 2.0


def gauss_rule(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]: exact to degree 2n - 1."""
    x = -np.cos(np.pi * (np.arange(n) + 0.75) / (n + 0.5))
    for _ in range(100):
        P, dP = _legendre(n, x)
        step = P / dP
        x = x - step
        if np.max(np.abs(step)) < 1e-16:
            break
    _, dP = _legendre(n, x)
    w = 2.0 / ((1.0 - x * x) * dP * dP)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange(nodes: np.ndarray,
             x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B, D) [len(x), len(nodes)]: the Lagrange basis through ``nodes`` and
    its derivative at the points ``x``, from the product formula."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    B = np.ones((len(x), n))
    D = np.zeros((len(x), n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        den = np.prod(nodes[i] - nodes[others])
        for j in others:
            B[:, i] *= (x - nodes[j])
        B[:, i] /= den
        for k in others:
            term = np.ones(len(x))
            for j in others:
                if j != k:
                    term *= (x - nodes[j])
            D[:, i] += term
        D[:, i] /= den
    return B, D


def element_matrices(p: int) -> tuple[np.ndarray, np.ndarray]:
    """(K, M) [p+1, p+1]: the stiffness and mass matrices of the order-p
    element on [0, 1], integrated exactly (a Gauss rule of p+2 points)."""
    xq, wq = gauss_rule(p + 2)
    B, D = lagrange(lobatto_nodes(p), xq)
    return (D * wq[:, None]).T @ D, (B * wq[:, None]).T @ B
