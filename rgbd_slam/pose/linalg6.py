"""Closed-form small-SPD solves for the LM normal equations.

``jnp.linalg.solve`` lowers to a pivoted LU with dynamic control flow, a
sequential path that dominated the LM iteration cost.  The damped normal matrix
``J^T J + lambda diag`` is symmetric positive definite, so a statically unrolled
6x6 Cholesky (all indices compile-time constants) fuses into pure elementwise
code and vmaps over any batch for free.
"""

from __future__ import annotations

import jax.numpy as jnp


def solve_spd(a, b, eps: float = 1e-20):
    """Solve ``a x = b`` for SPD ``a`` [..., N, N] via unrolled Cholesky.

    ``b`` may be a vector [..., N] or a matrix [..., N, M] (static N).  Near-
    singular pivots are floored so the solve stays finite; callers that can see
    indefinite inputs (LM accept/reject, Kalman validity gates) discard bad
    solutions downstream."""
    n = a.shape[-1]
    vec = b.ndim == a.ndim - 1
    if vec:
        b = b[..., None]

    l = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                d = jnp.sqrt(jnp.maximum(s, eps))
                l[i][i] = d
                inv_d[i] = 1.0 / d
            else:
                l[i][j] = s * inv_d[j]

    # forward substitution L y = b  (each y[i] has shape [..., M])
    y = [None] * n
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - l[i][k][..., None] * y[k]
        y[i] = s * inv_d[i][..., None]

    # back substitution L^T x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i][..., None] * x[k]
        x[i] = s * inv_d[i][..., None]

    out = jnp.stack(x, axis=-2)
    return out[..., 0] if vec else out


def solve6_spd(a, b, eps: float = 1e-20):
    """6x6 SPD solve (LM normal equations)."""
    return solve_spd(a, b, eps)


def inv3(a, eps: float = 1e-30):
    """Closed-form adjugate inverse of [..., 3, 3] matrices — pure elementwise ops
    (batched ``jnp.linalg.inv`` lowers to pivoted LU loops)."""
    m = a
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps,
                              jnp.where(det < 0, -eps, eps), det)
    adj = jnp.stack([
        jnp.stack([c00, c10, c20], axis=-1),
        jnp.stack([c01, c11, c21], axis=-1),
        jnp.stack([c02, c12, c22], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]
