"""Batched perspective-three-point (P3P) absolute pose solver.

The reference vendors the lambdatwist P3P solver but never calls it from the pipeline
(third_party/p3p.hpp; SURVEY.md §2.9 — only its standalone test uses it).  The north
star asks for P3P-RANSAC hypothesis generation as a batched array program, so this module
implements the classical Grunert formulation from scratch as pure batched array math:

* depth-ratio quartic with coefficients derived symbolically (resultant of the two
  law-of-cosines constraints; see the c4..c0 expressions below),
* closed-form Ferrari resolvent-cubic quartic roots + Newton polish (f32-safe),
* Horn/Kabsch absolute orientation from the recovered camera-frame triangle.

Everything broadcasts over leading axes: one call solves B RANSAC minimal subsets,
each returning up to 4 candidate poses with validity masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import se3


def _cubic_largest_real_root(a2, a1, a0):
    """Largest real root of z^3 + a2 z^2 + a1 z + a0 (trigonometric method)."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * a2 ** 3 / 27.0 - a2 * a1 / 3.0 + a0
    # discriminant branches handled by clamping into the trig form
    m = jnp.sqrt(jnp.maximum(-p / 3.0, 1e-12))
    arg = jnp.clip(3.0 * q / (2.0 * p * m + 1e-30), -1.0, 1.0)
    # p < 0: three real roots; take the largest
    t_trig = 2.0 * m * jnp.cos(jnp.arccos(arg) / 3.0)
    # p >= 0: single real root via Cardano
    disc = jnp.sqrt(jnp.maximum(q * q / 4.0 + p ** 3 / 27.0, 0.0))
    t_card = jnp.cbrt(-q / 2.0 + disc) + jnp.cbrt(-q / 2.0 - disc)
    t = jnp.where(p < 0, t_trig, t_card)
    return t - a2 / 3.0


def _quartic_roots(c4, c3, c2, c1, c0):
    """Real roots of a quartic, Ferrari's method, [..., 4] with validity mask.
    Complex root pairs are reported invalid."""
    safe4 = jnp.where(jnp.abs(c4) < 1e-12, 1.0, c4)
    p = c3 / safe4
    q = c2 / safe4
    r = c1 / safe4
    s = c0 / safe4

    # depressed quartic y^4 + alpha y^2 + beta y + gamma, v = y - p/4
    alpha = q - 3.0 * p * p / 8.0
    beta = r - p * q / 2.0 + p ** 3 / 8.0
    gamma = s - p * r / 4.0 + p * p * q / 16.0 - 3.0 * p ** 4 / 256.0

    z = _cubic_largest_real_root(2.0 * alpha, alpha * alpha - 4.0 * gamma,
                                 -beta * beta)
    z = jnp.maximum(z, 1e-12)
    w = jnp.sqrt(z)

    # y^2 + w y + (alpha + z - beta/w)/2 = 0  and  y^2 - w y + (alpha + z + beta/w)/2
    t1 = (alpha + z - beta / w) / 2.0
    t2 = (alpha + z + beta / w) / 2.0

    d1 = w * w / 4.0 - t1
    d2 = w * w / 4.0 - t2
    ok1 = d1 >= 0
    ok2 = d2 >= 0
    s1 = jnp.sqrt(jnp.maximum(d1, 0.0))
    s2 = jnp.sqrt(jnp.maximum(d2, 0.0))

    y = jnp.stack([-w / 2.0 + s1, -w / 2.0 - s1, w / 2.0 + s2, w / 2.0 - s2],
                  axis=-1)
    valid = jnp.stack([ok1, ok1, ok2, ok2], axis=-1)
    roots = y - (p / 4.0)[..., None]

    # Newton polish on the original quartic (f32 closed forms are rough)
    def poly(v):
        return ((((c4[..., None] * v + c3[..., None]) * v + c2[..., None]) * v
                 + c1[..., None]) * v + c0[..., None])

    def dpoly(v):
        return (((4.0 * c4[..., None] * v + 3.0 * c3[..., None]) * v
                 + 2.0 * c2[..., None]) * v + c1[..., None])

    for _ in range(3):
        f = poly(roots)
        df = dpoly(roots)
        roots = roots - f / jnp.where(jnp.abs(df) > 1e-12, df, 1e-12)

    return roots, valid


def p3p(world_points, bearings):
    """Solve P3P for minimal subsets.

    Args:
      world_points: [..., 3, 3] three world points (rows).
      bearings: [..., 3, 3] corresponding unit bearing vectors in the CAMERA
        (optical) frame (rows) — from ``screen_to_camera([u, v, 1])`` normalized.

    Returns (quat [..., 4, 4], position [..., 4, 3], valid [..., 4]): up to four
    candidate world-frame poses per subset (compatible with
    ``se3.world_to_camera(quat, position)``)."""
    x1, x2, x3 = world_points[..., 0, :], world_points[..., 1, :], world_points[..., 2, :]
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]

    a12 = jnp.sum((x1 - x2) ** 2, axis=-1)
    a13 = jnp.sum((x1 - x3) ** 2, axis=-1)
    a23 = jnp.sum((x2 - x3) ** 2, axis=-1)
    b12 = jnp.sum(f1 * f2, axis=-1)
    b13 = jnp.sum(f1 * f3, axis=-1)
    b23 = jnp.sum(f2 * f3, axis=-1)

    # quartic in v = lambda3/lambda1 (resultant of the two ratio constraints;
    # derived symbolically, common factor a12^2 dropped)
    c4 = (a12 ** 2 - 4 * a12 * a13 * b23 ** 2 + 2 * a12 * a13 - 2 * a12 * a23
          + a13 ** 2 - 2 * a13 * a23 + a23 ** 2)
    c3 = 4 * (-a12 ** 2 * b13 + a12 * a13 * b12 * b23
              + 2 * a12 * a13 * b13 * b23 ** 2 - a12 * a13 * b13
              + 2 * a12 * a23 * b13 - a13 ** 2 * b12 * b23
              + a13 * a23 * b12 * b23 + a13 * a23 * b13 - a23 ** 2 * b13)
    c2 = 2 * (2 * a12 ** 2 * b13 ** 2 + a12 ** 2
              - 4 * a12 * a13 * b12 * b13 * b23 - 2 * a12 * a13 * b23 ** 2
              - 4 * a12 * a23 * b13 ** 2 - 2 * a12 * a23
              + 2 * a13 ** 2 * b12 ** 2 + 2 * a13 ** 2 * b23 ** 2 - a13 ** 2
              - 2 * a13 * a23 * b12 ** 2 - 4 * a13 * a23 * b12 * b13 * b23
              + 2 * a23 ** 2 * b13 ** 2 + a23 ** 2)
    c1 = 4 * (-a12 ** 2 * b13 + a12 * a13 * b12 * b23 + a12 * a13 * b13
              + 2 * a12 * a23 * b13 - a13 ** 2 * b12 * b23
              + 2 * a13 * a23 * b12 ** 2 * b13 + a13 * a23 * b12 * b23
              - a13 * a23 * b13 - a23 ** 2 * b13)
    c0 = (a12 ** 2 - 2 * a12 * a13 - 2 * a12 * a23 + a13 ** 2
          - 4 * a13 * a23 * b12 ** 2 + 2 * a13 * a23 + a23 ** 2)

    v_roots, v_ok = _quartic_roots(c4, c3, c2, c1, c0)  # [..., 4]

    # u from the (A) quadratic: u^2 - 2 b12 u + C(v) = 0,
    # C(v) = 1 - (a12/a13)(v^2 - 2 b13 v + 1); pick the branch satisfying (B)
    r_ratio = (a12 / jnp.maximum(a13, 1e-12))[..., None]
    v = v_roots
    cv = 1.0 - r_ratio * (v * v - 2.0 * b13[..., None] * v + 1.0)
    disc_u = jnp.maximum(b12[..., None] ** 2 - cv, 0.0)
    sq = jnp.sqrt(disc_u)
    u_cands = jnp.stack([b12[..., None] + sq, b12[..., None] - sq], axis=-1)

    def b_resid(u):
        return jnp.abs((1 + u * u - 2 * b12[..., None] * u) * a23[..., None]
                       - (u * u + v * v - 2 * b23[..., None] * u * v)
                       * a12[..., None])

    res = jnp.stack([b_resid(u_cands[..., 0]), b_resid(u_cands[..., 1])], axis=-1)
    u = jnp.where(res[..., 0] <= res[..., 1], u_cands[..., 0], u_cands[..., 1])

    s_sq = a12[..., None] / jnp.maximum(
        1.0 + u * u - 2.0 * b12[..., None] * u, 1e-12)
    lam1 = jnp.sqrt(jnp.maximum(s_sq, 0.0))
    lam2 = u * lam1
    lam3 = v * lam1
    valid = v_ok & (lam1 > 0) & (lam2 > 0) & (lam3 > 0) \
        & (b12[..., None] ** 2 - cv >= -1e-3)

    # camera-frame points for each candidate: [..., 4, 3]
    p1 = lam1[..., None] * f1[..., None, :]
    p2 = lam2[..., None] * f2[..., None, :]
    p3 = lam3[..., None] * f3[..., None, :]

    # Absolute orientation from the minimal triplet via orthonormal triads:
    # both point sets satisfy the same pairwise distances by construction, so
    # R = C_c C_w^T with C = [e1, e2, e1 x e2] is exact — no SVD.  (A batched
    # 3x3 jnp.linalg.svd is an iterative solver loop; the triad is a handful of
    # cross products.  Degenerate/collinear triplets yield junk
    # rotations that RANSAC scoring discards.)
    pw = jnp.stack([x1, x2, x3], axis=-2)[..., None, :, :]  # [..., 1, 3pts, 3]
    pc = jnp.stack([p1, p2, p3], axis=-2)                   # [..., 4cand, 3pts, 3]

    def triad(pts):
        a = pts[..., 1, :] - pts[..., 0, :]
        b = pts[..., 2, :] - pts[..., 0, :]
        e1 = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
        b_perp = b - jnp.sum(b * e1, axis=-1, keepdims=True) * e1
        e2 = b_perp / jnp.maximum(
            jnp.linalg.norm(b_perp, axis=-1, keepdims=True), 1e-12)
        e3 = jnp.cross(e1, e2)
        return jnp.stack([e1, e2, e3], axis=-1)  # columns

    cw = triad(pw)                       # [..., 1, 3, 3]
    cc = triad(pc)                       # [..., 4cand, 3, 3]
    rot = jnp.einsum("...ij,...kj->...ik", cc, cw)  # world -> camera
    w_mean = jnp.mean(pw, axis=-2)
    c_mean = jnp.mean(pc, axis=-2)
    t = c_mean - jnp.einsum("...ij,...j->...i", rot, w_mean)

    # w2c = [rot | t]  ->  pose (quat, position): c2w = AXIS @ [Rq | pos]
    rot_c2w = jnp.swapaxes(rot, -1, -2)
    t_c2w = -jnp.einsum("...ij,...j->...i", rot_c2w, t)
    axis_t = jnp.asarray(se3.AXIS_CORRECTION.T, dtype=rot.dtype)
    rq = jnp.einsum("ij,...jk->...ik", axis_t, rot_c2w)
    pos = jnp.einsum("ij,...j->...i", axis_t, t_c2w)
    quat = se3.matrix_to_quat(rq)

    finite = jnp.all(jnp.isfinite(quat), axis=-1) & jnp.all(jnp.isfinite(pos), axis=-1)
    return quat, pos, valid & finite
