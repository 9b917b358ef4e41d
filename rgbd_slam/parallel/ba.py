"""Distributed windowed bundle adjustment via Schur-complement landmark elimination.

This is NEW capability relative to the reference (which has per-feature Kalman
filters only — no BA, no keyframes; README.md:152-158 lists it as future work) and is
the north-star distributed backend (SURVEY.md §2.10/§5): keyframes and landmark
blocks partitioned across devices, landmark elimination embarrassingly parallel per
block, the reduced camera system assembled with an all-reduce across devices.

Data layout (landmark-major so everything shards by landmark):
* poses:      [K, 6]  pose optimization coefficients (position + stereographic quat)
* landmarks:  [L, 3]  world points (mm)
* obs_kf:     [L, C]  keyframe index of each observation (int32)
* obs_uv:     [L, C, 2] pixel observations
* obs_mask:   [L, C]  validity

One Gauss-Newton iteration:
  Hll (3x3 per landmark), W blocks (6x3 per observation), reduced system
  S = Hpp - W Hll^-1 W^T assembled by segment-sum over keyframe pairs (a psum across
  landmark shards), gauge fixed on keyframe 0, dense solve of the [6K, 6K] reduced
  system, landmark back-substitution local to each shard.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CameraIntrinsics
from ..geometry import pinhole, se3
from ..pose.linalg6 import inv3

DAMPING = 1e-4
HUBER_PX = 3.0   # robust-kernel scale = the engine's point inlier gate
                 # (reference: map_point.cpp:16-65, parameters.hpp matching 3 px)

# Prior (anchor) weights (units: residual-space information, 1/sigma^2).
# History (r4 ablations, room-orbit + tunnel benches): a PIXEL-ONLY window
# refit degraded ATE at every anchor setting — the front-end KF fuses metric
# depth every frame, so reprojection-only BA discards information the map has.
# With the RGB-D depth residual row (_project_residual) the solve carries the
# full measurement content and LOOSE anchors win: room ATE 16.3 (BA off) ->
# 14.3 mm, tunnel 7.9 -> 7.4 mm at these defaults; tighter anchors (10/5mm)
# leave accuracy on the table, much looser (100/80mm) drifts back up.
LM_PRIOR_W = 1.0 / (30.0 ** 2)        # landmark anchor sigma 30 mm
POSE_PRIOR_POS_W = 1.0 / (20.0 ** 2)  # odometry position sigma 20 mm
POSE_PRIOR_ROT_W = 1.0 / (0.006 ** 2) # stereographic coeff sigma (~0.7 deg)


def _depth_sigma_mm(z):
    """Kinect depth-quantization sigma (reference: covariances.cpp:12-19 with
    the parameters.hpp:13-18 constants — same model the front-end KF uses)."""
    from ..config import DepthNoiseModel
    m = DepthNoiseModel()
    return jnp.maximum(m.quadratic * z * z + m.linear * z + m.constant,
                       m.floor_mm)


def _project_residual(pose6, landmark, uv, z_obs, cam: CameraIntrinsics,
                      z_weight):
    """RGB-D observation residual [3] of one landmark in one keyframe:
    (du, dv, w_z * dz).

    The depth row is what makes windowed BA in this system RGB-D rather than
    monocular: the front-end per-feature KF fuses metric depth every frame
    (map_point.cpp:188-240), so a reprojection-only window refit DISCARDS
    information the map already has and measurably degrades it (r4 ablation:
    every pixel-only BA feedback path hurt full-trajectory ATE).  With the
    depth row, the window solve sees the same measurement content plus
    cross-keyframe consistency."""
    quat, pos = se3.coefficients_to_pose(pose6)
    w2c = se3.world_to_camera(quat, pos)
    proj, valid = pinhole.world_to_screen(landmark, w2c, cam)
    r_uv = jnp.where(valid, uv - proj[:2], 0.0)
    dz = jnp.where(valid & (z_obs > 0.0),
                   (z_obs - proj[2]) * z_weight, 0.0)
    return jnp.concatenate([r_uv, dz[None]])


def _ba_blocks(poses, landmarks, obs_kf, obs_uv, obs_mask,
               cam: CameraIntrinsics, obs_z=None):
    """Per-observation residuals and Jacobian blocks, batched over [L, C].

    Residuals/Jacobians carry a Huber IRLS weight sqrt(HUBER_PX / |r|) beyond
    the kernel scale: the front end RANSAC-gates its matches, but the window
    problem sees every surviving association, and one wrong association with a
    large residual would otherwise dominate the quadratic cost and drag every
    pose in the window (measured: live BA *hurt* full-trajectory ATE until
    robustified).

    ``obs_z`` [L, C] adds the per-observation measured depth (mm, 0 = no
    depth) as a third residual row weighted by the Kinect noise model."""
    if obs_z is None:
        obs_z = jnp.zeros_like(obs_mask, dtype=obs_uv.dtype)

    def one(lm, kf_idx, uv, z, ok):
        pose6 = poses[kf_idx]
        # px-equivalent information weight for the depth row: ~1 px of screen
        # sigma against sigma_z(z) mm of depth sigma
        zw = jnp.where(z > 0.0, 1.0 / _depth_sigma_mm(jnp.maximum(z, 1.0)),
                       0.0)

        def rf(p6, l3):
            return _project_residual(p6, l3, uv, z, cam, zw)

        r = rf(pose6, lm)
        jp = jax.jacfwd(rf, argnums=0)(pose6, lm)   # [3, 6]
        jl = jax.jacfwd(rf, argnums=1)(pose6, lm)   # [3, 3]
        # robust norm over ALL rows: the depth row is already in px-equivalent
        # sigma units (zw = 1/sigma_z), so one bad depth sample (occlusion
        # boundary) is down-weighted exactly like a bad pixel match
        rn = jnp.linalg.norm(r)
        hub = jnp.sqrt(HUBER_PX / jnp.maximum(rn, HUBER_PX))
        m = ok.astype(r.dtype) * hub
        return r * m, jp * m, jl * m

    return jax.vmap(jax.vmap(one, in_axes=(None, 0, 0, 0, 0)),
                    in_axes=(0, 0, 0, 0, 0))(landmarks, obs_kf, obs_uv, obs_z,
                                             obs_mask)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Multi-process (multi-host) initialization, flag-gated.

    On a multi-host cluster each host runs the same program; calling this before any jax
    op joins the processes into one global device mesh, after which
    :func:`make_sharded_ba` over a mesh of ``jax.devices()`` spans hosts — the
    psum/psum_scatter collectives cross hosts with no code change (SURVEY.md §5 distributed-backend plan).
    Parameters default to the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID environment variables; returns True when distributed mode
    was actually initialized (single-process callers get False, no-op)."""
    import os

    coordinator_address = coordinator_address \
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes \
        or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if not coordinator_address or num_processes <= 1:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def _reduced_solve_pcg(s_rows, rhs, axis_name: str, cg_iterations: int):
    """Distributed solve of the reduced camera system by Jacobi-preconditioned
    conjugate gradients: the [6K, 6K] matrix lives as ROW BLOCKS sharded over
    ``axis_name`` (no device holds the dense matrix), the iterate is
    replicated, and each matvec is a local [R_loc, N] x [N] product followed by
    an all_gather — the standard large-scale BA reduced-system scheme
    (Schur + PCG, "Bundle Adjustment in the Large"), mapped to mesh
    collectives.  Solves S x = rhs; returns x [N] replicated."""
    n = rhs.shape[0]
    idx = jax.lax.axis_index(axis_name)
    r_loc = s_rows.shape[0]
    row0 = idx * r_loc

    # Jacobi preconditioner from the local diagonal entries
    diag_loc = s_rows[jnp.arange(r_loc), row0 + jnp.arange(r_loc)]
    diag = jax.lax.all_gather(diag_loc, axis_name, tiled=True)      # [N]
    minv = 1.0 / jnp.maximum(diag, 1e-12)

    def matvec(x):
        y_loc = s_rows @ x                                          # [R_loc]
        return jax.lax.all_gather(y_loc, axis_name, tiled=True)     # [N]

    # the all_gather outputs are device-varying under shard_map's vma typing;
    # cast the carry inits to match so the scan carry types agree (the rhs of
    # an anchored solve is varying already: its prior terms read the poses)
    def vary(a):
        if axis_name in jax.typeof(a).vma:
            return a
        return jax.lax.pcast(a, (axis_name,), to="varying")

    x0 = vary(jnp.zeros_like(rhs))
    r0 = vary(rhs)
    z0 = minv * r0
    p0 = z0
    rz0 = jnp.dot(r0, z0)

    def body(carry, _):
        x, r, p, rz = carry
        q = matvec(p)
        alpha = rz / jnp.maximum(jnp.dot(p, q), 1e-30)
        x = x + alpha * p
        r = r - alpha * q
        z = minv * r
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x0, r0, p0, rz0), None,
                                   length=cg_iterations)
    return x


def _gn_iteration(poses, landmarks, obs_kf, obs_uv, obs_mask,
                  cam: CameraIntrinsics, n_keyframes: int, axis_name=None,
                  pose_anchor=None, lm_anchor=None,
                  reduced_solver: str = "dense", cg_iterations: int = 0,
                  anchor_weights: tuple | None = None, obs_z=None):
    """One Schur-complement GN step.  When ``axis_name`` is set, landmark-axis
    partial sums are psum-reduced across the mesh (the distributed path).
    ``pose_anchor``/``lm_anchor`` add prior residuals pulling toward the
    odometry poses and KF-fused landmark positions (see prior-weight note).

    ``reduced_solver`` picks how the [6K, 6K] reduced camera system is solved
    in the distributed path: "dense" replicates a Cholesky per device (optimal
    for live windows, K <= 16), "pcg" shards the matrix into row blocks via
    psum_scatter and runs distributed preconditioned CG — the system is then
    partitioned over BOTH axes of SURVEY §2.10 (landmark blocks for
    elimination, keyframe row blocks for the reduced solve) with no device
    ever holding the dense [6K, 6K].  A literal 2-D (kf x lm) device mesh was
    rejected by design: it would replicate the per-observation work (the
    dominant cost) across the kf axis; phase-wise resharding keeps every
    device busy in both phases."""
    k = n_keyframes
    dt = poses.dtype
    r, jp, jl = _ba_blocks(poses, landmarks, obs_kf, obs_uv, obs_mask, cam,
                           obs_z=obs_z)
    # r [L,C,2], jp [L,C,2,6], jl [L,C,2,3]

    lm_w, pos_w, rot_w = (anchor_weights if anchor_weights is not None
                          else (LM_PRIOR_W, POSE_PRIOR_POS_W,
                                POSE_PRIOR_ROT_W))
    lm_prior_w = lm_w if lm_anchor is not None else 0.0
    # landmark blocks (local to each shard)
    hll = jnp.einsum("lcri,lcrj->lij", jl, jl) \
        + (DAMPING + lm_prior_w) * jnp.eye(3, dtype=dt)
    bl = jnp.einsum("lcri,lcr->li", jl, r)
    if lm_anchor is not None:
        bl = bl + lm_prior_w * (landmarks - lm_anchor)
    hll_inv = inv3(hll)  # closed-form adjugate: no batched LU loops

    # per-observation pose blocks
    w = jnp.einsum("lcri,lcrj->lcij", jp, jl)          # [L,C,6,3]
    hpp_obs = jnp.einsum("lcri,lcrj->lcij", jp, jp)    # [L,C,6,6]
    bp_obs = jnp.einsum("lcri,lcr->lci", jp, r)        # [L,C,6]

    # Keyframe assignment as a one-hot so every reduction below is a contraction
    # (matmuls) instead of a segment-sum scatter, whose atomic adds serialize
    # and sum in no fixed order.  Masked observations already have zeroed
    # r/jp/jl blocks, so no extra masking of e is needed.
    e = jax.nn.one_hot(obs_kf, k, dtype=dt)            # [L,C,K]
    hpp = jnp.einsum("lck,lcij->kij", e, hpp_obs)
    bp = jnp.einsum("lck,lci->ki", e, bp_obs)

    # Schur correction S[k1,k2] -= sum_l (e w Hll^-1)(e w)^T without materializing
    # the [L,C,C,6,6] pair tensor: fold the keyframe one-hot into the observation
    # blocks, then contract over (landmark, 3) as one [6K, L*3] x [L*3, 6K] matmul.
    y = jnp.einsum("lcij,ljk->lcik", w, hll_inv)        # [L,C,6,3]
    u = jnp.einsum("lck,lcia->lkia", e, y)              # [L,K,6,3]
    v = jnp.einsum("lck,lcja->lkja", e, w)              # [L,K,6,3]
    lloc = u.shape[0]
    s_corr = jax.lax.dot_general(
        u.reshape(lloc, k * 6, 3).transpose(1, 0, 2).reshape(k * 6, lloc * 3),
        v.reshape(lloc, k * 6, 3).transpose(1, 0, 2).reshape(k * 6, lloc * 3),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=dt)                      # [6K, 6K]
    bp_corr = jnp.einsum("lkia,la->ki", u, bl)          # [K, 6]

    use_pcg = axis_name is not None and reduced_solver == "pcg"
    if axis_name is not None:
        hpp = jax.lax.psum(hpp, axis_name)
        bp = jax.lax.psum(bp, axis_name)
        bp_corr = jax.lax.psum(bp_corr, axis_name)
        if use_pcg:
            # row-block shard the reduced system while reducing it: no device
            # ever materializes the summed dense [6K, 6K]
            s_rows = jax.lax.psum_scatter(s_corr, axis_name,
                                          scatter_dimension=0, tiled=True)
        else:
            s_corr = jax.lax.psum(s_corr, axis_name)

    if pose_anchor is not None:
        # odometry prior, added once globally (after the psum): diagonal
        # information + pull toward the anchor coefficients
        wdiag = jnp.asarray([pos_w] * 3 + [rot_w] * 3, dt)
        hpp = hpp + jnp.diag(wdiag)[None, :, :]
        bp = bp + wdiag[None, :] * (poses - pose_anchor)

    n = k * 6
    big_hpp = jnp.zeros((k, 6, k, 6), dt)
    big_hpp = big_hpp.at[jnp.arange(k), :, jnp.arange(k), :].set(hpp)
    rhs = (bp - bp_corr).reshape(n)
    fix = jnp.arange(n) < 6  # gauge: freeze keyframe 0
    rhs = jnp.where(fix, 0.0, rhs)

    if use_pcg:
        r_loc = s_rows.shape[0]
        idx = jax.lax.axis_index(axis_name)
        rr = idx * r_loc + jnp.arange(r_loc)           # global row ids
        hpp_rows = jax.lax.dynamic_slice(
            big_hpp.reshape(n, n), (idx * r_loc, 0), (r_loc, n))
        s_rows = hpp_rows - s_rows
        # gauge fix + damping on the local row block
        eye_rows = jax.nn.one_hot(rr, n, dtype=dt)
        s_rows = jnp.where((rr < 6)[:, None] | fix[None, :], eye_rows, s_rows)
        s_rows = s_rows + DAMPING * eye_rows
        iters = cg_iterations if cg_iterations > 0 else n
        delta_p = _reduced_solve_pcg(s_rows, -rhs, axis_name,
                                     iters).reshape(k, 6)
    else:
        s_mat = big_hpp.reshape(n, n) - s_corr
        s_mat = jnp.where(fix[:, None] | fix[None, :],
                          jnp.eye(n, dtype=dt), s_mat)
        s_mat = s_mat + DAMPING * jnp.eye(n, dtype=dt)
        # SPD after damping + gauge fix: Cholesky beats the default
        # pivoted-LU path
        chol = jax.scipy.linalg.cho_factor(s_mat)
        delta_p = jax.scipy.linalg.cho_solve(chol, -rhs).reshape(k, 6)

    # landmark back-substitution (local per shard): dl = -Hll^-1 (bl + W^T dp)
    dp_per_obs = jnp.take(delta_p, obs_kf, axis=0)      # [L, C, 6]
    wt_dp = jnp.einsum("lcij,lci->lj", w, dp_per_obs)   # [L, 3]
    delta_l = -jnp.einsum("lij,lj->li", hll_inv, bl + wt_dp)

    new_poses = poses + delta_p
    new_landmarks = landmarks + delta_l
    cost = jnp.sum(r * r)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    return new_poses, new_landmarks, cost


def ba_solve(poses, landmarks, obs_kf, obs_uv, obs_mask, cam: CameraIntrinsics,
             iterations: int = 8, anchored: bool = False,
             anchor_weights: tuple | None = None, obs_z=None):
    """Single-device windowed BA (the correctness anchor, SURVEY.md §7 risk list).

    ``anchored=True`` adds the odometry/map priors (the live-pipeline mode);
    the default un-anchored solve is the pure-BA mode used by convergence and
    sharding-equivalence tests.  ``anchor_weights`` = (landmark, position,
    rotation) information weights, defaulting to the module constants.
    ``obs_z`` [L, C] measured depths (mm) add the RGB-D depth residual row."""
    k = poses.shape[0]
    pose_anchor = poses if anchored else None
    lm_anchor = landmarks if anchored else None

    def body(carry, _):
        p, l = carry
        p2, l2, cost = _gn_iteration(p, l, obs_kf, obs_uv, obs_mask, cam, k,
                                     pose_anchor=pose_anchor,
                                     lm_anchor=lm_anchor,
                                     anchor_weights=anchor_weights,
                                     obs_z=obs_z)
        return (p2, l2), cost

    (p, l), costs = jax.lax.scan(body, (poses, landmarks), None,
                                 length=iterations)
    return p, l, costs


def make_sharded_ba(mesh: Mesh, cam: CameraIntrinsics, n_keyframes: int,
                    iterations: int = 8, axis: str = "lm",
                    anchored: bool = False,
                    reduced_solver: str = "dense", cg_iterations: int = 0,
                    anchor_weights: tuple | None = None,
                    with_depth: bool = False):
    """Build the distributed BA step: landmarks + observations sharded over the
    ``axis`` mesh dimension, reduced camera system psum-reduced across the mesh.

    ``reduced_solver="pcg"`` additionally shards the [6K, 6K] reduced camera
    system into keyframe row blocks (psum_scatter) and solves it with
    distributed Jacobi-preconditioned CG — both SURVEY §2.10 partition axes
    (landmark blocks AND keyframe blocks) without replicating the dense solve;
    ``cg_iterations`` 0 means 6K iterations (exact in exact arithmetic).

    Returns a jitted fn(poses, landmarks, obs_kf, obs_uv, obs_mask)
    -> (poses, landmarks, costs)."""
    if reduced_solver == "pcg":
        nd = mesh.shape[axis]
        assert (6 * n_keyframes) % nd == 0, \
            f"pcg reduced solve needs 6*K ({6 * n_keyframes}) divisible by " \
            f"the mesh axis size ({nd})"
    shard_map = jax.shard_map

    def stepfn(poses, landmarks, obs_kf, obs_uv, obs_mask, obs_z=None):
        pose_anchor = poses if anchored else None
        lm_anchor = landmarks if anchored else None
        if reduced_solver == "pcg":
            # the PCG solve goes through all_gathers, so its pose updates are
            # device-varying under vma typing (identical by construction —
            # deterministic collectives); match the scan carry type up front
            poses = jax.lax.pcast(poses, (axis,), to="varying")

        def body(carry, _):
            p, l = carry
            p2, l2, cost = _gn_iteration(p, l, obs_kf, obs_uv, obs_mask, cam,
                                         n_keyframes, axis_name=axis,
                                         pose_anchor=pose_anchor,
                                         lm_anchor=lm_anchor,
                                         reduced_solver=reduced_solver,
                                         cg_iterations=cg_iterations,
                                         anchor_weights=anchor_weights,
                                         obs_z=obs_z)
            return (p2, l2), cost

        (p, l), costs = jax.lax.scan(body, (poses, landmarks), None,
                                     length=iterations)
        if reduced_solver == "pcg":
            # replicated-identical copies back to an invariant output (exact
            # for power-of-two meshes; a [K, 6] pmean is negligible)
            p = jax.lax.pmean(p, axis)
            costs = jax.lax.pmean(costs, axis)
        return p, l, costs

    n_in = 6 if with_depth else 5
    sharded = shard_map(
        stepfn, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis),
                  P(axis))[:n_in],
        out_specs=(P(), P(axis), P()),
    )
    return jax.jit(sharded)
