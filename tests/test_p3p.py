"""P3P solver tests (parity target: third_party p3p_test coverage — synthetic camera
poses recovered from 3-point minimal sets, batched)."""

import jax
import jax.numpy as jnp
import numpy as np

from rgbd_slam.geometry import pinhole, se3
from rgbd_slam.ops.p3p import p3p
from rgbd_slam.config import CameraIntrinsics

CAM = CameraIntrinsics(width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0)


def make_case(rng):
    q = rng.normal(size=4)
    q = jnp.asarray(q / np.linalg.norm(q), jnp.float32)
    p = jnp.asarray(rng.normal(size=3) * 300, jnp.float32)
    w2c = se3.world_to_camera(q, p)
    # world points safely in front of the camera
    pts_c = np.concatenate([rng.uniform(-800, 800, (3, 2)),
                            rng.uniform(1500, 3500, (3, 1))], axis=1)
    c2w = np.asarray(se3.camera_to_world(q, p))
    pts_w = pts_c @ c2w[:3, :3].T + c2w[:3, 3]
    bearings = pts_c / np.linalg.norm(pts_c, axis=1, keepdims=True)
    return q, p, jnp.asarray(pts_w, jnp.float32), jnp.asarray(bearings, jnp.float32)


class TestP3P:
    def test_recovers_pose(self, rng):
        hits = 0
        trials = 32
        for _ in range(trials):
            q, p, pts_w, bearings = make_case(rng)
            quats, poss, valid = p3p(pts_w, bearings)
            best = 1e9
            for i in range(4):
                if not bool(valid[i]):
                    continue
                perr = float(se3.position_error(poss[i], p))
                rerr = float(se3.rotation_error_deg(quats[i], q))
                best = min(best, perr + rerr * 10)
            if best < 20.0:
                hits += 1
        assert hits >= trials * 0.9, f"only {hits}/{trials} solved"

    def test_batched(self, rng):
        cases = [make_case(rng) for _ in range(16)]
        pts = jnp.stack([c[2] for c in cases])
        brs = jnp.stack([c[3] for c in cases])
        quats, poss, valid = p3p(pts, brs)
        assert quats.shape == (16, 4, 4)
        assert poss.shape == (16, 4, 3)
        solved = 0
        for i, (q, p, _, _) in enumerate(cases):
            errs = [float(se3.position_error(poss[i, j], p))
                    for j in range(4) if bool(valid[i, j])]
            if errs and min(errs) < 15.0:
                solved += 1
        assert solved >= 14

    def test_degenerate_collinear_flagged_or_wrong(self, rng):
        """Collinear world points: no candidate should silently report a perfect
        pose with all-valid flags AND huge error... just require no NaN output."""
        pts_w = jnp.asarray([[0, 0, 2000], [0, 0, 2500], [0, 0, 3000]], jnp.float32)
        b = pts_w / jnp.linalg.norm(pts_w, axis=1, keepdims=True)
        quats, poss, valid = p3p(pts_w, b)
        assert np.isfinite(np.asarray(quats)).all()
        assert np.isfinite(np.asarray(poss)).all()

    def test_jit_and_vmap(self, rng):
        q, p, pts_w, bearings = make_case(rng)
        f = jax.jit(p3p)
        quats, poss, valid = f(pts_w, bearings)
        assert quats.shape == (4, 4)
