"""Keyframe window management feeding the distributed Schur-complement BA backend.

NEW capability vs the reference (which plans but never implements keyframes/BA,
README.md:152-158; ``update_local_to_global`` is an empty TODO, local_map.hpp:263).
The north star's sequence-parallel layer: keyframes are collected from the engine's
per-frame observation record (StepOutput.point_*), landmark observations are grouped
by feature id across the window, and the window is refined with
:mod:`rgbd_slam.parallel.ba` — locally or sharded over a device mesh.

Host-side orchestration (ring buffers, id bookkeeping) with device solves — the same
split the reference uses between its C++ containers and Eigen kernels.

Design point: the packed problem always has the STATIC shape
``(max_keyframes, max_landmarks, max_obs_per_landmark)`` with validity masks, so one
compiled solver serves every ``refine()`` call.  Variable shapes would recompile the
XLA program on nearly every call (the dominant cost of a naive implementation —
compile time is seconds, a solve is milliseconds).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CameraIntrinsics
from ..geometry import se3
from . import ba

# batched pose-coefficient conversions: one device dispatch per refine instead of K
_coeffs_to_poses = jax.jit(jax.vmap(se3.coefficients_to_pose))
_poses_to_coeffs = jax.jit(jax.vmap(se3.pose_to_coefficients))


def _np_pose_to_coeffs(quat, position):
    """Host mirror of se3.pose_to_coefficients: per-keyframe bookkeeping must
    not touch the device (an eager dispatch + fetch is a host-device round
    trip; this is four multiplies)."""
    q = np.asarray(quat, np.float64)
    p = np.asarray(position, np.float64)
    return np.concatenate(
        [p, q[:3] / max(1.0 + q[3], 1e-3)]).astype(np.float32)


@dataclass
class KeyframeWindow:
    """Sliding window of keyframes with per-feature-id observations.

    ``max_obs_per_landmark`` defaults to ``max_keyframes``: each keyframe
    contributes at most one observation of a landmark, so with C = K the
    per-landmark cap can never drop an observation inside the window (the
    "no silent caps" rule — any residual truncation is counted in
    ``dropped_landmarks`` / ``dropped_obs``)."""

    max_keyframes: int = 8
    max_landmarks: int = 512
    max_obs_per_landmark: int = 0   # 0 -> max_keyframes
    # (landmark, position, rotation) anchor information weights for the
    # anchored live solve; None = rgbd_slam.parallel.ba module defaults
    anchor_weights: tuple | None = None

    poses: list = field(default_factory=list)        # [K] 6-coeff np arrays
    timestamps: list = field(default_factory=list)
    frame_ids: list = field(default_factory=list)    # [K] source frame index
    obs: dict = field(default_factory=dict)          # fid -> list[(kf_idx, uv)]
    landmark_pos: dict = field(default_factory=dict) # fid -> last map position
    landmark_slot: dict = field(default_factory=dict)# fid -> map slot at last sight
    dropped_landmarks: int = 0   # cumulative landmarks truncated by max_landmarks
    dropped_obs: int = 0         # cumulative observations truncated by C cap

    def __post_init__(self):
        if self.max_obs_per_landmark <= 0:
            self.max_obs_per_landmark = self.max_keyframes
        self._solver = None
        self._sharded_solver = None
        self._sharded_axis = None
        self._lm_host = None

    def add_keyframe(self, quat, position, output, point_positions, timestamp=0.0,
                     frame_id=None):
        """Record a keyframe from an engine step output.

        point_positions: the map's current world positions aligned with the output's
        per-slot record (state.points.pos)."""
        matched = np.asarray(output.point_matched)
        fids = np.asarray(output.point_fid)
        uvs = np.asarray(output.point_obs_uv)
        zs = (np.asarray(output.point_obs_z)
              if hasattr(output, "point_obs_z")
              else np.zeros(len(fids), np.float32))
        pos = np.asarray(point_positions)
        self._add(quat, position, matched, fids, uvs, zs, pos, timestamp,
                  frame_id)

    def add_keyframe_packed(self, quat, position, fobs, fids, timestamp=0.0,
                            frame_id=None):
        """Record a keyframe from :func:`runner._pack_keyframe_obs` output —
        two host fetches instead of five."""
        fobs = np.asarray(fobs)
        fids = np.asarray(fids)
        self._add(quat, position, fobs[:, 0] > 0.5, fids, fobs[:, 1:3],
                  fobs[:, 3], fobs[:, 4:7], timestamp, frame_id)

    def _add(self, quat, position, matched, fids, uvs, zs, pos, timestamp,
             frame_id):
        # slide BEFORE inserting: otherwise a landmark observed in every live
        # keyframe hits the C cap with the NEW observation while the oldest one is
        # about to be evicted anyway (silent-cap bug caught by the drop counters)
        if len(self.poses) + 1 > self.max_keyframes:
            self._drop_oldest()
        kf_idx = len(self.poses)
        self.poses.append(_np_pose_to_coeffs(quat, position))
        self.timestamps.append(float(timestamp))
        self.frame_ids.append(kf_idx if frame_id is None else int(frame_id))

        for i in np.nonzero(matched & (fids >= 0))[0]:
            fid = int(fids[i])
            entry = self.obs.setdefault(fid, [])
            if len(entry) < self.max_obs_per_landmark:
                entry.append((kf_idx, uvs[i].copy(), float(zs[i])))
            else:
                self.dropped_obs += 1
            self.landmark_pos[fid] = pos[i].copy()
            self.landmark_slot[fid] = int(i)

    def _drop_oldest(self):
        self.poses.pop(0)
        self.timestamps.pop(0)
        self.frame_ids.pop(0)
        new_obs = {}
        for fid, entries in self.obs.items():
            kept = [(k - 1, uv, z) for k, uv, z in entries if k > 0]
            if kept:
                new_obs[fid] = kept
        self.obs = new_obs

    @property
    def n_keyframes(self):
        return len(self.poses)

    def build_problem(self):
        """Pack the window into the BA layout: landmarks observed in >= 2 keyframes.

        Always returns STATIC shapes (K = max_keyframes, L = max_landmarks,
        C = max_obs_per_landmark) so the compiled solver is reused:
        (poses [K, 6], landmarks [L, 3], obs_kf [L, C], obs_uv [L, C, 2],
        obs_mask [L, C], fids [L] int64, slots [L] int32, lm_valid [L]),
        or None if under-constrained."""
        if self.n_keyframes < 2:
            return None
        usable = [(fid, e) for fid, e in self.obs.items() if len(e) >= 2]
        if len(usable) < 8:
            return None
        if len(usable) > self.max_landmarks:
            # keep the best-constrained landmarks (most observations) rather than
            # dict insertion order, and account for the truncation
            usable.sort(key=lambda t: len(t[1]), reverse=True)
            self.dropped_landmarks += len(usable) - self.max_landmarks
            usable = usable[: self.max_landmarks]
        k = self.max_keyframes
        l = self.max_landmarks
        c = self.max_obs_per_landmark
        obs_kf = np.zeros((l, c), np.int32)
        obs_uv = np.zeros((l, c, 2), np.float32)
        obs_z = np.zeros((l, c), np.float32)
        obs_mask = np.zeros((l, c), bool)
        landmarks = np.zeros((l, 3), np.float32)
        fids = np.full((l,), -1, np.int64)
        slots = np.zeros((l,), np.int32)
        lm_valid = np.zeros((l,), bool)
        for i, (fid, entries) in enumerate(usable):
            fids[i] = fid
            slots[i] = self.landmark_slot.get(fid, 0)
            lm_valid[i] = True
            landmarks[i] = self.landmark_pos[fid]
            for j, (kf, uv, z) in enumerate(entries[:c]):
                obs_kf[i, j] = kf
                obs_uv[i, j] = uv
                obs_z[i, j] = z
                obs_mask[i, j] = True
        poses = np.zeros((k, 6), np.float32)
        poses[: self.n_keyframes] = np.stack(self.poses).astype(np.float32)
        # host arrays: the local solve path packs them into TWO device
        # transfers (see refine); the sharded path device_puts them per-spec
        return (poses, landmarks, obs_kf, obs_uv, obs_z, obs_mask,
                fids, slots, lm_valid)

    def _get_solver(self, cam: CameraIntrinsics, iterations: int, mesh):
        """One compiled solver per window (static problem shape => zero recompiles
        across refine() calls)."""
        if mesh is not None:
            if self._sharded_solver is None:
                # shard over the mesh's first axis, whatever it is called —
                # refine() reuses the recorded name for its device_put specs
                self._sharded_axis = mesh.axis_names[0]
                self._sharded_solver = ba.make_sharded_ba(
                    mesh, cam, n_keyframes=self.max_keyframes,
                    iterations=iterations, anchored=True, axis=self._sharded_axis,
                    anchor_weights=self.anchor_weights, with_depth=True)
            return self._sharded_solver
        if self._solver is None:
            weights = self.anchor_weights
            k = self.max_keyframes
            l = self.max_landmarks
            c = self.max_obs_per_landmark

            @jax.jit
            def solve(fbuf, ibuf):
                """Packed local solve: the whole problem arrives as ONE f32 +
                ONE i32 buffer and the result leaves as ONE f32 buffer (+ the
                landmark block, which stays on device for the map scatter) —
                refine() pays exactly 2 uploads + 1 fetch instead of ~9
                host-device transfers."""
                o = [0]

                def take(n, shape):
                    a = jax.lax.dynamic_slice(fbuf, (o[0],), (n,))
                    o[0] += n
                    return a.reshape(shape)

                poses = take(k * 6, (k, 6))
                landmarks = take(l * 3, (l, 3))
                obs_uv = take(l * c * 2, (l, c, 2))
                obs_z = take(l * c, (l, c))
                obs_mask = take(l * c, (l, c)) > 0.5
                lm_valid = take(l, (l,)) > 0.5
                obs_kf = ibuf[: l * c].reshape(l, c)
                slots = ibuf[l * c: l * c + l]
                fids_dev = ibuf[l * c + l:]
                new_poses, new_lm, costs = ba.ba_solve(
                    poses, landmarks, obs_kf, obs_uv, obs_mask, cam,
                    iterations=iterations, anchored=True,
                    anchor_weights=weights, obs_z=obs_z)
                quats, positions = jax.vmap(se3.coefficients_to_pose)(new_poses)
                # the refined landmarks + validity ride along in the single
                # fetch so apply_refinement never re-fetches them
                out = jnp.concatenate([quats.reshape(-1),
                                       positions.reshape(-1),
                                       costs.reshape(-1),
                                       new_lm.reshape(-1),
                                       lm_valid.astype(jnp.float32)])
                return out, new_lm, slots, lm_valid, fids_dev

            self._solver = solve
        return self._solver

    def refine(self, cam: CameraIntrinsics, iterations: int = 8, mesh=None):
        """Run windowed BA.

        Returns ``(refined, device_lm, costs)`` where ``refined`` is a list of
        (quat, position) host arrays for the n_keyframes live keyframes,
        ``device_lm = (fids [L], slots [L], new_lm [L,3] device, lm_valid [L])``
        stays on device for the map scatter-back, and ``costs`` is the per-iteration
        masked cost — or None when under-constrained."""
        problem = self.build_problem()
        if problem is None:
            return None
        (poses, landmarks, obs_kf, obs_uv, obs_z, obs_mask, fids, slots,
         lm_valid) = problem
        fn = self._get_solver(cam, iterations, mesh)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            sh = NamedSharding(mesh, P(self._sharded_axis))
            landmarks, obs_kf, obs_uv, obs_z, obs_mask = (
                jax.device_put(a, sh)
                for a in (landmarks, obs_kf, obs_uv, obs_z, obs_mask))
            new_poses, new_lm, costs = fn(poses, landmarks, obs_kf, obs_uv,
                                          obs_mask, obs_z)
            quats, positions = _coeffs_to_poses(new_poses)
            quats, positions = np.asarray(quats), np.asarray(positions)
            costs = np.asarray(costs)
            device_lm = (fids, jnp.asarray(slots), new_lm,
                         jnp.asarray(lm_valid))
        else:
            fbuf = np.concatenate([
                poses.reshape(-1), landmarks.reshape(-1), obs_uv.reshape(-1),
                obs_z.reshape(-1), obs_mask.astype(np.float32).reshape(-1),
                lm_valid.astype(np.float32)])
            ibuf = np.concatenate([obs_kf.reshape(-1), slots,
                                   fids.astype(np.int32)])
            out, new_lm, slots_dev, lm_valid_dev, fids_dev = fn(
                jnp.asarray(fbuf), jnp.asarray(ibuf))
            out = np.asarray(out)
            k = self.max_keyframes
            l = self.max_landmarks
            quats = out[: k * 4].reshape(k, 4)
            positions = out[k * 4: k * 7].reshape(k, 3)
            costs = out[k * 7: k * 7 + iterations]
            lm_host = out[k * 7 + iterations: k * 7 + iterations + l * 3]
            self._lm_host = (fids, lm_host.reshape(l, 3),
                             out[k * 7 + iterations + l * 3:] > 0.5)
            device_lm = (fids, slots_dev, new_lm, lm_valid_dev, fids_dev)
        refined = [(quats[i], positions[i]) for i in range(self.n_keyframes)]
        return refined, device_lm, costs

    def apply_refinement(self, refined, device_lm=None):
        """Write refined poses back into the window so the next refine starts from
        the improved estimate (the live-pipeline feedback path the reference leaves
        as an empty TODO, local_map.hpp:263-266).  Landmark positions refresh
        themselves on the next add_keyframe from the (scattered-back) live map, so
        only landmarks that already left the map need the device_lm update here."""
        self.poses = [_np_pose_to_coeffs(q, p) for q, p in refined]
        if device_lm is not None:
            fids, _slots, new_lm, lm_valid = device_lm[:4]
            cached = getattr(self, "_lm_host", None)
            if cached is not None and cached[0] is fids:
                _, lm_host, valid_host = cached   # rode along in refine's fetch
            else:
                lm_host = np.asarray(new_lm)
                valid_host = np.asarray(lm_valid)
            for i in range(len(fids)):
                if valid_host[i] and int(fids[i]) in self.landmark_pos:
                    self.landmark_pos[int(fids[i])] = lm_host[i]
