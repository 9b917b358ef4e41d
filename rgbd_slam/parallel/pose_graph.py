"""Pose-graph layer stitching consecutive BA windows into a consistent trajectory.

NEW capability vs the reference: its ``update_local_to_global`` hook is an empty
TODO (reference src/map_management/local_map.hpp:263-266) and keyframes/BA
are listed as future work (reference README.md:152-158).  This layer is the
north-star "pose-graph layer for inter-block consistency" (SURVEY.md
§2.10/§5): windowed Schur BA refines keyframe poses *inside* a sliding window, but
frames chained after an earlier window keep the absolute error they inherited at
chaining time.  The pose graph keeps every keyframe as a node, odometry +
BA-refined relative poses as edges, and re-solves the whole chain so later, better
relative estimates propagate into globally consistent absolute poses.

Design: the graph is packed into STATIC ``(max_nodes, max_edges)``
arrays with validity masks (one compiled solver for every solve() call), the
Gauss-Newton iteration is a ``lax.scan``, and every edge residual/Jacobian is
built by ``vmap`` + ``jax.jacfwd`` — no per-edge device loops.

Scope (stated, not silent): this is a bounded SLIDING-WINDOW graph, not a
global one — the dense GN solve is O(max_nodes^3) with no sparsity
exploitation, and overflow drops the oldest node (counted in
``dropped_nodes``).  At the default 64 nodes the dense [384, 384] solve is
one small dense factorization, simpler than any sparse scheme; a whole-trajectory layer would need the
chain-sparse Cholesky or the PCG row-block pattern of ``parallel/ba.py``.  Nodes use the
same 6-coefficient pose parameterization (position + stereographic quaternion,
geometry/se3.py) as the pose optimizer and the BA backend.

Host/device split: graph bookkeeping (node list, edge dict, relative-pose
measurements) is tiny per-keyframe quaternion algebra and stays in numpy —
per-keyframe eager device dispatches would each cost a host-device round trip
for a few multiplies.  Only the packed static-shape GN
solve runs on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3

DAMPING = 1e-5

# static-shape batched conversions: compiled once per (max_nodes,) capacity
_coeffs_to_poses = jax.jit(jax.vmap(se3.coefficients_to_pose))
_poses_to_coeffs = jax.jit(jax.vmap(se3.pose_to_coefficients))


# ---------------------------------------------------------------------------
# host-side (numpy) quaternion algebra for graph bookkeeping
# ---------------------------------------------------------------------------

def _np_quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _np_quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _np_quat_rotate(q, v):
    w, x, y, z = q
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return r @ np.asarray(v)


def np_relative(quat_i, pos_i, quat_j, pos_j):
    """(q_rel, p_rel): pose of j expressed in i's frame."""
    qc = _np_quat_conj(quat_i)
    q_rel = _np_quat_mul(qc, quat_j)
    p_rel = _np_quat_rotate(qc, np.asarray(pos_j) - np.asarray(pos_i))
    return q_rel, p_rel


def np_compose(quat_i, pos_i, q_rel, p_rel):
    """World pose of j given i's world pose and j's pose in i's frame."""
    return (_np_quat_mul(quat_i, q_rel),
            np.asarray(pos_i) + _np_quat_rotate(quat_i, p_rel))


def _np_stereographic(q):
    """Numpy mirror of se3.quat_to_stereographic (same component convention)."""
    return np.asarray(q[:3]) / max(1.0 + float(q[3]), 1e-3)


def _np_rel_coeffs(q_rel, p_rel):
    return np.concatenate([np.asarray(p_rel, np.float32),
                           _np_stereographic(q_rel).astype(np.float32)])


# ---------------------------------------------------------------------------
# device solve
# ---------------------------------------------------------------------------

def _relative_coeffs_jax(coeffs_i, coeffs_j):
    """6-coeff relative pose of node j expressed in node i's frame."""
    qi, pi = se3.coefficients_to_pose(coeffs_i)
    qj, pj = se3.coefficients_to_pose(coeffs_j)
    qi_inv = se3.quat_conjugate(qi)
    q_rel = se3.quat_multiply(qi_inv, qj)
    p_rel = se3.quat_rotate(qi_inv, pj - pi)
    return se3.pose_to_coefficients(q_rel, p_rel)


def _edge_residual(coeffs_i, coeffs_j, meas, weight):
    """Weighted 6-residual: measured relative pose vs current relative pose.

    Position part in mm; the stereographic-coefficient difference is scaled to
    be commensurate (1 coeff unit ~ 2 rad ~ O(1000) mm at scene scale)."""
    pred = _relative_coeffs_jax(coeffs_i, coeffs_j)
    r = pred - meas
    return r * weight * jnp.concatenate(
        [jnp.ones(3, pred.dtype), jnp.full((3,), 500.0, pred.dtype)])


def _graph_residuals(poses, edge_i, edge_j, edge_meas, edge_w):
    return jax.vmap(
        lambda i, j, m, w: _edge_residual(poses[i], poses[j], m, w))(
            edge_i, edge_j, edge_meas, edge_w)


@partial(jax.jit, static_argnames=("iterations",))
def solve_pose_graph(poses, edge_i, edge_j, edge_meas, edge_w,
                     iterations: int = 10):
    """Dense Gauss-Newton over the pose graph.

    poses [N, 6] node coefficients (node 0 gauge-fixed), edge_i/edge_j [E]
    int32, edge_meas [E, 6] measured relative coefficients, edge_w [E] weights
    (0 = padding).  Returns (refined poses [N, 6], costs [iterations])."""
    n = poses.shape[0]
    e = edge_i.shape[0]
    dt = poses.dtype
    # node assignment one-hots: every gather/scatter in the GN below becomes a
    # contraction (matmuls) instead of a segment-sum scatter
    onei = jax.nn.one_hot(edge_i, n, dtype=dt)          # [E, N]
    onej = jax.nn.one_hot(edge_j, n, dtype=dt)

    def body(p, _):
        # edge-local residuals + jacobians: jacfwd runs over the TWO incident
        # poses (12 tangents), not the flat [6N] vector — a ~N/2x cut in
        # autodiff work and compile size vs the naive whole-graph jacobian
        def edge_r(ci, cj, m, w):
            return _edge_residual(ci, cj, m, w)

        ci = p[edge_i]
        cj = p[edge_j]
        r = jax.vmap(edge_r)(ci, cj, edge_meas, edge_w)             # [E, 6]
        ji = jax.vmap(jax.jacfwd(edge_r, 0))(ci, cj, edge_meas, edge_w)
        jj = jax.vmap(jax.jacfwd(edge_r, 1))(ci, cj, edge_meas, edge_w)
        # dense jacobian [E*6, N*6] assembled by one-hot outer products, then
        # H = J^T J and g = J^T r as two matmuls
        bigj = (jnp.einsum("en,erc->ernc", onei, ji)
                + jnp.einsum("en,erc->ernc", onej, jj)).reshape(e * 6, n * 6)
        h = bigj.T @ bigj
        g = bigj.T @ r.reshape(-1)
        # gauge: freeze node 0
        fix = jnp.arange(n * 6) < 6
        h = jnp.where(fix[:, None] | fix[None, :], jnp.eye(n * 6, dtype=dt), h)
        g = jnp.where(fix, 0.0, g)
        h = h + DAMPING * jnp.eye(n * 6, dtype=dt)
        chol = jax.scipy.linalg.cho_factor(h)
        delta = jax.scipy.linalg.cho_solve(chol, -g)
        return p + delta.reshape(n, 6), jnp.sum(r * r)

    refined, costs = jax.lax.scan(body, poses, None, length=iterations)
    return refined, costs


@partial(jax.jit, static_argnames=("max_nodes", "max_edges", "iterations"))
def _solve_packed(fbuf, ibuf, max_nodes: int, max_edges: int,
                  iterations: int = 10):
    """Packed wrapper around :func:`solve_pose_graph`: the whole
    problem arrives as ONE f32 + ONE i32 array and the result leaves as ONE
    f32 array (the unpacked path costs ~9 host-device transfers per solve,
    this costs 3).
    Quaternion<->coefficient conversions happen on device inside the same
    program."""
    n, e = max_nodes, max_edges
    quats = fbuf[: n * 4].reshape(n, 4)
    positions = fbuf[n * 4: n * 7].reshape(n, 3)
    meas = fbuf[n * 7: n * 7 + e * 6].reshape(e, 6)
    w = fbuf[n * 7 + e * 6:]
    edge_i = ibuf[:e]
    edge_j = ibuf[e:]
    poses = jax.vmap(se3.pose_to_coefficients)(quats, positions)
    refined, costs = solve_pose_graph(poses, edge_i, edge_j, meas, w,
                                      iterations=iterations)
    rq, rp = jax.vmap(se3.coefficients_to_pose)(refined)
    return jnp.concatenate([rq.reshape(-1), rp.reshape(-1), costs])


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

@dataclass
class PoseGraph:
    """Keyframe pose graph with odometry + BA-window edges.

    Frame discipline: edge measurements are RELATIVE poses, which are invariant
    to which global frame the estimates live in — odometry edges are measured
    between consecutive raw engine poses, BA edges between refined window poses.
    Node estimates chain through the graph's own (solved) frame, so solving
    never mixes engine-frame and graph-frame absolutes.

    Static capacity: the packed problem is always (max_nodes, max_edges) so one
    compiled ``solve_pose_graph`` serves every call; overflow drops the OLDEST
    nodes (the sequence head is long-converged) and is counted, never silent."""

    max_nodes: int = 64
    max_edges: int = 256
    odometry_weight: float = 1.0
    ba_weight: float = 4.0

    frame_ids: list = field(default_factory=list)    # node -> source frame id
    quats: list = field(default_factory=list)        # node -> est quat (np [4])
    positions: list = field(default_factory=list)    # node -> est pos (np [3])
    # (fid_i, fid_j, kind) -> (meas6, w): odometry and BA measurements of the
    # same pair COEXIST as independent constraints with their own weights (an
    # accepted-but-poor BA edge stays counterbalanced by odometry)
    edges: dict = field(default_factory=dict)
    dropped_nodes: int = 0
    dropped_edges: int = 0

    def __post_init__(self):
        self._last_raw = None  # (quat, pos) of the last keyframe in ENGINE frame

    def add_keyframe(self, frame_id: int, quat, position):
        """Add a keyframe node from the engine's raw pose estimate; chains an
        odometry edge (measured in the engine frame) from the previous node."""
        quat = np.asarray(quat, np.float64)
        position = np.asarray(position, np.float64)
        if self.frame_ids:
            q_rel, p_rel = np_relative(self._last_raw[0], self._last_raw[1],
                                       quat, position)
            self.edges[(self.frame_ids[-1], int(frame_id), "odom")] = \
                (_np_rel_coeffs(q_rel, p_rel), self.odometry_weight)
            # node estimate chains from the previous node's (solved) estimate
            q_est, p_est = np_compose(self.quats[-1], self.positions[-1],
                                      q_rel, p_rel)
        else:
            q_est, p_est = quat, position
        self._last_raw = (quat, position)
        self.frame_ids.append(int(frame_id))
        self.quats.append(q_est)
        self.positions.append(p_est)
        if len(self.frame_ids) > self.max_nodes:
            dropped_fid = self.frame_ids.pop(0)
            self.quats.pop(0)
            self.positions.pop(0)
            self.edges = {k: v for k, v in self.edges.items()
                          if dropped_fid not in k[:2]}
            self.dropped_nodes += 1

    def add_ba_window(self, frame_ids, refined):
        """Record BA-refined relative poses between consecutive window keyframes
        as high-weight edges (relative poses are frame-invariant, so the BA
        window's internal geometry transfers to the graph without mixing
        absolute frames).  ``refined``: list of (quat, position) host arrays."""
        known = set(self.frame_ids)
        for a in range(len(frame_ids) - 1):
            fa, fb = int(frame_ids[a]), int(frame_ids[a + 1])
            if fa not in known or fb not in known:
                continue
            qa, pa = refined[a]
            qb, pb = refined[a + 1]
            q_rel, p_rel = np_relative(np.asarray(qa, np.float64),
                                       np.asarray(pa, np.float64),
                                       np.asarray(qb, np.float64),
                                       np.asarray(pb, np.float64))
            self.edges[(fa, fb, "ba")] = (_np_rel_coeffs(q_rel, p_rel),
                                          self.ba_weight)

    def solve(self, iterations: int = 10):
        """Solve the graph on device; returns (frame_ids list, quats [n, 4],
        positions [n, 3]) numpy, or None if under-constrained.  Refined poses
        are written back into the node state so subsequent odometry chains from
        the improved estimates."""
        n = len(self.frame_ids)
        if n < 3 or not self.edges:
            return None
        fid_to_node = {f: i for i, f in enumerate(self.frame_ids)}
        packed = [(fid_to_node[a], fid_to_node[b], m, w)
                  for (a, b, _), (m, w) in self.edges.items()
                  if a in fid_to_node and b in fid_to_node]
        if len(packed) > self.max_edges:
            self.dropped_edges += len(packed) - self.max_edges
            packed = packed[-self.max_edges:]

        quats = np.zeros((self.max_nodes, 4), np.float32)
        quats[:, 0] = 1.0
        quats[:n] = np.stack(self.quats).astype(np.float32)
        positions = np.zeros((self.max_nodes, 3), np.float32)
        positions[:n] = np.stack(self.positions).astype(np.float32)

        ei = np.zeros((self.max_edges,), np.int32)
        ej = np.zeros((self.max_edges,), np.int32)
        meas = np.zeros((self.max_edges, 6), np.float32)
        w = np.zeros((self.max_edges,), np.float32)
        for k, (a, b, m, ww) in enumerate(packed):
            ei[k], ej[k], meas[k], w[k] = a, b, m, ww

        # one upload pair, one jitted solve, one fetch (see _solve_packed)
        fbuf = np.concatenate([quats.reshape(-1), positions.reshape(-1),
                               meas.reshape(-1), w])
        ibuf = np.concatenate([ei, ej])
        out = np.asarray(_solve_packed(jnp.asarray(fbuf), jnp.asarray(ibuf),
                                       self.max_nodes, self.max_edges,
                                       iterations=iterations))
        nn = self.max_nodes
        rq = out[: nn * 4].reshape(nn, 4)
        rp = out[nn * 4: nn * 7].reshape(nn, 3)
        costs = out[nn * 7:]
        if not (np.isfinite(costs).all() and np.isfinite(rq[:n]).all()
                and np.isfinite(rp[:n]).all()):
            return None
        for i in range(n):
            self.quats[i] = rq[i].astype(np.float64)
            self.positions[i] = rp[i].astype(np.float64)
        return list(self.frame_ids), rq[:n], rp[:n]
