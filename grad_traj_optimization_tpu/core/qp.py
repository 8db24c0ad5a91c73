"""Closed-form minimum-snap QP seeding and optimization dependencies.

Batched rebuild of the reference ``TrajectoryGenerator``
(qp_generator.{h,cpp}).  Differences by design:

* No hidden file-scope state.  The reference keeps ``int m``, ``startVel``,
  ``startAcc`` as file-scope mutables consumed later by ``StackOptiDep`` /
  ``getInitialD`` (qp_generator.cpp:12-16) — here everything is an explicit
  argument/return.
* No dense 6m x 6m inverses.  Selection matrices C are pure permutation
  /duplication maps, encoded once per segment count ``m`` as static NumPy
  index arrays; the block inverses come from :mod:`core.poly`'s exact
  unit-time kernels.  Everything that depends on the (traced) segment times
  is a small batched matmul -> vmap/pjit-friendly.

Terminology (matches the reference):

* ``D`` — stacked endpoint derivatives, 6 per segment, slot order
  (p0, p1, v0, v1, a0, a1) per segment (qp_generator.cpp:44-54).
* ``d = (df, dp)`` — reordered free/fixed derivative vector with
  ``D = Ct @ d``; Ct rows are one-hot (qp_generator.cpp:357-390).
* For the optimizer partition (``StackOptiDep``): num_f = 6 (start and end
  p,v,a), num_p = 3m-3 (all interior derivatives).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax as _lax


def _einsum(subscripts, *operands):
    """einsum pinned to full f32 precision (no TF32/bf16 passes)."""
    return jnp.einsum(subscripts, *operands, precision=_lax.Precision.HIGHEST)

from grad_traj_optimization_tpu.core import poly


# ---------------------------------------------------------------------------
# Static selection maps (depend only on m)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def opt_dmap(m: int) -> np.ndarray:
    """Index map for the optimizer partition (StackOptiDep).

    Returns idx of shape (6m,): derivative slot ``6s + 2i + e`` (segment s,
    order i, end e) maps to d-slot ``idx[...]`` where d is laid out as
    ``[p0, v0, a0, pm, vm, am, (p, v, a) of interior waypoint 1..m-1]``.

    Closed form of the Ct built at qp_generator.cpp:357-390.
    """
    idx = np.zeros(6 * m, dtype=np.int64)
    for s in range(m):
        for i in range(3):
            for e in range(2):
                w = s + e
                if w == 0:
                    d = i
                elif w == m:
                    d = 3 + i
                else:
                    d = 6 + 3 * (w - 1) + i
                idx[6 * s + 2 * i + e] = d
    return idx


@functools.lru_cache(maxsize=None)
def opt_selection(m: int) -> np.ndarray:
    """Dense one-hot Ct (6m, 3m+3) with D = Ct @ d, float64."""
    idx = opt_dmap(m)
    ct = np.zeros((6 * m, 3 * m + 3), dtype=np.float64)
    ct[np.arange(6 * m), idx] = 1.0
    return ct


@functools.lru_cache(maxsize=None)
def minsnap_dmap(m: int) -> np.ndarray:
    """Index map for the full min-snap partition (PolyQPGeneration type 1).

    d layout (4m+2 slots): fixed block of 2m+4 = [p0, v0, a0, p0_end,
    (p_start_s, p_end_s) for s = 1..m-1, v_end, a_end], free block of
    2m-2 = [(v_w, a_w) for interior waypoints w = 1..m-1].

    Closed form of the Ct built at qp_generator.cpp:242-270.  Interior
    *positions* are duplicated fixed slots (continuity by value); interior
    vel/acc are merged free slots (continuity by sharing).
    """
    idx = np.zeros(6 * m, dtype=np.int64)
    for s in range(m):
        # positions
        idx[6 * s + 0] = 0 if s == 0 else 2 + 2 * s
        idx[6 * s + 1] = 3 + 2 * s
        # velocities
        for i, base in ((1, 0), (2, 1)):
            for e in range(2):
                w = s + e
                if w == 0:
                    d = 1 + base  # start vel / acc
                elif w == m:
                    d = 2 * m + 2 + base  # end vel / acc
                else:
                    d = 2 * m + 4 + 2 * (w - 1) + base
                idx[6 * s + 2 * i + e] = d
    return idx


# ---------------------------------------------------------------------------
# Optimization dependencies (L, R blocks) — reference StackOptiDep
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QPDep:
    """Everything the penalty optimizer needs, per scenario.

    Shapes for m segments (num_dp = 3m-3):
      L:    (6m, 3m+3)   coeff = L @ d    (reference _L = A^-1 Ct)
      Ldp:  (m, 6, num_dp) per-segment slice L[6s:6s+6, 6:]
      R:    (3m+3, 3m+3) smoothness quadratic form over d
      Rfp:  (6, num_dp)
      Rpp:  (num_dp, num_dp)
    """

    L: jnp.ndarray
    Ldp: jnp.ndarray
    R: jnp.ndarray
    Rfp: jnp.ndarray
    Rpp: jnp.ndarray


def build_dep(T) -> QPDep:
    """Build L and R blocks from segment times.

    Reference: StackOptiDep (qp_generator.cpp:357-405) — but expressed as
    per-segment 6x6 kernels scattered through the static selection map, so
    a batch of scenarios is one vmapped call.
    """
    T = jnp.asarray(T)
    m = T.shape[0]
    ndim = 3 * m + 3
    ct = jnp.asarray(opt_selection(m), dtype=T.dtype)  # (6m, ndim)
    ainv = poly.segment_ainv(T)  # (m, 6, 6)
    msnap = poly.segment_snap_form(T)  # (m, 6, 6)

    ct_seg = ct.reshape(m, 6, ndim)
    # L[6s + j, a] = sum_b Ainv[s, j, b] Ct[6s + b, a]
    L = _einsum("sjb,sba->sja", ainv, ct_seg).reshape(6 * m, ndim)
    # R = Ct^T blockdiag(M) Ct = sum_s Ct_s^T M_s Ct_s
    R = _einsum("spa,spq,sqb->ab", ct_seg, msnap, ct_seg)

    Ldp = L.reshape(m, 6, ndim)[:, :, 6:]
    return QPDep(L=L, Ldp=Ldp, R=R, Rfp=R[:6, 6:], Rpp=R[6:, 6:])


# ---------------------------------------------------------------------------
# Initial derivatives
# ---------------------------------------------------------------------------


def straight_line_d(waypoints, start_vel=None, start_acc=None):
    """Initial (Df, Dp) for waypoint seeding (reference type-2 path).

    The reference's type-2 'straight line' QP (qp_generator.cpp:317-345)
    plus getInitialD (:407-451) reduce to: interior derivative guesses are
    (waypoint position, 0 velocity, 0 acceleration); fixed block is
    [p_start, v_start, a_start, p_end, 0, 0].

    Args:
      waypoints: (m+1, 3).
    Returns:
      Df (3, 6), Dp (3, 3m-3) in axis-major layout (rows x,y,z), matching
      the reference decision-vector convention (grad_traj_optimizer.cpp:
      154-177: within a block, i%3 = 0 pos / 1 vel / 2 acc).
    """
    wp = jnp.asarray(waypoints)
    mp1 = wp.shape[0]
    m = mp1 - 1
    sv = jnp.zeros(3, wp.dtype) if start_vel is None else jnp.asarray(start_vel)
    sa = jnp.zeros(3, wp.dtype) if start_acc is None else jnp.asarray(start_acc)

    Df = jnp.stack(
        [
            wp[0],
            sv,
            sa,
            wp[m],
            jnp.zeros(3, wp.dtype),
            jnp.zeros(3, wp.dtype),
        ],
        axis=1,
    )  # (3, 6) columns [p0, v0, a0, pm, vm, am]

    interior = wp[1:m]  # (m-1, 3)
    dp = jnp.stack(
        [
            interior,  # position
            jnp.zeros_like(interior),  # velocity
            jnp.zeros_like(interior),  # acceleration
        ],
        axis=2,
    )  # (m-1, 3axes?, ...) -> careful: want (m-1, 3slots) per axis
    # dp currently (m-1, 3, 3): [wp_idx, axis, slot]; reorder to axis-major
    Dp = jnp.transpose(dp, (1, 0, 2)).reshape(3, 3 * (m - 1))
    return Df, Dp


def min_snap_dp(Df, Rpp, Rfp):
    """Closed-form smoothness-optimal free derivatives (the "min_snap"
    descent seed).

    Solves the unconstrained QP optimality condition
    ``dp* = -Rpp^-1 Rfp^T df`` per axis (the reference's own type-1
    initialization expressed in the optimizer's dp layout,
    qp_generator.cpp:242-315 / :407-451), Jacobi-equilibrated so the
    f32 solve survives Rpp condition numbers ~1e4.

    Args:
      Df: (3, 6) fixed derivatives; Rpp: (P, P); Rfp: (6, P).
    Returns:
      dp (3, P).  Callers clip to the descent box bounds.
    """
    diag = jnp.sqrt(jnp.clip(jnp.diagonal(Rpp), 1e-30))
    si = 1.0 / diag
    rs = Rpp * si[:, None] * si[None, :]
    rhs = -_einsum("xf,fp->xp", Df, Rfp) * si[None, :]  # (3, P)
    # one factorization, 3 RHS columns (the axes share the same Rpp)
    z = jnp.linalg.solve(rs, rhs.T).T
    return z * si[None, :]


def kino_d(pos, vel, acc):
    """Initial (Df, Dp) from kinodynamic states (reference setKinoPath path:
    PolyKinoGeneration + getInitialD, qp_generator.cpp:23-154, 407-451).

    Args:
      pos, vel, acc: (m+1, 3) states at the m+1 knots.
    """
    pos = jnp.asarray(pos)
    vel = jnp.asarray(vel)
    acc = jnp.asarray(acc)
    m = pos.shape[0] - 1
    Df = jnp.stack(
        [pos[0], vel[0], acc[0], pos[m], vel[m], acc[m]], axis=1
    )  # (3, 6)
    interior = jnp.stack([pos[1:m], vel[1:m], acc[1:m]], axis=2)  # (m-1,3,3)
    Dp = jnp.transpose(interior, (1, 0, 2)).reshape(3, 3 * (m - 1))
    return Df, Dp


def stacked_derivatives(Df, Dp, m: int):
    """Expand (Df, Dp) to the full per-segment derivative stack D.

    Returns (3, 6m) with per-segment slot order (p0,p1,v0,v1,a0,a1);
    D = d[opt_dmap] per axis.
    """
    d = jnp.concatenate([Df, Dp], axis=1)  # (3, 3m+3)
    idx = jnp.asarray(opt_dmap(m))
    return d[:, idx]


def coeff_from_d(Df, Dp, T):
    """Coefficients (m, 3, 6) from the optimizer derivative vector.

    Reference: getCoefficientFromDerivative (grad_traj_optimizer.cpp:
    253-279): coeff = L @ [df; dp] per axis.  Here: gather d into the
    per-segment 6-stack, then one batched 6x6 matmul.
    """
    T = jnp.asarray(T)
    m = T.shape[0]
    D = stacked_derivatives(Df, Dp, m)  # (3, 6m)
    ainv = poly.segment_ainv(T)  # (m, 6, 6)
    Dseg = D.reshape(3, m, 6)
    return _einsum("sjb,xsb->sxj", ainv, Dseg)


def kino_coeff(pos, vel, acc, T):
    """Pure Hermite interpolation coefficients from kino states.

    Reference: PolyKinoGeneration (qp_generator.cpp:23-154) — P = A^-1 D,
    no energy minimization (its ``type`` argument is ignored).
    """
    Df, Dp = kino_d(pos, vel, acc)
    return coeff_from_d(Df, Dp, jnp.asarray(T))


# ---------------------------------------------------------------------------
# Full min-snap seeding (reference PolyQPGeneration type 1)
# ---------------------------------------------------------------------------


def min_snap_coeff(waypoints, start_vel, start_acc, end_vel, end_acc, T):
    """Minimum-snap trajectory through waypoints, free interior vel/acc.

    Rebuild of PolyQPGeneration type 1 (qp_generator.cpp:242-315): fix all
    waypoint positions + start/end vel/acc, solve the free interior
    vel/acc from the unconstrained QP optimality condition
    ``dp = -Rpp^-1 Rfp^T df``.

    Args:
      waypoints: (m+1, 3); T: (m,).
    Returns:
      coeff (m, 3, 6) ascending powers.
    """
    wp = jnp.asarray(waypoints)
    T = jnp.asarray(T, dtype=wp.dtype)
    m = T.shape[0]
    num_f = 2 * m + 4
    num_p = 2 * m - 2

    idx = minsnap_dmap(m)
    ct = np.zeros((6 * m, num_f + num_p), dtype=np.float64)
    ct[np.arange(6 * m), idx] = 1.0
    ct_seg = jnp.asarray(ct, dtype=wp.dtype).reshape(m, 6, num_f + num_p)

    msnap = poly.segment_snap_form(T)
    R = _einsum("spa,spq,sqb->ab", ct_seg, msnap, ct_seg)
    Rpp = R[num_f:, num_f:]
    Rfp = R[:num_f, num_f:]

    # fixed derivative values df per axis: [p0, v0, a0, p_end_of_seg0,
    # (p_start_s, p_end_s) s=1..m-1, v_end, a_end]
    sv = jnp.asarray(start_vel, dtype=wp.dtype)
    sa = jnp.asarray(start_acc, dtype=wp.dtype)
    ev = jnp.asarray(end_vel, dtype=wp.dtype)
    ea = jnp.asarray(end_acc, dtype=wp.dtype)

    pos_cols = []
    pos_cols.append(wp[0])  # d0
    pos_cols.append(sv)  # d1
    pos_cols.append(sa)  # d2
    pos_cols.append(wp[1])  # d3: seg0 end position
    for s in range(1, m):
        pos_cols.append(wp[s])  # start position of segment s
        pos_cols.append(wp[s + 1])  # end position of segment s
    pos_cols.append(ev)  # d_{2m+2}
    pos_cols.append(ea)  # d_{2m+3}
    df = jnp.stack(pos_cols, axis=1)  # (3, 2m+4)

    # dp = -(Rpp^-1 Rfp^T) df  per axis — Jacobi-equilibrated for f32
    diag = jnp.sqrt(jnp.clip(jnp.diagonal(Rpp), 1e-30))
    s_inv = 1.0 / diag
    rpp_s = Rpp * s_inv[:, None] * s_inv[None, :]
    rhs = -_einsum("xf,fp->xp", df, Rfp) * s_inv[None, :]  # (3, num_p)
    # one factorization, 3 RHS columns (the axes share the same Rpp)
    dp = jnp.linalg.solve(rpp_s, rhs.T).T * s_inv[None, :]

    d = jnp.concatenate([df, dp], axis=1)  # (3, 4m+2)
    D = d[:, jnp.asarray(idx)]  # (3, 6m)
    ainv = poly.segment_ainv(T)
    return _einsum("sjb,xsb->sxj", ainv, D.reshape(3, m, 6))


# ---------------------------------------------------------------------------
# Time allocation
# ---------------------------------------------------------------------------


def allocate_times(waypoints, mean_v: float, init_time: float):
    """Segment-time heuristic: length / mean_v, + init_time on the first
    segment only.

    Replicates grad_traj_optimizer.cpp:73-81 including its quirk: the
    intended tail special-case ``i == segment_time.size()`` is never true,
    so only segment 0 receives init_time.
    """
    wp = jnp.asarray(waypoints)
    seg_len = jnp.linalg.norm(wp[1:] - wp[:-1], axis=-1)
    t = seg_len / mean_v
    return t.at[0].add(init_time)
