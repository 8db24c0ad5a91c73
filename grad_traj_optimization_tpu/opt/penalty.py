"""Penalty objective: smoothness + collision line integral.

Rebuild of ``GradTrajOptimizer::getCostAndGradient``
(grad_traj_optimizer.cpp:281-448) as pure batched tensor math:

* smoothness: ``f_s = sum_axis d^T R d`` with gradient
  ``2 Rfp^T df + 2 Rpp dp`` (:326-336);
* collision: line integral ``f_c = sum_s sum_k c(d(p(t_k))) ||v(t_k)|| dt_s``
  with ``c(d) = alpha * exp(-(d - d0)/r)`` (:345-409, :507-515), sampled at
  the reference's fixed 30 points per segment ``t = 1e-3 + k T_s/30``
  (:351-353).

All segments x samples evaluate in one batched matmul against the
precomputed sample-basis tensors; the SDF is touched through one fused
trilinear gather.  Two gradient formulas are provided:

* ``reference`` replicates the C++ exactly — including its quirks: the
  distance term carries an extra ``c(d)`` factor
  (:376-381 — the true derivative of the integrand would be
  ``g(d) grad_d ||v||`` without it), every gradient entry gets +1e-5
  (:428-432), and the cost gets +1e-3 (:417-418).  Matching the quirks
  matches the reference's descent direction, which is what parity against
  the C++ optimizer means.
* ``exact`` is the true analytic gradient of the sampled objective
  (computed in closed form, same tensor contraction — not autodiff).

The velocity/acceleration penalties (helpers grad_traj_optimizer.cpp:
517-535; usage block :382-407 commented out in the reference, weights
wv = wa = 1.0 fixed at :412) are implemented and gated by
``cfg.alpha_v`` / ``cfg.alpha_a``: the defaults of 0 reproduce the
reference's cost_vel = cost_acc = 0 exactly; nonzero scales (e.g. the
click.launch preset) enable them.  ``gradient_mode="reference"``
replicates the commented block faithfully, including its two quirks:
the |v| / |a| penalty "gradient" carries no sign factor (:521-526,
:533-535), and the second per-axis loop reuses the cv/ca values left
over from the LAST axis of the first loop (the z axis) in the
``c * v_k/||v||`` terms.  ``gradient_mode="exact"`` is the true
analytic gradient of the same sampled cost.  Like the collision term,
both are skipped when |wc| < 1e-4 (the reference breaks out of the
whole sampling loop, :346) and only active in step 2 (:385).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax as _lax


def _einsum(subscripts, *operands):
    """einsum pinned to full f32 precision (no TF32/bf16 passes)."""
    return jnp.einsum(subscripts, *operands, precision=_lax.Precision.HIGHEST)

from grad_traj_optimization_tpu.config import OptimizerConfig
from grad_traj_optimization_tpu.core import poly, qp
from grad_traj_optimization_tpu.fields import sdf


class Field(NamedTuple):
    """Flat distance-field handle.

    ``flat`` may concatenate many scenarios' grids; ``base`` selects this
    scenario's slab.  Keeping ``flat`` unbatched under vmap turns the
    batch's trilinear lookups into one large flat gather (see
    fields.sdf.trilinear_flat).  ``offset``/``full`` carry the exact-crop
    frame of a cropped grid (solver.crop_scenarios); None for a full
    grid.
    """

    flat: Any          # (total_voxels,)
    base: Any          # () int32 offset into flat
    origin: Any        # (3,)
    resolution: Any    # ()
    offset: Any = None  # (3,) int32 cell offset of the cropped window
    full: Any = None    # (3,) int32 extents of the uncropped map


def make_field(dist_grid, origin, resolution):
    """Field handle + static grid shape from a single (nx,ny,nz) grid."""
    return (
        Field(
            flat=dist_grid.reshape(-1),
            base=jnp.zeros((), jnp.int32),
            origin=jnp.asarray(origin),
            resolution=jnp.asarray(resolution),
        ),
        dist_grid.shape,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PenaltyCtx:
    """Per-scenario precomputation shared by every optimizer iteration."""

    T: Any          # (m,) segment times
    dep: qp.QPDep
    Df: Any         # (3, 6) fixed derivatives
    Tmat: Any       # (m, K, 6) position basis at sample times
    TVmat: Any      # (m, K, 6) velocity basis at sample times
    TL: Any         # (m, K, num_dp)  T(t) @ Ldp      (gradient chain)
    TVL: Any        # (m, K, num_dp)  T(t) @ V @ Ldp
    dt: Any         # (m,) integration step per segment
    TAmat: Any = None  # (m, K, 6) acceleration basis (alpha_a only)
    TAL: Any = None    # (m, K, num_dp)  T(t) @ V @ V @ Ldp (alpha_a only)


def build_ctx(T, Df, cfg: OptimizerConfig, dep: qp.QPDep | None = None):
    """Precompute sample bases and gradient chain tensors."""
    T = jnp.asarray(T)
    if dep is None:
        dep = qp.build_dep(T)
    K = cfg.n_samples
    k = jnp.arange(K, dtype=T.dtype)
    # t[s, k] = t_offset + k * T_s / K   (grad_traj_optimizer.cpp:351-353)
    ts = cfg.t_offset + k[None, :] * (T[:, None] / K)
    Tmat = poly.time_powers(ts)
    TVmat = poly.vel_powers(ts)
    TL = _einsum("mkj,mjd->mkd", Tmat, dep.Ldp)
    TVL = _einsum("mkj,mjd->mkd", TVmat, dep.Ldp)
    TAmat = TAL = None
    if cfg.alpha_a != 0.0:  # acceleration-penalty chains (T V V Ldp)
        TAmat = poly.acc_powers(ts)
        TAL = _einsum("mkj,mjd->mkd", TAmat, dep.Ldp)
    return PenaltyCtx(
        T=T, dep=dep, Df=jnp.asarray(Df), Tmat=Tmat, TVmat=TVmat,
        TL=TL, TVL=TVL, dt=T / K, TAmat=TAmat, TAL=TAL,
    )


def _va_weights(vel, acc, vn, cfg: OptimizerConfig):
    """Velocity/acceleration penalty costs and gradient-chain weights.

    Shapes: vel/acc (..., 3); vn (...,) = ||v|| + vel_eps.  Returns
    (cost_v, cost_a, w_tvl, w_tal) where cost_* are (...,) per-sample
    integrands (pre-dt) and w_tvl / w_tal are (..., 3) weights to
    contract against the TVL / TAL chains (pre-dt).  Implements the
    reference's commented usage block (grad_traj_optimizer.cpp:382-407,
    helpers :517-535) with wv = wa = 1 (:412); see the module docstring
    for the two reference-mode quirks replicated here.
    """
    ref = cfg.gradient_mode == "reference"
    zero = jnp.zeros_like(vel[..., 0])
    zero3 = jnp.zeros_like(vel)
    cost_v = cost_a = zero
    w_tvl = w_tal = zero3
    if cfg.alpha_v != 0.0:
        cv = cfg.alpha_v * jnp.exp((jnp.abs(vel) - cfg.v0) / cfg.r_v)
        gv = cv / cfg.r_v  # reference: no sign(v) factor (:521-526)
        cost_v = jnp.sum(cv, axis=-1) * vn
        if ref:
            # the stale-cv quirk: cv from the LAST axis (z) multiplies
            # every row's v_k/||v|| term (:382-407)
            cfac = cv[..., 2:3]
        else:
            gv = gv * jnp.sign(vel)
            cfac = jnp.sum(cv, axis=-1, keepdims=True)
        w_tvl = w_tvl + gv * vn[..., None] + cfac * vel / vn[..., None]
    if cfg.alpha_a != 0.0:
        ca = cfg.alpha_a * jnp.exp((jnp.abs(acc) - cfg.a0) / cfg.r_a)
        ga = ca / cfg.r_a  # reference: no sign(a) factor (:529-535)
        cost_a = jnp.sum(ca, axis=-1) * vn
        if ref:
            cafac = ca[..., 2:3]  # same stale-variable quirk
        else:
            ga = ga * jnp.sign(acc)
            cafac = jnp.sum(ca, axis=-1, keepdims=True)
        w_tal = ga * vn[..., None]
        w_tvl = w_tvl + cafac * vel / vn[..., None]
    return cost_v, cost_a, w_tvl, w_tal


def _sample_state(dp, ctx: PenaltyCtx):
    """Positions and velocities at every collision sample.

    Returns coeff (m,3,6), pos (m,K,3), vel (m,K,3).
    """
    coeff = qp.coeff_from_d(ctx.Df, dp, ctx.T)
    pos = _einsum("mkj,mxj->mkx", ctx.Tmat, coeff)
    vel = _einsum("mkj,mxj->mkx", ctx.TVmat, coeff)
    return coeff, pos, vel


def _smooth(dp, ctx: PenaltyCtx):
    d = jnp.concatenate([ctx.Df, dp], axis=1)  # (3, 3m+3)
    cost = _einsum("xa,ab,xb->", d, ctx.dep.R, d)
    grad = 2.0 * _einsum("xf,fd->xd", ctx.Df, ctx.dep.Rfp) + 2.0 * _einsum(
        "xp,pd->xd", dp, ctx.dep.Rpp
    )
    return cost, grad


def _collision_terms(pos, vel, field: Field, grid_shape,
                     cfg: OptimizerConfig):
    d, g = sdf.trilinear_flat(
        field.flat, field.base, grid_shape, field.origin,
        field.resolution, pos, offset=field.offset, full=field.full,
    )
    cd = cfg.alpha * jnp.exp(-(d - cfg.d0) / cfg.r)
    gd = -cd / cfg.r
    vn = jnp.linalg.norm(vel, axis=-1) + cfg.vel_eps
    return d, g, cd, gd, vn


def cost_and_grad(dp, ctx: PenaltyCtx, field: Field, grid_shape,
                  cfg: OptimizerConfig, step: int):
    """Total cost and gradient w.r.t. dp (3, num_dp).

    ``step`` follows the reference schedule: step 1 zeroes the smoothness
    weight (grad_traj_optimizer.cpp:413-415); step 2 is the full cost.
    """
    ws = 0.0 if step == 1 else cfg.w_smooth
    wc = cfg.w_collision

    cost_s, grad_s = _smooth(dp, ctx)

    if abs(wc) < 1e-4:  # reference skips the loop entirely (:346)
        cost = ws * cost_s + cfg.cost_eps
        grad = ws * grad_s
        if cfg.gradient_mode == "reference":
            grad = grad + cfg.grad_eps
        return cost, grad

    coeff, pos, vel = _sample_state(dp, ctx)
    d, g, cd, gd, vn = _collision_terms(pos, vel, field, grid_shape, cfg)

    cost_c = _einsum("mk,m->", cd * vn, ctx.dt)

    if cfg.gradient_mode == "reference":
        # grad_traj_optimizer.cpp:376-381 (incl. the extra cd factor)
        w_dist = gd * cd * vn  # (m, K)
    else:
        w_dist = gd * vn
    w1 = w_dist[..., None] * g  # (m, K, 3)
    w2 = (cd / vn)[..., None] * vel  # (m, K, 3)
    grad_c = _einsum("mkx,mkd,m->xd", w1, ctx.TL, ctx.dt) + _einsum("mkx,mkd,m->xd", w2, ctx.TVL, ctx.dt
    )

    cost = ws * cost_s + wc * cost_c + cfg.cost_eps
    grad = ws * grad_s + wc * grad_c
    # velocity/acceleration penalties (wv = wa = 1, step 2 only, :385,:412)
    if step == 2 and (cfg.alpha_v != 0.0 or cfg.alpha_a != 0.0):
        acc = (
            _einsum("mkj,mxj->mkx", ctx.TAmat, coeff)
            if cfg.alpha_a != 0.0 else None
        )
        cost_v, cost_a, w_tvl, w_tal = _va_weights(vel, acc, vn, cfg)
        cost = cost + _einsum("mk,m->", cost_v + cost_a, ctx.dt)
        grad = grad + _einsum("mkx,mkd,m->xd", w_tvl, ctx.TVL, ctx.dt)
        if cfg.alpha_a != 0.0:
            grad = grad + _einsum("mkx,mkd,m->xd", w_tal, ctx.TAL, ctx.dt)
    if cfg.gradient_mode == "reference":
        grad = grad + cfg.grad_eps  # :428-432
    return cost, grad


def cost_only(dp, ctx: PenaltyCtx, field: Field, grid_shape,
              cfg: OptimizerConfig, step: int):
    """Cost without the gradient chain (used by the step-acceptance test)."""
    ws = 0.0 if step == 1 else cfg.w_smooth
    wc = cfg.w_collision
    cost_s, _ = _smooth(dp, ctx)
    if abs(wc) < 1e-4:
        return ws * cost_s + cfg.cost_eps
    coeff, pos, vel = _sample_state(dp, ctx)
    _, _, cd, _, vn = _collision_terms(pos, vel, field, grid_shape, cfg)
    cost_c = _einsum("mk,m->", cd * vn, ctx.dt)
    cost = ws * cost_s + wc * cost_c + cfg.cost_eps
    if step == 2 and (cfg.alpha_v != 0.0 or cfg.alpha_a != 0.0):
        acc = (
            _einsum("mkj,mxj->mkx", ctx.TAmat, coeff)
            if cfg.alpha_a != 0.0 else None
        )
        cost_v, cost_a, _, _ = _va_weights(vel, acc, vn, cfg)
        cost = cost + _einsum("mk,m->", cost_v + cost_a, ctx.dt)
    return cost


def bounds(waypoints, num_dp: int, cfg: OptimizerConfig, dtype=jnp.float32,
           bos=None):
    """Box bounds on dp, axis-major (3, num_dp).

    Reference: grad_traj_optimizer.cpp:154-177 — position slots bounded
    within +-bos of the corresponding *initial interior waypoint*, velocity
    slots +-vos, acceleration slots +-aos.

    ``bos`` optionally overrides the scalar ``cfg.bos`` with a
    per-interior-waypoint half-width array (n_int,) — the consumer of a
    search corridor (e.g. RRT* safe-ball radii, the reference's
    path_finder.cpp:806-887 output) sets each waypoint's position box to
    its clearance radius so the optimum stays inside the safe tube.
    """
    wp = jnp.asarray(waypoints, dtype=dtype)
    n_int = num_dp // 3
    interior = wp[1 : 1 + n_int]  # (n_int, 3)
    center = jnp.zeros((n_int, 3, 3), dtype=dtype)
    center = center.at[:, 0, :].set(interior)  # slot 0: position
    center = jnp.transpose(center, (2, 0, 1)).reshape(3, num_dp)
    bos_arr = jnp.broadcast_to(
        jnp.asarray(cfg.bos if bos is None else bos, dtype=dtype), (n_int,)
    )
    half = jnp.stack(
        [
            bos_arr,
            jnp.full((n_int,), cfg.vos, dtype=dtype),
            jnp.full((n_int,), cfg.aos, dtype=dtype),
        ],
        axis=1,
    ).reshape(-1)
    return center - half[None, :], center + half[None, :]
