"""Kinodynamic trajectory search, shaped for a batched accelerator.

Rebuild of the reference ``KinodynamicAstar`` (kinodynamic_astar.{h,cpp})
and the kinodynamic parts of ``HybridAStarPathFinder``.  The math ports
one-to-one (closed-form state transit, Pontryagin heuristic via exact
cubic/quartic root formulas, one-shot cubic connection); the *container*
does not: a sequential priority queue with hash dedup is the wrong shape
for a data-parallel device, so the search is a **fixed-iteration batched
beam search**:

* every iteration expands the whole beam by the full acceleration-
  primitive set simultaneously (the reference's 5^3 inputs x durations,
  kinodynamic_astar.cpp:133-143, evaluated as one tensor op),
* feasibility (map bounds, velocity limits, collision along the primitive,
  kinodynamic_astar.cpp:157-213) becomes masks,
* selection dedups candidates by voxel (best-f per cell: within-parent
  lexsorts, a top-k pre-cut, one small global lexsort) — the batched
  analogue of the reference's NodeHashTable pruning
  (kinodynamic_astar.cpp:168-175, 223-259), which keeps the beam
  spatially diverse,
* termination = any beam state whose one-shot cubic to the goal is
  collision-free (computeShotTraj, kinodynamic_astar.cpp:386-451).

The output is knot states (Pos, Vel, Acc, Time) ready for the Hermite
seeding (core.qp.kino_coeff), exactly like the reference's
getKinoTrajMat (kinodynamic_astar.cpp:753-817) feeds PolyKinoGeneration.
The parity gate is on the *final optimized* trajectory (SURVEY.md sec. 7):
the beam search lands in the same homotopy class, the back-end does the
polishing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from grad_traj_optimization_tpu.fields import sdf

_NAN = jnp.nan


# ---------------------------------------------------------------------------
# Closed-form primitive math (exact ports)
# ---------------------------------------------------------------------------


def state_transit(state, u, tau):
    """Double-integrator closed form (kinodynamic_astar.cpp:740-751).

    state: (..., 6) = [p, v]; u: (..., 3); tau: (...,).
    """
    p = state[..., :3]
    v = state[..., 3:]
    tau = jnp.asarray(tau)[..., None]
    p1 = p + v * tau + 0.5 * u * tau**2
    v1 = v + u * tau
    return jnp.concatenate([p1, v1], axis=-1)


#: f32 cbrt exponent bit-trick seed (fit: /tmp-derived, max rel err
#: 3.2e-2 pre-refinement, 2.4e-7 after two Halley steps — the f32
#: rounding floor)
_CBRT_MAGIC = np.int32(709953000)

#: degree-12 monomial coefficients (ascending, in t = 2 s - 1 with
#: s = sqrt((1 + x) / 2)) of cos(arccos(x) / 3) on [-1, 1].  The
#: substitution makes the target analytic on the fit interval (the
#: raw function has a sqrt branch point at x = -1), so a modest-degree
#: Chebyshev fit reaches 1.6e-12 (f64) / 6.6e-8 (f32 Horner).
_COSACOS3_COEF = (
    7.66044443e-01, 2.47409066e-01, -1.55091884e-02, 2.46635329e-03,
    -5.04125005e-04, 1.16421674e-04, -2.89180781e-05, 7.55379954e-06,
    -2.04107582e-06, 5.43584535e-07, -1.52150101e-07, 6.13416383e-08,
    -1.83928907e-08,
)


def _fast_cbrt(v):
    """Branchless f32 cbrt without exp/log transcendentals: exponent
    bit-trick seed + two division-based Halley steps (cubic
    convergence), max rel err 2.4e-7 over |v| in [1e-20, 1e20].

    ``jnp.cbrt`` lowers through pow -> exp/log chains; this replaces
    them with integer ops + two divides.  Zero maps to
    zero; NaN propagates.
    """
    a = jnp.abs(v).astype(jnp.float32)
    i = jax.lax.bitcast_convert_type(a, jnp.int32)
    y = jax.lax.bitcast_convert_type(i // 3 + _CBRT_MAGIC, jnp.float32)
    for _ in range(2):
        y3 = y * y * y
        y = y * (y3 + 2.0 * a) / (2.0 * y3 + a)
    out = jnp.where(a > 1e-35, y, 0.0)
    return jnp.sign(v) * out  # sign(NaN) = NaN keeps NaN in -> NaN out


def _cos_acos3(x):
    """cos(arccos(x)/3) on [-1, 1] without arccos/cos: a degree-12
    polynomial in t = 2 sqrt((1+x)/2) - 1 (see _COSACOS3_COEF)."""
    s = jnp.sqrt(jnp.maximum(0.5 * (1.0 + x), 0.0))
    t = 2.0 * s - 1.0
    acc = jnp.full_like(t, _COSACOS3_COEF[-1])
    for c in _COSACOS3_COEF[-2::-1]:
        acc = acc * t + c
    return acc


def cubic_roots(a, b, c, d, fast: bool = False):
    """Real roots of a x^3 + b x^2 + c x + d (up to 3, NaN-padded).

    Exact port of the trigonometric/Cardano formulas in
    kinodynamic_astar.cpp:453-486, branchless over the discriminant.

    ``fast=True`` replaces the transcendental chains (2x cbrt, arccos,
    3x cos) with the bit-trick cbrt and the cos(arccos/3) polynomial +
    the triple-angle quadratic factorization: the three D < 0 roots
    are the roots of 4 y^3 - 3 y = x, so given y0 = cos(arccos(x)/3)
    the other two are (-y0 -+ sqrt(3 (1 - y0^2))) / 2.  Root values
    move by ~1e-5 absolute near |x| = 1 (same order as the f32 input
    quantization of arccos there); consumers gate behaviorally.
    """
    a2 = b / a
    a1 = c / a
    a0 = d / a
    Q = (3 * a1 - a2 * a2) / 9.0
    R = (9 * a1 * a2 - 27 * a0 - 2 * a2**3) / 54.0
    D = Q**3 + R * R

    sqrtD = jnp.sqrt(jnp.maximum(D, 0.0))
    cbrt = _fast_cbrt if fast else jnp.cbrt
    S = cbrt(R + sqrtD)
    Tt = cbrt(R - sqrtD)
    r_pos = -a2 / 3 + (S + Tt)  # D > 0: single real root

    # D < 0: three real roots
    xx = jnp.clip(R / jnp.sqrt(jnp.maximum(-(Q**3), 1e-300)), -1.0, 1.0)
    sq = 2 * jnp.sqrt(jnp.maximum(-Q, 0.0))
    if fast:
        y0 = _cos_acos3(xx)
        sq3 = jnp.sqrt(jnp.maximum(3.0 * (1.0 - y0 * y0), 0.0))
        r0 = sq * y0 - a2 / 3
        r1 = sq * (-y0 - sq3) * 0.5 - a2 / 3
        r2 = sq * (-y0 + sq3) * 0.5 - a2 / 3
    else:
        theta = jnp.arccos(xx)
        r0 = sq * jnp.cos(theta / 3) - a2 / 3
        r1 = sq * jnp.cos((theta + 2 * jnp.pi) / 3) - a2 / 3
        r2 = sq * jnp.cos((theta + 4 * jnp.pi) / 3) - a2 / 3

    neg = D < 0
    root_a = jnp.where(neg, r0, r_pos)
    root_b = jnp.where(neg, r1, _NAN)
    root_c = jnp.where(neg, r2, _NAN)
    return jnp.stack([root_a, root_b, root_c], axis=-1)


def quartic_roots(a, b, c, d, e, fast: bool = False):
    """Real roots of a x^4 + ... + e (up to 4, NaN-padded).

    Exact port of the Ferrari resolvent in kinodynamic_astar.cpp:488-528
    (including using the *first* cubic root as y1).  ``fast`` selects
    the transcendental-free cubic resolvent (see :func:`cubic_roots`).
    """
    a3 = b / a
    a2 = c / a
    a1 = d / a
    a0 = e / a

    ys = cubic_roots(
        jnp.ones_like(a3), -a2, a1 * a3 - 4 * a0,
        4 * a2 * a0 - a1 * a1 - a3 * a3 * a0,
        fast=fast,
    )
    y1 = ys[..., 0]
    r = a3 * a3 / 4 - a2 + y1
    bad = r < 0

    R = jnp.sqrt(jnp.maximum(r, 0.0))
    safeR = jnp.where(R != 0, R, 1.0)
    Dsq_r = (
        0.75 * a3 * a3 - R * R - 2 * a2
        + 0.25 * (4 * a3 * a2 - 8 * a1 - a3**3) / safeR
    )
    Esq_r = (
        0.75 * a3 * a3 - R * R - 2 * a2
        - 0.25 * (4 * a3 * a2 - 8 * a1 - a3**3) / safeR
    )
    inner = jnp.sqrt(jnp.maximum(y1 * y1 - 4 * a0, 0.0))
    Dsq_0 = 0.75 * a3 * a3 - 2 * a2 + 2 * inner
    Esq_0 = 0.75 * a3 * a3 - 2 * a2 - 2 * inner
    Dsq = jnp.where(R != 0, Dsq_r, Dsq_0)
    Esq = jnp.where(R != 0, Esq_r, Esq_0)

    Dv = jnp.sqrt(Dsq)  # NaN when negative — matches the isnan() gate
    Ev = jnp.sqrt(Esq)
    roots = jnp.stack(
        [
            -a3 / 4 + R / 2 + Dv / 2,
            -a3 / 4 + R / 2 - Dv / 2,
            -a3 / 4 - R / 2 + Ev / 2,
            -a3 / 4 - R / 2 - Ev / 2,
        ],
        axis=-1,
    )
    return jnp.where(bad[..., None], _NAN, roots)


def estimate_heuristic(x1, x2, w_time: float, max_vel: float,
                       tie_breaker: float = 1.0 / 10000.0,
                       fast: bool = False):
    """Pontryagin-based admissible heuristic + optimal connection time.

    Exact port of kinodynamic_astar.cpp:348-384: minimize
    c(t) = -c1/(3t^3) - c2/(2t^2) - c3/t + w_time * t over the real roots
    of its derivative quartic and the velocity lower bound t_bar.

    ``fast`` uses the transcendental-free quartic solver (root values
    move ~1e-6 relative; the beam search gates this behaviorally —
    see :func:`search`'s ``heu``).

    x1, x2: (..., 6).  Returns (cost, t_opt) with shapes (...,).
    """
    dp = x2[..., :3] - x1[..., :3]
    v0 = x1[..., 3:]
    v1 = x2[..., 3:]

    c1 = -36.0 * jnp.sum(dp * dp, axis=-1)
    c2 = 24.0 * jnp.sum((v0 + v1) * dp, axis=-1)
    c3 = -4.0 * (
        jnp.sum(v0 * v0, axis=-1)
        + jnp.sum(v0 * v1, axis=-1)
        + jnp.sum(v1 * v1, axis=-1)
    )
    c4 = jnp.zeros_like(c1)
    c5 = jnp.full_like(c1, w_time)

    ts = quartic_roots(c5, c4, c3, c2, c1, fast=fast)  # (..., 4)
    t_bar = jnp.max(jnp.abs(dp), axis=-1) / max_vel
    cand = jnp.concatenate([ts, t_bar[..., None]], axis=-1)  # (..., 5)

    t = jnp.where(
        jnp.isnan(cand) | (cand < t_bar[..., None]), jnp.inf, cand
    )
    cost = (
        -c1[..., None] / (3 * t**3)
        - c2[..., None] / (2 * t * t)
        - c3[..., None] / t
        + w_time * t
    )
    cost = jnp.where(jnp.isfinite(t), cost, jnp.inf)
    # best = cost at argmin == the min itself (bitwise: ties and the
    # all-inf / NaN cases agree) — jnp.min avoids lowering an argmin +
    # element gather for the hot (beam * P * n_dur) call sites
    best = jnp.min(cost, axis=-1)
    k = jnp.argmin(cost, axis=-1)
    t_opt = jnp.take_along_axis(
        jnp.where(jnp.isfinite(t), t, t_bar[..., None]), k[..., None],
        axis=-1,
    )[..., 0]  # dead-code-eliminated by XLA when the caller drops t_opt
    return (1.0 + tie_breaker) * best, t_opt


def shot_coeffs(state1, state2, t_d):
    """Cubic one-shot connection coefficients (ascending powers, (...,3,4)).

    computeShotTraj coefficient block (kinodynamic_astar.cpp:393-404):
    p(t) = d + c t + b t^2 + a t^3 with the end state matched exactly.
    """
    p0 = state1[..., :3]
    dp = state2[..., :3] - p0
    v0 = state1[..., 3:]
    v1 = state2[..., 3:]
    dv = v1 - v0
    td = jnp.asarray(t_d)[..., None]
    a = (1.0 / 6.0) * (
        -12.0 / td**3 * (dp - v0 * td) + 6.0 / td**2 * dv
    )
    b = 0.5 * (6.0 / td**2 * (dp - v0 * td) - 2.0 / td * dv)
    return jnp.stack([p0, v0, b, a], axis=-1)  # (..., 3, 4)


def shot_feasible(state1, state2, t_d, dist_grid, origin, resolution,
                  margin: float, n_check: int = 10):
    """Collision/bounds sweep of the one-shot cubic
    (kinodynamic_astar.cpp:415-446: 10 samples, EDT > margin)."""
    coef = shot_coeffs(state1, state2, t_d)  # (..., 3, 4)
    td = jnp.asarray(t_d)
    ks = jnp.arange(1, n_check + 1, dtype=coef.dtype) / n_check
    ts = td[..., None] * ks  # (..., n_check)
    tp = ts[..., None] ** jnp.arange(4, dtype=coef.dtype)
    pos = jnp.einsum(
        "...kj,...xj->...kx", tp, coef, precision=jax.lax.Precision.HIGHEST
    )
    d = sdf.distance_at(dist_grid, origin, resolution, pos)
    return jnp.all(d > margin, axis=-1)


# ---------------------------------------------------------------------------
# Batched beam search
# ---------------------------------------------------------------------------


class KinoResult(NamedTuple):
    pos: jnp.ndarray     # (n_knots, 3) knot positions
    vel: jnp.ndarray     # (n_knots, 3)
    acc: jnp.ndarray     # (n_knots, 3)
    times: jnp.ndarray   # (n_knots - 1,) segment durations
    reached: jnp.ndarray  # () bool — one-shot to goal succeeded
    cost: jnp.ndarray    # () g-score of the selected leaf


def _primitive_set(max_acc: float, n_acc: int = 5):
    """The reference input set: n_acc^3 accelerations with z halved
    (kinodynamic_astar.cpp:133-139: um << ax, ay, 0.5 * az)."""
    lin = np.linspace(-max_acc, max_acc, n_acc)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    g = g.reshape(-1, 3)
    g[:, 2] *= 0.5
    return g.astype(np.float32)


def search(
    dist_grid,
    origin,
    resolution,
    start_state,
    goal_state,
    obstacle_pred=None,
    start_time: float = 0.0,
    max_acc: float = 2.0,
    max_vel: float = 3.0,
    max_tau: float = 0.5,
    w_time: float = 10.0,
    lambda_heu: float = 5.0,
    margin: float = 0.2,
    max_iters: int = 30,
    beam: int = 64,
    n_acc: int = 5,
    n_dur: int = 2,
    check_num: int = 5,
    max_knots: int = 32,
    dedup: str = "exact512",
    heu: str = "exact",
) -> KinoResult:
    """Beam kinodynamic search (see :func:`_search_impl`).

    ``dedup``: beam-selection voxel dedup formulation.  The default
    "exact512" runs the SORT-PAYLOAD form (variadic stable lax.sort
    carrying f-values + source indices, static slices) with a 512
    pre-cut; "exact" = the provable beam^2 pre-cut; "lex<K>" = the
    legacy lexsort+gather formulation (bitwise-identical selections —
    kept for the CI equivalence test);
    "approx<K>" (lax.approx_max_k pre-cut) and "pp<K>" (per-parent
    top-K) are measured non-winners; "parent" skips the global stage
    (fastest, reach regression on crowded corridors).

    ``heu``: "exact" (reference transcendental quartic) or "fast"
    (polynomial cos(arccos/3) + bit-trick cbrt, ~1e-6 root movement,
    gate-verified; measured +0.6% — opt-in).
    """
    return _search_impl(
        dist_grid, origin, resolution, start_state, goal_state,
        obstacle_pred, start_time,
        max_acc=max_acc, max_vel=max_vel, max_tau=max_tau,
        w_time=w_time, lambda_heu=lambda_heu, margin=margin,
        max_iters=max_iters, beam=beam, n_acc=n_acc, n_dur=n_dur,
        check_num=check_num, max_knots=max_knots, dedup=dedup, heu=heu,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_acc", "max_vel", "max_tau", "w_time", "lambda_heu",
        "margin", "max_iters", "beam", "n_acc", "n_dur", "check_num",
        "max_knots", "dedup", "heu",
    ),
)
def _search_impl(
    dist_grid,
    origin,
    resolution,
    start_state,
    goal_state,
    obstacle_pred=None,
    start_time: float = 0.0,
    max_acc: float = 2.0,
    max_vel: float = 3.0,
    max_tau: float = 0.5,
    w_time: float = 10.0,
    lambda_heu: float = 5.0,
    margin: float = 0.2,
    max_iters: int = 30,
    beam: int = 64,
    n_acc: int = 5,
    n_dur: int = 2,
    check_num: int = 5,
    max_knots: int = 32,
    dedup: str = "exact512",
    heu: str = "exact",
) -> KinoResult:
    """Beam kinodynamic search from start_state to goal_state (both (6,)).

    When ``obstacle_pred`` (a search.predictor.ObjPrediction) is given,
    collision checks use the space-time oracle min(static EDT, predicted
    boxes at the node's absolute time) — the reference's ``dynamic`` mode
    (kinodynamic_astar.cpp:199-213 via evaluateCoarseEDT(pos, t)).

    Returns up to ``max_knots`` knot states along the best found branch
    (parents tracked per iteration), with the final knot the goal if the
    one-shot connection succeeded.  Termination is tracked every
    iteration (the reference stops as soon as the one-shot connects);
    primitives after the winning iteration come back with ZERO duration
    — consumers drop zero-time segments (replan._resample_knots does).

    Collision-sweep caveat (faithful to the reference): primitives are
    sampled ``check_num`` times (reference search/check_num = 5,
    compare22.launch:18; loop kinodynamic_astar.cpp:199-213), so with
    ``margin`` smaller than the map resolution a one-voxel-thin wall
    can slip between samples — in the reference exactly as here.
    Raise ``check_num`` (or keep margin >= resolution) when maps carry
    paper-thin obstacles.
    """
    dtype = jnp.float32
    prim = jnp.asarray(_primitive_set(max_acc, n_acc))  # (P, 3)
    P = prim.shape[0]
    taus = (jnp.arange(1, n_dur + 1, dtype=dtype) / n_dur) * max_tau

    origin = jnp.asarray(origin, dtype)
    res = jnp.asarray(resolution, dtype)
    start_state = jnp.asarray(start_state, dtype)
    goal_state = jnp.asarray(goal_state, dtype)

    big = jnp.asarray(1e18, dtype)

    # beam state
    states0 = jnp.tile(start_state[None], (beam, 1))
    g0 = jnp.full((beam,), big, dtype).at[0].set(0.0)
    t0 = jnp.full((beam,), jnp.asarray(start_time, dtype))
    # history: which (parent_slot, primitive, tau) produced each beam slot
    hist_parent0 = jnp.zeros((max_iters, beam), jnp.int32)
    hist_u0 = jnp.zeros((max_iters, beam, 3), dtype)
    hist_tau0 = jnp.zeros((max_iters, beam), dtype)

    def shot_total(states_b, g_b):
        """Best-case total (g + shot-feasible h) per beam slot.

        The reference's 10-sample shot sweep (computeShotTraj) is safe
        only for the short near-goal shots it fires; termination here
        may shoot from anywhere, so the sweep is densified (32 samples:
        <= ~0.3 m spacing at horizon-scale shots — matches the primitive
        sweep's density) or thin walls slip between samples.
        """
        h_b, t_sh = estimate_heuristic(states_b, goal_state, w_time,
                                       max_vel)
        t_hold = jnp.maximum(t_sh, 1e-2)
        feas_b = shot_feasible(
            states_b, goal_state, t_hold, dist_grid,
            origin, res, margin, n_check=32,
        )
        return g_b + jnp.where(feas_b, h_b, 0.5 * big), t_sh

    def body(it, carry):
        states, g, tcur, hp, hu, ht, best = carry
        # expand: (beam, P, n_dur, 6)
        cand = state_transit(
            states[:, None, None, :],
            prim[None, :, None, :],
            taus[None, None, :],
        )
        gc = (
            g[:, None, None]
            + (jnp.sum(prim**2, axis=-1)[None, :, None] + w_time)
            * taus[None, None, :]
        )

        # feasibility masks (kinodynamic_astar.cpp:157-213)
        p = cand[..., :3]
        v = cand[..., 3:]
        size = jnp.asarray(dist_grid.shape, dtype) * res
        in_map = jnp.all(
            (p > origin + 1e-3) & (p < origin + size - 1e-3), axis=-1
        )
        vel_ok = jnp.all(jnp.abs(v) <= max_vel, axis=-1)
        ks = jnp.arange(1, check_num + 1, dtype=dtype) / check_num
        nd = taus.shape[0]
        N = beam * P * nd

        def vox_key(pos_c):
            vox = jnp.floor((pos_c - origin) / res).astype(jnp.int32)
            vox = jnp.clip(vox, 0, jnp.asarray(dist_grid.shape) - 1)
            return (
                vox[..., 0] * dist_grid.shape[1] + vox[..., 1]
            ) * dist_grid.shape[2] + vox[..., 2]

        # collision sweep along each primitive
        sweep = state_transit(
            states[:, None, None, None, :],
            prim[None, :, None, None, :],
            (taus[None, None, :, None] * ks[None, None, None, :]),
        )[..., :3]
        d_st = sdf.distance_at(dist_grid, origin, res, sweep)
        safe_sweep = d_st > margin
        if obstacle_pred is not None:
            from grad_traj_optimization_tpu.fields import (
                dynamic as _dyn,
            )

            t_samp = (
                tcur[:, None, None, None]
                + taus[None, None, :, None] * ks[None, None, None, :]
            )
            d_box = _dyn.dist_to_boxes(sweep, t_samp, obstacle_pred)
            safe_sweep = safe_sweep & (
                jnp.min(d_box, axis=-1) > margin
            )
        no_col = jnp.all(safe_sweep, axis=-1)

        ok = in_map & vel_ok & no_col
        gc = jnp.where(ok, gc, big)

        # the hot call (beam * P * n_dur states per iteration):
        # heu="fast" swaps the quartic's transcendental chains for the
        # polynomial/bit-trick solvers (~1e-6 relative root movement,
        # gated behaviorally on the 100-case oracle suite).
        # shot_total's per-beam call stays exact — it is 250x smaller
        # and its t feeds the OUTPUT segment times.
        h, _ = estimate_heuristic(
            cand, goal_state, w_time, max_vel,
            fast=(heu == "fast"),
        )
        f = gc + lambda_heu * jnp.where(jnp.isfinite(h), h, 0.0)
        f = jnp.where(ok, f, big)

        # select the next beam with voxel dedup: keep only the best-f
        # candidate per occupied voxel, then top-k over distinct
        # voxels.  This is the batched analogue of the reference's
        # NodeHashTable dedup + same-voxel pruning (kinodynamic_astar.
        # cpp:168-175, 223-259) and is what keeps the beam spatially
        # diverse — a plain top-k fills the beam with near-duplicates
        # of the greediest lineage, which then dies collectively at
        # the first trap.
        #
        # EXACT two-stage formulation without a global 16k-key lexsort:
        #  1. within-parent pairwise dedup caps per-voxel duplication
        #     at `beam` (one survivor per parent per voxel);
        #  2. therefore the global best-per-voxel winners of at least
        #     `beam` distinct voxels lie inside the top beam^2
        #     candidates by f, and a pairwise dedup + top-k there
        #     reproduces the full global dedup's beam EXACTLY.
        keys = vox_key(cand[..., :3]).reshape(beam, P * nd)
        f_pp = f.reshape(beam, P * nd)
        if dedup.startswith("lex"):
            # pre-round-5 stage-1 formulation, kept as the test
            # reference: jnp.lexsort returns a PERMUTATION, so
            # every consumer pays a take_along_axis GATHER over the
            # (beam, P*nd) rows — 2 x 16k gathered elements per
            # iteration.
            order1 = jnp.lexsort((f_pp, keys), axis=-1)
            ks1 = jnp.take_along_axis(keys, order1, axis=-1)
            f1s = jnp.take_along_axis(f_pp, order1, axis=-1)
            src1 = order1
        else:
            # stage 1 (round 5): ONE variadic lax.sort carries the
            # f values and source positions THROUGH the sorting
            # network as payload operands — same (voxel, f) stable
            # order as the lexsort, zero post-sort gathers.
            iota1 = jnp.broadcast_to(
                jnp.arange(P * nd, dtype=jnp.int32), (beam, P * nd)
            )
            ks1, f1s, src1 = jax.lax.sort(
                (keys, f_pp, iota1), dimension=-1, num_keys=2,
                is_stable=True,
            )
        # per-parent best-per-voxel: caps per-voxel duplication at
        # `beam` (one survivor per parent per voxel)
        first1 = jnp.concatenate(
            [
                jnp.ones((beam, 1), bool),
                ks1[:, 1:] != ks1[:, :-1],
            ],
            axis=1,
        )
        f_s1 = jnp.where(first1, f1s, big)
        gidx1 = (
            src1
            + jnp.arange(beam, dtype=src1.dtype)[:, None] * (P * nd)
        )

        def dedup_epilogue(fK, hK, oidx):
            """Shared pre-cut epilogue for the lex/approx/pp arms:
            lexsort by (voxel, f) -> first-occurrence dedup mask ->
            top-k -> source indices.  (The default exact<K> path
            uses the gather-free sort-payload formulation instead.)
            """
            order2 = jnp.lexsort((fK, hK))
            hs2 = hK[order2]
            first2 = jnp.concatenate(
                [jnp.ones(1, bool), hs2[1:] != hs2[:-1]]
            )
            f_dd = jnp.where(first2, fK[order2], big)
            _, sel2 = jax.lax.top_k(-f_dd, beam)
            return oidx[order2[sel2]]

        if dedup.startswith("exact"):
            # stage 2 (round-5 sort-payload form): with duplication
            # <= beam, every voxel-winner that can reach the final
            # beam lies in the top beam^2 by f ("exact<K>" caps the
            # pre-cut at K: heuristic below beam^2, exact above).
            # All three selections are variadic stable sorts +
            # STATIC slices, so sorting WITH payloads deletes every
            # post-selection gather.  Order matches
            # the lex formulation bitwise: top_k ties break by
            # ascending index == stable ascending sort by f.
            k_pre = min(N, int(dedup[5:]) if dedup[5:] else
                        beam * beam)
            fK, hK, oidx = jax.lax.sort(
                (f_s1.reshape(N), ks1.reshape(N), gidx1.reshape(N)),
                num_keys=1, is_stable=True,
            )
            fK, hK, oidx = fK[:k_pre], hK[:k_pre], oidx[:k_pre]
            hs2, fs2, o2 = jax.lax.sort(
                (hK, fK, oidx), num_keys=2, is_stable=True
            )
            first2 = jnp.concatenate(
                [jnp.ones(1, bool), hs2[1:] != hs2[:-1]]
            )
            f_dd = jnp.where(first2, fs2, big)
            _, idx_s = jax.lax.sort(
                (f_dd, o2), num_keys=1, is_stable=True
            )
            idx = idx_s[:beam]
        elif dedup.startswith("lex"):
            # pre-round-5 stage 2: top_k + index gathers
            k_pre = min(N, int(dedup[3:]) if dedup[3:] else
                        beam * beam)
            negf, pre = jax.lax.top_k(-f_s1.reshape(N), k_pre)
            fK = -negf
            oidx = gidx1.reshape(N)[pre]
            hK = vox_key(cand.reshape(N, 6)[oidx, :3])
            idx = dedup_epilogue(fK, hK, oidx)
        elif dedup.startswith("approx"):
            # "approx<K>" (round 5): exact512's global pre-cut,
            # but via lax.approx_max_k (an approximate top-k with
            # recall 0.95).  The K-cut is already heuristic below beam^2
            # (exact512's own compromise), so a recall-0.95
            # selection only perturbs marginal candidates; gated
            # behaviorally like every dedup arm.  Everything after
            # the cut (512-lexsort dedup + exact top-k) unchanged.
            k_pre = min(N, int(dedup[6:]) if dedup[6:] else 512)
            negf, pre = jax.lax.approx_max_k(
                -f_s1.reshape(N), k_pre
            )
            fK = -negf
            oidx = gidx1.reshape(N)[pre]
            hK = vox_key(cand.reshape(N, 6)[oidx, :3])
            idx = dedup_epilogue(fK, hK, oidx)
        elif dedup.startswith("pp"):
            # "pp<K>" (round 5): PER-PARENT top-K pre-cut: a
            # per-ROW top-k over the (beam, P*nd) stage-1 survivors
            # is a small batched last-axis sort instead of the
            # global top_k(N).  Guarantee:
            # every parent's K best distinct voxels reach the
            # global stage (a final-beam winner provably lies in
            # its parent's top-`beam`, so "pp64" is EXACT; smaller
            # K STARVES the beam while few parents are feasible —
            # iteration 0 has ONE finite-g parent, so pp8 fills
            # only 8 distinct slots vs exact512's 64 (measured
            # 4.8x worse seed g on a fixture case).  Opt-in for
            # k >= beam only; prefer "approx<K>" for throughput.
            # The key/index lookups ride take_along_axis over the
            # already-sorted per-parent rows — no big gathers.
            k_pp = min(P * nd, int(dedup[2:]) if dedup[2:] else 8)
            negv, ppos = jax.lax.top_k(-f_s1, k_pp)  # rows
            fK = (-negv).reshape(-1)
            hK = jnp.take_along_axis(ks1, ppos, axis=-1).reshape(-1)
            oidx = jnp.take_along_axis(
                gidx1, ppos, axis=-1
            ).reshape(-1)
            idx = dedup_epilogue(fK, hK, oidx)
        else:
            # "parent": stop after the within-parent dedup.
            # Faster than "exact" BUT a real reach regression on
            # hard maps (736/1024 vs 945/1024 on the bench
            # scenarios):
            # cross-parent same-voxel duplicates eat beam slots
            # exactly when parents crowd a corridor.  Kept as an
            # opt-in throughput lever only.
            _, pos2 = jax.lax.top_k(-f_s1.reshape(N), beam)
            idx = gidx1.reshape(N)[pos2]
        new_states = cand.reshape(N, 6)[idx]
        new_g = gc.reshape(N)[idx]
        parent = idx // (P * nd)
        rem = idx % (P * nd)
        u_sel = prim[rem // nd]
        tau_sel = taus[rem % nd]

        hp = hp.at[it].set(parent)
        hu = hu.at[it].set(u_sel)
        ht = ht.at[it].set(tau_sel)
        new_t = tcur[parent] + tau_sel

        # early-termination tracking (the reference stops as soon as the
        # one-shot connects, kinodynamic_astar.cpp:86-117; a fixed-trip
        # fori_loop can't break, so track the best shot-feasible leaf
        # over ALL iterations and mask the junk tail at backtrack time —
        # otherwise every branch carries max_iters primitives of
        # near-goal wandering, roughly doubling the seed's flight time)
        total_it, t_sh_it = shot_total(new_states, new_g)
        slot_it = jnp.argmin(total_it)
        best_total, best_it, best_slot, best_tshot, best_g = best
        better = total_it[slot_it] < best_total
        best = (
            jnp.where(better, total_it[slot_it], best_total),
            jnp.where(better, it, best_it),
            jnp.where(better, slot_it, best_slot),
            jnp.where(better, t_sh_it[slot_it], best_tshot),
            jnp.where(better, new_g[slot_it], best_g),
        )
        return new_states, new_g, new_t, hp, hu, ht, best

    # the direct shot from the start state (zero primitives)
    total0_all, tsh0_all = shot_total(states0[:1], g0[:1])
    best0 = (
        total0_all[0], jnp.asarray(-1, jnp.int32),
        jnp.asarray(0, jnp.int32), tsh0_all[0], g0[0] * 0.0,
    )
    states, g, tcur, hp, hu, ht, best = jax.lax.fori_loop(
        0, max_iters, body,
        (states0, g0, t0, hist_parent0, hist_u0, hist_tau0, best0),
    )
    best_total, best_it, best_slot, t_shot_best, best_gv = best
    reached = best_total < 0.25 * big

    # ---- backtrack the branch: replay history from the best leaf,
    # masking iterations after it (they get u = 0, tau = 0 — consumers
    # drop zero-duration segments) ----
    def back(carry, it):
        slot = carry
        active = it <= best_it
        parent = jnp.where(active, hp[it, slot], slot)
        u = jnp.where(active, hu[it, slot], jnp.zeros(3, dtype))
        tau = jnp.where(active, ht[it, slot], jnp.asarray(0.0, dtype))
        return parent, (slot, u, tau)

    _, (slots, us, tds) = jax.lax.scan(
        back, best_slot, jnp.arange(max_iters - 1, -1, -1)
    )
    # reverse to forward order
    us = us[::-1]
    tds = tds[::-1]

    # forward-integrate the branch to knot states
    def fwd(carry, inp):
        st = carry
        u, tau = inp
        st2 = state_transit(st, u, tau)
        return st2, (st2, u, tau)

    _, (knots, accs, ktaus) = jax.lax.scan(fwd, start_state, (us, tds))

    pos = jnp.concatenate([start_state[None, :3], knots[:, :3]], axis=0)
    vel = jnp.concatenate([start_state[None, 3:], knots[:, 3:]], axis=0)
    acc = jnp.concatenate([accs, accs[-1:]], axis=0)
    # the masked post-termination tail (zero-duration duplicates of the
    # best leaf) sits between the real branch and the goal; rotate it to
    # the FRONT so the static keep-the-LAST trim below always discards
    # dupes before real knots (a traced roll — the dupe count depends on
    # best_it)
    n_masked = max_iters - 1 - best_it  # iterations after the best leaf
    pos = jnp.roll(pos, n_masked, axis=0)
    vel = jnp.roll(vel, n_masked, axis=0)
    acc = jnp.roll(acc, n_masked, axis=0)
    ktaus = jnp.roll(ktaus, n_masked, axis=0)
    # append the one-shot goal knot
    pos = jnp.concatenate([pos, goal_state[None, :3]], axis=0)
    vel = jnp.concatenate([vel, goal_state[None, 3:]], axis=0)
    acc = jnp.concatenate([acc, jnp.zeros((1, 3), dtype)], axis=0)
    times = jnp.concatenate(
        [ktaus, jnp.maximum(t_shot_best, 1e-2)[None]], axis=0
    )

    # trim/pad to max_knots (static): keep the LAST max_knots knots —
    # after the roll these are the real branch suffix + the goal
    k = pos.shape[0]
    if k > max_knots:
        pos = pos[k - max_knots :]
        vel = vel[k - max_knots :]
        acc = acc[k - max_knots :]
        times = times[k - max_knots :]
    return KinoResult(
        pos=pos, vel=vel, acc=acc, times=times, reached=reached,
        cost=best_gv,
    )


def search_adaptive(
    dist_grid, origin, resolution, start_state, goal_state,
    retries: int = 1, widen: float = 2.0, deepen: float = 1.5,
    beam: int = 64, max_iters: int = 30, **kw,
):
    """Beam search with adaptive widening on failure.

    The fixed-budget beam can miss narrow passages the exact A*
    threads (recorded: 96/100 vs the exact front-ends at beam=64,
    BEAM_VS_EXACT.md); before falling back to the host search, retry
    with a ``widen``x beam and ``deepen``x iterations — the batched
    expansion makes a wider beam cheap, and each retry
    shape compiles once.  Returns (KinoResult, n_retries_used).
    """
    res = search(
        dist_grid, origin, resolution, start_state, goal_state,
        beam=beam, max_iters=max_iters, **kw,
    )
    used = 0
    while not bool(res.reached) and used < retries:
        used += 1
        beam = int(round(beam * widen))
        max_iters = int(round(max_iters * deepen))
        res = search(
            dist_grid, origin, resolution, start_state, goal_state,
            beam=beam, max_iters=max_iters, **kw,
        )
    return res, used


def search_batch(
    dists,
    origins,
    resolution: float,
    starts,
    goals,
    obstacle_pred=None,
    start_times=None,
    **kw,
) -> KinoResult:
    """Batched beam search: one jitted program over B scenarios.

    The front-end counterpart of ``solver.solve_batch`` (the
    reference's compare2 loop runs one search per case,
    compare2.cpp:168-177; here the whole suite is one vmapped
    program).  Shares :func:`search`'s config via ``kw``.

    ``obstacle_pred`` (round 5): a predictor.ObjPrediction enables the
    reference's DYNAMIC mode at batch scale — every primitive sweep
    sample is additionally tested against the predicted moving boxes
    at its absolute node time (compare22's evaluateCoarseEDT oracle,
    kinodynamic_astar.cpp:199-213 / edt_environment.cpp:62-73).  Leaves
    may be per-scenario
    batched ((B, n_obj, ...)) or shared ((n_obj, ...)).
    ``start_times``: (B,) absolute search start times (the dynamic
    oracle is time-parametric); default zeros.

    Args:
      dists: (B, nx, ny, nz) distance fields (or (1, ...) shared).
      origins: (B, 3); resolution: shared static float.
      starts, goals: (B, 6) states.
    Returns:
      KinoResult with a leading batch axis on every field.
    """
    dists = jnp.asarray(dists)
    origins = jnp.asarray(origins, jnp.float32)
    starts = jnp.asarray(starts, jnp.float32)
    goals = jnp.asarray(goals, jnp.float32)
    # a (1, ...) dist is a SHARED map: vmap it with in_axes=None so the
    # grid is closed over once instead of materializing B full copies
    # in device memory
    shared = bool(dists.shape[0] == 1 and starts.shape[0] > 1)
    pred_axis = None
    if obstacle_pred is not None:
        pred_axis = 0 if obstacle_pred.poly.ndim == 4 else None
    if start_times is None:
        start_times = jnp.zeros((starts.shape[0],), jnp.float32)
    else:
        start_times = jnp.asarray(start_times, jnp.float32)

    return _search_batch_impl(
        dists, origins, jnp.asarray(resolution, jnp.float32), starts,
        goals, obstacle_pred, start_times, tuple(sorted(kw.items())),
        shared, pred_axis,
    )


@functools.partial(
    jax.jit,
    static_argnames=("skw", "shared", "pred_axis"),
)
def _search_batch_impl(dists, origins, resolution, starts, goals,
                       pred, start_times, skw,
                       shared=False, pred_axis=None):
    kw = dict(skw)

    def one(d, o, s, g, p, t0):
        return _search_impl(
            d, o, resolution, s, g, p, t0, **kw,
        )

    in_axes = (None if shared else 0, 0, 0, 0, pred_axis, 0)
    d = dists[0] if shared else dists
    return jax.vmap(one, in_axes=in_axes)(
        d, origins, starts, goals, pred, start_times
    )


def _retry_bucket(n: int, lo: int = 32) -> int:
    """Pad retry sub-batches to power-of-two buckets (bounded compile
    count across ticks with varying failure counts)."""
    b = lo
    while b < n:
        b *= 2
    return b


def search_batch_adaptive(
    dists,
    origins,
    resolution: float,
    starts,
    goals,
    obstacle_pred=None,
    start_times=None,
    retries: int = 1,
    widen: float = 2.0,
    deepen: float = 1.5,
    beam: int = 64,
    max_iters: int = 30,
    **kw,
) -> tuple[KinoResult, int, int]:
    """Batched beam search + BATCHED retry ladder over unreached lanes.

    The batch analogue of :func:`search_adaptive` (round-5 VERDICT
    item 2): after the base batch, the lanes whose search did not
    reach the goal are re-searched TOGETHER as one wider/deeper
    sub-batch (padded to a power-of-two bucket so repeated calls reuse
    compiled shapes), and their results scattered back.  At the
    bench's 945/1024 base reach this is one extra 128-lane program —
    the retry path of the 100/100 quality claim, now on the batched
    surface the pipeline bench actually runs.

    Returns (merged KinoResult, n_retried_lanes, retries_used).
    """
    dists = jnp.asarray(dists)
    res0 = search_batch(
        dists, origins, resolution, starts, goals,
        obstacle_pred=obstacle_pred, start_times=start_times,
        beam=beam, max_iters=max_iters, **kw,
    )
    pred_batched = (
        obstacle_pred is not None and obstacle_pred.poly.ndim == 4
    )
    origins = jnp.asarray(origins, jnp.float32)
    starts = jnp.asarray(starts, jnp.float32)
    goals = jnp.asarray(goals, jnp.float32)
    shared = dists.shape[0] == 1 and starts.shape[0] > 1
    out = res0
    used = 0
    n_retried = 0
    reached = np.asarray(out.reached)
    while used < retries and not reached.all():
        used += 1
        beam = int(round(beam * widen))
        max_iters = int(round(max_iters * deepen))
        idx = np.where(~reached)[0]
        n_retried = max(n_retried, len(idx))
        nb = min(_retry_bucket(len(idx)), starts.shape[0])
        pidx = np.concatenate(
            [idx, np.repeat(idx[-1:], nb - len(idx))]
        )
        sub = search_batch(
            dists if shared else dists[pidx], origins[pidx],
            resolution, starts[pidx], goals[pidx],
            obstacle_pred=(
                jax.tree.map(lambda x: x[pidx], obstacle_pred)
                if pred_batched else obstacle_pred
            ),
            start_times=(
                None if start_times is None
                else jnp.asarray(start_times, jnp.float32)[pidx]
            ),
            beam=beam, max_iters=max_iters, **kw,
        )
        ok = np.asarray(sub.reached)[: len(idx)]
        sel = idx[ok]
        if len(sel):
            sub_sel = jax.tree.map(
                lambda x: x[: len(idx)][ok], sub
            )
            # a deeper rung returns MORE knots (n_knots =
            # min(max_iters + 2, max_knots)); align by front-padding
            # the shallower side with zero-duration duplicates of its
            # first knot — the same leading-dupe convention the
            # backtrack roll produces, which every knot consumer
            # already handles
            out, sub_sel = _align_knot_counts(out, sub_sel)
            out = KinoResult(*(
                o.at[sel].set(s) for o, s in zip(out, sub_sel)
            ))
        reached = np.asarray(out.reached)
    return out, n_retried, used


def _align_knot_counts(a: KinoResult, b: KinoResult):
    """Front-pad the KinoResult with fewer knots (zero-duration dupes
    of its first knot) so both have equal knot-axis shapes."""

    def pad(r: KinoResult, k_to: int) -> KinoResult:
        m = k_to - r.pos.shape[1]
        if m <= 0:
            return r
        dup = lambda x: jnp.concatenate(
            [jnp.repeat(x[:, :1], m, axis=1), x], axis=1
        )
        return r._replace(
            pos=dup(r.pos), vel=dup(r.vel), acc=dup(r.acc),
            times=jnp.concatenate(
                [jnp.zeros(r.times.shape[:1] + (m,), r.times.dtype),
                 r.times], axis=1,
            ),
        )

    k = max(a.pos.shape[1], b.pos.shape[1])
    return pad(a, k), pad(b, k)


@functools.partial(jax.jit, static_argnames=("n",))
def resample_knots_batch(pos, vel, acc, times, n: int):
    """Jittable batched knot resampler: ``n`` uniformly-time-spaced
    knot states per lane, so every lane of a search batch feeds ONE
    fixed-shape back-end program (the traced analogue of
    replan._resample_knots).

    Every branch segment's position path is EXACTLY a cubic matched to
    its endpoint positions and velocities — constant-acceleration
    primitives are quadratics and the one-shot connection is the cubic
    of computeShotTraj (kinodynamic_astar.cpp:393-404) — so cubic
    Hermite interpolation between bracketing knots reconstructs the
    true branch geometry exactly at any time.  The beam's masked
    zero-duration prefix dupes collapse onto cum-time 0 and are never
    bracketed by a positive-length query.

    Args:
      pos/vel/acc: (B, K+1, 3); times: (B, K).
    Returns:
      (pos, vel, acc, times) with n knots / n-1 uniform segments per
      lane (acc is the Hermite second derivative at each knot).
    """
    pos = jnp.asarray(pos)
    times_ = jnp.asarray(times)

    def one(p, v, a, t):
        K = t.shape[0]
        ct = jnp.concatenate([jnp.zeros(1, t.dtype), jnp.cumsum(t)])
        # target times: long branches (>= n real knots) SNAP to whole
        # search knots (the host resampler's index-subsample semantics
        # — keeping the exact states the search certified through
        # gaps; uniform-time placement measured a clearance regression
        # on thin-gap maps at small refine budgets); short branches
        # use uniform TIME (index-space subdivision crammed knots into
        # the short segments of uneven branches, leaving ~0.1 s
        # segments whose T^5 quintic forms break f32)
        r = jnp.sum(t > 1e-9)  # real segments
        n_dup = (K - r).astype(jnp.int32)
        fi = jnp.round(
            jnp.linspace(0.0, 1.0, n) * r.astype(ct.dtype)
        ).astype(jnp.int32)
        t_knots = ct[jnp.clip(n_dup + fi, 0, K)]
        total = ct[-1]
        t_unif = jnp.linspace(0.0, total, n)
        targets = jnp.where(r >= n - 1, t_knots, t_unif)
        # bracketing segment: the segment whose start knot is the LAST
        # knot with ct <= target (ties pick the highest knot, skipping
        # zero-length segments); clip keeps t = total in segment K-1
        j = jnp.clip(
            jnp.sum(ct[None, :] <= targets[:, None] + 1e-9, axis=1) - 1,
            0, K - 1,
        ).astype(jnp.int32)
        Tj = jnp.maximum(t[j], 1e-9)
        s = jnp.clip((targets - ct[j]) / Tj, 0.0, 1.0)[:, None]
        p0, p1 = p[j], p[j + 1]
        v0 = v[j] * Tj[:, None]
        v1 = v[j + 1] * Tj[:, None]
        # cubic Hermite on [0, 1]
        h00 = 2 * s**3 - 3 * s**2 + 1
        h10 = s**3 - 2 * s**2 + s
        h01 = -2 * s**3 + 3 * s**2
        h11 = s**3 - s**2
        pk = h00 * p0 + h10 * v0 + h01 * p1 + h11 * v1
        d00 = 6 * s**2 - 6 * s
        d10 = 3 * s**2 - 4 * s + 1
        d01 = -d00
        d11 = 3 * s**2 - 2 * s
        vk = (d00 * p0 + d10 * v0 + d01 * p1 + d11 * v1) / Tj[:, None]
        g00 = 12 * s - 6
        g10 = 6 * s - 4
        g01 = -g00
        g11 = 6 * s - 2
        ak = (g00 * p0 + g10 * v0 + g01 * p1 + g11 * v1) / (
            Tj[:, None] ** 2
        )
        seg = jnp.maximum(jnp.diff(targets), 1e-2)
        return pk, vk, ak, seg

    return jax.vmap(one)(pos, jnp.asarray(vel), jnp.asarray(acc), times_)


def retime_knots(pos, vel, times, mode: str = "mean_v",
                 mean_v: float = 1.8, stretch: float = 1.0,
                 w_time: float = 10.0, max_vel: float = 3.0,
                 min_time: float = 1e-2):
    """Re-allocate segment durations over search knots before seeding.

    The beam's raw durations are its primitive taus (0.25/0.5 s) plus
    the shot time — a faster pace than the hybrid A*'s 1 s primitives,
    which buys flight time at the cost of the refined smoothness term
    (BEAM_VS_EXACT.md: penalty gm 1.13 but time gm 0.75 vs the hybrid
    seed).  Duration is free to change at seeding (PolyKinoGeneration
    takes Time as an input, qp_generator.cpp:23-154), so this re-walks
    the trade-off:

    * ``"search"`` — keep the search durations (reference setKinoPath
      semantics, grad_traj_optimizer.cpp:35-65);
    * ``"mean_v"`` — the reference's own waypoint-seeding rule
      T_s = len_s / mean_v (setPath, grad_traj_optimizer.cpp:67-81,
      without the first-segment init_time quirk);
    * ``"stretch"`` — scale the search durations by ``stretch``;
    * ``"pontryagin"`` — per-segment optimal connection time of the
      search's own cost (min over T of the Pontryagin double-
      integrator cost with time weight ``w_time``,
      kinodynamic_astar.cpp:348-384).

    Host-side (numpy in, numpy out); knots/segment counts unchanged.
    """
    import numpy as onp

    pos = onp.asarray(pos, onp.float64)
    times = onp.asarray(times, onp.float64)
    if mode == "search":
        return times
    if mode == "stretch":
        return onp.maximum(times * stretch, min_time)
    if mode == "mean_v":
        seg = onp.linalg.norm(onp.diff(pos, axis=0), axis=1)
        return onp.maximum(seg / mean_v, min_time)
    if mode == "pontryagin":
        vel = onp.asarray(vel, onp.float64)
        x = onp.concatenate([pos, vel], axis=1)
        _, t_opt = estimate_heuristic(
            jnp.asarray(x[:-1], jnp.float32), jnp.asarray(x[1:], jnp.float32),
            w_time, max_vel,
        )
        return onp.maximum(onp.asarray(t_opt, onp.float64), min_time)
    raise ValueError(f"unknown retime mode {mode!r}")


# ---------------------------------------------------------------------------
# Free-end-velocity one-shot (HybridAStarPathFinder variant)
# ---------------------------------------------------------------------------


def free_end_vel_shot(p0, p1, v0, max_vel: float = 3.0):
    """Minimum-acceleration cubic to a position goal with free end velocity.

    Exact port of HybridAStarPathFinder::getOptimalTime /
    getShotTrajectory (hybrid_astar.cpp:902-967): the optimal duration
    minimizes the acceleration integral 3 ||v0 T - dp||^2 / T^3 over the
    positive roots of its derivative quadratic
    3 v0.v0 T^2 - 12 dp.v0 T + 9 dp.dp, then is stretched per axis so the
    implied end velocity stays within (2.5/3) max_vel.

    Args:
      p0, p1, v0: (..., 3).
    Returns:
      (coef (..., 3, 4) ascending powers, T (...,), v1 (..., 3)).
    """
    p0 = jnp.asarray(p0)
    dp = jnp.asarray(p1) - p0
    v0 = jnp.asarray(v0)

    a = 3.0 * jnp.sum(v0 * v0, axis=-1)
    b = -12.0 * jnp.sum(dp * v0, axis=-1)
    c = 9.0 * jnp.sum(dp * dp, axis=-1)

    # quadratic roots (a can be 0 when starting at rest -> linear root)
    disc = b * b - 4 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    safe_a = jnp.where(jnp.abs(a) > 1e-12, a, 1.0)
    r1 = (-b + sq) / (2 * safe_a)
    r2 = (-b - sq) / (2 * safe_a)
    r_lin = jnp.where(jnp.abs(b) > 1e-12, -c / jnp.where(
        jnp.abs(b) > 1e-12, b, 1.0), jnp.inf)
    quad_ok = (jnp.abs(a) > 1e-12) & (disc >= 0)
    roots = jnp.stack(
        [
            jnp.where(quad_ok, r1, jnp.inf),
            jnp.where(quad_ok, r2, jnp.inf),
            jnp.where(jnp.abs(a) > 1e-12, jnp.inf, r_lin),
        ],
        axis=-1,
    )
    roots = jnp.where(roots > 0, roots, jnp.inf)

    def acc_cost_at(T):
        r = v0 * T[..., None] - dp
        return 3.0 * jnp.sum(r * r, axis=-1) / jnp.maximum(T, 1e-9) ** 3

    costs = jnp.stack(
        [
            jnp.where(
                jnp.isfinite(roots[..., i]),
                acc_cost_at(roots[..., i]),
                jnp.inf,
            )
            for i in range(3)
        ],
        axis=-1,
    )
    k = jnp.argmin(costs, axis=-1)
    T = jnp.take_along_axis(roots, k[..., None], axis=-1)[..., 0]
    # fallback duration when no positive root exists (degenerate dp = 0)
    T = jnp.where(jnp.isfinite(T), T, 1.0)

    # per-axis end-velocity feasibility stretch (hybrid_astar.cpp:942-948).
    # The reference evaluates ve ONCE from the pre-stretch T (:942), so
    # an axis-0 stretch does not change axis-1/2's trigger decisions.
    ve = v0 + 3 * (dp - v0 * T[..., None]) / (2 * T[..., None])
    for i in range(3):
        Tp = 3 * dp[..., i] / (2 * (max_vel + 0.5 * v0[..., i]))
        T = jnp.where((ve[..., i] > (2.5 / 3) * max_vel) & (Tp > T), Tp, T)

    v1 = v0 + 3 * (dp - v0 * T[..., None]) / (2 * T[..., None])
    Te = T[..., None]
    ca = -(dp - v0 * Te) / (2 * Te**3)
    cb = 3 * (dp - v0 * Te) / (2 * Te**2)
    coef = jnp.stack([p0, v0, cb, ca], axis=-1)  # (..., 3, 4)
    return coef, T, v1
