"""One-call batched planning pipeline: search -> seed -> raced refine.

The production composition of the framework's stages (the reference's
compare2 two-stage flow, compare2.cpp:168-321, at batch scale):

1. :func:`search.kinodynamic.search_batch_adaptive` — batched beam
   search with the wider/deeper retry ladder over unreached lanes
   (optionally a SECOND search arm with the hybrid A*'s 1 s primitives,
   the round-5 tail lever from BEAM_VS_EXACT.md);
2. :func:`search.kinodynamic.resample_knots_batch` — exact cubic-
   Hermite resample to one fixed knot shape;
3. :func:`solver.solve_kino_batch_race` — the seed-duration race
   (refine under each stretch, keep the per-lane winner by cost).

``host_fallback=True`` adds the exact host A* rung (native/gtop_core.cpp)
over the lanes the beam did not reach.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from grad_traj_optimization_tpu import native
from grad_traj_optimization_tpu import solver as solve_mod
from grad_traj_optimization_tpu.config import OptimizerConfig
from grad_traj_optimization_tpu.search import kinodynamic


@jax.jit
def _pack_safe_u8(d, margin):
    """Bit-pack the per-voxel safety boolean (d > margin) along z,
    8 voxels per byte, little bit-order (the inverse of numpy's
    ``unpackbits(..., bitorder="little")``).  The host fallback's
    exact A* only ever thresholds the field, so this is its whole
    information content at 1/32 the f32 transfer size."""
    safe = d > margin
    pad = (-d.shape[-1]) % 8
    safe = jnp.pad(safe, [(0, 0)] * (safe.ndim - 1) + [(0, pad)])
    b = safe.reshape(safe.shape[:-1] + (-1, 8)).astype(jnp.uint32)
    w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint32)
    return jnp.sum(b * w, axis=-1).astype(jnp.uint8)


@dataclasses.dataclass(frozen=True)
class PlanBatchResult:
    solution: solve_mod.Solution   # per-lane winner of the race
    search: kinodynamic.KinoResult  # merged (retry-included) search
    reached: np.ndarray            # (B,) search reached the goal
    ok: np.ndarray                 # (B,) reached AND refine converged
    n_retried: int                 # lanes re-searched by the ladder
    arm: np.ndarray | None         # (B,) 0 = base beam, 1 = long-tau
    n_host_fallback: int = 0       # lanes recovered by the exact A*


def plan_batch(
    dists,
    origins,
    resolution: float,
    starts,
    goals,
    obstacle_pred=None,
    start_times=None,
    cfg: OptimizerConfig = OptimizerConfig(),
    n_waypoints: int = 6,
    beam: int = 64,
    max_iters: int = 16,
    retries: int = 1,
    stretches: tuple[float, ...] = (1.0, 1.2),
    long_tau_arm: bool = False,
    max_tau: float = 0.5,
    host_fallback: bool = False,
    **search_kw,
) -> PlanBatchResult:
    """Plan a batch of missions end to end on device.

    Args mirror :func:`kinodynamic.search_batch_adaptive` plus the
    refine knobs; ``stretches`` races seed durations per lane
    (``(1.0,)`` disables the race), ``long_tau_arm`` adds a second
    search with 1 s primitives and keeps, per lane, the lower-cost
    refined arm (reached arms preferred).

    ``host_fallback=True`` runs the exact host A* over every lane the
    beam left unreached; it needs the native library and raises
    RuntimeError when that cannot be built or loaded.
    """
    if host_fallback:
        native.load()  # raises when the exact rung cannot run
    dists = jnp.asarray(dists)
    origins = jnp.asarray(origins, jnp.float32)
    B = np.shape(starts)[0]
    ress = jnp.full((B,), resolution, jnp.float32)
    origins_b = jnp.broadcast_to(origins, (B, 3)) if (
        origins.ndim == 1
    ) else origins

    def run_arm(mt):
        r, n_re, _ = kinodynamic.search_batch_adaptive(
            dists, origins_b, resolution, starts, goals,
            obstacle_pred=obstacle_pred, start_times=start_times,
            beam=beam, max_iters=max_iters, retries=retries,
            max_tau=mt, **search_kw,
        )
        p, v, a, t = kinodynamic.resample_knots_batch(
            r.pos, r.vel, r.acc, r.times, n_waypoints
        )
        sol = solve_mod.solve_kino_batch_race(
            dists, origins_b, ress, p, v, a, t,
            stretches=stretches, cfg=cfg,
        )
        return r, sol, n_re

    r0, s0, n_re = run_arm(max_tau)
    arm = None
    if long_tau_arm and abs(max_tau - 1.0) > 1e-6:
        r1, s1, _ = run_arm(1.0)
        # per-lane winner: reached AND finite-cost arms preferred,
        # then lower cost.  Keys must stay NaN-free — an additive
        # penalty (1e9 + NaN = NaN) would make every comparison False
        # and silently keep a broken base arm over a good long-tau one
        big = jnp.asarray(1e18, s0.cost.dtype)
        b_key = jnp.where(
            r0.reached & jnp.isfinite(s0.cost), s0.cost, big
        )
        l_key = jnp.where(
            r1.reached & jnp.isfinite(s1.cost), s1.cost, big
        )
        take = l_key < b_key

        def sel(x, y):
            t = take.reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.where(t, y, x)

        s0 = jax.tree.map(sel, s0, s1)
        # search results may differ in knot count between arms — align
        # before the same per-lane select
        r0a, r1a = kinodynamic._align_knot_counts(r0, r1)
        r0 = kinodynamic.KinoResult(*(
            sel(a, b) for a, b in zip(r0a, r1a)
        ))
        arm = np.asarray(take).astype(np.int32)

    reached = np.asarray(r0.reached)
    n_host = 0
    # the exact host A* validates against the STATIC field only —
    # with moving obstacles in play a "recovered" plan could cross a
    # predicted box's swept volume while reporting ok, so the rung is
    # skipped in dynamic mode (same caveat as replan's fallback_exact,
    # which re-checks dynamic clearance each tick)
    if host_fallback and obstacle_pred is None and not reached.all():
        # final rung of the production ladder (the harness/replan
        # via_fallback pattern, kinodynamic_astar.cpp:17-315 exact
        # algorithm): run the native host A* on each still-unreached
        # lane, refine the recovered seeds as one bucketed batch, and
        # scatter them back
        from grad_traj_optimization_tpu import replan

        idx = np.where(~reached)[0]
        shared = dists.shape[0] == 1
        # one device->host transfer of ONLY the needed lanes, BIT-
        # PACKED: the exact kino A* consumes the field exclusively
        # through `dist <= margin` threshold checks (gtop_core.cpp
        # k_dist_at/k_shot_ok callers :939/:1005/:1037 — no
        # trilinear, no distance values), so the rung ships the
        # boolean safety mask packed 8 voxels/byte (32x less than
        # f32) and expands it to a two-level {0, 10000} field on
        # host — search decisions bitwise-identical.
        margin = float(search_kw.get("margin", 0.2))
        kino_kw = {k: v for k, v in search_kw.items()
                   if k in ("max_acc", "max_vel", "w_time",
                            "lambda_heu")}
        sel_d = dists if shared else dists[jnp.asarray(idx)]
        nzv = dists.shape[-1]
        packed = np.asarray(_pack_safe_u8(sel_d, margin))
        safe = np.unpackbits(
            packed, axis=-1, bitorder="little"
        )[..., :nzv].astype(bool)
        dist_host = np.where(
            safe, np.float32(10000.0), np.float32(0.0)
        )
        ob = np.asarray(origins_b, np.float32)
        s_host = np.asarray(starts)
        g_host = np.asarray(goals)
        K = int(np.asarray(r0.pos).shape[1])

        def _host_search(j, i):
            d_i = dist_host[0] if shared else dist_host[j]
            fpos, fvel, facc, ftimes, f_ok = native.kino_search(
                d_i, ob[i], float(resolution),
                s_host[i].astype(np.float64),
                g_host[i].astype(np.float64),
                max_tau=max_tau, margin=margin, **kino_kw,
            )
            if f_ok and len(ftimes) >= 1:
                return replan._pad_knots_fixed(
                    fpos, fvel, facc, ftimes, k_to=K
                )
            return None

        # duplicate missions (e.g. a server's pad lanes replicate
        # the last request) search ONCE; the unique missions run
        # CONCURRENTLY — the engine holds no global state and the
        # ctypes call releases the GIL, so the rung scales with
        # host cores instead of serializing ~30 exact searches
        lane_key = {}
        uniq: dict = {}
        for j, i in enumerate(idx):
            mkey = (
                s_host[i].tobytes(), g_host[i].tobytes(),
                None if shared else int(i),
            )
            lane_key[int(i)] = mkey
            uniq.setdefault(mkey, (j, i))
        from concurrent.futures import ThreadPoolExecutor

        n_workers = min(8, len(uniq), os.cpu_count() or 1)
        with ThreadPoolExecutor(n_workers) as ex:
            futs = {
                mk: ex.submit(_host_search, j, i)
                for mk, (j, i) in uniq.items()
            }
            seen = {mk: f.result() for mk, f in futs.items()}
        rec_i, rec_knots = [], []
        for i in idx:
            cached = seen[lane_key[int(i)]]
            if cached is not None:
                rec_i.append(i)
                rec_knots.append(cached)
        if rec_i:
            n_host = len(rec_i)
            sel = np.asarray(rec_i)
            kp = np.stack([k[0] for k in rec_knots]).astype(
                np.float32
            )
            kv = np.stack([k[1] for k in rec_knots]).astype(
                np.float32
            )
            ka = np.stack([k[2] for k in rec_knots]).astype(
                np.float32
            )
            kt = np.stack([k[3] for k in rec_knots]).astype(
                np.float32
            )
            p, v, a, t = kinodynamic.resample_knots_batch(
                kp, kv, ka, kt, n_waypoints
            )
            s_f = solve_mod.solve_kino_batch_race(
                dists if shared else dists[sel], origins_b[sel],
                ress[sel], p, v, a, t, stretches=stretches,
                cfg=cfg,
            )
            s0 = solve_mod.Solution(*(
                o.at[sel].set(n) for o, n in zip(s0, s_f)
            ))
            r0 = kinodynamic.KinoResult(
                pos=r0.pos.at[sel].set(kp),
                vel=r0.vel.at[sel].set(kv),
                acc=r0.acc.at[sel].set(ka),
                times=r0.times.at[sel].set(kt),
                reached=r0.reached.at[sel].set(True),
                # the failed beam's g-score does not describe the
                # scattered-in native branch; inf marks it "not
                # comparable" without poisoning argmin consumers
                cost=r0.cost.at[sel].set(jnp.inf),
            )
            reached = np.asarray(r0.reached)
    ok = reached & (np.asarray(s0.status) == 0)
    return PlanBatchResult(
        solution=s0, search=r0, reached=reached, ok=ok,
        n_retried=int(n_re), arm=arm, n_host_fallback=n_host,
    )
