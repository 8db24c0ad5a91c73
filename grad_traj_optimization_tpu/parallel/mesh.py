"""Device-mesh scaling of the batched solver.

The reference is strictly single-core, single-process C++; its only IPC is
ROS pub/sub (SURVEY.md section 2).  Here distribution is first-class:

* axis ``"data"`` — scenarios.  The batched solve is embarrassingly
  parallel over scenarios, so sharding the leading axis of every Scenario
  leaf is enough: XLA partitions the whole vmapped program with zero
  communication (collectives appear only in reductions the caller asks
  for, e.g. fleet-wide convergence statistics via psum).
* axis ``"space"`` — the SDF voxel grid for pod-scale EDT builds
  (:mod:`grad_traj_optimization_tpu.parallel.edt_sharded`).

Multi-host: call :func:`init_distributed` first (jax.distributed), then
these helpers operate on the global mesh exactly as on one host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: int | None = None, n_space: int = 1,
              devices=None) -> Mesh:
    """A (data, space) mesh. Defaults to all visible devices on data."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_space
    devs = np.asarray(devices[: n_data * n_space]).reshape(n_data, n_space)
    return Mesh(devs, axis_names=("data", "space"))


def init_distributed(coordinator: str | None = None, num_processes=None,
                     process_id=None):
    """Multi-host bring-up (no-op if already initialized)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def shard_scenarios(scenarios, mesh: Mesh):
    """Place a Scenario batch with the leading axis split over "data"."""
    sharding = NamedSharding(mesh, P("data"))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), scenarios)


def global_scenarios(local_scenarios, mesh: Mesh):
    """Assemble a GLOBAL Scenario batch from per-process local shards.

    Multi-host entry point: each process passes the rows of the batch it
    owns (its slice along the leading axis, in process order) as host
    arrays; the result is a global jax.Array sharded over the mesh's
    "data" axis, usable with :func:`sharded_solve` exactly like a
    single-host batch.  (The reference has no distributed story at all —
    SURVEY.md §2; this is the jax.distributed replacement for its ROS
    pub/sub scatter of work.)
    """
    sharding = NamedSharding(mesh, P("data"))
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)
        ),
        local_scenarios,
    )


import functools


@functools.lru_cache(maxsize=None)
def _sharded_runner(mesh: Mesh, cfg, steps, record_trace):
    """Cached shard_map-wrapped solve.

    The wrapper MUST be built once per (mesh, cfg, steps, ...) and
    reused: a fresh closure per call defeats jax's compilation cache
    (function identity is part of the key), recompiling the whole
    program every invocation.
    """
    from grad_traj_optimization_tpu import solver as solve_mod

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P("data"),
        out_specs=P("data"),
        check_vma=False,
    )
    def run(scn):
        return solve_mod.solve_batch(
            scn, cfg=cfg, steps=steps, record_trace=record_trace
        )

    return run


def sharded_solve(scenarios, mesh: Mesh, cfg=None, steps=(2,),
                  record_trace=False):
    """Data-parallel batched solve over the mesh.

    ``scenarios`` leaves must have a leading batch axis divisible by the
    mesh's data-axis size.  Returns a Solution batch with the same
    sharding.

    Implemented with ``jax.shard_map`` rather than jit auto-partitioning:
    each device runs the full per-shard ``solve_batch`` program on its
    own scenarios, with no communication.
    """
    from grad_traj_optimization_tpu.config import OptimizerConfig

    if cfg is None:
        cfg = OptimizerConfig()
    scenarios = shard_scenarios(scenarios, mesh)
    run = _sharded_runner(mesh, cfg, tuple(steps), record_trace)
    return run(scenarios)


def convergence_stats(solution):
    """Fleet-wide convergence reductions (device-count independent).

    jnp reductions over a sharded Solution lower to psum/all-reduce
    collectives over the mesh — the batched analogue of the reference's
    printed per-solve counters (grad_traj_optimizer.cpp:233-239).
    """
    import jax.numpy as jnp

    ok = (solution.status == 0).astype(jnp.float32)
    return {
        "n_ok": jnp.sum(ok),
        "mean_cost": jnp.mean(solution.cost),
        "mean_accept": jnp.mean(solution.n_accept.astype(jnp.float32)),
    }


@functools.lru_cache(maxsize=None)
def _sharded_search_runner(mesh: Mesh, resolution: float, shared: bool,
                           pred_mode: str, skw):
    """Cached shard_map-wrapped batched beam search (round 5).

    Same caching contract as :func:`_sharded_runner` — a fresh closure
    per call would defeat the compilation cache.  ``shared`` replicates
    a leading-dim-1 distance grid instead of splitting it.
    ``pred_mode``: "none" | "batched" (per-lane prediction leaves,
    split over data) | "shared" (replicated).  Array-valued inputs are
    OPERANDS here, never part of the cache key — baking them into the
    closure would both break hashing and constant-fold them into HLO
    (the argless-jit / HTTP 413 trap).
    """
    from grad_traj_optimization_tpu.search import kinodynamic as kd

    kw = dict(skw)
    dspec = P() if shared else P("data")
    pspec = {"none": P(), "batched": P("data"), "shared": P()}[pred_mode]

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(dspec, P("data"), P("data"), P("data"), P("data"),
                  pspec),
        out_specs=P("data"),
        check_vma=False,
    )
    def run(dists, origins, starts, goals, start_times, pred):
        return kd.search_batch(
            dists, origins, resolution, starts, goals,
            obstacle_pred=(None if pred_mode == "none" else pred),
            start_times=start_times, **kw,
        )

    return run


def sharded_search(dists, origins, resolution, starts, goals,
                   mesh: Mesh, obstacle_pred=None, start_times=None,
                   **kw):
    """Data-parallel batched beam search over the mesh's "data" axis.

    The front-end analogue of :func:`sharded_solve` (the search is
    embarrassingly parallel over scenarios): each device runs the full
    batched beam program — including its sort-payload dedup — on its
    scenario shard.  A leading-dim-1
    ``dists`` is treated as a SHARED map and replicated to every
    device (each shard then takes search_batch's own shared fast
    path).  ``obstacle_pred``/``start_times`` (the dynamic space-time
    mode) ride as sharded operands — per-lane prediction leaves split
    over "data", shared leaves replicate.  Batch must divide by the
    data-axis size; remaining ``kw`` must be static (hashable) search
    options.
    """
    import jax.numpy as jnp

    for k, v in kw.items():
        if not isinstance(v, (int, float, str, bool, type(None))):
            raise TypeError(
                f"sharded_search kwarg {k!r} must be a static search "
                "option; array-valued inputs go through the named "
                "obstacle_pred/start_times parameters"
            )
    dists = jnp.asarray(dists)
    starts = jnp.asarray(starts, jnp.float32)
    B = starts.shape[0]
    shared = bool(dists.shape[0] == 1 and B > 1)
    n_data = mesh.shape["data"]
    if B % n_data:
        raise ValueError(
            f"batch {B} not divisible by data axis {n_data}"
        )
    if obstacle_pred is None:
        pred_mode = "none"
        pred_in = jnp.zeros((B,), jnp.float32)  # placeholder operand
        psh = NamedSharding(mesh, P("data"))
    elif obstacle_pred.poly.ndim == 4:
        pred_mode = "batched"
        pred_in = obstacle_pred
        psh = NamedSharding(mesh, P("data"))
    else:
        pred_mode = "shared"
        pred_in = obstacle_pred
        psh = NamedSharding(mesh, P())
    if start_times is None:
        start_times = jnp.zeros((B,), jnp.float32)
    dsh = NamedSharding(mesh, P() if shared else P("data"))
    lsh = NamedSharding(mesh, P("data"))
    run = _sharded_search_runner(
        mesh, float(resolution), shared, pred_mode,
        tuple(sorted(kw.items())),
    )
    return run(
        jax.device_put(dists, dsh),
        jax.device_put(jnp.asarray(origins, jnp.float32), lsh),
        jax.device_put(starts, lsh),
        jax.device_put(jnp.asarray(goals, jnp.float32), lsh),
        jax.device_put(
            jnp.asarray(start_times, jnp.float32), lsh
        ),
        jax.tree.map(lambda x: jax.device_put(x, psh), pred_in),
    )
