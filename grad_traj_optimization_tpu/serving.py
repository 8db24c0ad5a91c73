"""Production serving: asynchronous micro-batching front door for the
batched solver.

The reference serves one solve per ROS callback on one CPU core
(src/opti_node.cpp:47-147; compare2.cpp's topic handshake :129-137).
The rebuild's deployment surface is the opposite shape: the device is
fastest when many scenarios ride ONE batched program
(solver.solve_batch), so a server must aggregate concurrent requests
into batches without letting any single request wait unboundedly.  This
module implements that standard accelerator-serving pattern:

* requests enqueue from any thread (`submit` returns a Future);
* one dispatch thread drains the queue into a batch, bounded by
  ``max_batch`` and a ``max_wait_ms`` aggregation deadline measured
  from the OLDEST queued request;
* batches pad up to power-of-two buckets (replicating the last
  scenario; pad lanes are dropped on return) so XLA compiles one
  program per bucket instead of one per batch size;
* all requests must share one (grid_shape, n_waypoints) contract —
  real deployments shard traffic into such buckets up front; a
  mismatching scenario is rejected at submit();
* when every request in a batch shares the SAME distance-field array,
  the batch is assembled in shared-map form (``dist`` leading dim 1),
  which the solver reads from one grid instead of per-lane copies
  (solver.solve_batch docstring).

Latency accounting: the end-to-end request latency is queue wait +
device batch time + the result download (see ``scripts/serve_bench.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time
from concurrent.futures import Future

import numpy as np

from grad_traj_optimization_tpu import solver as solve_mod
from grad_traj_optimization_tpu.config import OptimizerConfig


def _safe_resolve(fut: Future, result=None, exception=None):
    """Resolve a future without killing the dispatch thread.

    A client ``cancel()`` racing the dispatch (between the dequeue and
    the resolution) makes ``set_result``/``set_exception`` raise
    InvalidStateError; an unguarded raise would end ``_run`` and hang
    every later submit.  ``set_running_or_notify_cancel`` claims the
    future first (after it returns False — cancelled — no resolution is
    attempted; after True a concurrent cancel can no longer land).
    """
    try:
        if not fut.set_running_or_notify_cancel():
            return  # client cancelled before dispatch claimed it
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except Exception:  # noqa: BLE001 — InvalidStateError et al.
        pass


@dataclasses.dataclass
class ServerStats:
    n_requests: int = 0
    n_batches: int = 0
    n_padded_lanes: int = 0
    batch_sizes: list = dataclasses.field(default_factory=list)
    wait_ms: list = dataclasses.field(default_factory=list)   # queue wait
    total_ms: list = dataclasses.field(default_factory=list)  # submit->done
    assemble_ms: list = dataclasses.field(default_factory=list)  # per batch
    device_ms: list = dataclasses.field(default_factory=list)    # per batch
    solve_ms: list = dataclasses.field(default_factory=list)     # instrument
    download_ms: list = dataclasses.field(default_factory=list)  # instrument

    def summary(self) -> dict:
        def pct(a, q):
            return float(np.percentile(a, q)) if a else 0.0

        return {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "mean_batch": (
                float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0
            ),
            "pad_fraction": (
                self.n_padded_lanes
                / max(sum(self.batch_sizes) + self.n_padded_lanes, 1)
            ),
            "wait_ms_p50": pct(self.wait_ms, 50),
            "wait_ms_p99": pct(self.wait_ms, 99),
            "total_ms_p50": pct(self.total_ms, 50),
            "total_ms_p99": pct(self.total_ms, 99),
            "assemble_ms_p50": pct(self.assemble_ms, 50),
            "device_ms_p50": pct(self.device_ms, 50),
            "solve_ms_p50": pct(self.solve_ms, 50),
            "download_ms_p50": pct(self.download_ms, 50),
        }


@functools.lru_cache(maxsize=None)
def _packer(treedef, shapes_dtypes):
    """One jitted flatten-and-concat program per result shape family
    (cached so repeated buckets reuse the compile)."""
    import jax
    import jax.numpy as jnp

    # the single-buffer pack round-trips every leaf through f32; that
    # is EXACT only for f32 leaves and integers < 2^24 — whitelist the
    # dtypes so a future wider/int64 leaf fails loudly here instead of
    # silently corrupting results
    for _shape, dt in shapes_dtypes:
        if dt not in ("float32", "int32", "bool"):
            raise TypeError(
                f"packed download cannot represent dtype {dt}; "
                "extend _packer with a second buffer for it"
            )

    def pack(*leaves):
        return jnp.concatenate(
            [jnp.ravel(x).astype(jnp.float32) for x in leaves]
        )

    return jax.jit(pack)


def _download_packed_multi(sols):
    """Download several batched result pytrees in ONE device->host
    transfer: each packs to a flat f32 buffer on device, the buffers
    concatenate there, and the single host copy splits back (one
    transfer per batch instead of one per leaf)."""
    import jax
    import jax.numpy as jnp

    packed, metas = [], []
    for sol in sols:
        leaves, treedef = jax.tree.flatten(sol)
        sd = tuple((tuple(x.shape), str(x.dtype)) for x in leaves)
        packed.append(_packer(treedef, sd)(*leaves))
        metas.append((treedef, sd, int(packed[-1].shape[0])))
    flat = np.asarray(
        jnp.concatenate(packed) if len(packed) > 1 else packed[0]
    )  # the single device->host transfer
    outs, off = [], 0
    for treedef, sd, ln in metas:
        seg = flat[off:off + ln]
        off += ln
        leaves_out, o2 = [], 0
        for shape, dtype in sd:
            n = int(np.prod(shape)) if shape else 1
            leaves_out.append(
                seg[o2:o2 + n].reshape(shape).astype(dtype)
            )
            o2 += n
        outs.append(jax.tree.unflatten(treedef, leaves_out))
    return outs


def _download_packed(sol):
    """Download one batched result pytree in ONE transfer."""
    return _download_packed_multi([sol])[0]


class _MicroBatcher:
    """Shared queue + aggregation-deadline dispatch machinery for the
    serving front doors.  Queue entries are ``(*payload, fut, t0)``
    tuples (future at [-2], enqueue timestamp at [-1]); subclasses
    implement ``_dispatch(batch)`` and call :meth:`_start_batcher` at
    the end of their ``__init__``.
    """

    def _start_batcher(self):
        self.stats = ServerStats()
        self._queue: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _enqueue(self, entry) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("server is shut down")
            self._queue.append(entry)
            self._cv.notify()

    def shutdown(self, wait: bool = True):
        with self._cv:
            self._closed = True
            self._cv.notify()
        if wait:
            self._worker.join()

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                # aggregation: wait out the deadline of the OLDEST
                # request (or until the batch fills)
                t_oldest = self._queue[0][-1]
                while len(self._queue) < self.max_batch and not self._closed:
                    remaining = (
                        self.max_wait_ms / 1e3
                        - (time.perf_counter() - t_oldest)
                    )
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — keep the worker alive
                # a dying dispatch thread would hang every later submit
                # with no error surfaced; fail this batch instead
                for entry in batch:
                    _safe_resolve(entry[-2], exception=e)


class SolveServer(_MicroBatcher):
    """Micro-batching solve server over one device.

    Args:
      cfg/steps: optimizer schedule for every request (one compiled
        program family per server).
      max_batch: hard batch-size cap (also the largest pad bucket).
      max_wait_ms: aggregation deadline measured from the oldest queued
        request; a request never waits longer than this for batchmates
        before dispatch (it may still wait behind an in-flight batch).
      pad_buckets: round batch sizes up to powers of two so the solver
        compiles O(log max_batch) programs instead of one per size.
    """

    def __init__(
        self,
        cfg: OptimizerConfig = OptimizerConfig(),
        steps=(2,),
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        pad_buckets: bool = True,
        bucket_floor: int = 128,
    ):
        self.cfg = cfg
        self.steps = tuple(steps)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.pad_buckets = bool(pad_buckets)
        self.bucket_floor = int(bucket_floor)
        self._contract = None  # (grid_shape, n_wp) fixed by first submit
        self._start_batcher()

    # -- client surface ---------------------------------------------------

    def submit(self, scenario: solve_mod.Scenario) -> Future:
        """Enqueue one (unbatched) Scenario; returns a Future resolving
        to its Solution (leading batch axis stripped)."""
        if scenario.grid_offset is not None:
            raise ValueError("submit() takes uncropped scenarios")
        key = (tuple(scenario.dist.shape), int(scenario.waypoints.shape[0]))
        fut: Future = Future()
        with self._cv:
            if self._contract is None:
                self._contract = key
            elif key != self._contract:
                raise ValueError(
                    f"scenario shape {key} != server contract "
                    f"{self._contract}; route each (grid, n_wp) bucket "
                    "to its own SolveServer"
                )
        self._enqueue((scenario, fut, time.perf_counter()))
        return fut

    def solve(self, scenario, timeout: float | None = None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(scenario).result(timeout=timeout)

    # -- dispatch ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        if not self.pad_buckets:
            return n
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _bucket_groups(self, n: int) -> list[int]:
        """Decompose a batch into pow2 bucket sizes (round 5).

        A single pow2 bucket pads up to ~50% dead lanes (a 720-lane
        batch solves as 1024 — measured as most of the residual
        serving-vs-direct solve gap).  Greedy decomposition into
        descending pow2 groups with a ``bucket_floor`` floor (720 ->
        512 + 128 + 128, pad 6.7%) trades a few extra dispatches —
        which queue asynchronously on device — for the dead-lane
        work.  When the decomposition saves no padding over the
        single covering bucket (e.g. n = 1000 -> groups totaling
        1024), the single bucket wins (fewer launches).  Sizes above
        the floor reuse the same O(log max_batch) compiled programs.
        """
        if not self.pad_buckets:
            return [n]
        floor = min(self.bucket_floor, self.max_batch)
        single = self._bucket(n)
        if n <= floor or n > self.max_batch - floor // 2:
            return [single]
        groups, rem = [], n
        while rem > 0:
            b = self._bucket(rem)
            if b > rem and b > floor:
                groups.append(b // 2)
                rem -= b // 2
            else:
                groups.append(max(b, floor))
                rem -= b
        if sum(groups) >= single:
            return [single]  # no padding saved -> one launch
        return groups

    def _dispatch(self, batch):
        t_dispatch = time.perf_counter()
        scns = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        n = len(scns)
        groups = self._bucket_groups(n)
        pads = sum(groups) - n
        try:
            import jax
            import jax.numpy as jnp

            def stack(leaves):
                # Per-lane device work costs a dispatch per lane:
                # identical leaf OBJECTS broadcast (zero per-lane ops),
                # host leaves stack on host (ONE upload inside
                # solve_batch); only genuinely distinct device leaves
                # pay a B-operand device stack.
                l0 = leaves[0]
                if all(x is l0 for x in leaves):
                    return jnp.broadcast_to(
                        jnp.asarray(l0), (len(leaves),) + np.shape(l0)
                    )
                if all(isinstance(x, np.ndarray) for x in leaves):
                    return jnp.asarray(np.stack(leaves))
                return jnp.stack([jnp.asarray(x) for x in leaves])

            # assemble + dispatch every group first (async on device),
            # then barrier + download — the groups pipeline
            sols = []
            ofs = 0
            for g in groups:
                sub = scns[ofs:ofs + g]
                ofs += min(g, n - ofs)
                sub = sub + [scns[-1]] * (g - len(sub))
                # shared-map fast path: every request references the
                # SAME field array -> one grid, no per-lane copies
                first = sub[0].dist
                shared = all(s.dist is first for s in sub)
                dist = (
                    first[None] if shared
                    else stack([s.dist for s in sub])
                )
                scn_b = solve_mod.Scenario(
                    dist=dist,
                    origin=stack([s.origin for s in sub]),
                    resolution=stack([s.resolution for s in sub]),
                    waypoints=stack([s.waypoints for s in sub]),
                )
                sols.append(solve_mod.solve_batch(
                    scn_b, cfg=self.cfg, steps=self.steps,
                    record_trace=False,
                ))
            t_assembled = time.perf_counter()
            # device-time barrier: splits solve time from the result
            # download in the stats
            jax.block_until_ready(sols)
            t_solved = time.perf_counter()
            # pull each group's Solution in ONE device->host transfer
            hosts = _download_packed_multi(sols)
            host = (
                hosts[0] if len(hosts) == 1
                else jax.tree.map(
                    lambda *xs: np.concatenate(xs, axis=0), *hosts
                )
            )
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for f in futs:
                _safe_resolve(f, exception=e)
            return
        t_done = time.perf_counter()
        # record stats BEFORE resolving futures: a client that awoke on
        # f.result() may immediately read (or reset) server.stats, and
        # recording afterwards raced that read (measured as warmup
        # batches leaking into a freshly reset per-load stats object)
        with self._cv:
            self.stats.n_requests += n
            self.stats.n_batches += 1
            self.stats.n_padded_lanes += pads
            self.stats.batch_sizes.append(n)
            self.stats.assemble_ms.append((t_assembled - t_dispatch) * 1e3)
            self.stats.device_ms.append((t_done - t_assembled) * 1e3)
            self.stats.solve_ms.append((t_solved - t_assembled) * 1e3)
            self.stats.download_ms.append((t_done - t_solved) * 1e3)
            for _, _, t0 in batch:
                self.stats.wait_ms.append((t_dispatch - t0) * 1e3)
                self.stats.total_ms.append((t_done - t0) * 1e3)
        for i, f in enumerate(futs):
            _safe_resolve(
                f,
                result=solve_mod.Solution(
                    *jax.tree.map(lambda x: x[i], host)
                ),
            )


class MissionServer(_MicroBatcher):
    """Micro-batching FULL-MISSION server: search + refine per request.

    The mission analogue of :class:`SolveServer` (the reference's
    actual online surface is one full mission per callback —
    compare2.cpp:129-177 start/goal handshake -> search -> optimize):
    requests are (start, goal) states against ONE shared distance
    field; the dispatch thread drains them into pow2-bucketed batches
    of :func:`pipeline.plan_batch` (adaptive retry-ladder search,
    raced refine, optional exact host-A* fallback rung).

    Each Future resolves to a dict with the lane's ``solution``
    (Solution, batch axis stripped), ``reached`` and ``ok`` flags.
    """

    def __init__(
        self,
        dist,
        origin,
        resolution: float,
        cfg: OptimizerConfig = OptimizerConfig(),
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        host_fallback: bool = False,
        **plan_kw,
    ):
        import jax
        import jax.numpy as jnp

        self.dist = jax.device_put(jnp.asarray(dist))
        if self.dist.ndim == 3:
            self.dist = self.dist[None]
        if self.dist.shape[0] != 1:
            raise ValueError(
                "MissionServer serves ONE shared field; got dist "
                f"leading dim {self.dist.shape[0]} — pass dist[:1] "
                "(per-request fields need per-(grid) servers)"
            )
        self.origin = np.asarray(origin, np.float32)
        self.resolution = float(resolution)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.host_fallback = bool(host_fallback)
        self.plan_kw = plan_kw
        self._start_batcher()

    def submit(self, start_state, goal_state) -> Future:
        """Enqueue one mission ((6,) start / goal = [p, v])."""
        s = np.asarray(start_state, np.float32).reshape(6)
        g = np.asarray(goal_state, np.float32).reshape(6)
        fut: Future = Future()
        self._enqueue((s, g, fut, time.perf_counter()))
        return fut

    def _dispatch(self, batch):
        import jax

        from grad_traj_optimization_tpu import pipeline

        t_dispatch = time.perf_counter()
        n = len(batch)
        target = n
        b = 1
        while b < n:
            b *= 2
        target = min(b, self.max_batch)
        pads = target - n
        starts = np.stack(
            [x[0] for x in batch] + [batch[-1][0]] * pads
        )
        goals = np.stack(
            [x[1] for x in batch] + [batch[-1][1]] * pads
        )
        futs = [x[2] for x in batch]
        t_assembled = time.perf_counter()
        try:
            res = pipeline.plan_batch(
                self.dist,
                np.broadcast_to(self.origin, (target, 3)),
                self.resolution, starts, goals, cfg=self.cfg,
                host_fallback=self.host_fallback, **self.plan_kw,
            )
            # ONE device->host transfer for the whole Solution
            sol_host = _download_packed(res.solution)
        except Exception as e:  # noqa: BLE001
            for f in futs:
                _safe_resolve(f, exception=e)
            return
        t_done = time.perf_counter()
        # stats before resolution (see SolveServer._dispatch)
        with self._cv:
            self.stats.n_requests += n
            self.stats.n_batches += 1
            self.stats.n_padded_lanes += pads
            self.stats.batch_sizes.append(n)
            self.stats.assemble_ms.append(
                (t_assembled - t_dispatch) * 1e3
            )
            self.stats.device_ms.append((t_done - t_assembled) * 1e3)
            for _, _, _, t0 in batch:
                self.stats.wait_ms.append((t_dispatch - t0) * 1e3)
                self.stats.total_ms.append((t_done - t0) * 1e3)
        for i, f in enumerate(futs):
            _safe_resolve(f, result={
                "solution": solve_mod.Solution(
                    *jax.tree.map(lambda x: x[i], sol_host)
                ),
                "reached": bool(res.reached[i]),
                "ok": bool(res.ok[i]),
            })
