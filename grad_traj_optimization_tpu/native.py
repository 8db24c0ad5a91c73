"""ctypes bindings for the native host engine (native/gtop_core.cpp).

The accelerator path owns batched solving; this binding exposes the C++
engine for host-side work: oracle-grade double-precision solves, the
exact kinodynamic A* rung of the mission pipeline, and fast
multithreaded EDT builds for data generation.

The library is compiled with ``-march=native``, so a build is only valid
on the host that made it.  :func:`load` therefore loads a library only
when its stamp (a hash of the tracked sources plus this host's CPU
identity) matches; otherwise it rebuilds from the tracked sources under
a file lock, and a failed build raises.  :func:`available` reports
whether the library is usable.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess

import numpy as np

_LIB = None
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_LIB_NAME = "libgtop_core.so"
_SOURCES = ("gtop_core.cpp", "Makefile")
_ABI_VERSION = 6  # must match gtop_abi_version() in gtop_core.cpp


def _host_id() -> str:
    """This host's CPU identity: what ``-march=native`` compiles for."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    ident.append(line.strip())
                if line.strip() == "":
                    break  # the first processor describes the host
    except OSError:
        ident.append(platform.processor())
    return hashlib.sha256("\n".join(ident).encode()).hexdigest()


def _stamp(native_dir: str) -> str:
    """Hash of the tracked sources plus this host's CPU identity."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(native_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    return f"{h.hexdigest()} {_host_id()}"


def _is_current(native_dir: str) -> bool:
    """True when the library exists and its stamp names these sources
    built on this host."""
    lib = os.path.join(native_dir, _LIB_NAME)
    try:
        with open(lib + ".stamp") as f:
            recorded = f.read().strip()
    except OSError:
        return False
    return os.path.exists(lib) and recorded == _stamp(native_dir)


def build(native_dir: str = _NATIVE_DIR, force: bool = True) -> str:
    """Compile the library from the tracked sources (``make -B``) and
    stamp it; returns its path.  Serialized across processes by a lock
    file; the library is swapped in atomically.  Raises RuntimeError
    when the build fails."""
    lib = os.path.join(native_dir, _LIB_NAME)
    with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _is_current(native_dir):
            return lib
        tmp = f"{_LIB_NAME}.tmp{os.getpid()}"
        try:
            subprocess.run(
                ["make", "-B", "-C", native_dir, f"LIB={tmp}"],
                check=True, capture_output=True, text=True, timeout=300,
            )
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or ""
            raise RuntimeError(
                f"native build failed: {e}\n{detail[-2000:]}"
            ) from e
        os.replace(os.path.join(native_dir, tmp), lib)
        with open(lib + ".stamp", "w") as f:
            f.write(_stamp(native_dir) + "\n")
    return lib


def load():
    """The loaded library, built first unless a current stamped build
    for this host exists.  Raises RuntimeError when it cannot be built
    or its ABI does not match."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib_path = build(force=False)
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        raise RuntimeError(f"{lib_path} does not load: {e}") from e
    try:
        abi = lib.gtop_abi_version()
    except AttributeError:
        abi = 1
    if abi != _ABI_VERSION:
        raise RuntimeError(
            f"libgtop_core.so ABI {abi} != expected {_ABI_VERSION}"
        )
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)

    lib.gtop_edt.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        f32p,
    ]
    lib.gtop_edt.restype = None
    lib.gtop_trilinear.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f32p, ctypes.c_int, f32p, f32p,
    ]
    lib.gtop_trilinear.restype = None
    lib.gtop_solve.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f64p, ctypes.c_int, f64p, f64p, f64p,
    ]
    lib.gtop_solve.restype = ctypes.c_double
    lib.gtop_solve_batch.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_float, f64p, ctypes.c_int, ctypes.c_int, f64p,
        f64p, f64p, f64p,
    ]
    lib.gtop_solve_batch.restype = None
    lib.gtop_rrt_create.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f64p,
        ctypes.c_double, f64p, f64p, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_uint64,
    ]
    lib.gtop_rrt_create.restype = ctypes.c_void_p
    lib.gtop_rrt_destroy.argtypes = [ctypes.c_void_p]
    lib.gtop_rrt_destroy.restype = None
    lib.gtop_rrt_grow.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gtop_rrt_best_cost.argtypes = [ctypes.c_void_p]
    lib.gtop_rrt_best_cost.restype = ctypes.c_double
    lib.gtop_rrt_commit_end.argtypes = [ctypes.c_void_p]
    lib.gtop_rrt_n_nodes.argtypes = [ctypes.c_void_p]
    lib.gtop_rrt_path_len.argtypes = [ctypes.c_void_p]
    lib.gtop_rrt_get_path.argtypes = [ctypes.c_void_p, f64p, f64p]
    lib.gtop_rrt_get_path.restype = None
    lib.gtop_rrt_reset_root.argtypes = [ctypes.c_void_p, f64p]
    lib.gtop_rrt_update_map.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int,
    ]
    lib.gtop_rrt_root.argtypes = [ctypes.c_void_p, f64p, f64p]
    lib.gtop_rrt_root.restype = None
    lib.gtop_free_shot.argtypes = [
        f64p, f64p, f64p, ctypes.c_double, f64p, f64p, f64p,
    ]
    lib.gtop_free_shot.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def edt(occ: np.ndarray, resolution: float) -> np.ndarray:
    """Multithreaded exact EDT (Felzenszwalb), float32 in/out."""
    lib = load()
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    out = np.empty_like(occ)
    nx, ny, nz = occ.shape
    lib.gtop_edt(_f32p(occ), nx, ny, nz, resolution, _f32p(out))
    return out


def trilinear(dist, origin, resolution, queries):
    """Batched trilinear distance + gradient."""
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin = np.ascontiguousarray(origin, dtype=np.float32)
    q = np.ascontiguousarray(queries, dtype=np.float32).reshape(-1, 3)
    n = len(q)
    d = np.empty(n, np.float32)
    g = np.empty((n, 3), np.float32)
    nx, ny, nz = dist.shape
    lib.gtop_trilinear(
        _f32p(dist), nx, ny, nz, _f32p(origin), resolution, _f32p(q), n,
        _f32p(d), _f32p(g),
    )
    return d, g


def _cfg_arr(cfg, steps):
    """The gtop_solve cfg array (ABI v5, 35 doubles)."""
    return np.array(
        [
            cfg.w_smooth, cfg.w_collision, cfg.alpha, cfg.d0, cfg.r,
            cfg.bos, cfg.vos, cfg.aos, cfg.mean_v, cfg.init_time,
            cfg.lr0, cfg.lr_grow, cfg.lr_shrink, cfg.lr_min, cfg.lr_max,
            cfg.n_samples, cfg.iters_step1, cfg.iters_step2, sum(steps),
            cfg.cost_eps, cfg.grad_eps, cfg.vel_eps, cfg.t_offset,
            1.0 if getattr(cfg, "step_rule", "adaptive") == "bb" else 0.0,
            float(getattr(cfg, "accept_window", 1)),
            {"reference": 0.0, "min_snap": 1.0, "dual": 2.0}[
                getattr(cfg, "seed_mode", "reference")
            ],
            float(getattr(cfg, "dual_ms_iters", 0)),
            cfg.alpha_v, cfg.v0, cfg.r_v, cfg.alpha_a, cfg.a0, cfg.r_a,
            float(getattr(cfg, "polish_iters", 0)),
            float(getattr(cfg, "dual_ms_window", 0)),
        ],
        dtype=np.float64,
    )


def solve(dist, origin, resolution, waypoints, cfg, steps=(2,)):
    """Deterministic double-precision solve, same algorithm as solver.py.

    Args:
      cfg: an OptimizerConfig.
    Returns:
      (coeff (m, 3, 6) float64, times (m,), cost).
    """
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    wp = np.ascontiguousarray(waypoints, dtype=np.float64)
    n_wp = len(wp)
    m = n_wp - 1
    cfg_arr = _cfg_arr(cfg, steps)
    coeff = np.empty((m, 3, 6), np.float64)
    times = np.empty(m, np.float64)
    nx, ny, nz = dist.shape
    cost = lib.gtop_solve(
        _f32p(dist), nx, ny, nz, _f32p(origin32), resolution, _f64p(wp),
        n_wp, _f64p(cfg_arr), _f64p(coeff), _f64p(times),
    )
    return coeff, times, cost


def solve_batch(dist, origin, resolution, waypoints, cfg, steps=(2,)):
    """Threaded batched host solve (one thread pool over scenarios).

    The host-engine counterpart of solver.solve_batch: ``dist`` is
    either (B, nx, ny, nz) per-scenario grids or (1, nx, ny, nz) /
    (nx, ny, nz) for one shared map; ``waypoints`` is (B, n_wp, 3).
    Returns (coeff (B, m, 3, 6) float64, times (B, m), costs (B,)).
    Outputs are bitwise-identical to per-case :func:`solve` calls
    (gtop_solve is reentrant — deliberately unlike the reference's
    file-scope-stateful TrajectoryGenerator, SURVEY.md quirk 6).
    """
    lib = load()
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    if dist.ndim == 3:
        dist = dist[None]
    wp = np.ascontiguousarray(waypoints, dtype=np.float64)
    B, n_wp = wp.shape[0], wp.shape[1]
    n_grids = dist.shape[0]
    if n_grids not in (1, B):
        raise ValueError(f"dist batch {n_grids} != 1 or {B}")
    m = n_wp - 1
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    cfg_arr = _cfg_arr(cfg, steps)
    coeff = np.empty((B, m, 3, 6), np.float64)
    times = np.empty((B, m), np.float64)
    costs = np.empty(B, np.float64)
    nx, ny, nz = dist.shape[1:]
    lib.gtop_solve_batch(
        _f32p(dist), n_grids, nx, ny, nz, _f32p(origin32), resolution,
        _f64p(wp), n_wp, B, _f64p(cfg_arr), _f64p(coeff), _f64p(times),
        _f64p(costs),
    )
    return coeff, times, costs


#: hybrid A* status codes (reference hybrid_astar.h:13-15)
HYBRID_NO_PATH = 0
HYBRID_REACH_END = 1
HYBRID_REACH_HORIZON = 2


def hybrid_search(
    dist,
    origin,
    resolution,
    start_state,
    goal_state,
    start_acc=(0.0, 0.0, 0.0),
    max_acc: float = 2.0,
    max_vel: float = 3.0,
    max_tau: float = 1.0,
    w_time: float = 10.0,
    lambda_heu: float = 5.0,
    horizon: float = 50.0,
    max_iters: int = 30000,
    init_max_tau: float = 0.8,
    use_init: bool = False,
    heu_mode: int = 0,
    margin: float = 0.2,
    max_knots: int = 64,
    shot_mode: int = 0,
):
    """Exact host-side hybrid A* — the compare2 front-end.

    Faithful port of HybridAStarPathFinder::searchPath
    (hybrid_astar.cpp:219-446) with the reference's setParameterAuto
    defaults (:17-23: max_tau=1, max_vel=3, max_acc=2, w_time=10,
    horizon=50, lambda_heu=5) and its hard-coded 0.2 m clearance
    (:644).  ``use_init`` enables the init-mode first expansion with
    ``start_acc`` (:1377-1447); ``heu_mode`` selects the heuristic
    (0 kinodynamic quartic — the active one; 1 diag / 2 manhattan /
    3 euclid, the reference's unwired geometric options, :148-186);
    ``shot_mode`` selects the one-shot family (0 fixed-end-vel shotHeu
    :1023-1101 — the active one; 1 free-end-vel freeEndVelShot
    :969-1021, present in the reference but unwired from searchPath —
    the goal knot then carries the shot's free end velocity).

    Returns (pos (K,3), vel (K,3), acc (K,3), times (K-1,), status)
    where status is HYBRID_{NO_PATH, REACH_END, REACH_HORIZON}.
    """
    lib = load()
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.gtop_hybrid_search.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f64p, f64p, f64p, f64p, f64p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.gtop_hybrid_search.restype = ctypes.c_int

    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    s9 = np.concatenate([
        np.asarray(start_state, np.float64).reshape(6),
        np.asarray(start_acc, np.float64).reshape(3),
    ])
    g6 = np.ascontiguousarray(goal_state, dtype=np.float64)
    cfg = np.array(
        [max_acc, max_vel, max_tau, w_time, lambda_heu, horizon,
         max_iters, init_max_tau, 1.0 if use_init else 0.0, heu_mode,
         margin, shot_mode],
        dtype=np.float64,
    )
    knots = np.zeros((max_knots, 9), np.float64)
    times = np.zeros(max_knots, np.float64)
    status = ctypes.c_int(0)
    nx, ny, nz = dist.shape
    k = lib.gtop_hybrid_search(
        _f32p(dist), nx, ny, nz, _f32p(origin32), resolution, _f64p(s9),
        _f64p(g6), _f64p(cfg), _f64p(knots), _f64p(times), max_knots,
        ctypes.byref(status),
    )
    if k == 0:
        return (np.zeros((0, 3)),) * 3 + (np.zeros(0), HYBRID_NO_PATH)
    return (
        knots[:k, 0:3], knots[:k, 3:6], knots[:k, 6:9], times[: k - 1],
        int(status.value),
    )


def kino_search(
    dist,
    origin,
    resolution,
    start_state,
    goal_state,
    max_acc: float = 2.0,
    max_vel: float = 3.0,
    max_tau: float = 0.5,
    w_time: float = 10.0,
    lambda_heu: float = 5.0,
    margin: float = 0.2,
    max_nodes: int = 20000,
    goal_r: float = 3.0,
    max_knots: int = 64,
):
    """Exact host-side kinodynamic A* (reference algorithm).

    Returns (pos (K,3), vel (K,3), acc (K,3), times (K-1,), reached).
    The batched beam search (search/kinodynamic.py) approximates this; use
    this exact version for host seeding and beam-quality checks.
    """
    lib = load()
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.gtop_kino_search.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_float, f64p, f64p, f64p, f64p, f64p, ctypes.c_int,
    ]
    lib.gtop_kino_search.restype = ctypes.c_int

    dist = np.ascontiguousarray(dist, dtype=np.float32)
    origin32 = np.ascontiguousarray(origin, dtype=np.float32)
    s6 = np.ascontiguousarray(start_state, dtype=np.float64)
    g6 = np.ascontiguousarray(goal_state, dtype=np.float64)
    cfg = np.array(
        [max_acc, max_vel, max_tau, w_time, lambda_heu, margin,
         max_nodes, goal_r],
        dtype=np.float64,
    )
    knots = np.zeros((max_knots, 9), np.float64)
    times = np.zeros(max_knots, np.float64)
    nx, ny, nz = dist.shape
    k = lib.gtop_kino_search(
        _f32p(dist), nx, ny, nz, _f32p(origin32), resolution, _f64p(s6),
        _f64p(g6), _f64p(cfg), _f64p(knots), _f64p(times), max_knots,
    )
    if k == 0:
        return (np.zeros((0, 3)),) * 3 + (np.zeros(0), False)
    return (
        knots[:k, 0:3], knots[:k, 3:6], knots[:k, 6:9], times[: k - 1],
        True,
    )


def free_shot(p0, p1, v0, max_vel: float = 3.0):
    """Free-end-velocity minimum-acceleration cubic one-shot.

    Exact f64 port of HybridAStarPathFinder::getOptimalTime /
    getShotTrajectory (hybrid_astar.cpp:902-967); cross-checked against
    the JAX port (search.kinodynamic.free_end_vel_shot) in
    tests/test_native.py.

    Returns (coef (3, 4) ascending powers, T, v1 (3,)).
    """
    lib = load()
    p0 = np.ascontiguousarray(p0, dtype=np.float64)
    p1 = np.ascontiguousarray(p1, dtype=np.float64)
    v0 = np.ascontiguousarray(v0, dtype=np.float64)
    coef = np.empty((3, 4), np.float64)
    T = np.empty(1, np.float64)
    v1 = np.empty(3, np.float64)
    lib.gtop_free_shot(
        _f64p(p0), _f64p(p1), _f64p(v0), float(max_vel), _f64p(coef),
        _f64p(T), _f64p(v1),
    )
    return coef, float(T[0]), v1


class NativeRRTPlanner:
    """Native incremental safe-ball informed RRT* (gtop_rrt_*).

    The C++ engine for the reference's receding-horizon rrtPathFinder
    (path_finder.cpp: RRTpathFind :713-804, resetRoot/costRecast
    :302-375, RRTpathReEvaluate/ReConnect/treeRepair :1065-1554),
    mirroring the semantics of :class:`search.rrt.RRTPlanner` with the
    same method surface, so ``replan.replan_loop_rrt`` can hold either.
    ~30x the Python planner's insertion rate, which is what keeps a
    full grow+repair cycle inside a real-time replan tick.

    RNG streams differ from the NumPy planner (mt19937 vs PCG64): trees
    are behaviorally, not bitwise, comparable.
    """

    def __init__(self, dist_grid, origin, resolution, start, goal,
                 steer_len: float = 1.5, min_radius: float = 0.3,
                 goal_bias: float = 0.15, radius_margin: float | None = None,
                 seed: int = 0):
        self._lib = load()
        dist = np.ascontiguousarray(dist_grid, dtype=np.float32)
        self._shape = dist.shape
        self.goal = np.asarray(goal, dtype=np.float64).copy()
        self.min_radius = float(min_radius)
        o = np.ascontiguousarray(origin, dtype=np.float64)
        s = np.ascontiguousarray(start, dtype=np.float64)
        g = np.ascontiguousarray(self.goal)
        nx, ny, nz = dist.shape
        self._h = self._lib.gtop_rrt_create(
            _f32p(dist), nx, ny, nz, _f64p(o), float(resolution),
            _f64p(s), _f64p(g), float(steer_len), float(min_radius),
            float(goal_bias),
            -1.0 if radius_margin is None else float(radius_margin),
            int(seed),
        )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.gtop_rrt_destroy(h)
            self._h = None

    @property
    def best_cost(self) -> float:
        return float(self._lib.gtop_rrt_best_cost(self._h))

    @property
    def commit_end(self) -> bool:
        return bool(self._lib.gtop_rrt_commit_end(self._h))

    def grow(self, n_iters: int) -> bool:
        return bool(self._lib.gtop_rrt_grow(self._h, int(n_iters)))

    def reset_root(self, commit_target) -> bool:
        t = np.ascontiguousarray(commit_target, dtype=np.float64)
        return bool(self._lib.gtop_rrt_reset_root(self._h, _f64p(t)))

    def update_map(self, dist_grid, repair_iters: int = 60) -> bool:
        dist = np.ascontiguousarray(dist_grid, dtype=np.float32)
        if dist.shape != self._shape:
            raise ValueError(
                f"update_map must keep the grid shape "
                f"({dist.shape} != {self._shape})"
            )
        return bool(
            self._lib.gtop_rrt_update_map(
                self._h, _f32p(dist), int(repair_iters)
            )
        )

    def result(self):
        from grad_traj_optimization_tpu.search.rrt import RRTResult

        k = int(self._lib.gtop_rrt_path_len(self._h))
        n_valid = int(self._lib.gtop_rrt_n_nodes(self._h))
        if k == 0:
            # exact surface parity with rrt.RRTPlanner.result(): the
            # unreached case is a 1-point path at the current root, so
            # backend-generic callers can index path[0] on failure
            c = np.zeros(3, np.float64)
            r = np.zeros(1, np.float64)
            self._lib.gtop_rrt_root(self._h, _f64p(c), _f64p(r))
            return RRTResult(
                path=c[None], radii=r.copy(),
                reached=False, cost=np.inf, n_nodes=n_valid,
            )
        path = np.zeros((k, 3), np.float64)
        radii = np.zeros(k, np.float64)
        self._lib.gtop_rrt_get_path(self._h, _f64p(path), _f64p(radii))
        return RRTResult(
            path=path, radii=radii, reached=True,
            cost=self.best_cost, n_nodes=n_valid,
        )
