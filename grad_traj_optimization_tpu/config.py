"""Typed configuration for the trajectory optimizer.

Replaces the reference's ROS-parameter-server configuration
(reference: src/grad_traj_optimizer.cpp:3-33 reads ~20 scalars under
``/traj_opti_node1/*``; values in launch/opti_node.launch:3-28,
launch/text_input.launch:84-117).

Two kinds of fields:

* **Static** fields (iteration budgets, sample counts, gradient mode) shape
  the compiled program; they are Python ints/strs and hashing a config gives
  a jit cache key.
* **Weight-like** fields (penalty weights, bounds) are plain floats baked
  into the trace as constants.  They rarely change between solves of the
  same deployment, so constant-folding them lets XLA pre-fuse the penalty
  math.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Penalty-optimizer parameters.

    Mirrors reference grad_traj_optimizer.cpp:3-33 (names kept for
    auditability), replacing NLopt wall-clock limits with deterministic
    iteration budgets (reference quirk: nlopt::srand(wall clock) +
    set_maxtime makes C++ results machine-dependent; see
    grad_traj_optimizer.cpp:135-148).
    """

    # --- penalty weights (launch/opti_node.launch:9-21) ---
    w_smooth: float = 1.0       # ws
    w_collision: float = 5.0    # wc
    alpha: float = 10.0         # collision penalty scale
    d0: float = 0.8             # collision penalty offset distance [m]
    r: float = 0.5              # collision penalty decay length [m]
    alpha_v: float = 0.0        # velocity penalty scale (vestigial in ref)
    v0: float = 2.5
    r_v: float = 1.5
    alpha_a: float = 0.0        # acceleration penalty scale (vestigial)
    a0: float = 3.5
    r_a: float = 1.5

    # --- box bounds on the free derivatives (launch/opti_node.launch:23-25;
    #     applied at grad_traj_optimizer.cpp:154-177) ---
    bos: float = 3.0            # position box half-width around waypoint [m]
    vos: float = 8.0            # velocity bound [m/s]
    aos: float = 10.0           # acceleration bound [m/s^2]

    # --- time allocation (grad_traj_optimizer.cpp:73-81) ---
    mean_v: float = 1.8         # mean velocity for segment-time heuristic
    init_time: float = 0.3      # extra time on the first segment

    # --- discretization of the collision line integral
    #     (grad_traj_optimizer.cpp:351-353: t = 1e-3, dt = T_s/30) ---
    n_samples: int = 30         # samples per segment (static)
    t_offset: float = 1e-3      # first sample offset into each segment

    # --- iteration budgets replacing NLopt set_maxtime
    #     (grad_traj_optimizer.cpp:144-148) ---
    iters_step1: int = 40       # step 1: ws = 0, collision-only shaping
    iters_step2: int = 100      # step 2: full cost
    # (with the default BB step rule, 100 iterations reach a lower cost
    # than 160 iterations of the multiplicative-adaptive rule)

    # --- descent controls (ours; no reference counterpart) ---
    lr0: float = 1e-2           # initial step size
    lr_grow: float = 1.6        # step growth on accepted iterations
    lr_shrink: float = 0.35     # step shrink on rejected iterations
    lr_min: float = 1e-8
    lr_max: float = 10.0
    # "adaptive": multiplicative grow/shrink on the normalized step;
    # "bb": Barzilai-Borwein spectral step from the last accepted
    #   (delta dp, delta grad) pair, with multiplicative backtracking on
    #   rejection — same evaluation count, much faster convergence.
    step_rule: str = "bb"
    # Nonmonotone acceptance window (Grippo-style): a candidate is
    # accepted if it beats the MAX of the last `accept_window` accepted
    # costs; the returned iterate/cost/trace are always the best seen,
    # so the reported cost envelope stays monotone.  1 = the strict
    # monotone rule.  Measured at B=512 random scenarios (same
    # evaluation count): window 8 reaches geomean 0.85x the monotone
    # rule's 100-iteration cost, p99 ratio 1.13, 2.7% of lanes >5%
    # worse — a uniform quality win per iteration.
    accept_window: int = 1
    # Descent seed: "reference" = straight-line interior derivatives
    # (getInitialD, qp_generator.cpp:407-451); "min_snap" = the
    # closed-form smoothness optimum dp* = -Rpp^-1 Rfp^T df (the
    # reference's own type-1 init, qp_generator.cpp:242-315) — reaches
    # the reference seed's 100-iter cost by iter ~18 at median but
    # lands ~25% of lanes in worse basins; "dual" = race both seeds
    # and keep the per-lane best (2x the evaluations per solve).
    seed_mode: str = "reference"
    # In "dual" mode, step-2 iteration budget of the min-snap arm
    # (0 = same as iters_step2).  The min-snap arm converges by ~15-18
    # iterations at median, so a short ms arm + longer reference arm
    # gives the best tail per evaluation (measured at 100 total evals:
    # 70+30 split reaches geomean 0.50x the monotone single-seed cost
    # with p99 1.33 vs p99 1.77 for the 50+50 split).
    dual_ms_iters: int = 0
    # In "dual" mode, the min-snap arm's nonmonotone acceptance window
    # (0 = same as accept_window).  The never-worse TURBO_SAFE preset
    # needs a strictly monotone W=1 reference arm (bitwise the
    # reference schedule) but the short min-snap arm converges better
    # nonmonotone: W=8 on the ms arm measured gm 0.534 vs 0.558 with
    # W=1 at B=1024.
    dual_ms_window: int = 0
    # Post-race polish (dual mode only): after the per-lane best arm is
    # selected, restart the descent from the winner for this many extra
    # step-2 iterations (fresh BB state — the restart itself escapes
    # shallow traps).  Measured at B=1024: 30+30+20 polish cuts the
    # dual race's p99 cost ratio 2.73 -> 1.75 at gm 0.53.
    polish_iters: int = 0

    # --- automatic exact cropping ---
    # When the batch qualifies (shared origin, uniform resolution, a
    # grid of at least 2^19 voxels), solve/solve_batch exact-crop the
    # grids to the waypoint window +- (bos + crop_margin) before
    # dispatch (see solver.crop_scenarios): in-window lookups are
    # bitwise-identical to the full grid.  Iterates that overshoot the
    # margin read the out-of-map sentinel (-1, a restoring penalty)
    # instead of the true field.  Set False to always solve on the
    # full grid.  Only consulted on concrete (untraced) inputs.
    auto_crop: bool = True
    crop_margin: float = 2.0

    # --- gradient formula ---
    # "reference": replicate grad_traj_optimizer.cpp:376-381 exactly,
    #   including its extra `cd` factor in the distance term and the +1e-5
    #   bias added to every gradient component (:428-432).
    # "exact": true analytic gradient of the sampled cost.
    gradient_mode: str = "reference"

    # numeric floors replicated from the reference
    cost_eps: float = 1e-3      # added to total cost (:417-418)
    grad_eps: float = 1e-5      # added to each gradient entry (:428-432)
    vel_eps: float = 1e-5       # ||v|| floor (:358)

    def __post_init__(self):
        if self.gradient_mode not in ("reference", "exact"):
            raise ValueError(f"bad gradient_mode: {self.gradient_mode}")
        if self.accept_window < 1:
            raise ValueError(f"bad accept_window: {self.accept_window}")
        if self.seed_mode not in ("reference", "min_snap", "dual"):
            raise ValueError(f"bad seed_mode: {self.seed_mode}")
        if self.dual_ms_window < 0:
            raise ValueError(f"bad dual_ms_window: {self.dual_ms_window}")
        if self.polish_iters < 0:
            raise ValueError(f"bad polish_iters: {self.polish_iters}")
        if self.polish_iters > 0 and self.seed_mode != "dual":
            raise ValueError(
                "polish_iters is the dual race's post-race polish; "
                "single-seed schedules should raise iters_step2 instead"
            )


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Static geometry of the voxel map.

    Shapes are static so one compiled solve serves every scenario on the
    same grid (reference: SDFMap ctor, src/sdf_map.cpp:3-24).
    """

    origin: tuple[float, float, float] = (-20.0, -20.0, 0.0)
    resolution: float = 0.2
    map_size: tuple[float, float, float] = (40.0, 40.0, 5.0)

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        import math

        return tuple(
            int(math.ceil(s / self.resolution)) for s in self.map_size
        )

    @property
    def n_voxels(self) -> int:
        nx, ny, nz = self.grid_shape
        return nx * ny * nz


# The two deployment presets shipped with the reference.
OPTI_NODE_CONFIG = OptimizerConfig()  # launch/opti_node.launch:3-28

# launch/text_input.launch:84-117 (ws=200, wc=0.1, alpha=5, d0=0.7, r=1,
# mean_v=1, init_time=0)
TEXT_INPUT_CONFIG = OptimizerConfig(
    w_smooth=200.0,
    w_collision=0.1,
    alpha=5.0,
    d0=0.7,
    r=1.0,
    mean_v=1.0,
    init_time=0.0,
)

# launch/click.launch:3-37 (ws=20, wc=0.1, alpha=10, d0=0.7, r=0.5,
# mean_v=1, init_time=0.3, alphav=alphaa=0.1).  The click node is the
# LEGACY optimizer API (example_click.cpp, commented out of the build);
# its launch sets nonzero velocity/acceleration penalty scales, which
# this rebuild honors (the modern back-end comments the usage out —
# grad_traj_optimizer.cpp:382-407 — so the modern reference would
# ignore them; set alpha_v=alpha_a=0 for that behavior).
CLICK_CONFIG = OptimizerConfig(
    w_smooth=20.0,
    w_collision=0.1,
    alpha=10.0,
    d0=0.7,
    r=0.5,
    alpha_v=0.1,
    alpha_a=0.1,
    mean_v=1.0,
    init_time=0.3,
)

# launch/compare2.launch:3-28 (ws=20, wc=1, alpha=10, d0=0.8, r=0.5,
# mean_v=1.8, init_time=0.3; step-2 budget 0.01 s — the tightest of all
# presets, reflected here as a short step-2 iteration budget).
COMPARE2_CONFIG = OptimizerConfig(
    w_smooth=20.0,
    w_collision=1.0,
    alpha=10.0,
    d0=0.8,
    r=0.5,
    mean_v=1.8,
    init_time=0.3,
    iters_step2=25,
)

# Ours (no reference counterpart): nonmonotone acceptance + dual-seed
# racing at the same 100-evaluation budget as the default config.
# Measured at B=1024 random scenarios: geomean final cost 0.53x the
# default config's, p95 ratio 1.14, p99 ratio 1.39.
TURBO_CONFIG = OptimizerConfig(
    accept_window=8,
    seed_mode="dual",
    iters_step2=70,
    dual_ms_iters=30,
)

# The fast-budget point: 60 evaluations (30 per seed arm), geomean final
# cost 0.59x the default config's at B=1024 — but a fat tail (p95 ratio
# 1.72, p99 2.88).  Use when median latency matters more than
# worst-case solution quality (e.g. high-rate replanning, where the
# next tick re-solves anyway).
TURBO_FAST_CONFIG = OptimizerConfig(
    accept_window=8,
    seed_mode="dual",
    iters_step2=30,
    dual_ms_iters=30,
)

# Fast race + post-race polish restart: geomean cost 0.53x at p95 1.27 /
# p99 1.75 (B=1024).  The frontier around it: +20 more ref-arm iters
# (50+30+20) = gm 0.51, p99 1.29; 70+30+20 = gm 0.50, p99 1.14.  Budget
# alone does NOT drive p99 to 1.0 — the tail lanes are in converged bad
# basins (targeted +80 iters left p99 at 2.6) — use TURBO_SAFE when
# "never worse" matters.
TURBO_POLISH_CONFIG = OptimizerConfig(
    accept_window=8,
    seed_mode="dual",
    iters_step2=30,
    dual_ms_iters=30,
    polish_iters=20,
)

# Never worse than the reference config, at better-than-reference
# median: the ref-seed arm IS the reference schedule bitwise
# (straight-line seed, monotone W=1, 100 iterations), so the per-lane
# best-of can only improve on it.  Measured at B=1024: geomean cost
# 0.53x with p90 = p95 = p99 = max = 1.000 and 0 worse lanes.  This is
# the quality-dominant configuration: strictly better on ~60% of lanes,
# identical on the rest.
TURBO_SAFE_CONFIG = OptimizerConfig(
    seed_mode="dual",
    iters_step2=100,
    dual_ms_iters=30,
    dual_ms_window=8,
)
