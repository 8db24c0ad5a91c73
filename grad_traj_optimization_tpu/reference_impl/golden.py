"""Float64 NumPy oracle mirroring the reference C++ math.

The reference has no automated tests and its optimizer output is
machine-dependent (NLopt seeded from the wall clock with wall-clock stop,
grad_traj_optimizer.cpp:135-148), so trajectory parity is defined against
this deterministic float64 reimplementation of the C++ *math*: the same
EDT, the same dense QP construction (including the literal 6m x 6m
``A.inverse()``), the same cost/gradient formulas with all their quirks.
The JAX path is tested against this oracle at the 1e-3 positional
tolerance demanded by BASELINE.md.

Everything here is written for clarity over speed (plain loops), exactly
because it is the yardstick, not the product.
"""

from __future__ import annotations

import numpy as np

INF = float("inf")


# ---------------------------------------------------------------------------
# SDF map (reference src/sdf_map.cpp)
# ---------------------------------------------------------------------------


class GoldenSDFMap:
    """Occupancy + Felzenszwalb EDT + trilinear sampling, float64."""

    def __init__(self, origin, resolution, map_size):
        self.origin = np.asarray(origin, dtype=np.float64)
        self.resolution = float(resolution)
        self.map_size = np.asarray(map_size, dtype=np.float64)
        self.grid = np.ceil(self.map_size / self.resolution).astype(int)
        self.occ = np.zeros(self.grid, dtype=np.float64)
        self.dist = np.full(self.grid, 10000.0)

    # -- indexing (sdf_map.cpp:55-78) --
    def in_map(self, pos):
        lo = self.origin + 1e-4
        hi = self.origin + self.map_size - 1e-4
        return bool(np.all(pos > lo) and np.all(pos < hi))

    def pos_to_index(self, pos):
        return np.floor((pos - self.origin) / self.resolution).astype(int)

    def set_occupancy(self, pos):
        pos = np.asarray(pos, dtype=np.float64)
        if not self.in_map(pos):
            return
        i = self.pos_to_index(pos)
        self.occ[i[0], i[1], i[2]] = 1.0

    # -- EDT (sdf_map.cpp:266-368) --
    @staticmethod
    def _dt_1d(f):
        """Exact 1-D squared distance transform (lower envelope of
        parabolas), sequential as in the C++ fillESDF."""
        n = len(f)
        d = np.empty(n)
        v = np.zeros(n, dtype=int)
        z = np.empty(n + 1)
        k = 0
        v[0] = 0
        z[0] = -INF
        z[1] = INF
        for q in range(1, n):
            while True:
                num = (f[q] + q * q) - (f[v[k]] + v[k] * v[k])
                s = num / (2 * q - 2 * v[k])
                if s <= z[k]:
                    k -= 1
                else:
                    break
            k += 1
            v[k] = q
            z[k] = s
            z[k + 1] = INF
        k = 0
        for q in range(n):
            while z[k + 1] < q:
                k += 1
            d[q] = (q - v[k]) ** 2 + f[v[k]]
        return d

    def update_esdf(self):
        nx, ny, nz = self.grid
        big = 1e30  # stands in for +inf to avoid inf-inf in the envelope
        tmp1 = np.empty(self.grid)
        tmp2 = np.empty(self.grid)
        for x in range(nx):
            for y in range(ny):
                f = np.where(self.occ[x, y, :] == 1, 0.0, big)
                tmp1[x, y, :] = self._dt_1d(f)
        for x in range(nx):
            for z in range(nz):
                tmp2[x, :, z] = self._dt_1d(tmp1[x, :, z])
        for y in range(ny):
            for z in range(nz):
                val = self._dt_1d(tmp2[:, y, z])
                self.dist[:, y, z] = np.minimum(
                    self.resolution * np.sqrt(val), self.dist[:, y, z]
                )

    # -- queries (sdf_map.cpp:155-242) --
    def get_distance_idx(self, ix, iy, iz):
        g = self.grid
        ix = min(max(ix, 0), g[0] - 1)
        iy = min(max(iy, 0), g[1] - 1)
        iz = min(max(iz, 0), g[2] - 1)
        return self.dist[ix, iy, iz]

    def dist_with_grad_trilinear(self, pos):
        pos = np.asarray(pos, dtype=np.float64)
        if not self.in_map(pos):
            return -1.0, np.zeros(3)
        res = self.resolution
        pos_m = pos - 0.5 * res
        idx = self.pos_to_index(pos_m)
        idx_pos = (idx + 0.5) * res + self.origin
        diff = (pos - idx_pos) / res

        values = np.empty((2, 2, 2))
        for a in range(2):
            for b in range(2):
                for c in range(2):
                    values[a, b, c] = self.get_distance_idx(
                        idx[0] + a, idx[1] + b, idx[2] + c
                    )

        v00 = (1 - diff[0]) * values[0, 0, 0] + diff[0] * values[1, 0, 0]
        v01 = (1 - diff[0]) * values[0, 0, 1] + diff[0] * values[1, 0, 1]
        v10 = (1 - diff[0]) * values[0, 1, 0] + diff[0] * values[1, 1, 0]
        v11 = (1 - diff[0]) * values[0, 1, 1] + diff[0] * values[1, 1, 1]
        v0 = (1 - diff[1]) * v00 + diff[1] * v10
        v1 = (1 - diff[1]) * v01 + diff[1] * v11
        dist = (1 - diff[2]) * v0 + diff[2] * v1

        grad = np.zeros(3)
        grad[2] = (v1 - v0) / res
        grad[1] = ((1 - diff[2]) * (v10 - v00) + diff[2] * (v11 - v01)) / res
        grad[0] = (
            (1 - diff[2]) * (1 - diff[1]) * (values[1, 0, 0] - values[0, 0, 0])
            + (1 - diff[2]) * diff[1] * (values[1, 1, 0] - values[0, 1, 0])
            + diff[2] * (1 - diff[1]) * (values[1, 0, 1] - values[0, 0, 1])
            + diff[2] * diff[1] * (values[1, 1, 1] - values[0, 1, 1])
        ) / res
        return dist, grad


# ---------------------------------------------------------------------------
# QP generator (reference src/qp_generator.cpp), dense float64
# ---------------------------------------------------------------------------


def _factorial(x):
    f = 1
    for i in range(x, 0, -1):
        f *= i
    return f


def mapping_matrix(times):
    """Dense block-diagonal A (6m x 6m), qp_generator.cpp:40-54."""
    m = len(times)
    A = np.zeros((6 * m, 6 * m))
    for k in range(m):
        ab = np.zeros((6, 6))
        for i in range(3):
            ab[2 * i, i] = _factorial(i)
            for j in range(i, 6):
                ab[2 * i + 1, j] = (
                    _factorial(j) / _factorial(j - i) * times[k] ** (j - i)
                )
        A[6 * k : 6 * k + 6, 6 * k : 6 * k + 6] = ab
    return A


def snap_hessian(times):
    """Dense Q (6m x 6m), qp_generator.cpp:99-110."""
    m = len(times)
    Q = np.zeros((6 * m, 6 * m))
    for k in range(m):
        for i in range(3, 6):
            for j in range(3, 6):
                Q[6 * k + i, 6 * k + j] = (
                    i * (i - 1) * (i - 2) * j * (j - 1) * (j - 2)
                    / (i + j - 5) * times[k] ** (i + j - 5)
                )
    return Q


def opt_ct(m):
    """Ct of StackOptiDep (qp_generator.cpp:357-390), dense."""
    num_f, num_p = 6, 3 * m - 3
    ct = np.zeros((6 * m, num_f + num_p))
    ct[0, 0] = 1
    ct[2, 1] = 1
    ct[4, 2] = 1
    ct[1, 6] = 1
    ct[3, 7] = 1
    ct[5, 8] = 1
    ct[6 * (m - 1) + 0, 3 * m + 0] = 1
    ct[6 * (m - 1) + 2, 3 * m + 1] = 1
    ct[6 * (m - 1) + 4, 3 * m + 2] = 1
    ct[6 * (m - 1) + 1, 3] = 1
    ct[6 * (m - 1) + 3, 4] = 1
    ct[6 * (m - 1) + 5, 5] = 1
    for j in range(2, m):
        ct[6 * (j - 1) + 0, 6 + 3 * (j - 2) + 0] = 1
        ct[6 * (j - 1) + 1, 6 + 3 * (j - 1) + 0] = 1
        ct[6 * (j - 1) + 2, 6 + 3 * (j - 2) + 1] = 1
        ct[6 * (j - 1) + 3, 6 + 3 * (j - 1) + 1] = 1
        ct[6 * (j - 1) + 4, 6 + 3 * (j - 2) + 2] = 1
        ct[6 * (j - 1) + 5, 6 + 3 * (j - 1) + 2] = 1
    return ct


class GoldenDeps:
    """A, Q, Ct, L, R and blocks for the optimizer partition."""

    def __init__(self, times):
        times = np.asarray(times, dtype=np.float64)
        m = self.m = len(times)
        self.A = mapping_matrix(times)
        self.Q = snap_hessian(times)
        ct = opt_ct(m)
        ainv = np.linalg.inv(self.A)
        self.L = ainv @ ct
        self.R = ct.T @ ainv.T @ self.Q @ ainv @ ct
        self.Rff = self.R[:6, :6]
        self.Rfp = self.R[:6, 6:]
        self.Rpf = self.R[6:, :6]
        self.Rpp = self.R[6:, 6:]
        self.num_dp = 3 * m - 3


def straight_line_init(waypoints, mean_v, init_time):
    """Segment times + initial (Df, Dp) for the setPath flow
    (grad_traj_optimizer.cpp:67-110 with type=2 QP)."""
    wp = np.asarray(waypoints, dtype=np.float64)
    m = len(wp) - 1
    times = np.zeros(m)
    for i in range(m):
        ln = np.linalg.norm(wp[i] - wp[i + 1])
        times[i] = ln / mean_v + (init_time if i == 0 else 0.0)
    Df = np.zeros((3, 6))
    Df[:, 0] = wp[0]
    Df[:, 3] = wp[m]
    Dp = np.zeros((3, 3 * m - 3))
    for k in range(1, m):
        Dp[:, (k - 1) * 3] = wp[k]
    return times, Df, Dp


# ---------------------------------------------------------------------------
# Cost and gradient (reference grad_traj_optimizer.cpp:281-448)
# ---------------------------------------------------------------------------


class GoldenOptimizer:
    def __init__(self, sdf_map: GoldenSDFMap, cfg):
        """cfg is an OptimizerConfig (duck-typed)."""
        self.map = sdf_map
        self.cfg = cfg

    def setup(self, waypoints):
        self.waypoints = np.asarray(waypoints, dtype=np.float64)
        self.times, self.Df, self.Dp0 = straight_line_init(
            waypoints, self.cfg.mean_v, self.cfg.init_time
        )
        self.deps = GoldenDeps(self.times)
        # closed-form smoothness optimum dp* = -Rpp^-1 Rfp^T df
        # (core/qp.min_snap_dp; clipped to bounds in optimize())
        self.Dp0_min_snap = np.linalg.solve(
            self.deps.Rpp, -(self.Df @ self.deps.Rfp).T
        ).T
        if getattr(self.cfg, "seed_mode", "reference") == "min_snap":
            self.Dp0 = self.Dp0_min_snap
        self.V = np.zeros((6, 6))
        for i in range(5):
            self.V[i, i + 1] = i + 1

    def coeff_from_d(self, dp):
        """coeff (m, 3, 6): grad_traj_optimizer.cpp:253-279."""
        deps = self.deps
        m = deps.m
        out = np.zeros((m, 3, 6))
        for ax in range(3):
            d = np.concatenate([self.Df[ax], dp[ax]])
            coe = deps.L @ d
            for s in range(m):
                out[s, ax] = coe[6 * s : 6 * s + 6]
        return out

    def cost_and_grad(self, dp, step=2):
        cfg = self.cfg
        deps = self.deps
        num_dp = deps.num_dp
        cost_smooth = 0.0
        g_smooth = np.zeros((3, num_dp))
        for ax in range(3):
            d = np.concatenate([self.Df[ax], dp[ax]])
            cost_smooth += d @ deps.R @ d
            g_smooth[ax] = 2 * deps.Rfp.T @ self.Df[ax] + 2 * deps.Rpp @ dp[ax]

        coe = self.coeff_from_d(dp)
        cost_colli = 0.0
        cost_vel = 0.0
        cost_acc = 0.0
        g_colli = np.zeros((3, num_dp))
        g_vel = np.zeros((3, num_dp))
        g_acc = np.zeros((3, num_dp))
        alpha_v = getattr(cfg, "alpha_v", 0.0)
        alpha_a = getattr(cfg, "alpha_a", 0.0)
        use_va = step == 2 and (alpha_v != 0.0 or alpha_a != 0.0)
        if abs(cfg.w_collision) >= 1e-4:
            for s in range(deps.m):
                Ldp = deps.L[6 * s : 6 * s + 6, 6:]
                dt = self.times[s] / cfg.n_samples
                t = cfg.t_offset
                while t < self.times[s]:
                    tv = np.array([t**i for i in range(6)])
                    tvv = tv @ self.V  # velocity basis
                    pos = coe[s] @ tv
                    vel = coe[s] @ tvv
                    vel_norm = np.linalg.norm(vel) + cfg.vel_eps
                    dist, grad = self.map.dist_with_grad_trilinear(pos)
                    cd = cfg.alpha * np.exp(-(dist - cfg.d0) / cfg.r)
                    gd = -(cfg.alpha / cfg.r) * np.exp(
                        -(dist - cfg.d0) / cfg.r
                    )
                    cost_colli += cd * vel_norm * dt
                    TL = tv @ Ldp
                    TVL = tvv @ Ldp
                    for k in range(3):
                        g_colli[k] += (
                            gd * grad[k] * cd * vel_norm * TL
                            + cd * (vel[k] / vel_norm) * TVL
                        ) * dt
                    if use_va:
                        # the commented usage block (grad_traj_optimizer.
                        # cpp:382-407), replicated loop-for-loop: cv/ca
                        # keep the LAST axis's value into the gradient
                        # loop, and the penalty "gradients" carry no
                        # sign(v)/sign(a) factor (:517-535)
                        tvvv = tvv @ self.V  # acceleration basis
                        acc = coe[s] @ tvvv
                        TAL = tvvv @ Ldp
                        cv = ca = 0.0
                        for k in range(3):
                            cv = alpha_v * np.exp(
                                (abs(vel[k]) - cfg.v0) / cfg.r_v
                            )
                            cost_vel += cv * vel_norm * dt
                            ca = alpha_a * np.exp(
                                (abs(acc[k]) - cfg.a0) / cfg.r_a
                            )
                            cost_acc += ca * vel_norm * dt
                        for k in range(3):
                            gv = (alpha_v / cfg.r_v) * np.exp(
                                (abs(vel[k]) - cfg.v0) / cfg.r_v
                            )
                            g_vel[k] += (
                                gv * vel_norm * TVL
                                + cv * (vel[k] / vel_norm) * TVL
                            ) * dt
                            ga = (alpha_a / cfg.r_a) * np.exp(
                                (abs(acc[k]) - cfg.a0) / cfg.r_a
                            )
                            g_acc[k] += (
                                ga * vel_norm * TAL
                                + ca * (vel[k] / vel_norm) * TVL
                            ) * dt
                    t += dt

        ws = 0.0 if step == 1 else cfg.w_smooth
        wc = cfg.w_collision
        wv = wa = 1.0  # fixed in the reference (:412)
        cost = (
            ws * cost_smooth + wc * cost_colli
            + wv * cost_vel + wa * cost_acc + cfg.cost_eps
        )
        grad = (
            ws * g_smooth + wc * g_colli
            + wv * g_vel + wa * g_acc + cfg.grad_eps
        )
        return cost, grad

    def bounds(self):
        """grad_traj_optimizer.cpp:154-177."""
        cfg = self.cfg
        num_dp = self.deps.num_dp
        lb = np.zeros((3, num_dp))
        ub = np.zeros((3, num_dp))
        for i in range(num_dp):
            if i % 3 == 0:
                wpt = self.waypoints[i // 3 + 1]
                lb[:, i] = wpt - cfg.bos
                ub[:, i] = wpt + cfg.bos
            elif i % 3 == 1:
                lb[:, i], ub[:, i] = -cfg.vos, cfg.vos
            else:
                lb[:, i], ub[:, i] = -cfg.aos, cfg.aos
        return lb, ub

    def optimize(self, steps=(2,)):
        """Deterministic float64 run of the same projected descent the JAX
        path uses (opt/descent.py), for end-to-end parity checks.

        seed_mode='dual' races both seeds exactly as solver._combine_dual:
        the reference-seed arm at the full step-2 budget and the min-snap
        arm at ``dual_ms_iters`` (0 = full), keeping the lower-cost arm.
        ``polish_iters`` then restarts the descent from the winner for
        that many step-2 iterations (fresh BB state, solver._merge_polish
        semantics: the lower of winner/polished cost is returned — the
        polish starts at the winner so it can only improve).
        """
        cfg = self.cfg
        if getattr(cfg, "seed_mode", "reference") == "dual":
            dp_a = self._descend(self.Dp0, steps, cfg.iters_step2)
            ms_iters = getattr(cfg, "dual_ms_iters", 0) or cfg.iters_step2
            ms_w = getattr(cfg, "dual_ms_window", 0)
            dp_b = self._descend(
                self.Dp0_min_snap, steps, ms_iters, accept_window=ms_w
            )
            final = max(steps)
            dp = dp_a if (
                self.cost_only(dp_a, final) <= self.cost_only(dp_b, final)
            ) else dp_b
            polish = getattr(cfg, "polish_iters", 0)
            if polish > 0:
                dp_p = self._descend(dp, (2,), polish)
                if self.cost_only(dp_p, 2) < self.cost_only(dp, final):
                    dp = dp_p
        else:
            dp = self._descend(self.Dp0, steps, cfg.iters_step2)
        return dp, self.coeff_from_d(dp)

    def _descend(self, dp0, steps, iters_step2, accept_window=0):
        cfg = self.cfg
        dp = dp0.copy()
        lb, ub = self.bounds()
        dp = np.clip(dp, lb, ub)
        use_bb = getattr(cfg, "step_rule", "adaptive") == "bb"
        W = accept_window or getattr(cfg, "accept_window", 1)
        for step in steps:
            iters = cfg.iters_step1 if step == 1 else iters_step2
            # fused scheme (must mirror opt/descent.py): one cost+grad per
            # iteration, gradient cached across rejections; step rule is
            # either multiplicative-adaptive or Barzilai-Borwein;
            # acceptance compares against the max of the last W accepted
            # costs (W = 1: strict monotone), best iterate returned
            cost, g = self.cost_and_grad(dp, step)
            lr = (
                cfg.lr0 / (np.linalg.norm(g) + 1e-12)
                if use_bb else cfg.lr0
            )
            scale = 1.0
            hist = np.full(W, cost)
            ptr = 0
            best_c, best_dp = cost, dp.copy()
            for _ in range(iters):
                if use_bb:
                    stepsz = lr * scale
                else:
                    stepsz = lr / (np.linalg.norm(g) + 1e-12)
                cand = np.clip(dp - stepsz * g, lb, ub)
                c2, g2 = self.cost_and_grad(cand, step)
                accept = c2 < hist.max()
                if use_bb:
                    if accept:
                        s = cand - dp
                        y = g2 - g
                        sy = abs(np.sum(s * y))
                        yy = max(np.sum(y * y), 1e-20)
                        lr = np.clip(sy / yy, cfg.lr_min, cfg.lr_max)
                        scale = 1.0
                    else:
                        scale = max(scale * cfg.lr_shrink, 1e-8)
                else:
                    if accept:
                        lr = min(lr * cfg.lr_grow, cfg.lr_max)
                    else:
                        lr = max(lr * cfg.lr_shrink, cfg.lr_min)
                if c2 < best_c:
                    best_c, best_dp = c2, cand.copy()
                if accept:
                    hist[ptr] = c2
                    ptr = (ptr + 1) % W
                    dp, g = cand, g2
            dp = best_dp
        return dp

    def cost_only(self, dp, step=2):
        c, _ = self.cost_and_grad(dp, step)
        return c
