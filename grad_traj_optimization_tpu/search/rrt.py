"""Safe-ball informed RRT* seeding (host-side utility).

Rebuild of the reference ``rrtPathFinder`` (path_finder.{h,cpp}) and the
simpler ``rrgPathFinder`` capability: nodes are safe balls (center +
clearance radius), sampling is goal-biased and — once a solution exists —
restricted to the informed prolate spheroid, edges require overlapping
safe balls (which guarantees the straight segment between centers is
collision-free), and RRT* rewiring keeps the tree asymptotically optimal.
The output is the waypoint path plus per-node radii — the safe corridor
the reference feeds downstream (path_finder.cpp:806-887).

The reference's receding-horizon machinery is rebuilt in
:class:`RRTPlanner`:

- ``grow(n)``            — RRTpathFind sampling rounds (path_finder.cpp:713-804)
- ``reset_root(p)``      — commit a new root mid-flight; nodes behind the
                           commit ball are cut and costs recast
                           (resetRoot/costRecast, :302-375)
- ``update_map(dist)``   — revalidate the tree under a map change:
                           shrink-only radii, branch cuts on failed nodes,
                           local reconnection of orphaned subtrees, best-path
                           re-evaluation, and repair sampling around the
                           failure regions (RRTpathReEvaluate/ReConnect/
                           treeRepair, :1065-1554)
- ``result()``           — tracePath/getPath (:806-887)

Deliberate deviations (SURVEY.md section 2 row 11): sampling-based search
is a poor fit for the accelerator hot path, so this runs on host NumPy as a
*seeding utility*; clearance radii come from the EDT grid instead of a
PCL k-d tree over raw points (the EDT is already built for the
optimizer); orphan reconnection walks the flat node arrays instead of a
k-d range query; and ``treeRepair`` re-samples the failure neighborhoods
with the standard insertion routine rather than re-inspecting cached
neighbors (the reference's repair loop exists to avoid k-d rebuilds,
which the array layout does not need).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RRTResult:
    path: np.ndarray        # (K, 3) waypoints start..goal
    radii: np.ndarray       # (K,) safe-ball radius per waypoint
    reached: bool
    cost: float             # path length
    n_nodes: int


def _dist_at(dist_grid, origin, resolution, p):
    g = dist_grid.shape
    idx = np.floor((p - origin) / resolution).astype(int)
    if np.any(idx < 0) or np.any(idx >= np.asarray(g)):
        return -1.0
    return float(dist_grid[idx[0], idx[1], idx[2]])


class RRTPlanner:
    """Incremental safe-ball informed RRT* over an EDT grid.

    Holds the tree as flat arrays (centers/radii/parents/costs/valid) so
    revalidation under map changes is vectorized.  ``plan`` below is the
    one-shot convenience wrapper.
    """

    def __init__(
        self,
        dist_grid,
        origin,
        resolution,
        start,
        goal,
        steer_len: float = 1.5,
        min_radius: float = 0.3,
        goal_bias: float = 0.15,
        radius_margin: float | None = None,
        seed: int = 0,
    ):
        self.dist = np.asarray(dist_grid)
        self.origin = np.asarray(origin, dtype=np.float64)
        self.resolution = float(resolution)
        self.goal = np.asarray(goal, dtype=np.float64)
        self.size = np.asarray(self.dist.shape) * self.resolution
        self.steer_len = steer_len
        self.min_radius = min_radius
        self.goal_bias = goal_bias
        # The cell-center EDT overestimates clearance to the obstacle
        # *region* by up to res*sqrt(3)/2, so the default margin is
        # max(0.15, 0.87*res) (reference: radius = nearest-obstacle
        # distance - 0.15, rrgPathFinder.cpp:96-110).
        if radius_margin is None:
            radius_margin = max(0.15, 0.87 * self.resolution)
        self.radius_margin = radius_margin
        self.rng = np.random.default_rng(seed)

        start = np.asarray(start, dtype=np.float64)
        r0 = self._clearance(start)
        self.centers = [start]
        self.radii = [max(r0, min_radius)]
        self.parents = [-1]
        self.costs = [0.0]
        self.valid = [True]
        self.root = 0
        self.goal_nodes: list[int] = []   # EndList analogue
        self.best_goal_node = -1
        self.best_cost = np.inf
        self.commit_end = False           # resetRoot's terminal flag

    # -- geometry helpers ------------------------------------------------

    def _clearance(self, p):
        return _dist_at(self.dist, self.origin, self.resolution, p) \
            - self.radius_margin

    def _sample(self):
        """Goal-biased uniform / informed-spheroid sample
        (path_finder.cpp:420-478)."""
        if self.rng.random() < self.goal_bias:
            return self.goal.copy()
        if np.isfinite(self.best_cost):
            root_c = self.centers[self.root]
            c_min = float(np.linalg.norm(self.goal - root_c))
            c_best = max(self.best_cost, c_min + 1e-6)
            center = 0.5 * (root_c + self.goal)
            a1 = (self.goal - root_c) / max(c_min, 1e-9)
            r1 = c_best / 2.0
            r23 = np.sqrt(max(c_best**2 - c_min**2, 1e-9)) / 2.0
            while True:
                u = self.rng.normal(size=3)
                u /= np.linalg.norm(u)
                u *= self.rng.random() ** (1 / 3)
                basis = _frame(a1)
                p = center + basis @ (np.array([r1, r23, r23]) * u)
                if np.all(p > self.origin) and np.all(p < self.origin + self.size):
                    return p
        return self.origin + self.rng.random(3) * self.size

    def _try_insert(self, x, steer: bool = True):
        """Steer toward x from its nearest valid node and insert with
        choose-parent + rewire (path_finder.cpp:480-509, 592-705).
        Returns the new node index or -1."""
        c_arr = np.asarray(self.centers)
        vmask = np.asarray(self.valid)
        d2 = np.sum((c_arr - x) ** 2, axis=1)
        d2[~vmask] = np.inf
        near = int(np.argmin(d2))
        dn = np.sqrt(d2[near])
        if not np.isfinite(dn) or dn < 1e-9:
            return -1
        if steer:
            x = c_arr[near] + (x - c_arr[near]) * min(1.0, self.steer_len / dn)

        r = self._clearance(x)
        if r < self.min_radius:
            return -1

        rr = np.asarray(self.radii)
        d = np.sqrt(np.sum((c_arr - x) ** 2, axis=1))
        connectable = vmask & (d <= rr + r)
        if not connectable.any():
            return -1
        cand_costs = np.asarray(self.costs) + d
        cand_costs[~connectable] = np.inf
        parent = int(np.argmin(cand_costs))
        new_cost = float(cand_costs[parent])
        if not np.isfinite(new_cost):
            return -1

        self.centers.append(x)
        self.radii.append(r)
        self.parents.append(parent)
        self.costs.append(new_cost)
        self.valid.append(True)
        i_new = len(self.centers) - 1

        # rewire neighbors through the new node
        improve = connectable & (np.asarray(self.costs[:-1]) > new_cost + d)
        for j in np.nonzero(improve)[0]:
            if j == self.root:
                continue
            self.parents[j] = i_new
            self.costs[j] = new_cost + d[j]

        # goal reachable from the new ball?  (EndList bookkeeping)
        dg = float(np.linalg.norm(self.goal - x))
        if dg <= r:
            self.goal_nodes.append(i_new)
            if new_cost + dg < self.best_cost:
                self.best_cost = new_cost + dg
                self.best_goal_node = i_new
        return i_new

    # -- the reference API surface ----------------------------------------

    def grow(self, n_iters: int):
        """Run ``n_iters`` sampling rounds (RRTpathFind's loop body,
        path_finder.cpp:713-804)."""
        for _ in range(n_iters):
            self._try_insert(self._sample())
        return np.isfinite(self.best_cost)

    def reset_root(self, commit_target):
        """Commit a new root as the vehicle advances along the best path
        (resetRoot, path_finder.cpp:302-363): the path node closest to the
        goal whose safe ball contains ``commit_target`` becomes the root;
        everything not in its subtree is cut and costs are recast
        (costRecast, :365-375) so g is measured from the new root."""
        commit_target = np.asarray(commit_target, dtype=np.float64)
        if self.best_goal_node < 0:
            return False
        chain = self._chain(self.best_goal_node)
        end = chain[-1]
        if (
            np.linalg.norm(self.centers[end] - commit_target)
            < self.radii[end]
        ):
            # almost at the final target (reference early return)
            self.commit_end = True
            return True
        new_root = -1
        for i in reversed(chain):  # closest-to-goal containing node wins
            if (
                np.linalg.norm(self.centers[i] - commit_target)
                < self.radii[i] - 0.1
            ):
                new_root = i
                break
        if new_root < 0 or new_root == self.root:
            return new_root == self.root
        keep = self._subtree(new_root)
        for i in range(len(self.centers)):
            if self.valid[i] and i not in keep:
                self.valid[i] = False
        self.parents[new_root] = -1
        self.root = new_root
        self._recompute_costs()
        self._reevaluate_best()
        return True

    def update_map(self, dist_grid, repair_iters: int = 60):
        """Revalidate the tree against a changed map
        (RRTpathReEvaluate + ReConnect + treeRepair,
        path_finder.cpp:1065-1554).

        Radii are shrink-only ("the radius of a node may shrink or remain
        no change, but can not enlarge", :1138-1141); nodes whose ball
        drops below ``min_radius`` are cut with their branches, orphaned
        but still-valid subtrees are locally reconnected where safe-ball
        overlap permits, the goal list and best path are re-evaluated, and
        ``repair_iters`` insertion attempts are spent around the failure
        regions.  Returns True if a path to goal survives (or is repaired
        in-call)."""
        self.dist = np.asarray(dist_grid)
        n = len(self.centers)
        repair_regions: list[tuple[np.ndarray, float]] = []

        # 1. shrink-only radius refresh; cut failed nodes + branches.
        #    One adjacency build serves every cut: marking an already-cut
        #    branch invalid again is idempotent, so the entry-time lists
        #    give the same result as a per-cut rebuild at O(n) total
        #    instead of O(n * n_failed)
        adj = self._children_adjacency()
        for i in range(n):
            if not self.valid[i]:
                continue
            new_r = min(self.radii[i], self._clearance(self.centers[i]))
            self.radii[i] = new_r
            if new_r < self.min_radius and i != self.root:
                repair_regions.append(
                    (self.centers[i].copy(), max(new_r, self.min_radius))
                )
                for j in self._subtree(i, children=adj):
                    self.valid[j] = False

        # 2. BFS from root over still-overlapping edges → reachable set
        children: list[list[int]] = [[] for _ in range(n)]
        for i in range(n):
            p = self.parents[i]
            if i != self.root and self.valid[i] and p >= 0:
                children[p].append(i)
        reach = {self.root} if self.valid[self.root] else set()
        stack = list(reach)
        while stack:
            i = stack.pop()
            for j in children[i]:
                if not self.valid[j] or j in reach:
                    continue
                gap = np.linalg.norm(self.centers[i] - self.centers[j])
                if gap <= self.radii[i] + self.radii[j]:
                    reach.add(j)
                    stack.append(j)

        # 3. ReConnect rounds: orphaned valid subtree roots look for a new
        #    parent among reachable nodes (localReConnect analogue)
        orphans = [
            i for i in range(n)
            if self.valid[i] and i not in reach
        ]
        progress = True
        while progress and orphans:
            progress = False
            still = []
            for i in orphans:
                if i in reach:
                    continue
                best_j, best_c = -1, np.inf
                ci, ri = self.centers[i], self.radii[i]
                for j in reach:
                    gap = np.linalg.norm(self.centers[j] - ci)
                    if gap <= self.radii[j] + ri:
                        c = self.costs[j] + gap
                        if c < best_c:
                            best_j, best_c = j, c
                if best_j >= 0:
                    self.parents[i] = best_j
                    reach.add(i)
                    # the orphan's own intact subtree comes along
                    stack = [i]
                    while stack:
                        a = stack.pop()
                        for b in children[a]:
                            if self.valid[b] and b not in reach:
                                gap = np.linalg.norm(
                                    self.centers[a] - self.centers[b]
                                )
                                if gap <= self.radii[a] + self.radii[b]:
                                    reach.add(b)
                                    stack.append(b)
                    progress = True
                else:
                    still.append(i)
            orphans = still
        for i in orphans:
            if self.valid[i]:
                repair_regions.append(
                    (self.centers[i].copy(), max(self.radii[i], self.min_radius))
                )
            self.valid[i] = False

        self._recompute_costs()
        self._reevaluate_best()

        # 4. treeRepair: spend insertion attempts near the failure regions
        if repair_regions and repair_iters > 0:
            per = max(1, repair_iters // len(repair_regions))
            for center, r_old in repair_regions:
                for _ in range(per):
                    p = center + self.rng.normal(size=3) * r_old
                    self._try_insert(p)
            self._reevaluate_best()
        return np.isfinite(self.best_cost)

    def result(self) -> RRTResult:
        """Trace the best path (tracePath/getPath,
        path_finder.cpp:806-887)."""
        n_valid = int(np.count_nonzero(self.valid))
        if self.best_goal_node < 0:
            return RRTResult(
                path=np.asarray([self.centers[self.root]]),
                radii=np.asarray([self.radii[self.root]]),
                reached=False, cost=np.inf, n_nodes=n_valid,
            )
        chain = self._chain(self.best_goal_node)
        path = np.asarray([self.centers[i] for i in chain] + [self.goal])
        rads = np.asarray(
            [self.radii[i] for i in chain]
            + [max(self._clearance(self.goal), self.min_radius)]
        )
        return RRTResult(
            path=path, radii=rads, reached=True, cost=self.best_cost,
            n_nodes=n_valid,
        )

    # -- internals ---------------------------------------------------------

    def _chain(self, i):
        # bounded by node count: a rewire against stale descendant
        # costs could in principle create a parent cycle; an unbounded
        # walk would then never terminate (see the same guard in
        # native/gtop_core.cpp chain_of)
        chain = [i]
        n = len(self.parents)
        while self.parents[chain[-1]] >= 0 and len(chain) <= n:
            chain.append(self.parents[chain[-1]])
        chain.reverse()
        return chain

    def _children_adjacency(self):
        """Parent→children lists over currently-valid nodes (O(n))."""
        n = len(self.centers)
        children: list[list[int]] = [[] for _ in range(n)]
        for j in range(n):
            p = self.parents[j]
            if j != self.root and self.valid[j] and p >= 0:
                children[p].append(j)
        return children

    def _subtree(self, i, children=None):
        if children is None:
            children = self._children_adjacency()
        out = {i}
        stack = [i]
        while stack:
            a = stack.pop()
            for b in children[a]:
                if b not in out:
                    out.add(b)
                    stack.append(b)
        return out

    def _recompute_costs(self):
        """Top-down exact cost refresh from the root (the array analogue
        of costRecast + the reference's per-branch g updates)."""
        n = len(self.centers)
        children = self._children_adjacency()
        seen = set()
        if self.valid[self.root]:
            self.costs[self.root] = 0.0
            seen.add(self.root)
            stack = [self.root]
            while stack:
                a = stack.pop()
                for b in children[a]:
                    if b in seen:
                        continue
                    self.costs[b] = self.costs[a] + float(
                        np.linalg.norm(self.centers[a] - self.centers[b])
                    )
                    seen.add(b)
                    stack.append(b)
        # anything valid but unreachable from the root is dead weight
        for i in range(n):
            if self.valid[i] and i not in seen:
                self.valid[i] = False

    def _reevaluate_best(self):
        """Re-pick the best goal node among surviving EndList entries
        (RRTpathReEvaluate's feasibleEndList scan)."""
        self.goal_nodes = [
            i for i in self.goal_nodes
            if self.valid[i]
            and np.linalg.norm(self.goal - self.centers[i]) <= self.radii[i]
        ]
        self.best_goal_node = -1
        self.best_cost = np.inf
        for i in self.goal_nodes:
            c = self.costs[i] + float(np.linalg.norm(self.goal - self.centers[i]))
            if c < self.best_cost:
                self.best_cost = c
                self.best_goal_node = i


def plan(
    dist_grid,
    origin,
    resolution,
    start,
    goal,
    max_iters: int = 2000,
    steer_len: float = 1.5,
    min_radius: float = 0.3,
    goal_bias: float = 0.15,
    radius_margin: float | None = None,
    seed: int = 0,
) -> RRTResult:
    """Grow a safe-ball RRT* from start toward goal (one-shot).

    Args:
      dist_grid: (nx, ny, nz) EDT distance field (NumPy or JAX array).
      min_radius: minimum (shrunk) clearance for a node to be admitted.
      radius_margin: subtracted from the EDT value to get the safe-ball
        radius (reference: radius = nearest-obstacle distance - 0.15,
        rrgPathFinder.cpp:96-110); default max(0.15, 0.87 * resolution) —
        without it, overlapping balls can tunnel through one-cell walls.
    """
    planner = RRTPlanner(
        dist_grid, origin, resolution, start, goal,
        steer_len=steer_len, min_radius=min_radius, goal_bias=goal_bias,
        radius_margin=radius_margin, seed=seed,
    )
    planner.grow(max_iters)
    return planner.result()


def corridor_waypoints(
    result: RRTResult,
    rdp_epsilon: float = 0.4,
    min_bos: float = 0.3,
):
    """RDP-simplify an RRT* path, carrying the safe-ball radii along.

    The reference's RRT* output is consumed downstream as a corridor —
    waypoints plus per-node clearance radii (path_finder.cpp:806-887,
    tracePath/getPath return (Path, Radius)).  This is the rebuild's
    consumer hookup: the kept waypoints seed the QP, and each kept
    node's radius becomes that waypoint's position-bound half-width
    (penalty.bounds ``bos``), so the optimizer's interior waypoints
    cannot leave their safe balls.

    Returns (waypoints (K, 3), bos_wp (K,)).  ``min_bos`` floors the
    half-widths so a tight ball still leaves the optimizer room to
    polish.
    """
    from grad_traj_optimization_tpu.search import rdp

    if not result.reached:
        raise ValueError("corridor_waypoints needs a reached RRTResult")
    wps, idx = rdp.simplify(result.path, rdp_epsilon, return_index=True)
    bos_wp = np.maximum(np.asarray(result.radii)[idx], min_bos)
    return wps, bos_wp


def trim_passed(path, radii, pos):
    """Drop corridor nodes the vehicle has already flown past.

    Projects ``pos`` onto the path polyline and keeps everything after
    the closest segment.  The receding-horizon loop needs this because a
    root commit (resetRoot) only advances when a path ball CONTAINS the
    flown state (path_finder.cpp:302-363); when the refined trajectory
    cuts a corner outside the balls, the traced path still starts at the
    old root and the refinement corridor would pin an interior waypoint
    BEHIND the vehicle — the optimizer then shapes a backtracking
    trajectory whose first flown window nearly cancels, stalling the
    flight.

    Returns (path', radii') — the forward remainder, always ending at
    the original final node (the goal); may be length 1.
    """
    path = np.asarray(path, np.float64)
    radii = np.asarray(radii, np.float64)
    pos = np.asarray(pos, np.float64)
    if len(path) <= 2:
        return path[1:], radii[1:]
    best_s, best_d = 0, np.inf
    for s in range(len(path) - 1):
        a, b = path[s], path[s + 1]
        ab = b - a
        L2 = float(ab @ ab)
        t = 0.0 if L2 < 1e-12 else float(
            np.clip((pos - a) @ ab / L2, 0.0, 1.0)
        )
        d = float(np.linalg.norm(a + t * ab - pos))
        if d < best_d:
            best_d, best_s = d, s
    return path[best_s + 1:], radii[best_s + 1:]


def _frame(a1):
    """Orthonormal frame with first axis a1."""
    e = np.array([1.0, 0.0, 0.0])
    if abs(a1 @ e) > 0.9:
        e = np.array([0.0, 1.0, 0.0])
    b = np.cross(a1, e)
    b /= np.linalg.norm(b)
    c = np.cross(a1, b)
    return np.stack([a1, b, c], axis=1)
