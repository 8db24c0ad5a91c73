"""Ramer-Douglas-Peucker polyline simplification.

Rebuild of the reference ``RDPCurveSimplifier``
(douglas_peucker.hpp:36-157): iteratively split each segment at the point
with the largest perpendicular distance to the chord until every point is
within epsilon of its chord.  Used to turn dense search paths (hundreds of
cell centers) into sparse waypoints for the QP seeding.

Two implementations:

* :func:`simplify` — host-side NumPy recursion (search post-processing is
  tiny and irregular; this is the pragmatic default between the device
  search and the device refinement stages).
* :func:`simplify_masked` — fixed-depth masked JAX version for use inside
  jitted pipelines: returns a keep-mask over the input points.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _perp_dist(front, back, pts):
    """Perpendicular distance of pts to the line through front->back
    (douglas_peucker.hpp:148-157: cross-product with normalized chord)."""
    d = back - front
    n = np.linalg.norm(d)
    if n < 1e-12:
        return np.linalg.norm(pts - front, axis=-1)
    d = d / n
    v = pts - front
    return np.linalg.norm(np.cross(v, d), axis=-1)


def simplify(curve, epsilon: float, return_index: bool = False):
    """Simplify an (N, 3) polyline; returns (M, 3) with endpoints kept.

    With ``return_index`` also returns the kept indices (M,) into the
    input — used to carry per-point side data (e.g. RRT* safe-ball
    radii) through the simplification.
    """
    curve = np.asarray(curve, dtype=np.float64)
    n = len(curve)
    if n <= 2:
        if return_index:
            return curve.copy(), np.arange(n)
        return curve.copy()
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j - i < 2:
            continue
        seg = curve[i + 1 : j]
        dist = _perp_dist(curve[i], curve[j], seg)
        k = int(np.argmax(dist))
        if dist[k] > epsilon:
            split = i + 1 + k
            keep[split] = True
            stack.append((i, split))
            stack.append((split, j))
    if return_index:
        return curve[keep], np.nonzero(keep)[0]
    return curve[keep]


def simplify_masked(curve, valid, epsilon: float, max_depth: int = 10):
    """Jit-friendly RDP: returns a keep mask (bool, same length).

    ``valid`` masks real points of a padded path (padding must repeat the
    last valid point).  Splits all active chords simultaneously per depth
    level — max_depth levels bound the recursion (2^max_depth segments).
    """
    curve = jnp.asarray(curve)
    n = curve.shape[0]
    valid = jnp.asarray(valid)
    last = jnp.maximum(jnp.sum(valid.astype(jnp.int32)) - 1, 1)

    keep = jnp.zeros(n, bool).at[0].set(True).at[last].set(True)
    # seg_id[i]: index of the chord-start for point i = cummax of kept idx
    idxs = jnp.arange(n)

    def level(keep, _):
        kept_idx = jnp.where(keep, idxs, -1)
        start = jax.lax.cummax(kept_idx)  # chord start per point
        # chord end per point: next kept index (reverse cummax trick)
        rev = jnp.where(keep, idxs, n * 2)[::-1]
        end = jax.lax.cummin(rev)[::-1]
        fr = curve[jnp.clip(start, 0, n - 1)]
        bk = curve[jnp.clip(end, 0, n - 1)]
        d = bk - fr
        dn = jnp.linalg.norm(d, axis=-1, keepdims=True)
        dhat = d / jnp.maximum(dn, 1e-12)
        v = curve - fr
        dist = jnp.linalg.norm(jnp.cross(v, dhat), axis=-1)
        interior = (idxs > start) & (idxs < end) & valid & (idxs <= last)
        dist = jnp.where(interior, dist, -1.0)
        # per-chord argmax via segment trick: one-hot the max in each chord
        # chords are contiguous; use start as segment id
        seg_max = jax.ops.segment_max(
            dist, start, num_segments=n, indices_are_sorted=True
        )
        is_max = (dist >= seg_max[jnp.clip(start, 0, n - 1)] - 1e-12) & (
            dist > epsilon
        )
        # keep only the first max per chord
        first_max = is_max & (
            jax.lax.cummax(jnp.where(is_max, idxs, -1)) == idxs
        )
        return keep | first_max, None

    keep, _ = jax.lax.scan(level, keep, None, length=max_depth)
    return keep & (valid | (idxs == 0))
