"""Spatially-sharded Euclidean distance transform.

For large grids (BASELINE.md stress config: 512^3 = 537 MB f32) the
voxel grid is sharded along x over the mesh's "space" axis.  The three
separable EDT passes then split into:

* z- and y-passes: every line lives inside one shard -> purely local;
* x-pass: the scanned axis is the sharded one.  The min-plus parabola
  transform ``out[q] = min_v (f[v] + (q - v)^2)`` needs every v for every
  q, so the local slabs are **ring-rotated** with ``lax.ppermute``:
  at step s each device folds the slab originating from device
  (me + s) mod p into its running minimum, then passes the slab on.
  p - 1 hops, each overlapping a local partial-min — the EDT analogue of
  ring attention: point-to-point hops instead of an all-to-all.

This mirrors the role the sequential x-sweep plays in the reference
(sdf_map.cpp:348-364) while keeping every hop a nearest-neighbor
collective (SURVEY.md section 5, "long-context" note).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grad_traj_optimization_tpu.fields import sdf


def _local_passes(occ_local):
    """z then y squared-distance passes (local to the shard)."""
    sq = sdf._nearest_sq_1d(occ_local, axis=2)
    return sdf._minplus_axis(sq, axis=1)


def _ring_minplus_x(sq_local, axis_name: str, p: int):
    """Min-plus along the sharded x axis via ring rotation."""
    me = jax.lax.axis_index(axis_name)
    nxl = sq_local.shape[0]
    q_global = me * nxl + jnp.arange(nxl)  # (nxl,)

    def fold(acc, slab, owner):
        v_global = owner * nxl + jnp.arange(nxl)
        # (q, v) parabola between this device's outputs and the slab's cells
        para = (q_global[:, None] - v_global[None, :]).astype(
            slab.dtype
        ) ** 2
        # slab: (nxl_v, ny, nz) -> candidate (nxl_q, ny, nz)
        cand = jnp.min(
            slab[None, :, :, :] + para[:, :, None, None], axis=1
        )
        return jnp.minimum(acc, cand)

    acc = jnp.full_like(sq_local, jnp.inf)
    slab = sq_local
    perm = [(i, (i - 1) % p) for i in range(p)]
    for s in range(p):
        owner = (me + s) % p
        acc = fold(acc, slab, owner)
        if s != p - 1:
            slab = jax.lax.ppermute(slab, axis_name, perm)
    return acc


def edt_sharded(occ, resolution: float, mesh: Mesh, prev_dist=None):
    """EDT of an occupancy grid sharded along x over mesh axis "space".

    Args:
      occ: (nx, ny, nz) global occupancy (device_put with P("space") or
        replicated; this function applies the sharding).
    Returns:
      distance grid sharded the same way.
    """
    n_space = mesh.shape["space"]
    sharding = NamedSharding(mesh, P("space", None, None))
    occ = jax.device_put(occ, sharding)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P("space", None, None),
        out_specs=P("space", None, None),
    )
    def _impl(occ_local):
        sq = _local_passes(occ_local)
        sq = _ring_minplus_x(sq, "space", n_space)
        dist = resolution * jnp.sqrt(sq)
        return jnp.minimum(dist, sdf.FREE_DIST).astype(jnp.float32)

    out = jax.jit(_impl)(occ)
    if prev_dist is not None:
        out = jnp.minimum(out, prev_dist)
    return out
