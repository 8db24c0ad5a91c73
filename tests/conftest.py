"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated on a host-platform device mesh
(``xla_force_host_platform_device_count``).  The platform is also forced
through jax.config (before any backend initializes) so the suite stays
on the CPU on a machine with a GPU.  Tests marked ``gpu`` run only with
``-m gpu`` on a GPU machine (see the ``gpu_device`` fixture).
"""

import os


def pytest_configure(config):
    if config.getoption("markexpr", "") == "gpu":
        return  # the on-card run keeps the GPU backend
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


def gap_wall_map(gap_lo=-0.8, gap_hi=0.8, thickness_cells=1,
                 grid_shape=(40, 40, 16)):
    """Shared test map: a wall across y=0 (``thickness_cells`` cells
    thick) spanning the 10 m arena, with one gap at x in (gap_lo,
    gap_hi), as an EDT distance field.  Pass an empty interval
    (gap_lo == gap_hi) for a solid wall.  Returns (dist, origin, res).

    The x grid is exact binary fractions (-5 + k/4), so the open-
    interval gap test is exact for any bounds not on the grid.
    """
    import numpy as np
    import jax.numpy as jnp

    from grad_traj_optimization_tpu.fields import sdf

    origin = np.array([-5.0, -5.0, 0.0])
    res = 0.25
    rows = tuple(res * k for k in range(thickness_cells))
    pts = [
        (x, y, z)
        for x in np.arange(-5.0, 5.0, res)
        for y in rows
        for z in np.arange(0.1, 4.0, res)
        if not (gap_lo < x < gap_hi)
    ]
    occ = sdf.rasterize(
        jnp.asarray(np.array(pts), jnp.float32),
        jnp.asarray(origin, jnp.float32), res, grid_shape,
    )
    return np.asarray(sdf.edt(occ, res)), origin, res
