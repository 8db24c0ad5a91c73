"""Large-grid EDT stress benchmark (BASELINE.md config 5).

Builds a large random occupancy grid (default 512^3 = 537 MB f32) and
times the exact EDT:

* single-device (the dense min-plus passes), and
* sharded over all visible devices along x with ring ppermute
  (parallel/edt_sharded), when more than one device is present.

Usage: python scripts/stress_edt.py [n] [occupancy_fraction]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    frac = float(sys.argv[2]) if len(sys.argv) > 2 else 0.001

    import jax
    import jax.numpy as jnp

    from grad_traj_optimization_tpu.fields import sdf
    from grad_traj_optimization_tpu.parallel import edt_sharded, mesh

    rng = np.random.default_rng(0)
    print(f"grid {n}^3 = {n**3/1e6:.0f}M voxels, "
          f"{n**3*4/1e9:.2f} GB f32, occ {frac}")
    occ = (rng.random((n, n, n)) < frac).astype(np.float32)
    occj = jax.device_put(jnp.asarray(occ))

    res = 0.2
    f = jax.jit(lambda o: sdf.edt(o, res))
    t0 = time.perf_counter()
    d = f(occj)
    d.block_until_ready()
    _ = float(d[0, 0, 0])  # host sync
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = f(occj)
    _ = float(d[0, 0, 0])
    t_warm = time.perf_counter() - t0
    print(f"single-device EDT: compile+run {t_compile:.1f}s, "
          f"warm {t_warm:.2f}s "
          f"({n**3 / t_warm / 1e6:.0f} Mvoxel/s)")

    devs = jax.devices()
    if len(devs) > 1:
        m = mesh.make_mesh(n_data=1, n_space=len(devs))
        t0 = time.perf_counter()
        ds = edt_sharded.edt_sharded(occj, res, m)
        _ = float(ds[0, 0, 0])
        t_sh = time.perf_counter() - t0
        print(f"sharded EDT over {len(devs)} devices: {t_sh:.2f}s "
              "(incl compile)")
        err = float(jnp.max(jnp.abs(ds - d)))
        print(f"sharded vs single max diff: {err}")


if __name__ == "__main__":
    main()
