"""SDF/EDT layer vs brute force and the float64 golden port."""

import numpy as np
import jax.numpy as jnp

from grad_traj_optimization_tpu.fields import sdf
from grad_traj_optimization_tpu.reference_impl import golden


def _random_occ(shape, p=0.08, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < p).astype(np.float32)


def test_edt_matches_brute_force():
    occ = _random_occ((9, 7, 5), seed=1)
    d = np.asarray(sdf.edt(jnp.asarray(occ), 0.2))
    bf = np.asarray(sdf.edt_brute_force(jnp.asarray(occ), 0.2))
    np.testing.assert_allclose(d, bf, rtol=1e-5, atol=1e-5)


def test_edt_matches_golden_felzenszwalb():
    occ = _random_occ((12, 10, 6), p=0.05, seed=2)
    gm = golden.GoldenSDFMap((0, 0, 0), 0.2, (2.4, 2.0, 1.2))
    gm.occ = occ.astype(np.float64)
    gm.update_esdf()
    d = np.asarray(sdf.edt(jnp.asarray(occ), 0.2))
    np.testing.assert_allclose(d, gm.dist, rtol=1e-5, atol=1e-5)


def test_edt_empty_map_is_free_dist():
    occ = np.zeros((6, 6, 4), np.float32)
    d = np.asarray(sdf.edt(jnp.asarray(occ), 0.2))
    np.testing.assert_allclose(d, sdf.FREE_DIST)


def test_edt_occupied_cells_zero():
    occ = _random_occ((8, 8, 8), p=0.2, seed=3)
    d = np.asarray(sdf.edt(jnp.asarray(occ), 0.25))
    assert np.all(d[occ > 0.5] == 0.0)


def test_rasterize_matches_golden():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.0, 3.0, size=(200, 3))  # includes out-of-map points
    origin = np.array([0.0, 0.0, 0.0])
    res = 0.2
    gm = golden.GoldenSDFMap(origin, res, (2.0, 2.0, 2.0))
    for p in pts:
        gm.set_occupancy(p)
    occ = np.asarray(
        sdf.rasterize(
            jnp.asarray(pts, jnp.float32), jnp.asarray(origin, jnp.float32),
            res, gm.occ.shape,
        )
    )
    np.testing.assert_array_equal(occ, gm.occ)


def test_trilinear_matches_golden():
    occ = _random_occ((14, 12, 8), p=0.1, seed=5)
    origin = np.array([-1.0, -1.0, 0.0])
    res = 0.25
    gm = golden.GoldenSDFMap(origin, res, (14 * res, 12 * res, 8 * res))
    gm.occ = occ.astype(np.float64)
    gm.update_esdf()

    d_grid = jnp.asarray(gm.dist, jnp.float32)
    rng = np.random.default_rng(6)
    queries = rng.uniform(-1.2, 2.2, size=(300, 3))  # includes out-of-map
    d, g = sdf.distance_and_gradient(
        d_grid, jnp.asarray(origin, jnp.float32), res,
        jnp.asarray(queries, jnp.float32),
    )
    d, g = np.asarray(d), np.asarray(g)
    for i, q in enumerate(queries):
        dg, gg = gm.dist_with_grad_trilinear(q)
        np.testing.assert_allclose(d[i], dg, rtol=1e-4, atol=1e-4)
        if dg >= 0:  # in map: gradient defined
            np.testing.assert_allclose(g[i], gg, rtol=1e-3, atol=1e-3)


def test_distance_at_out_of_map():
    d_grid = jnp.ones((4, 4, 4), jnp.float32)
    d = sdf.distance_at(
        d_grid, jnp.zeros(3, jnp.float32), 0.5,
        jnp.asarray([[5.0, 0.2, 0.2], [0.2, 0.2, 0.2]], jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(d), [-1.0, 1.0])


def test_edt_batch_matches_single():
    rng = np.random.default_rng(10)
    occ = (rng.random((4, 11, 9, 6)) < 0.07).astype(np.float32)
    db = np.asarray(sdf.edt_batch(jnp.asarray(occ), 0.25))
    for i in range(4):
        d1 = np.asarray(sdf.edt(jnp.asarray(occ[i]), 0.25))
        np.testing.assert_allclose(db[i], d1, atol=1e-5)


def test_trilinear_flat_offset():
    """trilinear_flat with a base offset must match the per-grid lookup."""
    rng = np.random.default_rng(11)
    grids = rng.random((3, 8, 7, 5)).astype(np.float32) * 4.0
    flat = jnp.asarray(grids.reshape(-1))
    origin = jnp.zeros(3, jnp.float32)
    res = 0.5
    q = jnp.asarray(rng.uniform(0.3, 2.0, size=(40, 3)), jnp.float32)
    nvox = 8 * 7 * 5
    for b in range(3):
        d_flat, g_flat = sdf.trilinear_flat(
            flat, b * nvox, (8, 7, 5), origin, res, q
        )
        d_ref, g_ref = sdf.distance_and_gradient(
            jnp.asarray(grids[b]), origin, res, q
        )
        np.testing.assert_allclose(np.asarray(d_flat), np.asarray(d_ref),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(g_flat), np.asarray(g_ref),
                                   atol=1e-5)


def test_edt_update_add_exact_vs_full_recompute():
    """Region-limited incremental update (reference setUpdateRange,
    sdf_map.cpp:244-262, sweep bounds :311-364): additions inside the
    box are BITWISE equal to a full recompute — both with whole-grid
    influence and with out_margin >= max(prev)/res."""
    rng = np.random.default_rng(3)
    res = 0.2
    for _ in range(3):
        occ0 = (rng.random((32, 28, 16)) < 0.012).astype(np.float32)
        d0 = sdf.edt(jnp.asarray(occ0), res)
        lo, hi = (8, 6, 3), (20, 18, 12)
        occ1 = occ0.copy()
        adds = rng.integers(lo, hi, size=(5, 3))
        for a in adds:
            occ1[tuple(a)] = 1.0
        d_full = np.asarray(sdf.edt(jnp.asarray(occ1), res))
        d_inc = np.asarray(
            sdf.edt_update(d0, jnp.asarray(occ1), res, lo, hi, mode="add")
        )
        assert np.array_equal(d_full, d_inc)
        m = int(np.ceil(float(np.max(np.asarray(d0))) / res)) + 1
        d_win = np.asarray(
            sdf.edt_update(
                d0, jnp.asarray(occ1), res, lo, hi, mode="add",
                out_margin=m,
            )
        )
        assert np.array_equal(d_full, d_win)


def test_edt_update_reset_exact_on_edit_region():
    """Reset mode = the reference's literal windowed rebuild (resetBuffer
    + box-bounded sweeps): handles removals; exact on cells whose true
    nearest occupied lies inside the box (the caller-margin contract the
    reference ships) — in particular the edit region itself when the box
    pads it by max-distance influence."""
    rng = np.random.default_rng(5)
    res = 0.2
    occ0 = (rng.random((36, 32, 18)) < 0.015).astype(np.float32)
    d0 = sdf.edt(jnp.asarray(occ0), res)
    elo, ehi = (14, 12, 7), (19, 17, 11)
    occ1 = occ0.copy()
    occ1[elo[0]:ehi[0], elo[1]:ehi[1], elo[2]:ehi[2]] = 0.0  # removals
    occ1[16, 14, 9] = 1.0                                    # an add
    d_full = np.asarray(sdf.edt(jnp.asarray(occ1), res))
    pad = int(np.ceil(float(d_full.max()) / res)) + 2
    blo = tuple(max(0, l - pad) for l in elo)
    bhi = tuple(min(g, h + pad) for h, g in zip(ehi, occ0.shape))
    d_inc = np.asarray(
        sdf.edt_update(d0, jnp.asarray(occ1), res, blo, bhi, mode="reset")
    )
    esl = tuple(slice(l, h) for l, h in zip(elo, ehi))
    assert np.array_equal(d_full[esl], d_inc[esl])
    # outside the box: untouched (reference semantics)
    mask = np.ones(occ0.shape, bool)
    mask[tuple(slice(l, h) for l, h in zip(blo, bhi))] = False
    assert np.array_equal(np.asarray(d0)[mask], d_inc[mask])
    # windowed distances never UNDERestimate (fewer sources)
    assert np.all(d_inc >= d_full - 1e-6)
