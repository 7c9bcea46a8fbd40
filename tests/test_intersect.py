"""Ray/triangle and BVH intersection unit tests (counterpart of
src/tests/artic/test_intersection.art)."""

import numpy as np
import jax.numpy as jnp

from ignis_jax.ops.intersect import intersect_any, intersect_closest
from ignis_jax.ops.bvh import BVH, build_bvh, bvh_any, bvh_closest, bvh_tables


def _quad_tables():
    # unit square at z=0: two triangles in grid layout (shapes.py _make_grid)
    v = np.array([[-1, -1, 0], [1, -1, 0], [-1, 1, 0], [1, 1, 0]], np.float32)
    idx = np.array([[0, 1, 3], [0, 3, 2]], np.int32)
    v0 = v[idx[:, 0]]
    e1 = v[idx[:, 1]] - v0
    e2 = v[idx[:, 2]] - v0
    return v0, e1, e2


def test_closest_hit_quad():
    v0, e1, e2 = _quad_tables()
    n = 64
    rng = np.random.default_rng(1)
    px = rng.uniform(-0.99, 0.99, n).astype(np.float32)
    py = rng.uniform(-0.99, 0.99, n).astype(np.float32)
    org = np.stack([px, py, np.full(n, -2.0, np.float32)], axis=1)
    d = np.tile(np.float32([0, 0, 1]), (n, 1))
    t, u, v, prim = intersect_closest(
        jnp.asarray(org), jnp.asarray(d),
        jnp.zeros(n, jnp.float32), jnp.full(n, 1e30, jnp.float32),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    t, u, v, prim = map(np.asarray, (t, u, v, prim))
    assert (prim >= 0).all(), "all rays must hit the quad"
    np.testing.assert_allclose(t, 2.0, rtol=1e-5)
    # reconstruct hit point from barycentrics (weights of v1/v2)
    p = (v0[prim] + e1[prim] * u[:, None] + e2[prim] * v[:, None])
    np.testing.assert_allclose(p[:, 0], px, atol=1e-5)
    np.testing.assert_allclose(p[:, 1], py, atol=1e-5)


def test_miss_outside_quad():
    v0, e1, e2 = _quad_tables()
    org = np.float32([[2.5, 0, -2], [0, -3.0, -2]])
    d = np.tile(np.float32([0, 0, 1]), (2, 1))
    t, u, v, prim = intersect_closest(
        jnp.asarray(org), jnp.asarray(d),
        jnp.zeros(2, jnp.float32), jnp.full(2, 1e30, jnp.float32),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    assert (np.asarray(prim) == -1).all()


def test_tmin_tmax_respected():
    v0, e1, e2 = _quad_tables()
    org = np.float32([[0, 0, -2]])
    d = np.float32([[0, 0, 1]])
    # tmax before the plane → miss
    _, _, _, prim = intersect_closest(
        jnp.asarray(org), jnp.asarray(d),
        jnp.zeros(1, jnp.float32), jnp.full(1, 1.5, jnp.float32),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    assert int(np.asarray(prim)[0]) == -1
    # tmin after the plane → miss
    occ = intersect_any(
        jnp.asarray(org), jnp.asarray(d),
        jnp.full(1, 2.5, jnp.float32), jnp.full(1, 1e30, jnp.float32),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    assert not bool(np.asarray(occ)[0])


def test_bvh_matches_bruteforce():
    rng = np.random.default_rng(7)
    nt = 300
    v0 = rng.uniform(-1, 1, (nt, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (nt, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (nt, 3)).astype(np.float32)
    n = 256
    org = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)

    bt, bu, bv, bi = intersect_closest(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))

    bvh = build_bvh(v0, e1, e2)
    tables = bvh_tables(bvh, {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2})
    tables = {k: jnp.asarray(va) for k, va in tables.items()}
    qt, qu, qv, qi = bvh_closest(tables, jnp.asarray(org), jnp.asarray(d),
                                 jnp.asarray(tmin), jnp.asarray(tmax))

    bt, bi = np.asarray(bt), np.asarray(bi)
    qt, qi = np.asarray(qt), np.asarray(qi)
    hit_b = bi >= 0
    hit_q = qi >= 0
    np.testing.assert_array_equal(hit_b, hit_q)
    np.testing.assert_allclose(qt[hit_b], bt[hit_b], rtol=2e-5, atol=1e-6)
    # bvh_closest maps hits back to original soup indices
    np.testing.assert_array_equal(qi[hit_q], bi[hit_b])

    # occlusion agreement
    occ_b = np.asarray(intersect_any(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
        jnp.full(n, 3.0, np.float32),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2)))
    occ_q = np.asarray(bvh_any(tables, jnp.asarray(org), jnp.asarray(d),
                               jnp.asarray(tmin), jnp.full(n, 3.0, np.float32)))
    np.testing.assert_array_equal(occ_b, occ_q)
