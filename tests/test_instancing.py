"""Two-level TLAS instancing (VERDICT r3 #3).

A scene with N instances of one mesh must (a) store the mesh once plus N
transform records, and (b) render the same image as the equivalent scene
with N independently-baked shape copies."""

import numpy as np
import jax.numpy as jnp


def _scene(instanced, n=3, ball_bsdf=None):
    """n glass-ball instances over a diffuse floor under an env light.
    instanced=True reuses ONE shape; False duplicates it per entity
    (which compiles to the world-space soup)."""
    shapes = [{"type": "rectangle", "name": "floor", "width": 8,
               "height": 8,
               "transform": [{"rotate": [-90, 0, 0]},
                             {"translate": [0, -1, 0]}]}]
    entities = [{"name": "floor", "shape": "floor", "bsdf": "white"}]
    for i in range(n):
        sname = "ball" if instanced else f"ball{i}"
        if instanced and i == 0 or not instanced:
            shapes.append({"type": "icosphere", "name": sname,
                           "radius": 0.5, "subdivisions": 2})
        entities.append({
            "name": f"b{i}", "shape": sname,
            "bsdf": ball_bsdf[i] if ball_bsdf else "red",
            "transform": [{"scale": 1.0 + 0.2 * i},
                          {"rotate": [0, 30 * i, 0]},
                          {"translate": [1.6 * i - 1.6, 0, 0]}]})
    return {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 55,
                   "transform": [1, 0, 0, 0,
                                 0, 0.9397, -0.342, 2.0,
                                 0, 0.342, 0.9397, -4.5,
                                 0, 0, 0, 1]},
        "film": {"size": [48, 48]},
        "bsdfs": [
            {"type": "diffuse", "name": "white",
             "reflectance": [0.7, 0.7, 0.7]},
            {"type": "diffuse", "name": "red",
             "reflectance": [0.8, 0.15, 0.1]},
            {"type": "conductor", "name": "gold", "material": "gold"},
        ],
        "shapes": shapes,
        "entities": entities,
        "lights": [{"type": "env", "name": "sky",
                    "radiance": [0.8, 0.9, 1.0]}],
    }


def test_instancing_detected_and_memory_shared():
    from ignis_jax.api import Runtime
    rt_i = Runtime(_scene(True))
    rt_b = Runtime(_scene(False))
    assert rt_i.scene.instanced is not None
    assert rt_b.scene.instanced is None
    # geometry memory: one local copy + transforms vs three world bakes
    soup_i = int(rt_i.tables["tri_v0"].shape[0])
    soup_b = int(rt_b.tables["tri_v0"].shape[0])
    pool = int(rt_i.tables["tl_tris"].shape[0])
    ball_tris = (soup_b - soup_i) // 3
    assert pool < 2 * ball_tris          # ~one copy, padded
    assert rt_i.tables["tl_inst"].shape[0] == 3


def test_instanced_render_matches_baked():
    from ignis_jax.api import Runtime
    rt_i = Runtime(_scene(True))
    rt_b = Runtime(_scene(False))
    rt_i.step(spi=2)
    rt_b.step(spi=2)
    a = rt_i.currentFrame()
    b = rt_b.currentFrame()
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # identical RNG/work enumeration -> near-identical images (fp assoc.)
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)


def test_instances_carry_distinct_materials():
    from ignis_jax.api import Runtime
    sc = _scene(True, ball_bsdf=["red", "gold", "white"])
    rt = Runtime(sc)
    rt.step(spi=2)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    sc2 = _scene(False, ball_bsdf=["red", "gold", "white"])
    rt2 = Runtime(sc2)
    rt2.step(spi=2)
    np.testing.assert_allclose(img, rt2.currentFrame(), rtol=2e-3,
                               atol=2e-3)


def test_many_instances_scale():
    """25 instances: pool memory stays ~1 copy + 25 records."""
    from ignis_jax.api import Runtime
    sc = _scene(True, n=25)
    rt = Runtime(sc)
    assert rt.tables["tl_inst"].shape[0] == 25
    rt.step(spi=1)
    assert np.isfinite(rt.currentFrame()).all()


def test_tlas_degenerate_triangles_never_hit():
    """Degenerate faces in an instanced mesh must never hit: the traversal
    must honor the stored per-triangle mask (bw_tables zeroes it for
    degenerate rows), like the one-level sweep does."""
    from ignis_jax.ops.bw_tlas import build_tlas, tlas_traverse_xla
    rng = np.random.default_rng(7)
    t = 16
    v0 = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2[3] = e1[3]  # degenerate
    e1[9] = 0.0
    n0 = np.cross(e1, e2).astype(np.float32)
    sh = {"v0": v0, "e1": e1, "e2": e2, "n0": n0, "n1": n0, "n2": n0,
          "uv0": np.zeros((t, 2), np.float32),
          "uv1": np.zeros((t, 2), np.float32),
          "uv2": np.zeros((t, 2), np.float32)}
    ident = np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]],
                       np.float32)
    tab = {k: jnp.asarray(v) for k, v in build_tlas(
        [sh], [(0, ident, ident, np.eye(3, dtype=np.float32), 0, 0xF)]
    ).items()}
    n = 256
    org = jnp.asarray(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    tmin = jnp.zeros(n, jnp.float32)
    tmax = jnp.full(n, 1e30, jnp.float32)
    bt, bu, bv, bi, be = tlas_traverse_xla(tab, org, d, tmin, tmax)
    bi = np.asarray(bi)
    assert (bi >= 0).any()
    assert not np.isin(bi, [3, 9]).any()
    # every reported hit must carry a valid instance id
    assert (np.asarray(be)[bi >= 0] == 0).all()
