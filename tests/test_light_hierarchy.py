"""Light hierarchy selector tests (light_hierarchy.art, LightHierarchy.cpp).

Correctness: hierarchy selection is a valid importance scheme — the
selection pdf must be consistent (hierarchy_pdf == pdf returned by
hierarchy_sample for the sampled light) and the NEE estimator must stay
unbiased (hierarchy render == cdf render in expectation).
Variance: on many_point_lights.json the hierarchy must beat the CDF
selector at equal spp.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

SCENE = "/root/reference/scenes/many_point_lights.json"


def _grid_light_scene(selector, nl=16):
    """4x4 grid of point lights over a diffuse floor."""
    lights = []
    rng = np.random.RandomState(5)
    for i in range(nl):
        x = (i % 4 - 1.5) * 1.2
        z = (i // 4 - 1.5) * 1.2
        inten = float(rng.uniform(0.2, 3.0))
        lights.append({"type": "point", "name": f"l{i}",
                       "position": [x, 1.0, z],
                       "intensity": [inten] * 3})
    return {
        "technique": {"type": "path", "max_depth": 2,
                      "light_selector": selector},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0,
                                 0, 0, -1, 3.5,
                                 0, 1, 0, 0,
                                 0, 0, 0, 1]},  # above, looking down
        "film": {"size": [32, 32]},
        "bsdfs": [{"type": "diffuse", "name": "w",
                   "reflectance": [0.8, 0.8, 0.8]}],
        "shapes": [{"type": "rectangle", "name": "floor", "width": 8,
                    "height": 8,
                    "transform": [{"rotate": [-90, 0, 0]}]}],
        "entities": [{"name": "floor", "shape": "floor", "bsdf": "w"}],
        "lights": lights,
    }


def _render(scene_dict, spi, iters, seed=0):
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(scene_dict), seed=seed)
    for _ in range(iters):
        rt.step(spi=spi)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    return np.asarray(img)


def test_hierarchy_tables_built():
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(_grid_light_scene("hierarchy")))
    assert "lh_child" in rt.tables
    assert rt.scene.lh_depth >= 4  # 16 lights -> depth 5 tree
    # codes are unique per light in a balanced tree of distinct positions
    codes = np.asarray(rt.tables["lh_codes"])
    assert len(set(codes.tolist())) == len(codes)


def test_sample_pdf_consistency():
    """pdf(light | pos) from the replay must equal the pdf the sampler
    returned for that draw."""
    import jax.numpy as jnp

    from ignis_jax.api import load_scene
    from ignis_jax.light.hierarchy import hierarchy_pdf, hierarchy_sample
    rt = load_scene(json.dumps(_grid_light_scene("hierarchy")))
    t = rt.tables
    n = 512
    pos = jnp.asarray(
        np.random.RandomState(0).uniform(-3, 3, (n, 3)).astype(np.float32))
    seed = jnp.arange(n, dtype=jnp.uint32) * 7919
    counter = jnp.ones((n,), jnp.uint32)
    act = jnp.ones((n,), bool)
    loc, pdf, _ = hierarchy_sample(t, pos, seed, counter, act,
                                   rt.scene.lh_depth)
    pdf2 = hierarchy_pdf(t, loc, pos, rt.scene.lh_depth)
    np.testing.assert_allclose(np.asarray(pdf), np.asarray(pdf2), rtol=1e-5)
    # pdfs over all lights sum to 1 at any point
    nl = np.asarray(t["lh_codes"]).shape[0]
    tot = sum(np.asarray(hierarchy_pdf(
        t, jnp.full((n,), i, jnp.int32), pos, rt.scene.lh_depth))
        for i in range(nl))
    np.testing.assert_allclose(tot, 1.0, rtol=1e-4)


def test_hierarchy_unbiased_vs_cdf():
    imgs = {}
    for sel in ("cdf", "hierarchy"):
        imgs[sel] = _render(_grid_light_scene(sel), spi=4, iters=8)
    assert abs(imgs["hierarchy"].mean() - imgs["cdf"].mean()) \
        < 0.05 * imgs["cdf"].mean()


def test_hierarchy_lower_variance_many_lights():
    """Per-pixel variance across independent renders, equal spp: the
    position-aware selector must beat the static CDF (committed gate for
    many_point_lights.json, BASELINE gate 3)."""
    var = {}
    for sel in ("cdf", "hierarchy"):
        sc = _grid_light_scene(sel)
        renders = np.stack([_render(sc, spi=1, iters=1, seed=s)
                            for s in range(6)])
        var[sel] = float(np.mean(np.var(renders, axis=0)))
    assert var["hierarchy"] < var["cdf"], var


@pytest.mark.slow
def test_many_point_lights_scene_renders():
    from ignis_jax.api import load_scene
    rt = load_scene(SCENE, width=32, height=32)
    assert "lh_child" in rt.tables  # selector: hierarchy in the scene json
    rt.step(spi=1)
    img = rt.currentFrame()
    assert np.isfinite(img).all() and img.mean() > 0
