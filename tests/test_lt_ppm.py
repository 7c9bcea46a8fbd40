"""Light tracer + progressive photon mapper technique tests.

Oracle: on a diffuse box scene lit by an area light, LT, PPM and the path
tracer estimate the same radiance (different estimators → loose
statistical tolerance), matching the reference's cross-technique parity
(src/artic/technique/{lighttracer,photonmapper,pathtracer}.art).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def _box_scene(tech):
    return {
        "technique": tech,
        "camera": {"type": "perspective", "fov": 40,
                   "transform": [-1, 0, 0, 0, 0, 1, 0, 0,
                                 0, 0, -1, 3.5, 0, 0, 0, 1]},
        "film": {"size": [16, 16]},
        "bsdfs": [
            {"type": "diffuse", "name": "white",
             "reflectance": [0.7, 0.7, 0.7]},
        ],
        "shapes": [
            {"type": "rectangle", "name": "light", "width": 0.5,
             "height": 0.5,
             "transform": [{"translate": [0, 0.95, 0]},
                           {"rotate": [90, 0, 0]}]},  # face DOWN into box
            {"type": "rectangle", "name": "floor", "width": 2, "height": 2,
             "transform": [{"translate": [0, -1, 0]},
                           {"rotate": [-90, 0, 0]}]},
            {"type": "rectangle", "name": "back", "width": 2, "height": 2,
             "transform": [{"translate": [0, 0, -1]}]},  # faces camera (+z)
        ],
        "entities": [
            {"name": "light", "shape": "light", "bsdf": "white"},
            {"name": "floor", "shape": "floor", "bsdf": "white"},
            {"name": "back", "shape": "back", "bsdf": "white"},
        ],
        "lights": [
            {"type": "area", "name": "light", "entity": "light",
             "radiance": [10, 10, 10]},
        ],
    }


def _render_mean(tech, iters=6, spi=4):
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(_box_scene(tech)))
    for _ in range(iters):
        rt.step(spi=spi)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    return img.mean(), img


def test_lighttracer_matches_path():
    pt_mean, _ = _render_mean({"type": "path", "max_depth": 4})
    lt_mean, img = _render_mean({"type": "lighttracer", "max_depth": 4},
                                iters=8, spi=8)
    assert lt_mean > 0.0
    # same estimand, very different variance profiles
    assert abs(lt_mean - pt_mean) < 0.5 * pt_mean


def test_photonmapper_runs_and_is_plausible():
    pt_mean, _ = _render_mean({"type": "path", "max_depth": 4})
    ppm_mean, img = _render_mean(
        {"type": "photonmapper", "max_depth": 4, "photons": 20000,
         "radius": 0.05}, iters=4, spi=2)
    assert ppm_mean > 0.0
    assert abs(ppm_mean - pt_mean) < 0.75 * pt_mean


def test_ppm_radius_shrinks():
    from ignis_jax.render.photonmapper import ppm_compute_radius
    r0 = ppm_compute_radius(1.0, 0)
    r5 = ppm_compute_radius(1.0, 5)
    r20 = ppm_compute_radius(1.0, 20)
    assert r0 == 1.0 and r5 < r0 and r20 < r5 and r20 >= 1e-5


def test_emission_sampling_point_light():
    """Point-light photon emission: power conservation E[I·4π... ] —
    intensity already divided by the uniform-sphere pdf (light/point.art:9-12)."""
    import jax.numpy as jnp

    from ignis_jax.api import load_scene
    from ignis_jax.light.emission import sample_light_emission

    sc = _box_scene({"type": "path"})
    sc["lights"] = [{"type": "point", "name": "p",
                     "position": [0.1, 0.2, 0.3], "intensity": [2, 2, 2]}]
    rt = load_scene(json.dumps(sc))
    n = 256
    seed = jnp.arange(n, dtype=jnp.uint32) * 977
    counter = jnp.ones((n,), jnp.uint32)
    em, c2 = sample_light_emission(
        rt.scene, rt.tables, jnp.zeros((n,), jnp.int32), seed, counter,
        jnp.ones((n,), bool))
    assert np.all(np.asarray(c2) == 5)  # 4 draws consumed
    np.testing.assert_allclose(np.asarray(em["pos"]),
                               np.tile([0.1, 0.2, 0.3], (n, 1)), atol=1e-6)
    # intensity/pdf = 2 * 4π
    np.testing.assert_allclose(np.asarray(em["intensity"]),
                               2 * 4 * np.pi, rtol=1e-4)
    # directions on the unit sphere, covering both hemispheres
    d = np.asarray(em["dir"])
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    assert (d[:, 2] > 0).any() and (d[:, 2] < 0).any()


def _mix_box(tech, mixed=True):
    sc = _box_scene(tech)
    if mixed:
        # mix(diffuse(0.9), diffuse(0.1), k=0.75) == diffuse(0.3) exactly
        # for eval and statistically for sampling (mix.art:10-13)
        sc["bsdfs"] = [
            {"type": "diffuse", "name": "hi", "reflectance": [0.9] * 3},
            {"type": "diffuse", "name": "lo", "reflectance": [0.1] * 3},
            {"type": "mix", "name": "white", "first": "hi",
             "second": "lo", "weight": 0.75},
        ]
    else:
        sc["bsdfs"] = [
            {"type": "diffuse", "name": "white", "reflectance": [0.3] * 3}]
    return sc


def _render_scene_mean(sc, iters=6, spi=6):
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(sc))
    for _ in range(iters):
        rt.step(spi=spi)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    return img.mean()


def test_lighttracer_respects_mix_weight():
    """Regression: lighttracer must use the layered (two-lobe) BSDF
    dispatchers, not the single-lobe union functions — a mix BSDF must
    match its lerped-diffuse equivalent under light transport."""
    ref = _render_scene_mean(
        _mix_box({"type": "lighttracer", "max_depth": 4}, mixed=False),
        iters=8, spi=8)
    mix = _render_scene_mean(
        _mix_box({"type": "lighttracer", "max_depth": 4}, mixed=True),
        iters=8, spi=8)
    assert mix > 0.0
    assert abs(mix - ref) < 0.25 * ref


def test_photonmapper_respects_mix_weight():
    ref = _render_scene_mean(
        _mix_box({"type": "photonmapper", "max_depth": 4,
                  "photons": 20000, "radius": 0.05}, mixed=False),
        iters=4, spi=2)
    mix = _render_scene_mean(
        _mix_box({"type": "photonmapper", "max_depth": 4,
                  "photons": 20000, "radius": 0.05}, mixed=True),
        iters=4, spi=2)
    assert mix > 0.0
    assert abs(mix - ref) < 0.3 * ref
