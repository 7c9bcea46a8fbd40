"""Analytic light-transport oracles.

Ported from the reference integrator suite (src/tests/integrator/
test_lights.py:5-44) but with the expected values re-derived against the
CURRENT reference light code: the bundled test constants divide point/spot
intensity by 4pi, while the shipped loaders pass `intensity` through as W/sr
(src/runtime/light/PointLight.cpp:33-52, docs/src/scene/lights.rst
"Intensity of the point light given in radiometric [W/sr]").  We follow the
code, so our oracles are the stale constants x 4pi — re-derived here by
numerical quadrature of the same closed-form integrals.

Scene: unit camera at (0,0,-1) looking +z with fov 90 onto a white lambertian
plane spanning [-1,1]^2 at z=0 (flat scene of the reference suite).
"""

import numpy as np
import pytest

from conftest import compute_scene_average, create_flat_scene


def _quad(fn, n=2000):
    """Average of fn(x, y) over [-1,1]^2 (plane-average of radiance)."""
    xs = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    x, y = np.meshgrid(xs, xs)
    return float(np.mean(fn(x, y)))


def test_no_light():
    scene = create_flat_scene()
    value = compute_scene_average(scene, spp=1, size=64)
    assert value == pytest.approx(0, abs=1e-8)


def test_point_light():
    # L(x,y) = I * cos(theta_surf) / (pi * d^2); I = 1 W/sr,
    # cos = 2/d, d^2 = x^2+y^2+4 (delta light: NEE only, MIS weight 1).
    expected = _quad(lambda x, y: 2.0 / (np.pi * (x * x + y * y + 4.0) ** 1.5))
    scene = create_flat_scene()
    scene["lights"].append(
        {"type": "point", "name": "_light", "position": [0, 0, -2],
         "intensity": [1, 1, 1]})
    value = compute_scene_average(scene, spp=4, size=200)
    assert value == pytest.approx(expected, rel=3e-3)


def test_spot_light():
    # Spot adds the light-side cosine through the area-measure pdf
    # (light/spot.art:31-41: pdf=make_area_pdf(1), cos=-dot(dir, axis)):
    # L = I * cos_l * cos_surf / (pi d^2), cos_l = cos_surf = 2/d.
    # cutoff=falloff=45deg covers the whole plane (max angle < 45).
    expected = _quad(lambda x, y: 4.0 / (np.pi * (x * x + y * y + 4.0) ** 2))
    scene = create_flat_scene()
    scene["lights"].append(
        {"type": "spot", "name": "_light", "cutoff": 45, "falloff": 45,
         "position": [0, 0, -2], "direction": [0, 0, 1],
         "intensity": [1, 1, 1]})
    value = compute_scene_average(scene, spp=4, size=200)
    assert value == pytest.approx(expected, rel=3e-3)


def test_env_light_bsdf_sampling():
    # Furnace: white two-sided lambertian plane inside radiance-1 env.
    # With pure BSDF sampling (nee off) the estimator is exactly 1 per path.
    scene = create_flat_scene()
    scene["technique"]["nee"] = False
    scene["lights"].append(
        {"type": "env", "name": "_light", "radiance": [1, 1, 1]})
    value = compute_scene_average(scene, spp=2, size=64)
    assert value == pytest.approx(1, rel=1e-4)


def test_env_light_nee_one_sided():
    # DELIBERATE deviation from bsdf/diffuse.art:3 (absolute_cos): the
    # reference's two-sided lambertian eval collects the lower hemisphere
    # of the sphere-sampled env through the sheet (scene average 2), which
    # all three offline golden renderers contradict.  Our diffuse eval is
    # clamped to the shading hemisphere, so a unit-reflectance sheet under
    # a unit env converges to 1 (see union._diffuse_eval).
    scene = create_flat_scene()
    scene["lights"].append(
        {"type": "env", "name": "_light", "radiance": [1, 1, 1]})
    value = compute_scene_average(scene, spp=24, size=96)
    assert value == pytest.approx(1, rel=2e-2)


def test_two_sided_diffuse_constant_env_furnace():
    """Furnace: a diffuse sheet under a constant env converges to rho*L for
    BOTH estimator halves (BSDF-only and NEE+MIS) with the hemisphere
    clamp; the reference's absolute_cos eval would give ~2*rho under NEE
    (back-lit transmission through an opaque sheet)."""
    import json

    import numpy as np

    from ignis_jax.api import load_scene
    base = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 40,
                   "transform": [1, 0, 0, 0, 0, 0, 1, -5,
                                 0, -1, 0, 0, 0, 0, 0, 1]},
        "film": {"size": [24, 24]},
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": 0.8}],
        "shapes": [{"type": "rectangle", "name": "p", "width": 60,
                    "height": 60, "transform": [{"rotate": [-90, 0, 0]}]}],
        "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
        "lights": [{"type": "constant", "name": "sky", "radiance": 1}],
    }
    vals = {}
    for nee in (False, True):
        sc = json.loads(json.dumps(base))
        sc["technique"]["nee"] = nee
        rt = load_scene(json.dumps(sc))
        for _ in range(24):
            rt.step(spi=4)
        img = np.asarray(rt.currentFrame())
        vals[nee] = float(img[8:16, 8:16, 0].mean())
    assert vals[False] == pytest.approx(0.8, rel=0.02)
    assert vals[True] == pytest.approx(0.8, rel=0.05)


def test_env_sat_cdf_variant():
    """cdf_method: "sat" (CDF.cpp computeForImageSAT / EnvironmentLight
    .cpp:15): the SAT stores the exact reference weighting and its derived
    sampling tables integrate the same env as the plain CDF."""
    import numpy as np
    from ignis_jax.light.env_cdf import build_sat2d, sat_to_cdf
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (32, 64, 3)).astype(np.float32) ** 2
    img[5, 11] = 50.0  # bright texel
    sat = build_sat2d(img, premultiply_sin=True, compensate=False)
    assert sat.shape == (32, 64)
    assert abs(float(sat[-1, -1]) - 1.0) < 1e-6
    # monotone in both axes
    assert (np.diff(sat, axis=0) >= -1e-6).all()
    assert (np.diff(sat, axis=1) >= -1e-6).all()
    m, c = sat_to_cdf(sat)
    # the derived marginal reproduces the sin-weighted row masses
    w = (img.sum(axis=2) / 3.0
         * np.sin(np.pi * (np.arange(32) + 0.5) / 32)[:, None])
    rows = w.sum(axis=1)
    expect = np.cumsum(rows) / rows.sum()
    np.testing.assert_allclose(m, expect, rtol=1e-4, atol=1e-5)
    # row 5's conditional concentrates on the bright texel
    jump = c[5, 11] - (c[5, 10] if 10 >= 0 else 0.0)
    assert jump > 0.5


def test_env_sat_scene_loads_and_renders():
    import numpy as np
    from ignis_jax.api import Runtime
    from ignis_jax.utils.exr import write_exr
    import tempfile, os
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory() as td:
        exr = os.path.join(td, "e.exr")
        write_exr(exr, rng.uniform(0, 2, (16, 32, 3)).astype(np.float32))
        sc = {
            "technique": {"type": "path", "max_depth": 2},
            "camera": {"type": "perspective", "fov": 60,
                       "transform": {"translate": [0, 0, -3]}},
            "film": {"size": [24, 24]},
            "textures": [{"type": "image", "name": "env", "filename": exr}],
            "bsdfs": [{"type": "diffuse", "name": "m",
                       "reflectance": 0.6}],
            "shapes": [{"type": "rectangle", "name": "sq", "width": 2,
                        "height": 2}],
            "entities": [{"name": "sq", "shape": "sq", "bsdf": "m"}],
            "lights": [{"type": "env", "name": "sky", "radiance": "env",
                        "cdf": True, "cdf_method": "sat"}],
        }
        rt = Runtime(sc)
        assert any(k.endswith("_sat") for k in rt.tables)
        rt.step(spi=2)
        assert np.isfinite(rt.currentFrame()).all()
