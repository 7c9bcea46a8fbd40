"""Parameter registry tests (Runtime::setParameter, Runtime.cpp:668-731;
ParameterSet, RuntimeStructs.h:56-69).

The registry is a traced float vector (`tables["params"]`): scene
`parameters` entries plus built-in __camera_*/__time keys.  Changing a value
must not retrace/recompile, and gradients must flow to registry-named
parameters (this build's replacement for the reference's
embed-vs-registry ShadingTree specialization, ShadingTree.h:16-63).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def _param_scene():
    return {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [24, 24]},
        "parameters": [
            {"type": "number", "name": "p_scale", "value": 4},
            {"type": "color", "name": "p_col0", "value": 0},
            {"type": "color", "name": "p_col1", "value": 1},
        ],
        "textures": [
            {"type": "checkerboard", "name": "check",
             "scale_x": "p_scale", "scale_y": "p_scale",
             "color0": "p_col0", "color1": "p_col1"},
        ],
        "bsdfs": [
            {"type": "diffuse", "name": "ground", "reflectance": "check"},
        ],
        "shapes": [
            {"type": "rectangle", "name": "Bottom", "width": 4, "height": 4},
        ],
        "entities": [
            {"name": "Bottom", "shape": "Bottom", "bsdf": "ground"},
        ],
        "lights": [
            {"type": "point", "name": "l", "position": [0, 0, -2],
             "intensity": [2, 2, 2]},
        ],
    }


def _fresh(scene=None):
    from ignis_jax.api import load_scene
    return load_scene(json.dumps(scene or _param_scene()))


def test_set_parameter_changes_image_without_recompile():
    rt = _fresh()
    rt.step(spi=2)
    img0 = rt.currentFrame()
    ncomp = rt._render_wavefront._cache_size()

    rt.setParameter("p_col0", [0.9, 0.1, 0.1])
    rt.reset()
    rt.step(spi=2)
    img1 = rt.currentFrame()
    assert not np.allclose(img0, img1)
    # red checker cells: red mean rises, green falls
    assert img1[..., 0].mean() > img0[..., 0].mean()
    assert rt._render_wavefront._cache_size() == ncomp, \
        "setParameter must not retrace/recompile"


def test_camera_pose_parameter_no_recompile():
    rt = _fresh()
    rt.step(spi=2)
    img0 = rt.currentFrame()
    ncomp = rt._render_wavefront._cache_size()
    # move the camera up and look down at the plane
    rt.setCameraOrientationParameter([0, 0.5, -3.0], [0, -0.1, 1], [0, 1, 0])
    rt.reset()
    rt.step(spi=2)
    img1 = rt.currentFrame()
    assert not np.allclose(img0, img1)
    assert rt._render_wavefront._cache_size() == ncomp


def test_number_parameter_scales_checker():
    rt = _fresh()
    rt.step(spi=2)
    img_coarse = rt.currentFrame()
    rt.setParameter("p_scale", 16.0)
    rt.reset()
    rt.step(spi=2)
    img_fine = rt.currentFrame()
    assert not np.allclose(img_coarse, img_fine)
    # finer checker -> more cells mix toward the mean within pixels; image
    # variance across pixels drops
    assert img_fine.std() < img_coarse.std() * 1.2


def test_get_parameter_roundtrip():
    rt = _fresh()
    rt.setParameter("p_scale", 7.0)
    assert rt.getParameter("p_scale") == pytest.approx(7.0)
    rt.setParameter("p_col0", [0.2, 0.4, 0.6])
    np.testing.assert_allclose(rt.getParameter("p_col0")[:3],
                               [0.2, 0.4, 0.6], atol=1e-6)
    with pytest.raises(KeyError):
        rt.setParameter("nope", 1.0)


def test_gradient_flows_to_registry_parameter():
    import jax.numpy as jnp

    from ignis_jax.render.integrator import trace_wave
    rt = _fresh()
    scene = rt.scene
    n = 64
    idx = np.arange(n, dtype=np.int32)
    x = jnp.asarray(idx % 24)
    y = jnp.asarray((idx // 24) % 24)

    def loss(params, tables):
        t = dict(tables)
        t["params"] = params
        c = trace_wave(scene, t, x, y, jnp.uint32(0), jnp.uint32(0),
                       jnp.uint32(0), 0, differentiable=True)
        return jnp.sum(c)

    g = jax.grad(loss)(rt.tables["params"], rt.tables)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    # the checkerboard colors receive gradient; dL/d(col1) > 0 (brighter
    # checker -> brighter image)
    _, off, size = scene.param_registry["p_col1"]
    assert np.abs(g[off:off + size]).sum() > 0


def test_parameter_plane_scene_compiles(ref_scenes):
    from ignis_jax.api import load_scene
    rt = load_scene(f"{ref_scenes}/parameter_plane.json",
                    width=16, height=16)
    rt.step(spi=1)
    assert np.isfinite(rt.currentFrame()).all()


def test_runtime_bake_texture_and_expr():
    """Runtime.bake (BakeShader.cpp / entrypoints/bake.art): bakes scene
    textures and raw PExpr strings over the unit uv grid."""
    import numpy as np
    from ignis_jax.api import Runtime
    sc = {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": {"translate": [0, 0, -3]}},
        "film": {"size": [16, 16]},
        "textures": [{"type": "checkerboard", "name": "check",
                      "color0": 1.0, "color1": 0.0}],
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": "check"}],
        "shapes": [{"type": "rectangle", "name": "sq", "width": 2,
                    "height": 2}],
        "entities": [{"name": "sq", "shape": "sq", "bsdf": "m"}],
        "lights": [{"type": "env", "name": "sky", "radiance": 1.0}],
    }
    rt = Runtime(sc)
    img = rt.bake("check", 32, 16)
    assert img.shape == (16, 32, 3)
    assert np.isfinite(img).all()
    # checkerboard: both extremes present
    assert img.max() > 0.9 and img.min() < 0.1
    expr = rt.bake("vec3(uv.x, uv.y, 0.5)", 16, 8)
    assert expr.shape == (8, 16, 3)
    np.testing.assert_allclose(expr[0, -1, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(expr[-1, 0, 1], 1.0, atol=1e-5)
