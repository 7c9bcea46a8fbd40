"""Differentiable-rendering checks: radiance gradients w.r.t. material/light
parameter tables against finite differences (BASELINE.md gate 5 groundwork)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import create_flat_scene


def _loss_fn(scene, base_tables, n=64):
    from ignis_jax.render.integrator import trace_wave

    idx = np.arange(n, dtype=np.int32)
    x = jnp.asarray(idx % scene.width)
    y = jnp.asarray(idx // scene.width % scene.height)

    def loss(mat_colors):
        t = dict(base_tables)
        t["mat_colors"] = mat_colors
        c = trace_wave(scene, t, x, y, jnp.uint32(0), jnp.uint32(0),
                       jnp.uint32(0), 0, differentiable=True)
        return jnp.mean(c)

    return loss


def _compile(scene_dict, size=16):
    from ignis_jax.scene.compile import load_and_compile
    scene_dict = dict(scene_dict)
    scene_dict["film"] = {"size": [size, size]}
    scene = load_and_compile(scene_dict)
    tables = {k: jnp.asarray(v) for k, v in scene.tables.items()}
    return scene, tables


def test_grad_wrt_diffuse_reflectance_point_light():
    scene_dict = create_flat_scene()
    scene_dict["lights"].append(
        {"type": "point", "name": "_l", "position": [0, 0, -2],
         "intensity": [1, 1, 1]})
    scene, tables = _compile(scene_dict)
    loss = _loss_fn(scene, tables)

    mc = tables["mat_colors"]
    g = jax.grad(loss)(mc)
    g = np.asarray(g)

    # point-light NEE radiance is linear in kd → grad positive on slot 0
    assert np.all(g[0, 0] > 0), g
    # finite differences
    eps = 1e-3
    for c in range(3):
        up = mc.at[0, 0, c].add(eps)
        dn = mc.at[0, 0, c].add(-eps)
        fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
        assert fd == pytest.approx(float(g[0, 0, c]), rel=5e-3, abs=1e-7)


def test_grad_wrt_area_light_radiance():
    scene_dict = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "diffuse", "name": "g", "reflectance": [0.5, 0.5, 0.5]}],
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 2, "height": 2,
             "flip_normals": True},
            {"type": "rectangle", "name": "lamp", "width": 0.2, "height": 0.2,
             "transform": [{"translate": [0, 0, -1.0]}]},
        ],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "g"},
            {"name": "lamp", "shape": "lamp", "bsdf": "g"},
        ],
        "lights": [{"type": "area", "name": "al", "entity": "lamp",
                    "radiance": [2, 2, 2]}],
    }
    scene, tables = _compile(scene_dict)
    from ignis_jax.render.integrator import trace_wave
    n = scene.width * scene.height
    idx = np.arange(n, dtype=np.int32)
    x = jnp.asarray(idx % scene.width)
    y = jnp.asarray(idx // scene.width % scene.height)

    def loss(light_data):
        t = dict(tables)
        t["light_data"] = light_data
        c = trace_wave(scene, t, x, y, jnp.uint32(0), jnp.uint32(0),
                       jnp.uint32(0), 0, differentiable=True)
        return jnp.mean(c)

    ld = tables["light_data"]
    g = np.asarray(jax.grad(loss)(ld))
    # radiance slots of the plane area light (cols 13:16) must matter
    assert np.any(np.abs(g[0, 13:16]) > 0), g[0]
    eps = 1e-2
    up = ld.at[0, 13].add(eps)
    dn = ld.at[0, 13].add(-eps)
    fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
    assert fd == pytest.approx(float(g[0, 13]), rel=1e-2, abs=1e-7)
