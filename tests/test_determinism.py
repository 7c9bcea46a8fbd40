"""Determinism + driver-equivalence tests.

(a) Same seed => bitwise-identical image (port of the reference's
    src/tests/integrator/test_reproducibility.py; the property the
    path-replay gradient design depends on, core/random.art:35-44).
(b) render_wavefront (production: regenerating wave + tail cascade)
    computes the same per-pixel radiance as summing trace_wave (the
    oracle driver used by igtrace) over the work list.
(c) Sharded (8-device CPU mesh) execution matches single-device output.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

SCENE = {
    "technique": {"type": "path", "max_depth": 4},
    "camera": {"type": "perspective", "fov": 50,
               "transform": [-1, 0, 0, 0, 0, 1, 0, 0,
                             0, 0, -1, 3.0, 0, 0, 0, 1]},
    "film": {"size": [20, 20]},
    "bsdfs": [
        {"type": "diffuse", "name": "white", "reflectance": [0.7, 0.6, 0.5]},
        {"type": "conductor", "name": "mirror", "material": "none"},
    ],
    "shapes": [
        {"type": "rectangle", "name": "floor", "width": 3, "height": 3,
         "transform": [{"translate": [0, -1, 0]}, {"rotate": [-90, 0, 0]}]},
        {"type": "rectangle", "name": "back", "width": 3, "height": 3,
         "transform": [{"translate": [0, 0, -1]}]},
    ],
    "entities": [
        {"name": "floor", "shape": "floor", "bsdf": "white"},
        {"name": "back", "shape": "back", "bsdf": "mirror"},
    ],
    "lights": [
        {"type": "point", "name": "l", "position": [0.4, 0.8, 1.2],
         "intensity": [3, 3, 3]},
    ],
}


def _runtime(seed=7):
    from ignis_jax.api import load_scene
    return load_scene(json.dumps(SCENE), seed=seed)


def test_same_seed_bitwise_identical():
    imgs = []
    for _ in range(2):
        rt = _runtime(seed=7)
        for _ in range(3):
            rt.step(spi=2)
        imgs.append(np.asarray(rt.currentFrame()))
    assert np.array_equal(imgs[0], imgs[1]), "same seed must replay bitwise"


def test_different_seed_differs():
    rt_a = _runtime(seed=7)
    rt_b = _runtime(seed=8)
    for rt in (rt_a, rt_b):
        rt.step(spi=2)
    assert not np.array_equal(rt_a.currentFrame(), rt_b.currentFrame())


def test_wavefront_equals_trace_wave_sum():
    """The regenerating wavefront driver and the per-lane oracle driver
    must agree per pixel (same RNG keying: (sample, iter, frame, x, y))."""
    import jax.numpy as jnp

    from ignis_jax.render.integrator import render_wavefront, trace_wave
    rt = _runtime()
    scene, tables = rt.scene, rt.tables
    w, h = scene.width, scene.height
    npix = w * h
    spi = 2
    idx = np.arange(npix * spi, dtype=np.int64)
    x = jnp.asarray((idx % npix % w).astype(np.int32))
    y = jnp.asarray((idx % npix // w).astype(np.int32))
    smp = jnp.asarray((idx // npix).astype(np.uint32))

    fb, _stats = render_wavefront(scene, tables, x, y, smp,
                                  jnp.uint32(3), jnp.uint32(0), 0,
                                  capacity=256, spi=spi)
    fb = np.asarray(fb)

    acc = np.zeros((npix, 3), np.float32)
    for s in range(spi):
        lane = trace_wave(scene, tables, x[:npix], y[:npix],
                          jnp.uint32(s), jnp.uint32(3), jnp.uint32(0), 0)
        acc += np.asarray(lane)
    np.testing.assert_allclose(fb, acc, rtol=2e-4, atol=2e-5)


def test_sharded_matches_single_device():
    """8-device CPU mesh pixel-sharded render == single-device render."""
    import jax.numpy as jnp

    from ignis_jax.parallel.sharding import make_mesh, replicate, shard_wave
    from ignis_jax.render.integrator import trace_wave

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    rt = _runtime()
    scene, tables = rt.scene, rt.tables
    w, h = scene.width, scene.height
    npix = w * h
    idx = np.arange(npix, dtype=np.int32)
    x_np = (idx % w).astype(np.int32)
    y_np = (idx // w).astype(np.int32)

    single = np.asarray(trace_wave(
        scene, tables, jnp.asarray(x_np), jnp.asarray(y_np),
        jnp.uint32(0), jnp.uint32(0), jnp.uint32(0), 0))

    mesh = make_mesh(8)
    tab8 = replicate(mesh, tables)
    x8, y8 = shard_wave(mesh, jnp.asarray(x_np), jnp.asarray(y_np))
    sharded = np.asarray(jax.jit(
        lambda t, a, b: trace_wave(scene, t, a, b, jnp.uint32(0),
                                   jnp.uint32(0), jnp.uint32(0), 0)
    )(tab8, x8, y8))
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)
