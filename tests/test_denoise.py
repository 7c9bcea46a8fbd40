"""A-trous denoiser tests (render/denoise.py — the OIDN post-pass analog,
Device.cpp:1604-1607)."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def test_denoise_reduces_noise_preserves_edges():
    from ignis_jax.render.denoise import atrous_denoise
    rng = np.random.RandomState(0)
    h = w = 64
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, : w // 2] = 0.2
    clean[:, w // 2:] = 0.8
    normals = np.zeros((h, w, 3), np.float32)
    normals[:, : w // 2, 2] = 1.0
    normals[:, w // 2:, 0] = 1.0      # normal edge at the boundary
    depth = np.ones((h, w), np.float32)
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    out = np.asarray(atrous_denoise(noisy, normals=normals, depth=depth))
    err_noisy = np.abs(noisy - clean).mean()
    err_out = np.abs(out - clean).mean()
    assert err_out < 0.35 * err_noisy          # noise reduced
    # edge preserved: the two halves stay distinct
    assert abs(out[:, : w // 2 - 2].mean() - 0.2) < 0.05
    assert abs(out[:, w // 2 + 2:].mean() - 0.8) < 0.05


def test_denoise_runtime_end_to_end():
    from ignis_jax.api import load_scene
    from ignis_jax.render.denoise import denoise_runtime
    sc = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 45,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [32, 32]},
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": 0.6}],
        "shapes": [{"type": "rectangle", "name": "p", "width": 2,
                    "height": 2}],
        "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
        "lights": [{"type": "area", "name": "l", "entity": "p2",
                    "radiance": 4},
                   {"type": "point", "name": "pl", "position": [0.5, 0.5, -1],
                    "intensity": [1, 1, 1]}],
    }
    sc["shapes"].append({"type": "rectangle", "name": "p2", "width": 0.3,
                         "height": 0.3,
                         "transform": [{"translate": [0, 0.8, -0.5]}]})
    sc["bsdfs"].append({"type": "diffuse", "name": "b", "reflectance": 0})
    sc["entities"].append({"name": "p2", "shape": "p2", "bsdf": "b"})
    rt = load_scene(json.dumps(sc))
    rt.step(spi=1)   # 1 spp: noisy
    noisy = np.asarray(rt.currentFrame())
    out = denoise_runtime(rt)
    assert out.shape == noisy.shape
    assert np.isfinite(out).all()
    # variance drops, mean roughly preserved
    assert out.std() < noisy.std()
    assert abs(out.mean() - noisy.mean()) < 0.25 * max(noisy.mean(), 1e-6)
