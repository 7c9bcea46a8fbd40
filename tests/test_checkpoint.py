"""Checkpoint/resume (SURVEY §5.4): interrupted renders continue
bitwise-identically — the counter-keyed RNG makes the accumulation state
the complete render state."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

SCENE = {
    "technique": {"type": "path", "max_depth": 3},
    "camera": {"type": "perspective", "fov": 45,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
    "film": {"size": [16, 16]},
    "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": 0.6}],
    "shapes": [{"type": "rectangle", "name": "p", "width": 2, "height": 2}],
    "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
    "lights": [{"type": "point", "name": "l", "position": [0.3, 0.4, -1],
                "intensity": [2, 2, 2]}],
}


def test_checkpoint_resume_bitwise(tmp_path):
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(SCENE), seed=11)
    for _ in range(3):
        rt.step(spi=2)
    rt.saveCheckpoint(tmp_path / "ck.npz")
    for _ in range(3):
        rt.step(spi=2)
    full = np.asarray(rt.currentFrame())

    rt2 = load_scene(json.dumps(SCENE), seed=0)  # seed restored from ck
    rt2.loadCheckpoint(tmp_path / "ck.npz")
    assert rt2.currentSampleCount() == 6
    for _ in range(3):
        rt2.step(spi=2)
    resumed = np.asarray(rt2.currentFrame())
    assert np.array_equal(full, resumed)


def test_checkpoint_size_mismatch(tmp_path):
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(SCENE))
    rt.step(spi=1)
    rt.saveCheckpoint(tmp_path / "ck.npz")
    other = json.loads(json.dumps(SCENE))
    other["film"]["size"] = [8, 8]
    rt2 = load_scene(json.dumps(other))
    with pytest.raises(ValueError):
        rt2.loadCheckpoint(tmp_path / "ck.npz")


def test_tonemap_imageinfo_api(tmp_path):
    """Runtime.tonemap / Runtime.imageinfo (Runtime.h surface parity)."""
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(SCENE))
    rt.step(spi=2)
    tm = rt.tonemap("aces")
    assert tm.shape == (16, 16, 3)
    assert tm.min() >= 0.0 and tm.max() <= 1.0
    linear = rt.tonemap("none", gamma=False)
    assert np.allclose(linear[linear < 1.0],
                       np.asarray(rt.currentFrame())[linear < 1.0],
                       atol=1e-5)
    info = rt.imageinfo(histogram=True, percentile=True)
    assert info["max"] >= info["avg"] >= info["min"] >= 0
    assert info["nan_count"] == 0 and info["inf_count"] == 0
    assert "histogram" in info and "soft_max" in info
