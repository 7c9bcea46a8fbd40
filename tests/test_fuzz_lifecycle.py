"""Parser fuzzing + multi-runtime lifecycle tests.

Ports of src/tests/fuzzer/main.cpp:16-50 (random byte strings into the
scene parser must never crash the process — raising SceneError is fine)
and src/tests/multiple_runtimes/main.cpp:10-43 (sequentially construct
and step several runtimes; pass = no crash/leak).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ignis_jax.scene.parser import SceneError, load_scene_string  # noqa: E402


def _try_parse(text):
    try:
        load_scene_string(text)
    except (SceneError, ValueError, KeyError, TypeError, AttributeError,
            RecursionError, UnicodeDecodeError) as e:  # noqa: F841
        return False  # graceful rejection
    return True


def test_fuzz_standard_inputs():
    for s in ("", "\0", "\n", "{", "}", "[]", "{}", '{"shapes": 3}',
              '{"camera": []}', '{"technique": {"type": 5}}',
              '{"shapes": [{"type": null}]}'):
        _try_parse(s)  # must not crash the interpreter


def test_fuzz_random_bytes():
    rng = np.random.RandomState(0xF022)
    for _ in range(200):
        size = int(rng.randint(0, 2048))
        raw = bytes(rng.randint(0, 128, size, dtype=np.uint8).tolist())
        _try_parse(raw.decode("ascii", errors="ignore"))


def test_fuzz_json_mutations():
    """Structurally-valid JSON with hostile values."""
    rng = np.random.RandomState(7)
    base = {
        "technique": {"type": "path"},
        "camera": {"type": "perspective"},
        "film": {"size": [8, 8]},
        "bsdfs": [{"type": "diffuse", "name": "m"}],
        "shapes": [{"type": "rectangle", "name": "p"}],
        "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
        "lights": [],
    }
    hostile = [None, -1, 1e39, -1e39, float("nan"), "", "x", [], {},
               [1, 2, 3, 4, 5], {"a": 1}, True]
    for _ in range(60):
        sc = json.loads(json.dumps(base).replace("NaN", "0"))
        section = rng.choice(list(sc.keys()))
        v = hostile[rng.randint(len(hostile))]
        if isinstance(sc[section], list) and sc[section]:
            key = rng.choice(list(sc[section][0].keys()))
            sc[section][0][key] = v
        elif isinstance(sc[section], dict):
            key = rng.choice(list(sc[section].keys()))
            sc[section][key] = v
        try:
            _try_parse(json.dumps(sc, allow_nan=False))
        except ValueError:
            pass


def test_multiple_runtimes_lifecycle():
    """Sequential runtimes over different scenes, alternating techniques
    (the CPU/GPU alternation of the reference maps to technique/driver
    variation here); each steps to 8 spp; no crash, no cross-talk."""
    from ignis_jax.api import load_scene
    scenes = []
    for i, tech in enumerate(["path", "volpath", "debug", "path"]):
        scenes.append(json.dumps({
            "technique": {"type": tech, "max_depth": 3},
            "camera": {"type": "perspective", "fov": 45,
                       "transform": [1, 0, 0, 0, 0, 1, 0, 0,
                                     0, 0, 1, -2 - i, 0, 0, 0, 1]},
            "film": {"size": [12, 12]},
            "bsdfs": [{"type": "diffuse", "name": "m",
                       "reflectance": 0.3 + 0.1 * i}],
            "shapes": [{"type": "rectangle", "name": "p", "width": 2,
                        "height": 2}],
            "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
            "lights": [{"type": "point", "name": "l",
                        "position": [0, 1, -1], "intensity": [1, 1, 1]}],
        }))
    means = []
    for src in scenes:
        rt = load_scene(src)
        while rt.currentSampleCount() < 8:
            rt.step(spi=2)
        img = rt.currentFrame()
        assert np.isfinite(img).all()
        means.append(float(img.mean()))
        del rt
    # different reflectances ⇒ different results (no state leakage between
    # runtimes); first and last share technique but differ in scene
    assert means[0] != means[3]
