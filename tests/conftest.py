import os

# Force a virtual 8-device CPU mesh for sharding tests.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
# The suite runs on the CPU unless JAX_PLATFORMS says otherwise; tests
# marked `gpu` need the card: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF_SCENES = "/root/reference/scenes"


@pytest.fixture
def ref_scenes():
    return REF_SCENES


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev


def create_flat_scene():
    """Port of src/tests/integrator/common/__init__.py:37-64."""
    return {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {
            "type": "perspective",
            "fov": 90,
            "near_clip": 0.01,
            "far_clip": 100,
            "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -1],
        },
        "film": {"size": [1000, 1000]},
        "bsdfs": [
            {"type": "diffuse", "name": "ground", "reflectance": [1, 1, 1]}
        ],
        "shapes": [
            {"type": "rectangle", "name": "Bottom", "width": 2, "height": 2,
             "flip_normals": True}
        ],
        "entities": [
            {"name": "Bottom", "shape": "Bottom", "bsdf": "ground"}
        ],
        "lights": [],
    }


def compute_scene_average(scene, spp=8, size=256):
    from ignis_jax.api import Runtime
    scene = dict(scene)
    scene["film"] = {"size": [size, size]}
    rt = Runtime(scene)
    rt.step(spi=spp)
    return float(np.mean(rt.currentFrame()))
