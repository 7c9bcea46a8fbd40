"""Perspective depth-of-field (perspective.art:69-83 thin lens) and brick
pattern (texture/brick.art) tests."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def _checker_scene(aperture, focal, dist=3.0):
    return {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 40,
                   "aperture_radius": aperture, "focal_length": focal,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -dist]},
        "film": {"size": [48, 48]},
        "textures": [{"type": "checkerboard", "name": "check",
                      "scale_x": 8, "scale_y": 8}],
        "bsdfs": [{"type": "diffuse", "name": "g", "reflectance": "check"}],
        "shapes": [{"type": "rectangle", "name": "p", "width": 3,
                    "height": 3}],
        "entities": [{"name": "p", "shape": "p", "bsdf": "g"}],
        "lights": [{"type": "point", "name": "l", "position": [0, 0, -3],
                    "intensity": [6, 6, 6]}],
    }


def _render(sc, spp=16):
    from ignis_jax.api import load_scene
    rt = load_scene(json.dumps(sc))
    for _ in range(spp // 4):
        rt.step(spi=4)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    return np.asarray(img)


def _sharpness(img):
    g = img.mean(axis=-1)
    return float(np.abs(np.diff(g, axis=1)).mean()
                 + np.abs(np.diff(g, axis=0)).mean())


def test_dof_in_focus_matches_pinhole():
    pin = _render(_checker_scene(0.0, 1.0))
    foc = _render(_checker_scene(0.05, 3.0))  # focus exactly on the plane
    # in-focus thin lens ~ pinhole (small residual blur from plane tilt)
    assert abs(foc.mean() - pin.mean()) < 0.05 * pin.mean()
    assert _sharpness(foc) > 0.6 * _sharpness(pin)


def test_dof_defocus_blurs():
    foc = _render(_checker_scene(0.12, 3.0), spp=64)
    defoc = _render(_checker_scene(0.12, 1.0), spp=64)  # focus in front
    # the MC-noise floor keeps the gradient metric from collapsing fully;
    # measured ratio ~0.69 at 64 spp
    assert _sharpness(defoc) < 0.8 * _sharpness(foc)
    # energy is preserved by the lens model
    assert abs(defoc.mean() - foc.mean()) < 0.08 * foc.mean()


def test_brick_pattern_fractions():
    """Gap fraction: body covers (1-gap_x)*(1-gap_y) of each tile."""
    import jax.numpy as jnp

    from ignis_jax.texture.eval import eval_one
    tex = dict(type=3, name="b",
               color0=np.float32([0, 0, 0]), color1=np.float32([1, 1, 1]),
               scale=np.float32([3, 6]), gap=np.float32([0.1, 0.2]),
               transform=np.float32([[1, 0, 0], [0, 1, 0]]))
    n = 512
    g = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(g, g)
    uv = jnp.asarray(np.stack([uu.ravel(), vv.ravel()], -1), jnp.float32)

    class _S:
        textures = [tex]
    out = np.asarray(eval_one(_S(), {}, tex, uv))
    frac = out[:, 0].mean()
    assert frac == pytest.approx((1 - 0.1) * (1 - 0.2), abs=0.02)


def test_brick_running_bond():
    """Odd rows are offset by half a brick."""
    import jax.numpy as jnp

    from ignis_jax.texture.eval import eval_one
    tex = dict(type=3, name="b",
               color0=np.float32([0, 0, 0]), color1=np.float32([1, 1, 1]),
               scale=np.float32([1, 2]), gap=np.float32([0.3, 0.0]),
               transform=np.float32([[1, 0, 0], [0, 1, 0]]))

    class _S:
        textures = [tex]
    # x near the row-0 gap center (x=0.85 of brick) at row 0 vs row 1
    uv = jnp.asarray([[0.85, 0.25], [0.85, 0.75], [0.35, 0.75]], jnp.float32)
    out = np.asarray(eval_one(_S(), {}, tex, uv))
    assert out[0, 0] == 0.0     # row 0: in gap
    assert out[1, 0] == 1.0     # row 1: shifted half brick -> body
    assert out[2, 0] == 0.0     # row 1 gap moved to x=0.35
