"""Extended finite-difference gradient oracles (VERDICT r3 #5).

Each test perturbs one differentiable parameter class and checks the
reverse-mode gradient against central differences through the full
path-replay renderer (matched-seed, so the FD is noise-free)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import create_flat_scene


def _compile(scene_dict, size=16):
    from ignis_jax.scene.compile import load_and_compile
    scene_dict = dict(scene_dict)
    scene_dict["film"] = {"size": [size, size]}
    scene = load_and_compile(scene_dict)
    tables = {k: jnp.asarray(v) for k, v in scene.tables.items()}
    return scene, tables


def _loss(scene, tables, key, n=64, center=False):
    from ignis_jax.render.integrator import trace_wave
    idx = np.arange(n, dtype=np.int32)
    if center:  # lanes over the middle rows of the film
        idx = idx + (scene.width * scene.height // 2 - n // 2)
    x = jnp.asarray(idx % scene.width)
    y = jnp.asarray(idx // scene.width % scene.height)

    def loss(val):
        t = dict(tables)
        t[key] = val
        c = trace_wave(scene, t, x, y, jnp.uint32(0), jnp.uint32(0),
                       jnp.uint32(0), 0, differentiable=True)
        return jnp.mean(c)
    return loss


def _check_fd(loss, val, slots, eps=1e-3, rel=2e-2):
    g = np.asarray(jax.grad(loss)(val))
    checked = 0
    for slot in slots:
        up = val.at[slot].add(eps)
        dn = val.at[slot].add(-eps)
        fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
        an = float(g[slot])
        if abs(fd) < 1e-7 and abs(an) < 1e-7:
            continue
        assert fd == pytest.approx(an, rel=rel, abs=1e-6), (slot, fd, an)
        checked += 1
    assert checked > 0, "no slot produced signal"


def test_grad_texture_texel(tmp_path):
    """d radiance / d texel of an image texture driving reflectance."""
    from ignis_jax.utils.exr import write_exr
    img = np.full((4, 4, 3), 0.5, np.float32)
    img[1, 2] = [0.9, 0.3, 0.1]
    path = tmp_path / "tex.exr"
    write_exr(str(path), img)
    sd = create_flat_scene()
    sd["textures"] = [{"type": "image", "name": "tex",
                       "filename": str(path)}]
    sd["bsdfs"][0]["reflectance"] = "tex"
    sd["lights"] = [{"type": "point", "name": "l",
                     "position": [0, 0, -2], "intensity": [1, 1, 1]}]
    scene, tables = _compile(sd)
    key = None
    for k in tables:
        if k.endswith("_img"):
            key = k
    assert key is not None, sorted(tables)
    loss = _loss(scene, tables, key, center=True)
    val = tables[key]
    g = np.asarray(jax.grad(loss)(val))
    nz = [tuple(i) for i in np.argwhere(np.abs(g) > 1e-7)]
    assert nz, "no texel received gradient"
    _check_fd(loss, val, nz[:3], eps=1e-2, rel=3e-2)


def test_grad_env_radiance():
    """d radiance / d env light tint (light_data slots)."""
    sd = create_flat_scene()
    sd["lights"] = [{"type": "env", "name": "sky",
                     "radiance": [0.6, 0.7, 0.8]}]
    scene, tables = _compile(sd)
    loss = _loss(scene, tables, "light_data")
    ld = tables["light_data"]
    base = np.asarray(ld[0])
    slots = [(0, c) for c in range(8) if abs(base[c]) > 0.05]
    _check_fd(loss, ld, slots, eps=1e-2)


def test_grad_roughness_roughconductor():
    """d radiance / d roughness of a rough conductor (mat_scalars)."""
    sd = create_flat_scene()
    sd["bsdfs"] = [{"type": "roughconductor", "name": "ground",
                    "material": "gold", "roughness": 0.4}]
    sd["lights"] = [{"type": "point", "name": "l", "position": [0.3, 0.2, -2],
                     "intensity": [2, 2, 2]}]
    scene, tables = _compile(sd)
    loss = _loss(scene, tables, "mat_scalars")
    ms = tables["mat_scalars"]
    g = np.asarray(jax.grad(loss)(ms))
    nz = [tuple(i) for i in np.argwhere(np.abs(g) > 1e-6)]
    assert nz, "roughness produced no gradient"
    _check_fd(loss, ms, nz[:3], eps=1e-3, rel=5e-2)


def test_grad_sigma_a_homogeneous():
    """d radiance / d sigma_a through a homogeneous absorbing box."""
    # camera rays cross the fog box to a lit wall; the wall's shadow rays
    # go UP to the light and never re-enter the box (binary any-hit
    # occlusion would otherwise hide the fog entirely)
    sd = {
        "technique": {"type": "volpath", "max_depth": 4},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "media": [{"type": "homogeneous", "name": "fog",
                   "sigma_a": [0.8, 0.5, 0.2], "sigma_s": [0, 0, 0]}],
        "bsdfs": [
            {"type": "passthrough", "name": "null"},
            {"type": "diffuse", "name": "wall", "reflectance": [0.8, 0.8, 0.8]},
        ],
        "shapes": [
            {"type": "cube", "name": "box", "width": 1, "height": 1,
             "depth": 1},
            {"type": "rectangle", "name": "back", "width": 6, "height": 6,
             "transform": [{"translate": [0, 0, 1.5]},
                           {"rotate": [180, 0, 0]}]},
        ],
        "entities": [
            {"name": "box", "shape": "box", "bsdf": "null",
             "inner_medium": "fog"},
            {"name": "back", "shape": "back", "bsdf": "wall"},
        ],
        "lights": [{"type": "point", "name": "l", "position": [0, 4, 1.3],
                    "intensity": [30, 30, 30]}],
    }
    scene, tables = _compile(sd)
    loss = _loss(scene, tables, "medium_data", center=True)
    md = tables["medium_data"]
    fog = None
    for mi in range(md.shape[0]):
        if float(np.asarray(md)[mi, 0]) > 0.5:
            fog = mi
    assert fog is not None
    _check_fd(loss, md, [(fog, 0), (fog, 1)], eps=1e-2, rel=5e-2)


def test_grad_registry_param():
    """d radiance / d registry parameter (scene `parameters` section)."""
    sd = create_flat_scene()
    sd["parameters"] = [{"type": "number", "name": "bright", "value": 0.7}]
    sd["bsdfs"][0]["reflectance"] = "vec3(bright, bright, bright)"
    sd["lights"] = [{"type": "point", "name": "l", "position": [0, 0, -2],
                     "intensity": [1, 1, 1]}]
    scene, tables = _compile(sd)
    assert "bright" in scene.param_registry
    loss = _loss(scene, tables, "params")
    p = tables["params"]
    _, off, _ = scene.param_registry["bright"]
    _check_fd(loss, p, [off], eps=1e-3)


def test_grad_multibounce_indirect():
    """Gradient flows through a 3-bounce indirect path (wall color seen
    only via one diffuse bounce)."""
    sd = {
        "technique": {"type": "path", "max_depth": 4, "min_depth": 4},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "bsdfs": [
            {"type": "diffuse", "name": "floor", "reflectance": [0.8, 0.8, 0.8]},
            {"type": "diffuse", "name": "red", "reflectance": [0.9, 0.1, 0.1]},
        ],
        "shapes": [
            {"type": "rectangle", "name": "fl", "width": 4, "height": 4,
             "flip_normals": True},
            {"type": "rectangle", "name": "side", "width": 4, "height": 4,
             "transform": [{"rotate": [0, -90, 0]},
                           {"translate": [1.5, 0, 0]}]},
        ],
        "entities": [
            {"name": "fl", "shape": "fl", "bsdf": "floor"},
            {"name": "side", "shape": "side", "bsdf": "red"},
        ],
        "lights": [{"type": "point", "name": "l", "position": [0, 0, -1.5],
                    "intensity": [4, 4, 4]}],
    }
    scene, tables = _compile(sd)
    loss = _loss(scene, tables, "mat_colors", n=256)
    mc = tables["mat_colors"]
    g = np.asarray(jax.grad(loss)(mc))
    # the red wall (mat 1) is never directly visible from this camera but
    # its color must still receive gradient via the indirect bounce
    assert np.any(np.abs(g[1, 0]) > 1e-8), g[1]
    _check_fd(loss, mc, [(1, 0, 0)], eps=1e-2, rel=5e-2)
