"""Heterogeneous participating media tests.

Oracle: a constant-density voxel grid must reproduce the homogeneous
closed forms exactly — quadrature transmittance of a constant field is
exact, and delta tracking with a tight majorant has zero null-collision
probability (reference semantics: medium/methods/delta_tracking.art,
medium/volume/voxelgrid/voxelgrid.art).
"""

import json
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


def _write_bin(path, sigma_a, sigma_s, emission, dims=(4, 4, 4)):
    w, h, d = dims
    with open(path, "wb") as f:
        f.write(struct.pack("4I", w, h, d, 0))
        vox = np.zeros(12, np.float32)
        vox[0:3] = sigma_a
        vox[4:7] = sigma_s
        vox[8:11] = emission
        f.write(vox.tobytes() * (w * h * d))


def _hetero_scene(tmp_path, sigma_a, sigma_s, g=0.0, emission=(0, 0, 0)):
    binp = tmp_path / "grid.bin"
    _write_bin(binp, sigma_a, sigma_s, emission)
    scene = {
        "technique": {"type": "volpath", "max_depth": 4},
        "camera": {"type": "perspective", "fov": 40,
                   "transform": [-1, 0, 0, 0, 0, 1, 0, 0,
                                 0, 0, -1, 3.85, 0, 0, 0, 1]},
        "film": {"size": [8, 8]},
        "bsdfs": [
            {"type": "diffuse", "name": "wall", "reflectance": [0.8, 0.8, 0.8]},
            {"type": "passthrough", "name": "null"},
        ],
        "shapes": [
            {"type": "cube", "name": "Box", "width": 2, "height": 2,
             "depth": 2},
        ],
        "entities": [
            {"name": "Box", "shape": "Box", "bsdf": "null",
             "inner_medium": "Med"},
        ],
        "lights": [
            {"type": "constant", "name": "Sky", "radiance": [1, 1, 1]},
        ],
        "media": [
            {"type": "heterogeneous", "name": "Med",
             "filename": str(binp), "g": g},
        ],
    }
    return scene


def test_voxel_bin_loader(tmp_path):
    from ignis_jax.medium.volume import load_voxel_grid_bin
    binp = tmp_path / "g.bin"
    _write_bin(binp, [0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [1, 2, 3],
               dims=(3, 2, 5))
    g = load_voxel_grid_bin(binp)
    assert g["sigma_a"].shape == (5, 2, 3, 3)
    np.testing.assert_allclose(g["sigma_a"][2, 1, 0], [0.1, 0.2, 0.3])
    np.testing.assert_allclose(g["sigma_s"][4, 0, 2], [0.4, 0.5, 0.6])
    np.testing.assert_allclose(g["emission"][0, 0, 0], [1, 2, 3])

    # reference data file sanity (scenes/volume/media/debug_grid.bin)
    import os
    ref = "/root/reference/scenes/volume/media/debug_grid.bin"
    if os.path.exists(ref):
        rg = load_voxel_grid_bin(ref)
        assert rg["sigma_a"].shape == (10, 10, 10, 3)


def test_grid_lookup_nearest_and_trilinear():
    from ignis_jax.medium.volume import grid_lookup
    grid = jnp.arange(2 * 2 * 2 * 1, dtype=jnp.float32).reshape(2, 2, 2, 1)
    # voxel centers at normalized (0.25, 0.75)
    p = jnp.asarray([[0.2, 0.2, 0.2], [0.8, 0.2, 0.2], [0.2, 0.8, 0.8]])
    out = grid_lookup(grid, p)
    np.testing.assert_allclose(np.asarray(out)[:, 0], [0, 1, 6])
    # trilinear at the exact center of a voxel = voxel value
    c = jnp.asarray([[0.25, 0.25, 0.25]])
    np.testing.assert_allclose(np.asarray(grid_lookup(grid, c, True))[0, 0],
                               0.0, atol=1e-6)
    # trilinear midway between voxels 0 and 1 along x
    m = jnp.asarray([[0.5, 0.25, 0.25]])
    np.testing.assert_allclose(np.asarray(grid_lookup(grid, m, True))[0, 0],
                               0.5, atol=1e-6)


def test_constant_grid_matches_homogeneous_transmittance(tmp_path):
    """Quadrature transmittance through a constant grid == closed form."""
    from ignis_jax.api import load_scene
    from ignis_jax.medium.union import medium_eval

    sa, ss = [0.2, 0.6, 0.8], [0.3, 0.2, 0.1]
    rt = load_scene(json.dumps(_hetero_scene(tmp_path, sa, ss)))
    scene, tables = rt.scene, rt.tables
    assert scene.media[0]["type"] == "hetero_voxel"

    # segment fully inside the box ([-1,1]^3): world pts
    p0 = jnp.asarray([[-0.9, 0.0, 0.0]])
    p1 = jnp.asarray([[0.9, 0.0, 0.0]])
    mid = jnp.full((1,), 0, jnp.int32)
    zeros = jnp.zeros((1, 3), jnp.float32)
    tr = medium_eval(scene, tables, mid, zeros, zeros, p0, p1)
    sigma_t = np.asarray(sa) + np.asarray(ss)
    expect = np.exp(-sigma_t * 1.8)
    np.testing.assert_allclose(np.asarray(tr)[0], expect, rtol=1e-5)

    # outside-the-grid segment: lookups clamp, but a vacuum lane (-1) is 1
    trv = medium_eval(scene, tables, jnp.full((1,), -1, jnp.int32),
                      zeros, zeros, p0, p1)
    np.testing.assert_allclose(np.asarray(trv)[0], [1, 1, 1])


def test_constant_grid_delta_tracking_matches_homogeneous(tmp_path):
    """With a tight majorant on a constant grid the fictional coefficient
    is 0 and the flight matches the homogeneous closed form."""
    from ignis_jax.api import load_scene
    from ignis_jax.medium.union import medium_sample

    sa, ss = [0.1, 0.1, 0.1], [2.0, 2.0, 2.0]
    rt = load_scene(json.dumps(_hetero_scene(tmp_path, sa, ss)))
    scene, tables = rt.scene, rt.tables

    n = 4096
    key = np.random.default_rng(3)
    p0 = jnp.asarray(np.tile([-0.9, 0.0, 0.0], (n, 1)), jnp.float32)
    p1 = jnp.asarray(np.tile([0.9, 0.0, 0.0], (n, 1)), jnp.float32)
    seed = jnp.asarray(key.integers(0, 2**32, n, dtype=np.uint32))
    counter = jnp.ones((n,), jnp.uint32)
    mid = jnp.zeros((n,), jnp.int32)
    zeros = jnp.zeros((n, 3), jnp.float32)
    ms, counter2 = medium_sample(scene, tables, mid, zeros, zeros, seed,
                                 counter, p0, p1,
                                 jnp.ones((n,), bool))
    # all lanes consumed a draw
    assert np.all(np.asarray(counter2) == 2)
    # fictional coefficient is 0 on a constant grid with exact majorant
    np.testing.assert_allclose(np.asarray(ms["sigma_n"]), 0.0, atol=1e-5)
    v = np.asarray(ms["valid"])
    # expected collision fraction 1 - exp(-sigma_t_max * 1.8)
    frac = v.mean()
    expect = 1.0 - np.exp(-2.1 * 1.8)
    assert abs(frac - expect) < 0.05
    # local properties at samples = grid constants
    np.testing.assert_allclose(np.asarray(ms["sigma_s"])[v],
                               np.tile(ss, (v.sum(), 1)), rtol=1e-5)
    # unbiased transmittance estimator: E[color * pdf] ≈ exp(-σt d) per chan
    pos = np.asarray(ms["pos"])[v]
    assert np.all(pos[:, 0] > -0.91) and np.all(pos[:, 0] < 0.91)


def test_volpath_hetero_renders(tmp_path):
    """End-to-end: constant hetero grid renders close to the same scene
    with an equivalent homogeneous medium."""
    from ignis_jax.api import load_scene

    sa, ss = [0.1, 0.1, 0.1], [0.8, 0.8, 0.8]
    sc_h = _hetero_scene(tmp_path, sa, ss)
    rt = load_scene(json.dumps(sc_h))
    for _ in range(4):
        rt.step(spi=4)
    img_het = rt.currentFrame()
    assert np.isfinite(img_het).all()

    sc_o = dict(sc_h)
    sc_o["media"] = [{"type": "homogeneous", "name": "Med",
                      "sigma_a": sa, "sigma_s": ss, "g": 0.0}]
    rt2 = load_scene(json.dumps(sc_o))
    for _ in range(4):
        rt2.step(spi=4)
    img_hom = rt2.currentFrame()
    # same estimand; different estimators → statistical tolerance
    assert abs(img_het.mean() - img_hom.mean()) < 0.15 * max(
        img_hom.mean(), 1e-3)


def test_emissive_voxel_grid(tmp_path):
    """A purely absorbing+emitting grid produces radiance along camera
    rays (volpathtracer.art:216-221 absorption-event emission)."""
    from ignis_jax.api import load_scene

    scene = _hetero_scene(tmp_path, [3.0, 3.0, 3.0], [0.0, 0.0, 0.0],
                          emission=(5.0, 5.0, 5.0))
    scene["lights"] = []
    rt = load_scene(json.dumps(scene))
    for _ in range(4):
        rt.step(spi=4)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # glowing volume visible


def test_nvdb_roundtrip(tmp_path):
    """NanoVDB writer→reader round trip preserves the dense grid."""
    from ignis_jax.medium.nanovdb import load_nvdb_grid, write_nvdb_grid
    rng = np.random.default_rng(7)
    dense = rng.uniform(0, 1, (12, 9, 17)).astype(np.float32)
    dense[dense < 0.3] = 0.0  # sparsity: some empty leaves
    p = tmp_path / "t.nvdb"
    write_nvdb_grid(p, dense, "density")
    back = load_nvdb_grid(p, "density")
    np.testing.assert_allclose(back, dense, rtol=1e-6)
    with pytest.raises(ValueError):
        load_nvdb_grid(p, "temperature")


def test_nvdb_medium_end_to_end(tmp_path):
    """hetero_density medium via .nvdb renders finite, nonzero output."""
    from ignis_jax.api import load_scene
    from ignis_jax.medium.nanovdb import write_nvdb_grid

    dense = np.full((8, 8, 8), 0.8, np.float32)
    p = tmp_path / "cloud.nvdb"
    write_nvdb_grid(p, dense, "density")
    scene = _hetero_scene(tmp_path, [0, 0, 0], [0, 0, 0])
    scene["media"] = [{"type": "heterogeneous", "name": "Med",
                       "filename": str(p), "shader": "monochromatic",
                       "scalar_density": 1.0, "scalar_scattering": 1.0,
                       "scalar_absorption": 0.2, "g": 0.0}]
    rt = load_scene(json.dumps(scene))
    assert rt.scene.media[0]["type"] == "hetero_density"
    np.testing.assert_allclose(
        np.asarray(rt.tables["medium_majorant"][0]), 0.8 * 1.2, rtol=1e-5)
    for _ in range(2):
        rt.step(spi=4)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


def test_ratio_tracking_transmittance_converges(tmp_path):
    """`method: delta_tracking` selects the stochastic ratio tracker
    (HeterogeneousMedium.cpp:223-236; delta_tracking.art eval_tr): its
    seed-averaged estimate must converge to the closed-form/quadrature
    transmittance, and the default method must remain deterministic."""
    import jax.numpy as jnp
    from ignis_jax.api import load_scene
    from ignis_jax.medium.union import medium_eval

    sa, ss = [0.4, 0.9, 1.4], [0.3, 0.2, 0.1]
    sc = _hetero_scene(tmp_path, sa, ss)
    for m in sc["media"]:
        m["method"] = "delta_tracking"
    rt = load_scene(json.dumps(sc))
    scene, tables = rt.scene, rt.tables
    assert scene.media[0]["method"] == "delta_tracking"

    n = 4096
    p0 = jnp.tile(jnp.asarray([[-0.9, 0.0, 0.0]]), (n, 1))
    p1 = jnp.tile(jnp.asarray([[0.9, 0.0, 0.0]]), (n, 1))
    mid = jnp.zeros((n,), jnp.int32)
    zeros = jnp.zeros((n, 3), jnp.float32)
    seeds = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(7919)
    ctr = jnp.zeros((n,), jnp.uint32)
    tr = medium_eval(scene, tables, mid, zeros, zeros, p0, p1,
                     seed=seeds, counter=ctr)
    est = np.asarray(tr).mean(axis=0)
    expect = np.exp(-(np.asarray(sa) + np.asarray(ss)) * 1.8)
    np.testing.assert_allclose(est, expect, rtol=0.1, atol=0.01)
    # without an RNG stream the call stays deterministic (quadrature)
    tr_q = medium_eval(scene, tables, mid, zeros, zeros, p0, p1)
    np.testing.assert_allclose(np.asarray(tr_q)[0], expect, rtol=1e-5)
