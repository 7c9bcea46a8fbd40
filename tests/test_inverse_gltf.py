"""BASELINE gate 5: glTF volume-attenuation inverse rendering
(tools/inverse_render.py — DragonAttenuation-equivalent configuration)."""

import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


@pytest.mark.slow
def test_recover_base_color_and_attenuation(tmp_path):
    from inverse_render import make_volume_gltf, run
    g = make_volume_gltf(tmp_path / "standin.gltf")
    res, params, (true_mc, true_md) = run(
        g, size=24, spp=6, iters=120, lr=0.06, out_dir=tmp_path, quiet=True)
    rec_bc = np.asarray(res["recovered_base_color"])
    true_bc = np.asarray(res["true_base_color"])
    # base color must recover tightly; attenuation moves toward truth
    # (its gradient signal comes only from interior refraction lanes)
    assert np.abs(rec_bc - true_bc).max() < 0.1, res
    init_err = np.abs(1.0 - true_md[0, 0:3]).max()
    rec_err = np.abs(np.asarray(res["recovered_sigma_a"])
                     - np.asarray(res["true_sigma_a"])).max()
    assert rec_err < init_err, res


def test_sigma_a_gradient_flows(tmp_path):
    """Closed-form transmittance for pure-absorption homogeneous media
    must carry gradient to medium_data (the DragonAttenuation path)."""
    import jax.numpy as jnp

    from ignis_jax.api import load_scene
    from ignis_jax.render.integrator import trace_wave
    from inverse_render import make_volume_gltf
    g = make_volume_gltf(tmp_path / "s.gltf")
    rt = load_scene(str(g), width=20, height=20)
    n = 400
    idx = np.arange(n, dtype=np.int32)
    x = jnp.asarray(idx % 20)
    y = jnp.asarray(idx // 20)

    def f(md):
        t = dict(rt.tables)
        t["medium_data"] = md
        return jnp.sum(trace_wave(rt.scene, t, x, y, jnp.uint32(0),
                                  jnp.uint32(0), jnp.uint32(0), 0,
                                  differentiable=True))

    gmd = np.asarray(jax.grad(f)(rt.tables["medium_data"]))
    gmd = np.nan_to_num(gmd)
    assert np.abs(gmd[0, 0:3]).sum() > 0, gmd


def test_gltf_sparse_accessor_and_texture_transform(tmp_path):
    """glTF depth items (VERDICT r3 #9): sparse accessors override base
    rows; KHR_texture_transform + sampler wraps become texture entries."""
    import base64
    import json as _json

    import numpy as np

    from ignis_jax.utils.exr import write_exr
    from ignis_jax.scene.gltf import GLTF, load_gltf_scene

    tex = np.zeros((2, 2, 3), np.float32)
    tex[0, 0] = [1, 0, 0]
    write_exr(str(tmp_path / "t.exr"), tex)

    pos = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    uvs = np.float32([[0, 0], [1, 0], [0, 1]])
    idx = np.uint16([0, 1, 2, 0])  # padded to 4 for alignment
    sparse_idx = np.uint16([2, 0])  # padded
    sparse_val = np.float32([[0, 0, 5]])
    buf = (pos.tobytes() + uvs.tobytes() + idx.tobytes()
           + sparse_idx.tobytes() + sparse_val.tobytes())
    o_uv = len(pos.tobytes())
    o_ix = o_uv + len(uvs.tobytes())
    o_si = o_ix + len(idx.tobytes())
    o_sv = o_si + len(sparse_idx.tobytes())
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [1, 1, 1, 1],
            "baseColorTexture": {"index": 0, "extensions": {
                "KHR_texture_transform": {"offset": [0.25, 0.0],
                                          "scale": [2.0, 2.0]}}}}}],
        "textures": [{"source": 0, "sampler": 0}],
        "samplers": [{"wrapS": 33071, "wrapT": 10497}],
        "images": [{"uri": "t.exr"}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": o_uv},
            {"buffer": 0, "byteOffset": o_uv, "byteLength": o_ix - o_uv},
            {"buffer": 0, "byteOffset": o_ix, "byteLength": 6},
            {"buffer": 0, "byteOffset": o_si, "byteLength": 2},
            {"buffer": 0, "byteOffset": o_sv, "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "sparse": {
                 "count": 1,
                 "indices": {"bufferView": 3, "componentType": 5123},
                 "values": {"bufferView": 4}}},
            {"bufferView": 1, "componentType": 5126, "count": 3,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
    }
    p = tmp_path / "sparse.gltf"
    p.write_text(_json.dumps(doc))

    g = GLTF(p)
    acc = g.accessor(0)
    np.testing.assert_allclose(acc[2], [0, 0, 5])  # sparse override
    np.testing.assert_allclose(acc[0], [0, 0, 0])

    scene = load_gltf_scene(p)
    assert scene.textures_order, "baseColor texture not imported"
    tname = scene.textures_order[0]
    tobj = scene.textures[tname]
    assert tobj.get("wrap_mode_u") == "clamp"
    m = np.asarray(tobj["transform"], np.float32).reshape(2, 3)
    np.testing.assert_allclose(m[0], [2.0, 0.0, 0.25], atol=1e-6)
    # the mesh BSDF references the texture by name
    b = scene.bsdfs[scene.bsdfs_order[0]]
    assert b["base_color"] == tname
