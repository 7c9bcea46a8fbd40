"""Breadth shape/mesh-IO tests: gauss, gauss_lobe, Mitsuba .serialized,
backslash path normalization (LoaderShape.cpp:20-41, MtsSerializedFile.cpp,
TriMesh.cpp:1059-1156)."""

import json
import struct
import zlib

import numpy as np
import pytest


def test_gauss_shape_geometry():
    from ignis_jax.scene.shapes import build_shape
    mesh = build_shape({"type": "gauss", "name": "g", "sigma": 0.5,
                        "height": 2.0, "sections": 16, "slices": 8},
                       lambda p: p)
    v = mesh.vertices
    # grounded: base ring at z=0; peak at height*(gauss(0)-gauss(1)) along z
    import math
    g0 = 1.0 / (0.5 * 2 * math.pi)
    g1 = math.exp(-1 / (2 * 0.25)) / (0.5 * 2 * math.pi)
    assert v[:, 2].min() == pytest.approx(0.0, abs=1e-6)
    assert v[:, 2].max() == pytest.approx(2.0 * (g0 - g1), rel=1e-5)
    assert mesh.face_count == 16 * 2 * 8  # cap + sides + peak fan


def test_gauss_lobe_scene_renders(ref_scenes):
    import jax  # noqa: F401

    from ignis_jax.api import load_scene
    rt = load_scene(f"{ref_scenes}/gauss_lobe.json", width=24, height=24)
    rt.step(spi=1)
    img = rt.currentFrame()
    assert np.isfinite(img).all() and img.mean() > 0


def _write_serialized(path, verts, faces, normals=None, uvs=None,
                      version=4):
    flags = 0x1000  # MF_FLOAT
    blob = b""
    if version >= 4:
        blob += b"shape0\0"
    if normals is not None:
        flags |= 0x0001
    if uvs is not None:
        flags |= 0x0002
    payload = struct.pack("<QQ", len(verts), len(faces))
    payload += np.asarray(verts, np.float32).tobytes()
    if normals is not None:
        payload += np.asarray(normals, np.float32).tobytes()
    if uvs is not None:
        payload += np.asarray(uvs, np.float32).tobytes()
    payload += np.asarray(faces, np.uint32).tobytes()
    blob = struct.pack("<I", flags) + blob + payload
    comp = zlib.compress(blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<HH", 0x041C, version))
        f.write(comp)
        if version >= 4:
            f.write(struct.pack("<Q", 0))
        else:
            f.write(struct.pack("<I", 0))
        f.write(struct.pack("<I", 1))


def test_mitsuba_serialized_roundtrip(tmp_path):
    from ignis_jax.scene.mesh import load_serialized
    verts = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]])
    faces = np.uint32([[0, 1, 2], [1, 3, 2]])
    uvs = np.float32([[0, 0], [1, 0], [0, 1], [1, 1]])
    p = tmp_path / "quad.serialized"
    _write_serialized(p, verts, faces, uvs=uvs)
    mesh = load_serialized(p)
    np.testing.assert_allclose(mesh.vertices, verts)
    np.testing.assert_array_equal(mesh.indices, faces.astype(np.int32))
    np.testing.assert_allclose(mesh.texcoords, uvs)
    # normals computed (flat quad -> +z)
    np.testing.assert_allclose(np.abs(mesh.normals[:, 2]), 1.0, atol=1e-6)


def test_mitsuba_serialized_v3(tmp_path):
    from ignis_jax.scene.mesh import load_serialized
    verts = np.float32([[0, 0, 0], [2, 0, 0], [0, 2, 0]])
    faces = np.uint32([[0, 1, 2]])
    p = tmp_path / "tri.serialized"
    _write_serialized(p, verts, faces, version=3)
    mesh = load_serialized(p)
    assert mesh.face_count == 1
    np.testing.assert_allclose(mesh.vertices, verts)


def test_mitsuba_shape_in_scene(tmp_path):
    import jax  # noqa: F401

    from ignis_jax.api import load_scene
    verts = np.float32([[-1, -1, 0], [1, -1, 0], [-1, 1, 0], [1, 1, 0]])
    faces = np.uint32([[0, 1, 3], [0, 3, 2]])
    _write_serialized(tmp_path / "m.serialized", verts, faces)
    sc = {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": 0.7}],
        "shapes": [{"type": "mitsuba", "name": "q",
                    "filename": "m.serialized"}],
        "entities": [{"name": "q", "shape": "q", "bsdf": "m"}],
        "lights": [{"type": "point", "name": "l", "position": [0, 0, -2],
                    "intensity": [2, 2, 2]}],
    }
    (tmp_path / "scene.json").write_text(json.dumps(sc))
    rt = load_scene(str(tmp_path / "scene.json"))
    rt.step(spi=2)
    assert rt.currentFrame().mean() > 0


def test_backslash_paths_resolve(tmp_path):
    from ignis_jax.scene.parser import load_scene_dict
    (tmp_path / "textures").mkdir()
    (tmp_path / "textures" / "t.png").write_bytes(b"")
    sc = load_scene_dict({}, base_dir=tmp_path)
    p = sc.resolve_path("textures\\t.png")
    assert p.exists()
