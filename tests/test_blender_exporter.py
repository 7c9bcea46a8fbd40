"""Blender exporter round-trip (VERDICT r4 #9): export_scene runs against
a duck-typed stand-in of the bpy scene graph (no Blender in this image),
and the produced JSON — textured material, area light with generated
emitter geometry, camera/film settings — renders with ignis_jax."""

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace as NS

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "scripts" / "blender_exporter"))


class _Mat4:
    """Tiny stand-in for mathutils.Matrix (row-major 4x4)."""

    def __init__(self, rows):
        self.rows = rows

    def __getitem__(self, r):
        return self.rows[r]

    @property
    def translation(self):
        return _Vec((self.rows[0][3], self.rows[1][3], self.rows[2][3]))

    def to_3x3(self):
        return _Mat3([r[:3] for r in self.rows[:3]])


class _Mat3:
    def __init__(self, rows):
        self.rows = rows

    def __matmul__(self, v):
        return _Vec(tuple(sum(self.rows[i][k] * v[k] for k in range(3))
                          for i in range(3)))


class _Vec(tuple):
    def __new__(cls, seq):
        return super().__new__(cls, seq)


def _ident(translate=(0, 0, 0)):
    t = translate
    return _Mat4([[1, 0, 0, t[0]], [0, 1, 0, t[1]],
                  [0, 0, 1, t[2]], [0, 0, 0, 1]])


def _socket(value, links=()):
    return NS(default_value=value, links=list(links))


def _make_scene(tmp_path):
    # texture image the "Image Texture" node points at
    from PIL import Image
    img_path = tmp_path / "check.png"
    arr = np.zeros((8, 8, 3), np.uint8)
    arr[::2, ::2] = 255
    arr[1::2, 1::2] = 255
    Image.fromarray(arr).save(img_path)

    class _Img:
        filepath = str(img_path)
        name = "check"
        colorspace_settings = NS(name="sRGB")

        def save_render(self, path):
            Image.fromarray(arr).save(path)

    tex_node = NS(bl_idname="ShaderNodeTexImage", image=_Img())
    base_color = _socket((0.8, 0.8, 0.8, 1.0),
                         links=[NS(from_node=tex_node)])
    sockets = {
        "Base Color": base_color,
        "Metallic": _socket(0.0), "Roughness": _socket(0.8),
        "IOR": _socket(1.45), "Transmission": _socket(0.0),
        "Sheen": _socket(0.0), "Clearcoat": _socket(0.0),
        "Anisotropic": _socket(0.0),
    }
    pnode = NS(bl_idname="ShaderNodeBsdfPrincipled",
               inputs=NS(get=lambda n, s=sockets: s.get(n)))
    mat = NS(name="Checkered", use_nodes=True,
             node_tree=NS(nodes=[pnode]),
             diffuse_color=(0.8, 0.8, 0.8, 1.0))

    # a unit quad mesh with uvs
    verts = [NS(co=(-1, -1, 0), normal=(0, 0, 1)),
             NS(co=(1, -1, 0), normal=(0, 0, 1)),
             NS(co=(1, 1, 0), normal=(0, 0, 1)),
             NS(co=(-1, 1, 0), normal=(0, 0, 1))]
    tris = [NS(vertices=(0, 1, 2), loops=(0, 1, 2)),
            NS(vertices=(0, 2, 3), loops=(3, 4, 5))]
    uvdata = [NS(uv=(0, 0)), NS(uv=(1, 0)), NS(uv=(1, 1)),
              NS(uv=(0, 0)), NS(uv=(1, 1)), NS(uv=(0, 1))]
    mesh = NS(vertices=verts, loop_triangles=tris,
              uv_layers=NS(active=NS(data=uvdata)),
              calc_loop_triangles=lambda: None)

    mesh_obj = NS(name="Quad", type="MESH", hide_render=False,
                  active_material=mat, matrix_world=_ident(),
                  evaluated_get=lambda dg: NS(
                      to_mesh=lambda: mesh, to_mesh_clear=lambda: None))

    light_obj = NS(name="Lamp", type="LIGHT", hide_render=False,
                   matrix_world=_ident((0, 0, 2)),
                   data=NS(type="AREA", energy=40.0, color=(1, 1, 0.8),
                           size=1.0, size_y=1.0, shape="SQUARE"))

    cam = NS(matrix_world=_ident((0, 0, 3)),
             data=NS(type="PERSP", angle=math.radians(60),
                     clip_start=0.1, clip_end=100.0, lens=50.0,
                     dof=NS(use_dof=False)))

    scene = NS(objects=[mesh_obj, light_obj], camera=cam, world=None,
               render=NS(resolution_x=64, resolution_y=64),
               cycles=NS(samples=16))
    ctx = NS(scene=scene, evaluated_depsgraph_get=lambda: None)
    return ctx


def test_export_and_render_round_trip(tmp_path):
    from ignis_jax_blender import export_scene
    ctx = _make_scene(tmp_path)
    out = tmp_path / "scene.json"
    export_scene(ctx, str(out))
    doc = json.loads(out.read_text())
    # textured material bound by texture name
    mat = [b for b in doc["bsdfs"] if b["name"] == "Checkered"][0]
    assert isinstance(mat["base_color"], str)
    assert any(t["name"] == mat["base_color"] for t in doc["textures"])
    # area light produced emitter geometry + black bsdf
    assert any(e["name"] == "Lamp_ent" for e in doc["entities"])
    assert any(b["name"] == "__black" for b in doc["bsdfs"])
    assert any(l["type"] == "area" and l["entity"] == "Lamp_ent"
               for l in doc["lights"])
    assert doc["film"]["size"] == [64, 64]
    assert doc["film"]["spp"] == 16

    # ...and the exported scene actually renders
    from ignis_jax.api import Runtime
    rt = Runtime(str(out), width=32, height=32)
    rt.step(spi=2)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    assert img.mean() > 1e-4
