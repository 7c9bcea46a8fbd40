"""Blender → ignis_jax scene exporter add-on.

Functional port of the reference's scripts/blender_exporter/ignis_blender
(18 modules, ~3k LoC) scoped to the scene features ignis_jax consumes:
meshes (exported as PLY), Principled-BSDF materials, point/spot/area/sun
lights, the world background (constant or environment image), camera and
film settings.  Install as a Blender add-on and use
File > Export > ignis_jax scene (.json), or call `export_scene(ctx, path)`
from scripts.

NOTE: developed without a Blender installation in this environment —
the bpy surface used here is the stable 2.8+ API also used by the
reference exporter.
"""

bl_info = {
    "name": "ignis_jax scene exporter",
    "author": "ignis_jax",
    "version": (0, 1, 0),
    "blender": (2, 80, 0),
    "location": "File > Import-Export",
    "description": "Export scene to the ignis_jax (Ignis) JSON format",
    "category": "Import-Export",
}

import json
import math
import os


def _color3(c):
    return [float(c[0]), float(c[1]), float(c[2])]


def _matrix(m):
    """Blender 4x4 (row-major Matrix) -> reference row-major 16 floats."""
    return [float(m[r][c]) for r in range(4) for c in range(4)]


def _camera_matrix(m):
    """Blender cameras look down -Z; the reference convention is
    +Z-forward/+Y-up, so rotate 180 deg about local Y (utils.py
    orient_y_up_z_forward: rot @ Quaternion((0,0,1,0))) — i.e. negate
    the first and third columns of the rotation part."""
    out = [[float(m[r][c]) for c in range(4)] for r in range(4)]
    for r in range(3):
        out[r][0] = -out[r][0]
        out[r][2] = -out[r][2]
    return [v for row in out for v in row]


def _image_tex_of(node_input, name, out_dir, textures):
    """If the socket is driven by an Image Texture node, export the image
    and register it as a scene texture; returns the texture name or None
    (reference node.py export_node image path)."""
    for link in getattr(node_input, "links", []) or []:
        src = link.from_node
        if getattr(src, "bl_idname", "") == "ShaderNodeTexImage" and \
                getattr(src, "image", None) is not None:
            img = src.image
            base = os.path.basename(img.filepath or (img.name + ".png"))
            img_path = os.path.join(out_dir, "textures", base)
            os.makedirs(os.path.dirname(img_path), exist_ok=True)
            try:
                img.save_render(img_path)
            except Exception:
                pass
            tname = f"_tex_{name}"
            textures.append({
                "type": "image", "name": tname,
                "filename": os.path.relpath(img_path, out_dir),
                "linear": getattr(getattr(img, "colorspace_settings", None),
                                  "name", "sRGB") != "sRGB"})
            return tname
    return None


def _export_material(mat, out_dir, textures):
    """Principled BSDF node -> ignis principled entry (reference
    bsdf.py/export_material semantics; image-texture-driven sockets
    export their image and bind by texture name)."""
    out = {"type": "principled", "name": mat.name}
    node = None
    if mat.use_nodes:
        for n in mat.node_tree.nodes:
            if n.bl_idname == "ShaderNodeBsdfPrincipled":
                node = n
                break
    if node is None:
        out.update(type="diffuse",
                   reflectance=_color3(mat.diffuse_color))
        return out

    def inp(name, default=None):
        s = node.inputs.get(name)
        if s is None:
            return default
        tex = _image_tex_of(s, f"{mat.name}_{name}".replace(" ", "_"),
                            out_dir, textures)
        if tex is not None:
            return tex
        v = s.default_value
        try:
            return _color3(v)
        except TypeError:
            return float(v)

    out["base_color"] = inp("Base Color", [0.8, 0.8, 0.8])
    out["metallic"] = inp("Metallic", 0.0)
    out["roughness"] = inp("Roughness", 0.5)
    out["ior"] = inp("IOR", 1.45)
    tr = inp("Transmission", None)
    if tr is None:
        tr = inp("Transmission Weight", 0.0)  # Blender 4.x
    out["specular_transmission"] = tr or 0.0
    sheen = inp("Sheen", None)
    if sheen is None:
        sheen = inp("Sheen Weight", 0.0)
    out["sheen"] = sheen or 0.0
    cc = inp("Clearcoat", None)
    if cc is None:
        cc = inp("Coat Weight", 0.0)
    out["clearcoat"] = cc or 0.0
    out["anisotropic"] = inp("Anisotropic", 0.0) or 0.0
    return out


def _export_light(obj):
    li = obj.data
    pos = list(obj.matrix_world.translation)
    if li.type == "POINT":
        return {"type": "point", "name": obj.name,
                "position": [float(v) for v in pos],
                "power": [li.energy * c for c in _color3(li.color)]}
    if li.type == "SPOT":
        d = obj.matrix_world.to_3x3() @ type(obj.matrix_world.translation)(
            (0.0, 0.0, -1.0))
        return {"type": "spot", "name": obj.name,
                "position": [float(v) for v in pos],
                "direction": [float(v) for v in d],
                "cutoff": math.degrees(li.spot_size) / 2.0,
                "falloff": math.degrees(li.spot_size) / 2.0
                * (1.0 - li.spot_blend),
                "power": [li.energy * c for c in _color3(li.color)]}
    if li.type == "SUN":
        d = obj.matrix_world.to_3x3() @ type(obj.matrix_world.translation)(
            (0.0, 0.0, -1.0))
        return {"type": "directional", "name": obj.name,
                "direction": [float(v) for v in d],
                "irradiance": [li.energy * c for c in _color3(li.color)]}
    if li.type == "AREA":
        # Blender area lights are implicit geometry: emit a rectangle
        # entity of the light's size under its world transform with a
        # black bsdf, and bind the area light to it (reference light.py
        # export_area_light — power is Watts, the loader's
        # AreaLight.cpp:101 power->radiance conversion applies)
        sx = float(getattr(li, "size", 1.0))
        sy = float(getattr(li, "size_y", sx) or sx)
        if getattr(li, "shape", "SQUARE") in ("SQUARE", "DISK"):
            sy = sx
        # flip_normals: Blender area lights emit along local -Z
        # (reference light.py:98-103)
        shape = {"type": "rectangle", "name": f"{obj.name}_shape",
                 "width": sx, "height": sy, "flip_normals": True}
        entity = {"name": f"{obj.name}_ent", "shape": f"{obj.name}_shape",
                  "bsdf": "__black", "camera_visible": False,
                  "transform": _matrix(obj.matrix_world)}
        light = {"type": "area", "name": obj.name,
                 "entity": f"{obj.name}_ent",
                 "power": [li.energy * c for c in _color3(li.color)]}
        return ("area", shape, entity, light)
    return None


def _export_world(world, out_dir):
    if world is None or not world.use_nodes:
        return None
    bg = None
    env = None
    for n in world.node_tree.nodes:
        if n.bl_idname == "ShaderNodeBackground":
            bg = n
        elif n.bl_idname == "ShaderNodeTexEnvironment":
            env = n
    if env is not None and env.image is not None:
        img_path = os.path.join(out_dir, "textures",
                                os.path.basename(env.image.filepath or
                                                 env.image.name + ".exr"))
        os.makedirs(os.path.dirname(img_path), exist_ok=True)
        try:
            env.image.save_render(img_path)
        except Exception:
            pass
        return ({"type": "image", "name": "__world_tex",
                 "filename": os.path.relpath(img_path, out_dir)},
                {"type": "env", "name": "__world", "radiance": "__world_tex",
                 "scale": float(bg.inputs["Strength"].default_value)
                 if bg else 1.0})
    if bg is not None:
        col = _color3(bg.inputs["Color"].default_value)
        s = float(bg.inputs["Strength"].default_value)
        if max(col) * s > 0:
            return (None, {"type": "constant", "name": "__world",
                           "radiance": [c * s for c in col]})
    return None


def export_scene(context, filepath):
    out_dir = os.path.dirname(os.path.abspath(filepath))
    mesh_dir = os.path.join(out_dir, "meshes")
    os.makedirs(mesh_dir, exist_ok=True)

    scene = context.scene
    cam = scene.camera
    doc = {
        "technique": {"type": "path", "max_depth": 8},
        "film": {"size": [scene.render.resolution_x,
                          scene.render.resolution_y]},
        "textures": [], "bsdfs": [], "shapes": [], "entities": [],
        "lights": [],
    }
    if cam is not None:
        cd = cam.data
        if getattr(cd, "type", "PERSP") == "ORTHO":
            doc["camera"] = {
                "type": "orthogonal",
                "scale": float(getattr(cd, "ortho_scale", 1.0)),
                "near_clip": cd.clip_start, "far_clip": cd.clip_end,
                "transform": _camera_matrix(cam.matrix_world),
            }
        else:
            doc["camera"] = {
                "type": "perspective",
                "fov": math.degrees(cd.angle),
                "near_clip": cd.clip_start,
                "far_clip": cd.clip_end,
                "transform": _camera_matrix(cam.matrix_world),
            }
            dof = getattr(cd, "dof", None)
            if dof is not None and getattr(dof, "use_dof", False):
                doc["camera"]["focal_length"] = float(
                    getattr(dof, "focus_distance", 1.0))
                doc["camera"]["aperture_radius"] = float(
                    cd.lens / 2000.0 / max(getattr(dof, "aperture_fstop",
                                                   2.8), 1e-3))
    # film/sampler settings (reference render.py)
    spp = getattr(getattr(scene, "cycles", None), "samples", None)
    if spp:
        doc["film"]["spp"] = int(spp)

    mats = set()
    need_black = False
    for obj in scene.objects:
        if obj.hide_render:
            continue
        if obj.type == "LIGHT":
            li = _export_light(obj)
            if isinstance(li, tuple) and li[0] == "area":
                _, shape, entity, light = li
                doc["shapes"].append(shape)
                doc["entities"].append(entity)
                doc["lights"].append(light)
                need_black = True
            elif li is not None:
                doc["lights"].append(li)
            continue
        if obj.type != "MESH":
            continue
        ply = os.path.join(mesh_dir, f"{obj.name}.ply")
        dg = context.evaluated_depsgraph_get()
        ev = obj.evaluated_get(dg)
        me = ev.to_mesh()
        _write_ply(me, ply)
        ev.to_mesh_clear()
        doc["shapes"].append({"type": "ply", "name": obj.name,
                              "filename": os.path.relpath(ply, out_dir)})
        mat = obj.active_material
        mname = mat.name if mat else "__default"
        if mat and mat.name not in mats:
            doc["bsdfs"].append(_export_material(mat, out_dir,
                                                 doc["textures"]))
            mats.add(mat.name)
        elif not mat and "__default" not in mats:
            doc["bsdfs"].append({"type": "diffuse", "name": "__default",
                                 "reflectance": 0.8})
            mats.add("__default")
        doc["entities"].append({
            "name": obj.name, "shape": obj.name, "bsdf": mname,
            "transform": _matrix(obj.matrix_world)})

    if need_black:
        doc["bsdfs"].append({"type": "diffuse", "name": "__black",
                             "reflectance": 0.0})

    w = _export_world(scene.world, out_dir)
    if w is not None:
        tex, light = w
        if tex is not None:
            doc["textures"].append(tex)
        doc["lights"].append(light)

    with open(filepath, "w") as f:
        json.dump(doc, f, indent=1)
    return {"FINISHED"}


def _write_ply(me, path):
    """Ascii PLY writer: positions + (when present) vertex normals and
    the active UV layer, triangulated.  UVs are REQUIRED for textured
    round-trips (reference ply.py save_mesh writes nx..ny/s,t too)."""
    me.calc_loop_triangles()
    verts = me.vertices
    tris = me.loop_triangles
    uvl = None
    layers = getattr(me, "uv_layers", None)
    if layers is not None and getattr(layers, "active", None) is not None:
        uvl = layers.active.data
    # per-vertex uv from the first loop that references the vertex
    uvs = None
    if uvl is not None:
        uvs = [(0.0, 0.0)] * len(verts)
        for t in tris:
            for li, vi in zip(t.loops, t.vertices):
                u, v = uvl[li].uv
                uvs[vi] = (float(u), float(v))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if uvs is not None:
            f.write("property float s\nproperty float t\n")
        f.write(f"element face {len(tris)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            n = getattr(v, "normal", (0.0, 0.0, 1.0))
            row = (f"{v.co[0]} {v.co[1]} {v.co[2]} "
                   f"{n[0]} {n[1]} {n[2]}")
            if uvs is not None:
                row += f" {uvs[i][0]} {uvs[i][1]}"
            f.write(row + "\n")
        for t in tris:
            a, b, c = t.vertices
            f.write(f"3 {a} {b} {c}\n")


# ---- Blender operator / menu glue
try:
    import bpy
    from bpy_extras.io_utils import ExportHelper

    class ExportIgnisTpu(bpy.types.Operator, ExportHelper):
        bl_idname = "export_scene.ignis_jax"
        bl_label = "Export ignis_jax scene"
        filename_ext = ".json"

        def execute(self, context):
            return export_scene(context, self.filepath)

    def menu_func(self, context):
        self.layout.operator(ExportIgnisTpu.bl_idname,
                             text="ignis_jax scene (.json)")

    def register():
        bpy.utils.register_class(ExportIgnisTpu)
        bpy.types.TOPBAR_MT_file_export.append(menu_func)

    def unregister():
        bpy.utils.unregister_class(ExportIgnisTpu)
        bpy.types.TOPBAR_MT_file_export.remove(menu_func)
except ImportError:  # imported outside Blender (tests, linting)
    def register():
        pass

    def unregister():
        pass
