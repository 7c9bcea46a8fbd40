"""mts2ig — Mitsuba 2/3 scene XML → ignis scene JSON converter.

Counterpart of the reference's C++ tool (src/tools/mts2ig/main.cpp,
1,146 LoC): parses the Mitsuba scene graph (defaults + $substitutions,
sensor/film/sampler, bsdfs incl. twosided/bumpmap wrappers, textures,
shapes with inline area emitters, emitters) and emits the reference's
scene JSON dialect, which ignis_jax (and the reference renderer) load
directly.

Usage: python -m ignis_jax.cli.mts2ig scene.xml [-o scene.json]
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np


def _subst(value: str, defaults: dict) -> str:
    def rep(m):
        return str(defaults.get(m.group(1), m.group(0)))
    return re.sub(r"\$(\w+)", rep, value)


def _floats(s: str):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _props(el, defaults):
    """Collect typed child properties of a Mitsuba element."""
    out = {}
    for ch in el:
        nm = ch.get("name")
        if ch.tag in ("float", "integer"):
            out[nm] = float(_subst(ch.get("value"), defaults))
            if ch.tag == "integer":
                out[nm] = int(out[nm])
        elif ch.tag in ("string",):
            out[nm] = _subst(ch.get("value"), defaults)
        elif ch.tag in ("boolean",):
            out[nm] = _subst(ch.get("value"), defaults).lower() == "true"
        elif ch.tag in ("rgb", "spectrum", "vector", "point"):
            if ch.get("value") is not None:
                v = _floats(_subst(ch.get("value"), defaults))
            else:
                v = [float(ch.get(a, 0)) for a in "xyz"]
            out[nm] = v[0] if len(v) == 1 else v
    return out


def _transform(el, defaults):
    """<transform> children → 4x4 matrix (applied in document order)."""
    m = np.eye(4)
    for ch in el:
        t = np.eye(4)
        if ch.tag == "matrix":
            vals = _floats(_subst(ch.get("value"), defaults))
            t = np.asarray(vals, np.float64).reshape(4, 4)
        elif ch.tag == "lookat":
            o = np.asarray(_floats(_subst(ch.get("origin"), defaults)))
            tg = np.asarray(_floats(_subst(ch.get("target"), defaults)))
            up = np.asarray(_floats(_subst(ch.get("up"), defaults)))
            fwd = tg - o
            fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
            left = np.cross(up / max(np.linalg.norm(up), 1e-12), fwd)
            left = left / max(np.linalg.norm(left), 1e-12)
            nup = np.cross(fwd, left)
            t[:3, 0] = left
            t[:3, 1] = nup
            t[:3, 2] = fwd
            t[:3, 3] = o
        elif ch.tag == "translate":
            for i, a in enumerate("xyz"):
                t[i, 3] = float(_subst(ch.get(a, "0"), defaults))
        elif ch.tag == "scale":
            if ch.get("value") is not None:
                v = _floats(_subst(ch.get("value"), defaults))
                if len(v) == 1:
                    v = v * 3
            else:
                v = [float(_subst(ch.get(a, "1"), defaults)) for a in "xyz"]
            t[0, 0], t[1, 1], t[2, 2] = v
        elif ch.tag == "rotate":
            ang = math.radians(float(_subst(ch.get("angle", "0"), defaults)))
            ax = np.asarray([float(_subst(ch.get(a, "0"), defaults))
                             for a in "xyz"])
            ax = ax / max(np.linalg.norm(ax), 1e-12)
            c, s = math.cos(ang), math.sin(ang)
            x, y, z = ax
            t[:3, :3] = [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)]]
        m = m @ t
    return m


# Mitsuba bsdf plugin → ignis bsdf JSON (LoaderBSDF name space)
def _convert_bsdf(el, defaults, name, textures, counters):
    btype = el.get("type")
    p = _props(el, defaults)
    tex_refs = {}
    for ch in el.findall("texture"):
        tname = f"_mtstex_{counters['tex']}"
        counters["tex"] += 1
        textures.append(_convert_texture(ch, defaults, tname))
        tex_refs[ch.get("name")] = tname

    def col(key, default):
        if key in tex_refs:
            return tex_refs[key]
        v = p.get(key, default)
        return v

    if btype == "twosided":
        inner = el.find("bsdf")
        spec = _convert_bsdf(inner, defaults, name, textures, counters)
        # the reference loader treats most bsdfs as twosided already
        return spec
    if btype == "bumpmap":
        inner = el.find("bsdf")
        spec = _convert_bsdf(inner, defaults, name + "_inner", textures,
                             counters)
        out = {"type": "bumpmap", "name": name, "bsdf": spec["name"],
               "strength": p.get("scale", 1.0)}
        if tex_refs:
            out["map"] = next(iter(tex_refs.values()))
        return [spec, out]
    if btype == "mask":
        inner = el.find("bsdf")
        spec = _convert_bsdf(inner, defaults, name + "_inner", textures,
                             counters)
        return [spec, {"type": "mask", "name": name, "bsdf": spec["name"],
                       "weight": col("opacity", 0.5)}]
    if btype == "blendbsdf":
        subs = el.findall("bsdf")
        a = _convert_bsdf(subs[0], defaults, name + "_a", textures, counters)
        b = _convert_bsdf(subs[1], defaults, name + "_b", textures, counters)
        return [a, b, {"type": "blend", "name": name, "first": a["name"],
                       "second": b["name"], "weight": col("weight", 0.5)}]

    if btype in ("diffuse", "smoothdiffuse"):
        return {"type": "diffuse", "name": name,
                "reflectance": col("reflectance", 0.5)}
    if btype == "roughdiffuse":
        return {"type": "roughdiffuse", "name": name,
                "reflectance": col("reflectance", 0.5),
                "alpha": p.get("alpha", 0.2)}
    if btype in ("conductor", "roughconductor"):
        out = {"type": ("conductor" if btype == "conductor"
                        else "roughconductor"), "name": name}
        if "material" in p:
            out["material"] = p["material"]
        for k in ("eta", "k"):
            if k in p:
                out[k] = p[k]
        if "specular_reflectance" in p:
            out["specular_reflectance"] = col("specular_reflectance", 1.0)
        if btype == "roughconductor":
            out["alpha"] = p.get("alpha", 0.1)
        return out
    if btype in ("dielectric", "thindielectric", "roughdielectric"):
        out = {"type": {"dielectric": "dielectric",
                        "thindielectric": "thindielectric",
                        "roughdielectric": "roughdielectric"}[btype],
               "name": name}
        if "int_ior" in p:
            out["int_ior" if isinstance(p["int_ior"], float)
                else "int_ior_material"] = p["int_ior"]
        if "ext_ior" in p:
            out["ext_ior" if isinstance(p["ext_ior"], float)
                else "ext_ior_material"] = p["ext_ior"]
        if btype == "roughdielectric":
            out["alpha"] = p.get("alpha", 0.1)
        return out
    if btype in ("plastic", "roughplastic"):
        out = {"type": btype, "name": name,
               "diffuse_reflectance": col("diffuse_reflectance", 0.5)}
        if "int_ior" in p and isinstance(p["int_ior"], float):
            out["int_ior"] = p["int_ior"]
        if btype == "roughplastic":
            out["alpha"] = p.get("alpha", 0.1)
        return out
    if btype == "principled":
        out = {"type": "principled", "name": name,
               "base_color": col("base_color", 0.8)}
        for k in ("metallic", "roughness", "anisotropic", "sheen",
                  "clearcoat", "spec_trans", "specular"):
            if k in p:
                out[{"spec_trans": "specular_transmission"}.get(k, k)] = p[k]
        return out
    if btype == "null":
        return {"type": "passthrough", "name": name}
    print(f"[mts2ig] warning: bsdf type '{btype}' unmapped; "
          f"substituting diffuse", file=sys.stderr)
    return {"type": "diffuse", "name": name, "reflectance": [1.0, 0.0, 1.0]}


def _convert_texture(el, defaults, name):
    ttype = el.get("type")
    p = _props(el, defaults)
    if ttype == "bitmap":
        out = {"type": "image", "name": name,
               "filename": p.get("filename", "")}
        if "to_uv" in p:
            pass
        return out
    if ttype == "checkerboard":
        return {"type": "checkerboard", "name": name,
                "color0": p.get("color0", 0.4),
                "color1": p.get("color1", 0.2)}
    print(f"[mts2ig] warning: texture '{ttype}' unmapped; constant",
          file=sys.stderr)
    return {"type": "checkerboard", "name": name}


def convert(xml_path: Path) -> dict:
    tree = ET.parse(xml_path)
    root = tree.getroot()
    defaults: dict = {}
    for d in root.findall("default"):
        defaults[d.get("name")] = d.get("value")

    scene = {"technique": {"type": "path", "max_depth": 64},
             "camera": {"type": "perspective", "fov": 60.0},
             "film": {"size": [256, 256]},
             "textures": [], "bsdfs": [], "shapes": [], "entities": [],
             "lights": []}
    counters = {"tex": 0, "shape": 0, "light": 0}

    integ = root.find("integrator")
    if integ is not None:
        p = _props(integ, defaults)
        itype = integ.get("type", "path")
        scene["technique"] = {
            "type": {"path": "path", "volpath": "volpath",
                     "ptracer": "lighttracer"}.get(itype, "path"),
            "max_depth": int(p.get("max_depth", 64))}

    sensor = root.find("sensor")
    if sensor is not None:
        p = _props(sensor, defaults)
        cam = {"type": "perspective", "fov": float(p.get("fov", 60.0))}
        if "near_clip" in p:
            cam["near_clip"] = p["near_clip"]
        if "far_clip" in p:
            cam["far_clip"] = p["far_clip"]
        tr = sensor.find("transform")
        if tr is not None:
            cam["transform"] = [float(v) for v in
                                _transform(tr, defaults).reshape(-1)[:16]]
        scene["camera"] = cam
        film = sensor.find("film")
        if film is not None:
            fp = _props(film, defaults)
            scene["film"]["size"] = [int(fp.get("width", 256)),
                                     int(fp.get("height", 256))]

    # top-level bsdfs (by id)
    for b in root.findall("bsdf"):
        name = b.get("id") or f"_mtsbsdf_{len(scene['bsdfs'])}"
        spec = _convert_bsdf(b, defaults, name, scene["textures"], counters)
        scene["bsdfs"].extend(spec if isinstance(spec, list) else [spec])

    # shapes
    for sh in root.findall("shape"):
        stype = sh.get("type")
        p = _props(sh, defaults)
        sname = sh.get("id") or f"shape{counters['shape']}"
        counters["shape"] += 1
        tr = sh.find("transform")
        m = _transform(tr, defaults) if tr is not None else np.eye(4)
        if stype in ("obj", "ply", "serialized"):
            shape = {"type": stype, "name": sname,
                     "filename": p.get("filename", "")}
            if stype == "serialized" and "shape_index" in p:
                shape["shape_index"] = int(p["shape_index"])
            if p.get("face_normals"):
                shape["face_normals"] = True
        elif stype == "rectangle":
            shape = {"type": "rectangle", "name": sname,
                     "width": 2, "height": 2}
        elif stype == "cube":
            shape = {"type": "cube", "name": sname, "width": 2,
                     "height": 2, "depth": 2}
        elif stype == "sphere":
            shape = {"type": "sphere", "name": sname,
                     "radius": float(p.get("radius", 1.0))}
            if "center" in p:
                shape["center"] = p["center"]
        else:
            print(f"[mts2ig] warning: shape '{stype}' skipped",
                  file=sys.stderr)
            continue
        scene["shapes"].append(shape)

        # material binding: <ref id> or inline bsdf
        bname = None
        ref = sh.find("ref")
        if ref is not None:
            bname = ref.get("id")
        inline = sh.find("bsdf")
        if inline is not None:
            bname = inline.get("id") or f"{sname}_mat"
            spec = _convert_bsdf(inline, defaults, bname,
                                 scene["textures"], counters)
            scene["bsdfs"].extend(spec if isinstance(spec, list)
                                  else [spec])
            if isinstance(spec, list):
                bname = spec[-1]["name"]
        if bname is None:
            scene["bsdfs"].append({"type": "diffuse",
                                   "name": f"{sname}_default",
                                   "reflectance": 0.5})
            bname = f"{sname}_default"

        ent = {"name": sname, "shape": sname, "bsdf": bname}
        if tr is not None:
            ent["transform"] = [float(v) for v in m.reshape(-1)[:16]]
        scene["entities"].append(ent)

        em = sh.find("emitter")
        if em is not None and em.get("type") == "area":
            ep = _props(em, defaults)
            rad = ep.get("radiance", 1.0)
            scene["lights"].append({"type": "area",
                                    "name": f"{sname}_light",
                                    "entity": sname, "radiance": rad})

    # standalone emitters
    for em in root.findall("emitter"):
        etype = em.get("type")
        p = _props(em, defaults)
        lname = em.get("id") or f"light{counters['light']}"
        counters["light"] += 1
        tr = em.find("transform")
        m = _transform(tr, defaults) if tr is not None else np.eye(4)
        if etype == "constant":
            scene["lights"].append({"type": "env", "name": lname,
                                    "radiance": p.get("radiance", 1.0)})
        elif etype == "envmap":
            l = {"type": "env", "name": lname,
                 "radiance": f"_mtstex_env_{lname}", "cdf": True}
            scene["textures"].append({"type": "image",
                                      "name": f"_mtstex_env_{lname}",
                                      "filename": p.get("filename", "")})
            if tr is not None:
                l["transform"] = [float(v) for v in m[:3, :3].reshape(-1)]
            scene["lights"].append(l)
        elif etype == "point":
            pos = list(np.asarray(m[:3, 3], np.float64))
            l = {"type": "point", "name": lname, "position": pos}
            if "intensity" in p:
                l["intensity"] = p["intensity"]
            if "power" in p:
                l["power"] = p["power"]
            scene["lights"].append(l)
        elif etype in ("directional", "distant"):
            d = list(m[:3, :3] @ np.asarray([0, 0, 1.0]))
            scene["lights"].append({"type": "directional", "name": lname,
                                    "direction": d,
                                    "irradiance": p.get("irradiance", 1.0)})
        elif etype == "spot":
            pos = list(np.asarray(m[:3, 3], np.float64))
            d = list(m[:3, :3] @ np.asarray([0, 0, 1.0]))
            scene["lights"].append({
                "type": "spot", "name": lname, "position": pos,
                "direction": d, "intensity": p.get("intensity", 1.0),
                "cutoff": p.get("cutoff_angle", 20.0),
                "falloff": p.get("beam_width", p.get("cutoff_angle", 20.0))})
        elif etype in ("sunsky", "sky"):
            scene["lights"].append({"type": "sky", "name": lname})
        else:
            print(f"[mts2ig] warning: emitter '{etype}' skipped",
                  file=sys.stderr)

    return scene


def _absolutize_assets(scene, base: Path):
    """Resolve relative asset paths against the XML's directory so the
    emitted JSON renders from anywhere (the JSON may be written far from
    the meshes the XML referenced)."""
    for coll in (scene.get("shapes", []), scene.get("textures", [])):
        for obj in coll:
            fn = obj.get("filename")
            if fn and not Path(fn).is_absolute():
                cand = (base / fn).resolve()
                if cand.exists():
                    obj["filename"] = str(cand)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mts2ig")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    xml_path = Path(args.input)
    scene = convert(xml_path)
    _absolutize_assets(scene, xml_path.parent)
    out = Path(args.output) if args.output else xml_path.with_suffix(".json")
    out.write_text(json.dumps(scene, indent=1))
    print(f"wrote {out} ({len(scene['shapes'])} shapes, "
          f"{len(scene['bsdfs'])} bsdfs, {len(scene['lights'])} lights)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
