"""Scene JSON parser.

Parses the reference's flat JSON scene format (src/runtime/loader/Parser.cpp:450-533):
top-level sections `technique/camera/film/shapes/textures/bsdfs/lights/media/
entities/parameters/externals`.  RapidJSON is run with comment+trailing-comma
tolerance in the reference, so we strip //-comments and /* */ blocks first.

The output is a plain dict-of-dicts `Scene` (name-keyed sections), which the
scene compiler (ignis_jax.scene.compile) lowers to flat JAX arrays.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any


def _strip_json_comments(text: str) -> str:
    out = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == '\\' and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
        elif c == '"':
            in_str = True
            out.append(c)
            i += 1
        elif c == '/' and i + 1 < n and text[i + 1] == '/':
            while i < n and text[i] != '\n':
                i += 1
        elif c == '/' and i + 1 < n and text[i + 1] == '*':
            i += 2
            while i + 1 < n and not (text[i] == '*' and text[i + 1] == '/'):
                i += 1
            i += 2
        else:
            out.append(c)
            i += 1
    return ''.join(out)


def _strip_trailing_commas(text: str) -> str:
    # Remove ",\s*}" and ",\s*]" outside of strings. A light regex pass is
    # enough for the scene corpus.
    return re.sub(r',(\s*[}\]])', r'\1', text)


_LIST_SECTIONS = ("shapes", "textures", "bsdfs", "lights", "media", "entities")


class SceneError(RuntimeError):
    pass


class Scene:
    """Parsed scene: named objects per section plus scalar sections."""

    def __init__(self, data: dict, base_dir: Path):
        self.base_dir = Path(base_dir)
        self.data = data
        self.technique: dict = data.get("technique") or {"type": "path"}
        self.camera: dict = data.get("camera") or {"type": "perspective"}
        self.film: dict = data.get("film") or {}
        self.parameters: dict = data.get("parameters") or {}
        # explicit-markers so scalar sections survive NESTED externals
        # (three-planes-base.json has no technique itself but inherits
        # max_depth 4 from two-planes-base.json — checking the raw child
        # dict alone drops it)
        self.has_technique = "technique" in data
        self.has_camera = "camera" in data
        self.has_film = "film" in data
        for section in _LIST_SECTIONS:
            items = data.get(section) or []
            if not isinstance(items, list):
                raise SceneError(f"Section '{section}' must be a list")
            table: dict[str, dict] = {}
            order: list[str] = []
            for idx, obj in enumerate(items):
                if not isinstance(obj, dict):
                    raise SceneError(f"Entry {idx} of '{section}' must be an object")
                name = obj.get("name", f"__{section}_{idx}")
                if name not in table:  # first wins, as in the reference
                    table[name] = obj
                    order.append(name)
            setattr(self, section, table)
            setattr(self, section + "_order", order)

    def resolve_path(self, filename: str) -> Path:
        # scenes authored on Windows use backslash separators (e.g.
        # ship.json "textures\\..."); the reference normalizes via
        # std::filesystem — do the same here
        filename = str(filename).replace("\\", "/")
        p = Path(filename)
        if p.is_absolute():
            return p
        return self.base_dir / p


def load_scene_dict(data: dict, base_dir: str | os.PathLike = ".") -> Scene:
    # Handle external includes ("externals" section): merged first-wins.
    scene = Scene(data, Path(base_dir))
    for ext in data.get("externals") or []:
        fn = ext.get("filename")
        if not fn:
            continue
        child = load_scene_file(scene.resolve_path(fn))
        for section in _LIST_SECTIONS:
            table = getattr(scene, section)
            order = getattr(scene, section + "_order")
            for name, obj in getattr(child, section).items():
                if name not in table:
                    table[name] = obj
                    order.append(name)
        # scalar sections also merge first-wins (Parser.cpp handles
        # externals by pre-populating the scene; the cbox-d* evaluation
        # scenes define camera/film only in cbox-base.json)
        if not scene.has_camera and child.has_camera:
            scene.camera = child.camera
            scene.has_camera = True
        if not scene.has_film and child.has_film:
            scene.film = child.film
            scene.has_film = True
        if not scene.has_technique and child.has_technique:
            scene.technique = child.technique
            scene.has_technique = True
        if "parameters" not in data and child.parameters:
            scene.parameters = child.parameters
    return scene


def load_scene_string(text: str, base_dir: str | os.PathLike = ".") -> Scene:
    cleaned = _strip_trailing_commas(_strip_json_comments(text))
    try:
        data = json.loads(cleaned)
    except json.JSONDecodeError as e:
        raise SceneError(f"Invalid scene JSON: {e}") from e
    if not isinstance(data, dict):
        raise SceneError("Scene root must be a JSON object")
    return load_scene_dict(data, base_dir)


def load_scene_file(path: str | os.PathLike) -> Scene:
    path = Path(path)
    text = path.read_text()
    if path.suffix.lower() in (".gltf", ".glb"):
        from ignis_jax.scene.gltf import load_gltf_scene
        return load_gltf_scene(path)
    return load_scene_string(text, path.parent)
