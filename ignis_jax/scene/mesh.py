"""Triangle-mesh container and OBJ/PLY loaders (numpy, vectorized).

Counterpart of src/runtime/mesh/ (TriMesh.cpp, ObjFile.cpp, PlyFile.cpp):
same geometry semantics (normal generation, flip_normals swaps winding and
negates normals, face_normals flattens shading normals), but the storage is
plain numpy arrays ready to be lowered to device tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray   # (V, 3) f32
    indices: np.ndarray    # (F, 3) i32
    normals: np.ndarray | None = None    # (V, 3) f32 per-vertex shading normals
    texcoords: np.ndarray | None = None  # (V, 2) f32

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, dtype=np.int32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, dtype=np.float32).reshape(-1, 3)
        if self.texcoords is not None:
            self.texcoords = np.asarray(self.texcoords, dtype=np.float32).reshape(-1, 2)

    @property
    def face_count(self) -> int:
        return self.indices.shape[0]

    def face_normals_raw(self) -> np.ndarray:
        """Unnormalized geometric normals cross(v1-v0, v2-v0) per face."""
        v0 = self.vertices[self.indices[:, 0]]
        v1 = self.vertices[self.indices[:, 1]]
        v2 = self.vertices[self.indices[:, 2]]
        return np.cross(v1 - v0, v2 - v0)

    def compute_vertex_normals(self) -> None:
        """Area-weighted vertex normals (TriMesh::computeVertexNormals)."""
        fn = self.face_normals_raw()
        n = np.zeros_like(self.vertices)
        for k in range(3):
            np.add.at(n, self.indices[:, k], fn)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        bad = ln[:, 0] < 1e-20
        n = np.where(bad[:, None], np.float32([0, 0, 1]), n / np.maximum(ln, 1e-20))
        self.normals = n.astype(np.float32)

    def ensure_normals(self) -> None:
        if self.normals is None or self.normals.shape[0] != self.vertices.shape[0]:
            self.compute_vertex_normals()
        else:
            ln = np.linalg.norm(self.normals, axis=-1, keepdims=True)
            self.normals = np.where(ln < 1e-20, np.float32([0, 0, 1]),
                                    self.normals / np.maximum(ln, 1e-20)).astype(np.float32)

    def ensure_texcoords(self) -> None:
        if self.texcoords is None or self.texcoords.shape[0] != self.vertices.shape[0]:
            self.texcoords = np.zeros((self.vertices.shape[0], 2), dtype=np.float32)

    def flip_normals(self) -> None:
        """Swap winding + negate shading normals (TriMesh.cpp:34-43)."""
        self.indices = self.indices[:, [0, 2, 1]].copy()
        if self.normals is not None:
            self.normals = -self.normals

    def apply_face_normals(self) -> None:
        """Flat shading: un-weld vertices so each face uses its geometric normal."""
        fn = self.face_normals_raw()
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = np.where(ln < 1e-20, np.float32([0, 0, 1]), fn / np.maximum(ln, 1e-20))
        self.ensure_texcoords()
        f = self.face_count
        new_idx = np.arange(3 * f, dtype=np.int32).reshape(f, 3)
        self.vertices = self.vertices[self.indices.reshape(-1)]
        self.texcoords = self.texcoords[self.indices.reshape(-1)]
        self.normals = np.repeat(fn, 3, axis=0).astype(np.float32)
        self.indices = new_idx

    def transformed(self, m4: np.ndarray) -> "TriMesh":
        self.ensure_normals()
        self.ensure_texcoords()
        lin = m4[:3, :3]
        nm = np.linalg.inv(lin).T
        v = self.vertices @ lin.T + m4[:3, 3]
        n = self.normals @ nm.T
        return TriMesh(v.astype(np.float32), self.indices.copy(),
                       n.astype(np.float32), self.texcoords.copy())

    def remove_zero_area_triangles(self) -> int:
        fn = self.face_normals_raw()
        good = np.einsum('ij,ij->i', fn, fn) > 1.1920929e-07
        removed = int((~good).sum())
        if removed:
            self.indices = self.indices[good]
        return removed

    @staticmethod
    def concat(meshes: list["TriMesh"]) -> "TriMesh":
        for m in meshes:
            m.ensure_normals()
            m.ensure_texcoords()
        off = 0
        idx = []
        for m in meshes:
            idx.append(m.indices + off)
            off += m.vertices.shape[0]
        return TriMesh(
            np.concatenate([m.vertices for m in meshes]),
            np.concatenate(idx),
            np.concatenate([m.normals for m in meshes]),
            np.concatenate([m.texcoords for m in meshes]))


# ---------------------------------------------------------------- OBJ loader

def load_obj(path: str | Path) -> TriMesh:
    """Minimal OBJ reader: v/vn/vt/f with triangulation fan, negative indices."""
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    texcoords: list[list[float]] = []
    # corner = (v, vt, vn) indices; we un-weld into per-corner vertices then weld.
    corner_map: dict[tuple[int, int, int], int] = {}
    out_v: list[int] = []
    out_n: list[int] = []
    out_t: list[int] = []
    faces: list[list[int]] = []

    def corner(spec: str) -> int:
        parts = spec.split('/')
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ti - 1 if ti > 0 else (len(texcoords) + ti if ti < 0 else -1)
        ni = ni - 1 if ni > 0 else (len(normals) + ni if ni < 0 else -1)
        key = (vi, ti, ni)
        idx = corner_map.get(key)
        if idx is None:
            idx = len(out_v)
            corner_map[key] = idx
            out_v.append(vi)
            out_t.append(ti)
            out_n.append(ni)
        return idx

    with open(path, 'r', errors='replace') as f:
        for line in f:
            if not line or line[0] in '#\n':
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == 'v':
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == 'vn':
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == 'vt':
                texcoords.append([float(parts[1]), float(parts[2])])
            elif tag == 'f':
                cs = [corner(p) for p in parts[1:]]
                for k in range(1, len(cs) - 1):
                    faces.append([cs[0], cs[k], cs[k + 1]])

    pos = np.asarray(positions, dtype=np.float32)
    v = pos[np.asarray(out_v, dtype=np.int64)]
    n = None
    if normals and all(i >= 0 for i in out_n):
        nn = np.asarray(normals, dtype=np.float32)
        n = nn[np.asarray(out_n, dtype=np.int64)]
    t = None
    if texcoords and all(i >= 0 for i in out_t):
        tt = np.asarray(texcoords, dtype=np.float32)
        t = tt[np.asarray(out_t, dtype=np.int64)]
    mesh = TriMesh(v, np.asarray(faces, dtype=np.int32), n, t)
    mesh.ensure_normals()
    mesh.ensure_texcoords()
    return mesh


# ---------------------------------------------------------------- PLY loader

_PLY_TYPES = {
    'char': 'i1', 'int8': 'i1', 'uchar': 'u1', 'uint8': 'u1',
    'short': 'i2', 'int16': 'i2', 'ushort': 'u2', 'uint16': 'u2',
    'int': 'i4', 'int32': 'i4', 'uint': 'u4', 'uint32': 'u4',
    'float': 'f4', 'float32': 'f4', 'double': 'f8', 'float64': 'f8',
}


def load_ply(path: str | Path) -> TriMesh:
    """PLY reader: ascii / binary_little_endian / binary_big_endian."""
    with open(path, 'rb') as f:
        data = f.read()

    # Parse header
    end = data.find(b'end_header')
    if end < 0 or not data.startswith(b'ply'):
        raise ValueError(f"Not a PLY file: {path}")
    header = data[:end].decode('ascii', errors='replace')
    body = data[end:]
    body = body[body.find(b'\n') + 1:]

    fmt = 'ascii'
    elements: list[tuple[str, int, list]] = []  # (name, count, [(kind, dtype..., pname)])
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == 'format':
            fmt = parts[1]
        elif parts[0] == 'element':
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == 'property':
            if parts[1] == 'list':
                elements[-1][2].append(('list', _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]], parts[4]))
            else:
                elements[-1][2].append(('scalar', _PLY_TYPES[parts[1]], parts[2]))

    endian = '<' if fmt != 'binary_big_endian' else '>'

    vertices = normals = texcoords = None
    faces: np.ndarray | None = None

    if fmt == 'ascii':
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            if name == 'vertex':
                width = len(props)
                arr = np.asarray(tokens[pos:pos + count * width], dtype=np.float64).reshape(count, width)
                pos += count * width
                cols = {p[2]: i for i, p in enumerate(props)}
                vertices, normals, texcoords = _extract_vertex_attrs(arr, cols)
            elif name == 'face':
                rows = []
                for _ in range(count):
                    n = int(tokens[pos]); pos += 1
                    poly = [int(t) for t in tokens[pos:pos + n]]
                    pos += n
                    for k in range(1, n - 1):
                        rows.append([poly[0], poly[k], poly[k + 1]])
                faces = np.asarray(rows, dtype=np.int32)
            else:
                # skip unknown ascii element (assumes scalar props)
                pos += count * len(props)
    else:
        offset = 0
        for name, count, props in elements:
            if name == 'vertex':
                if any(p[0] == 'list' for p in props):
                    raise ValueError("List property in vertex element not supported")
                dt = np.dtype([(p[2], endian + p[1]) for p in props])
                arr_s = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                cols = {p[2]: i for i, p in enumerate(props)}
                arr = np.stack([arr_s[p[2]].astype(np.float64) for p in props], axis=1)
                vertices, normals, texcoords = _extract_vertex_attrs(arr, cols)
            elif name == 'face':
                faces, offset = _read_binary_faces(body, offset, count, props, endian)
            else:
                fixed = sum(np.dtype(endian + p[1]).itemsize for p in props if p[0] == 'scalar')
                if any(p[0] == 'list' for p in props):
                    raise ValueError(f"Cannot skip list element '{name}'")
                offset += fixed * count

    if vertices is None or faces is None:
        raise ValueError(f"PLY file missing vertex or face data: {path}")
    mesh = TriMesh(vertices, faces, normals, texcoords)
    mesh.ensure_normals()
    mesh.ensure_texcoords()
    return mesh


def _extract_vertex_attrs(arr: np.ndarray, cols: dict):
    def get(names):
        if all(n in cols for n in names):
            return arr[:, [cols[n] for n in names]].astype(np.float32)
        return None
    vertices = get(('x', 'y', 'z'))
    normals = get(('nx', 'ny', 'nz'))
    texcoords = get(('u', 'v'))
    if texcoords is None:
        texcoords = get(('s', 't'))
    return vertices, normals, texcoords


def _read_binary_faces(body: bytes, offset: int, count: int, props, endian: str):
    lp = next(p for p in props if p[0] == 'list')
    if len(props) != 1:
        raise ValueError("Face element with extra properties not supported")
    cdt = np.dtype(endian + lp[1])
    idt = np.dtype(endian + lp[2])
    # Fast path: uniform triangle faces
    first = int(np.frombuffer(body, dtype=cdt, count=1, offset=offset)[0])
    stride = cdt.itemsize + first * idt.itemsize
    if offset + stride * count <= len(body):
        block = np.frombuffer(body, dtype=np.uint8, count=stride * count, offset=offset).reshape(count, stride)
        counts = block[:, :cdt.itemsize].copy().view(cdt)[:, 0]
        if np.all(counts == first):
            idx = block[:, cdt.itemsize:].copy().view(idt).astype(np.int64).reshape(count, first)
            if first == 3:
                return idx.astype(np.int32), offset + stride * count
            tris = []
            for k in range(1, first - 1):
                tris.append(idx[:, [0, k, k + 1]])
            return np.concatenate(tris).astype(np.int32), offset + stride * count
    # Slow path: ragged polygons
    rows = []
    pos = offset
    for _ in range(count):
        n = int(np.frombuffer(body, dtype=cdt, count=1, offset=pos)[0])
        pos += cdt.itemsize
        poly = np.frombuffer(body, dtype=idt, count=n, offset=pos).astype(np.int64)
        pos += n * idt.itemsize
        for k in range(1, n - 1):
            rows.append([poly[0], poly[k], poly[k + 1]])
    return np.asarray(rows, dtype=np.int32), pos


def load_serialized(path: str | Path, shape_index: int = 0) -> TriMesh:
    """Mitsuba `.serialized` mesh file (mesh/MtsSerializedFile.cpp:163-318).

    Layout: u16 ident 0x041C, u16 version (>= 3); zlib-deflated shape blobs;
    trailing dictionary of u64 (v4+) / u32 (v3) start offsets, then u32
    shape count.  Each blob: u32 flags, [v4+: NUL-terminated name],
    u64 vertexCount, u64 triCount, positions/normals/uv/colors (f32 or f64
    per MF_DOUBLE), then u32/u64 index triples."""
    import struct
    import zlib
    data = Path(path).read_bytes()
    ident, version = struct.unpack_from("<HH", data, 0)
    if ident != 0x041C:
        raise ValueError(f"{path}: not a Mitsuba serialized file")
    if version < 3:
        raise ValueError(f"{path}: serialized version {version} < 3")
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    if shape_index >= count:
        raise ValueError(f"{path}: shape {shape_index} >= count {count}")
    osz, ofmt = (8, "<Q") if version >= 4 else (4, "<I")
    dict_at = len(data) - 4 - osz * count
    (start,) = struct.unpack_from(ofmt, data, dict_at + osz * shape_index)
    end = (struct.unpack_from(ofmt, data, dict_at + osz * (shape_index + 1))[0]
           if shape_index + 1 < count else dict_at)
    blob = zlib.decompress(data[start + 4:end])

    pos = 0

    def rd(fmt, n=1):
        nonlocal pos
        sz = struct.calcsize(fmt)
        out = struct.unpack_from("<" + fmt, blob, pos)
        pos += sz
        return out if n > 1 or len(out) > 1 else out[0]

    flags = rd("I")
    if version >= 4:
        while blob[pos] != 0:
            pos += 1
        pos += 1
    vcount = rd("Q")
    tcount = rd("Q")
    fdt = np.float64 if flags & 0x2000 else np.float32
    fsz = np.dtype(fdt).itemsize

    def take(n):
        nonlocal pos
        a = np.frombuffer(blob, fdt, n, pos).astype(np.float32)
        pos += n * fsz
        return a

    verts = take(vcount * 3).reshape(-1, 3)
    normals = take(vcount * 3).reshape(-1, 3) if flags & 0x0001 else None
    uv = take(vcount * 2).reshape(-1, 2) if flags & 0x0002 else None
    if flags & 0x0008:                      # vertex colors ignored
        take(vcount * 3)
    idt = np.uint64 if vcount > 0xFFFFFFFF else np.uint32
    idx = np.frombuffer(blob, idt, tcount * 3, pos).astype(np.int32)
    mesh = TriMesh(verts, idx.reshape(-1, 3), normals, uv)
    mesh.ensure_normals()
    return mesh


def load_mesh_file(path: str | Path) -> TriMesh:
    path = Path(path)
    ext = path.suffix.lower()
    if ext == '.obj':
        loader = load_obj
    elif ext == '.ply':
        loader = load_ply
    elif ext in ('.serialized', '.mts'):
        loader = load_serialized
    else:
        raise ValueError(f"Unsupported mesh format: {path}")

    # on-disk cache of the converted mesh (CacheManager.h:7-33 analog)
    from ignis_jax.utils.cache import cached_arrays

    def build(p):
        m = loader(p)
        out = dict(vertices=m.vertices, indices=m.indices)
        if m.normals is not None:
            out["normals"] = m.normals
        if m.texcoords is not None:
            out["texcoords"] = m.texcoords
        return out

    d = cached_arrays(path, "mesh", build)
    return TriMesh(d["vertices"], d["indices"], d.get("normals"),
                   d.get("texcoords"))
