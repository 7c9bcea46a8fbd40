"""Built-in shape providers → TriMesh.

Counterpart of src/runtime/shape/TriMeshProvider.cpp:19-130 and the TriMesh
factory functions (src/runtime/mesh/TriMesh.cpp:700-1060).  Geometry (vertex
order, winding, uv layout) matches the reference so that prim ids, area CDFs,
and light sampling agree.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from ignis_jax.scene.mesh import TriMesh, load_mesh_file


def _prop(obj: dict, key, default=None):
    return obj.get(key, default)


def _vec3(obj, key, default):
    v = obj.get(key, default)
    if isinstance(v, (int, float)):
        return np.array([v, v, v], dtype=np.float64)
    return np.asarray(v, dtype=np.float64)


def _tangent_frame(n):
    sign = 1.0 if n[2] >= 0 else -1.0
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t = np.array([1 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    bt = np.array([b, sign + n[1] * n[1] * a, -n[1]])
    return t, bt


def _make_triangle(p0, p1, p2) -> TriMesh:
    """addTriangle (TriMesh.cpp:700-709): verts (o, o+x, o+y), uv (0,0),(1,0),(0,1)."""
    x, y = p1 - p0, p2 - p0
    n = np.cross(x, y)
    n = n / max(np.linalg.norm(n), 1e-20)
    verts = np.stack([p0, p0 + x, p0 + y])
    return TriMesh(verts, np.array([[0, 1, 2]], dtype=np.int32),
                   np.tile(n, (3, 1)), np.array([[0, 0], [1, 0], [0, 1]], dtype=np.float32))


def _make_grid(origin, x_axis, y_axis, cx, cy) -> TriMesh:
    """addGrid (TriMesh.cpp:711-739)."""
    n = np.cross(x_axis, y_axis)
    n = n / max(np.linalg.norm(n), 1e-20)
    verts, uvs = [], []
    for j in range(cy + 1):
        for i in range(cx + 1):
            u, v = i / cx, j / cy
            verts.append(origin + x_axis * u + y_axis * v)
            uvs.append([u, v])
    faces = []
    for j in range(cy):
        for i in range(cx):
            i1 = j * (cx + 1) + i
            i2 = (j + 1) * (cx + 1) + i
            faces.append([i1, i1 + 1, i2 + 1])
            faces.append([i1, i2 + 1, i2])
    return TriMesh(np.asarray(verts), np.asarray(faces, dtype=np.int32),
                   np.tile(n, (len(verts), 1)), np.asarray(uvs, dtype=np.float32))


def _make_plane(origin, x_axis, y_axis) -> TriMesh:
    return _make_grid(origin, x_axis, y_axis, 1, 1)


def _make_rectangle(p0, p1, p2, p3) -> TriMesh:
    """MakeRectangle (TriMesh.cpp:981-987): tris (p0,p1,p3), (p1,p2,p3)."""
    m1 = _make_triangle(p0, p1, p3)
    m2 = _make_triangle(p1, p2, p3)
    return TriMesh.concat([m1, m2])


def _make_box(origin, x_axis, y_axis, z_axis) -> TriMesh:
    """MakeBox (TriMesh.cpp:989-1003): six planes."""
    lll = origin
    hhh = origin + x_axis + y_axis + z_axis
    planes = [
        _make_plane(lll, y_axis, x_axis),
        _make_plane(lll, x_axis, z_axis),
        _make_plane(lll, z_axis, y_axis),
        _make_plane(hhh, -x_axis, -y_axis),
        _make_plane(hhh, -z_axis, -x_axis),
        _make_plane(hhh, -y_axis, -z_axis),
    ]
    return TriMesh.concat(planes)


def _add_disk(center, n, nx, ny, radius, sections, fill_cap, flip=False) -> TriMesh:
    """addDisk (TriMesh.cpp:747-781)."""
    verts, uvs = [], []
    if fill_cap:
        verts.append(center)
        uvs.append([0.0, 0.0])
    for i in range(sections):
        x = math.cos(2 * math.pi * i / sections)
        y = math.sin(2 * math.pi * i / sections)
        verts.append(radius * nx * x + radius * ny * y + center)
        uvs.append([0.5 * (x + 1), 0.5 * (y + 1)])
    faces = []
    if fill_cap:
        for i in range(sections):
            c = i + 1
            nc = (i + 1 if i + 1 < sections else 0) + 1
            faces.append([0, nc, c] if flip else [0, c, nc])
    normals = np.tile(n, (len(verts), 1))
    return TriMesh(np.asarray(verts), np.asarray(faces, dtype=np.int32).reshape(-1, 3),
                   normals, np.asarray(uvs, dtype=np.float32))


def _make_disk(center, normal, radius, sections) -> TriMesh:
    sections = max(3, sections)
    normal = normal / max(np.linalg.norm(normal), 1e-20)
    nx, ny = _tangent_frame(normal)
    return _add_disk(center, normal, nx, ny, radius, sections, True)


def _make_gauss(origin, direction, sigma, radius_scale, sections,
                slices) -> TriMesh:
    """MakeRadialGaussian (TriMesh.cpp:1059-1113): stacked rings following
    a radial gaussian height profile, grounded so gauss(1) sits at z=0."""
    sections = max(3, int(sections))
    slices = max(2, int(slices))
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(direction, np.float64)

    def gauss(r):
        return math.exp(-(r * r) / (2 * sigma * sigma)) / (sigma * 2 * math.pi)

    defect = direction * gauss(1.0)
    peak = origin + direction * gauss(0.0) - defect
    normal = direction / max(np.linalg.norm(direction), 1e-20)
    nx, ny = _tangent_frame(normal)

    verts, faces = [], []
    # bottom disk (cap filled)
    verts.append(origin)
    for i in range(sections):
        x = math.cos(2 * math.pi * i / sections)
        y = math.sin(2 * math.pi * i / sections)
        verts.append(radius_scale * nx * x + radius_scale * ny * y + origin)
    for i in range(sections):
        c = i + 1
        nc = (i + 1 if i + 1 < sections else 0) + 1
        faces.append([0, c, nc])
    # intermediate rings + side quads (TriMesh.cpp:1078-1094)
    for i in range(1, slices):
        radius = 1.0 - i / slices
        g = gauss(radius)
        ring_c = origin + direction * g - defect
        for k in range(sections):
            x = math.cos(2 * math.pi * k / sections)
            y = math.sin(2 * math.pi * k / sections)
            verts.append(radius_scale * radius * (nx * x + ny * y) + ring_c)
        start = (i - 1) * sections + 1
        for k in range(sections):
            c = k + start
            nc = (k + 1 if k + 1 < sections else 0) + start
            faces.append([c, c + sections, nc])
            faces.append([c + sections, nc + sections, nc])
    # peak fan
    verts.append(peak)
    end = len(verts) - 1
    start = (slices - 1) * sections + 1
    for i in range(sections):
        c = i + start
        nc = (i + 1 if i + 1 < sections else 0) + start
        faces.append([c, end, nc])
    mesh = TriMesh(np.asarray(verts), np.asarray(faces, np.int32))
    mesh.compute_vertex_normals()
    mesh.ensure_texcoords()
    return mesh


def _make_gauss_lobe(origin, direction, x_axis, y_axis, cov, theta_size,
                     phi_size, scale) -> TriMesh:
    """MakeGaussianLobe (TriMesh.cpp:1115-1156): spherical grid displaced by
    an anisotropic gaussian over (theta, phi) around `direction`."""
    theta_size = max(8, int(theta_size))
    phi_size = max(8, int(phi_size))
    x_axis = np.asarray(x_axis, np.float64)
    y_axis = np.asarray(y_axis, np.float64)
    n = np.cross(x_axis, y_axis)
    n = n / max(np.linalg.norm(n), 1e-20)
    nx = x_axis / max(np.linalg.norm(x_axis), 1e-20)
    ny = y_axis / max(np.linalg.norm(y_axis), 1e-20)
    cov = np.asarray(cov, np.float64).reshape(2, 2)
    det = abs(np.linalg.det(cov))
    if det <= 1e-12:
        raise ValueError("gauss_lobe covariance not positive semi-definite")
    inv_cov = np.linalg.inv(cov)
    norm = 1.0 / (2 * math.pi * math.sqrt(det))

    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-20)
    local = np.asarray([d @ nx, d @ ny, d @ n])
    mean_theta = math.acos(min(1.0, max(-1.0, local[2])))
    mean_phi = math.atan2(local[1], local[0])

    base = _make_grid(np.zeros(3), np.float64([1, 0, 0]),
                      np.float64([0, 1, 0]), theta_size, phi_size)
    verts = np.asarray(base.vertices, np.float64).copy()
    for j in range(phi_size + 1):
        for i in range(theta_size + 1):
            phi = 2 * math.pi * (j / phi_size) - math.pi
            theta = math.pi * (i / theta_size)
            a = np.asarray([theta - mean_theta, phi - mean_phi])
            value = norm * math.exp(-0.5 * a @ inv_cov @ a)
            st, ct = math.sin(theta), math.cos(theta)
            u = (x_axis * (st * math.cos(phi)) + y_axis * (st * math.sin(phi))
                 + n * ct)
            verts[j * (theta_size + 1) + i] = \
                u * value * scale + np.asarray(origin, np.float64)
    mesh = TriMesh(verts, base.indices, None, base.texcoords)
    mesh.compute_vertex_normals()
    return mesh


def _make_uv_sphere(center, radius, stacks, slices) -> TriMesh:
    """MakeUVSphere (TriMesh.cpp:782-837)."""
    verts, norms, uvs, faces = [], [], [], []
    for j in range(stacks + 1):
        rho = math.pi * j / stacks
        for i in range(slices + 1):
            theta = 2 * math.pi * i / slices
            d = np.array([math.sin(rho) * math.cos(theta),
                          math.sin(rho) * math.sin(theta),
                          math.cos(rho)])
            verts.append(center + radius * d)
            norms.append(d)
            uvs.append([i / slices, j / stacks])
    for j in range(stacks):
        for i in range(slices):
            i1 = j * (slices + 1) + i
            i2 = (j + 1) * (slices + 1) + i
            faces.append([i1, i2 + 1, i1 + 1])
            faces.append([i1, i2, i2 + 1])
    return TriMesh(np.asarray(verts), np.asarray(faces, dtype=np.int32),
                   np.asarray(norms), np.asarray(uvs, dtype=np.float32))


def _make_ico_sphere(center, radius, subdivisions) -> TriMesh:
    """MakeIcoSphere (TriMesh.cpp:838-954): icosahedron + midpoint subdivision."""
    phi = 1.618033989
    base = []
    for d in range(3):
        for s1 in (-1, 1):
            for s2 in (-1, 1):
                v = np.zeros(3)
                v[(d + 1) % 3] = phi * s1
                v[(d + 2) % 3] = 1.0 * s2
                base.append(v / np.linalg.norm(v))
    verts = base
    faces = [
        (0, 8, 4), (0, 4, 6), (0, 6, 9), (0, 9, 2), (0, 2, 8),
        (3, 8, 2), (3, 2, 11), (3, 11, 7), (3, 7, 10), (3, 10, 8),
        (1, 4, 5), (1, 5, 7), (1, 7, 11), (1, 11, 6), (1, 6, 4),
        (10, 5, 2), (2, 5, 11), (5, 10, 7), (8, 10, 4), (4, 10, 5),
    ]
    # The exact icosahedron face list differs across implementations; we
    # rebuild one via convex hull adjacency instead for robustness.
    faces = _icosahedron_faces(np.asarray(verts))
    for _ in range(subdivisions):
        verts, faces = _subdivide(verts, faces)
    v = np.asarray(verts)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    uv = np.zeros((len(v), 2), dtype=np.float32)
    return TriMesh(center + radius * v, np.asarray(faces, dtype=np.int32), v.copy(), uv)


def _icosahedron_faces(verts: np.ndarray):
    # All vertices lie on the unit sphere; faces = triples of mutually nearest
    # neighbors with circumradius below edge threshold and outward orientation.
    n = len(verts)
    edge = 4.0 / math.sqrt(10.0 + 2.0 * math.sqrt(5.0))  # icosa edge for R=1
    faces = []
    for i in range(n):
        for j in range(i + 1, n):
            if abs(np.linalg.norm(verts[i] - verts[j]) - edge) > 1e-4:
                continue
            for k in range(j + 1, n):
                if (abs(np.linalg.norm(verts[i] - verts[k]) - edge) < 1e-4
                        and abs(np.linalg.norm(verts[j] - verts[k]) - edge) < 1e-4):
                    c = (verts[i] + verts[j] + verts[k]) / 3
                    nrm = np.cross(verts[j] - verts[i], verts[k] - verts[i])
                    if np.dot(nrm, c) < 0:
                        faces.append((i, k, j))
                    else:
                        faces.append((i, j, k))
    return faces


def _subdivide(verts, faces):
    verts = list(verts)
    cache: dict[tuple[int, int], int] = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        idx = cache.get(key)
        if idx is None:
            m = (np.asarray(verts[a]) + np.asarray(verts[b])) * 0.5
            m = m / np.linalg.norm(m)
            idx = len(verts)
            verts.append(m)
            cache[key] = idx
        return idx

    out = []
    for (a, b, c) in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return verts, out


def _make_cone(base_center, base_radius, tip, sections, fill_cap) -> TriMesh:
    sections = max(3, sections)
    h = base_center - tip
    h = h / max(np.linalg.norm(h), 1e-20)
    nx, ny = _tangent_frame(h)
    disk = _add_disk(base_center, h, nx, ny, base_radius, sections, fill_cap)
    verts = list(disk.vertices)
    norms = list(disk.normals)
    uvs = list(disk.texcoords)
    faces = list(disk.indices)
    tip_idx = len(verts)
    verts.append(tip)
    norms.append(h)
    uvs.append([0.0, 0.0])
    start = 1 if fill_cap else 0
    for i in range(sections):
        c = i + start
        nc = (i + 1 if i + 1 < sections else 0) + start
        faces.append([c, nc, tip_idx])
    return TriMesh(np.asarray(verts), np.asarray(faces, dtype=np.int32),
                   np.asarray(norms), np.asarray(uvs, dtype=np.float32))


def _make_cylinder(base_center, base_radius, top_center, top_radius, sections, fill_cap) -> TriMesh:
    sections = max(3, sections)
    h = base_center - top_center
    h = h / max(np.linalg.norm(h), 1e-20)
    nx, ny = _tangent_frame(h)
    bottom = _add_disk(base_center, h, nx, ny, base_radius, sections, fill_cap)
    top = _add_disk(top_center, h, nx, ny, top_radius, sections, fill_cap, flip=True)
    mesh = TriMesh.concat([bottom, top])
    off = len(bottom.vertices)
    start = 1 if fill_cap else 0
    faces = list(mesh.indices)
    for i in range(sections):
        c = i + start
        nc = (i + 1 if i + 1 < sections else 0) + start
        faces.append([c, nc, off + nc])
        faces.append([c, off + nc, off + c])
    mesh.indices = np.asarray(faces, dtype=np.int32)
    return mesh


def build_shape(obj: dict, resolve_path) -> TriMesh:
    """Construct the mesh for one shape object (LoaderShape.cpp:20-41 types)."""
    stype = obj.get("type", "triangle")
    if stype == "triangle":
        mesh = _make_triangle(_vec3(obj, "p0", [0, 0, 0]),
                              _vec3(obj, "p1", [1, 0, 0]),
                              _vec3(obj, "p2", [0, 1, 0]))
    elif stype in ("rectangle", "plane"):
        if "p0" not in obj:
            w = float(_prop(obj, "width", 2.0))
            h = float(_prop(obj, "height", 2.0))
            origin = _vec3(obj, "origin", [-w / 2, -h / 2, 0])
            mesh = _make_plane(origin, np.array([w, 0, 0]), np.array([0, h, 0]))
        else:
            mesh = _make_rectangle(_vec3(obj, "p0", [-1, -1, 0]),
                                   _vec3(obj, "p1", [1, -1, 0]),
                                   _vec3(obj, "p2", [1, 1, 0]),
                                   _vec3(obj, "p3", [-1, 1, 0]))
    elif stype in ("cube", "box"):
        w = float(_prop(obj, "width", 2.0))
        h = float(_prop(obj, "height", 2.0))
        d = float(_prop(obj, "depth", 2.0))
        origin = _vec3(obj, "origin", [-w / 2, -h / 2, -d / 2])
        mesh = _make_box(origin, np.array([w, 0, 0]), np.array([0, h, 0]), np.array([0, 0, d]))
    elif stype == "icosphere":
        mesh = _make_ico_sphere(_vec3(obj, "center", [0, 0, 0]),
                                float(_prop(obj, "radius", 1.0)),
                                int(_prop(obj, "subdivisions", 4)))
    elif stype in ("uvsphere", "sphere"):
        mesh = _make_uv_sphere(_vec3(obj, "center", [0, 0, 0]),
                               float(_prop(obj, "radius", 1.0)),
                               int(_prop(obj, "stacks", 32)),
                               int(_prop(obj, "slices", 16)))
        if stype == "sphere":
            # "sphere" is analytic in the reference (SphereProvider.cpp:
            # 1-71, artic/shapes/sphere.art:45-132); the tessellation above
            # stays as the fallback for entities the analytic path cannot
            # serve (non-uniform scale, media interfaces).  The compiler
            # promotes eligible entities to exact sphere records.
            mesh.analytic = ("sphere", _vec3(obj, "center", [0, 0, 0]),
                             float(_prop(obj, "radius", 1.0)))
    elif stype == "disk":
        mesh = _make_disk(_vec3(obj, "origin", [0, 0, 0]),
                          _vec3(obj, "normal", [0, 0, 1]),
                          float(_prop(obj, "radius", 1.0)),
                          int(_prop(obj, "sections", 32)))
    elif stype == "cone":
        mesh = _make_cone(_vec3(obj, "p0", [0, 0, 0]),
                          float(_prop(obj, "radius", 1.0)),
                          _vec3(obj, "p1", [0, 0, 1]),
                          int(_prop(obj, "sections", 32)),
                          bool(_prop(obj, "filled", True)))
    elif stype == "cylinder":
        if "radius" in obj:
            br = tr = float(obj["radius"])
        else:
            br = float(_prop(obj, "bottom_radius", 1.0))
            tr = float(_prop(obj, "top_radius", br))
        mesh = _make_cylinder(_vec3(obj, "p0", [0, 0, 0]), br,
                              _vec3(obj, "p1", [0, 0, 1]), tr,
                              int(_prop(obj, "sections", 32)),
                              bool(_prop(obj, "filled", True)))
    elif stype == "gauss":
        # TriMeshProvider.cpp:107-118
        mesh = _make_gauss(
            _vec3(obj, "origin", [0, 0, 0]),
            np.asarray(_vec3(obj, "normal", [0, 0, 1]), np.float64)
            * float(_prop(obj, "height", 1.0)),
            float(_prop(obj, "sigma", 1.0)),
            float(_prop(obj, "radius_scale", 1.0)),
            int(_prop(obj, "sections", 32)), int(_prop(obj, "slices", 16)))
    elif stype == "gauss_lobe":
        # TriMeshProvider.cpp:120-138
        st_ = float(_prop(obj, "sigma_theta", 1.0))
        sp_ = float(_prop(obj, "sigma_phi", 1.0))
        an_ = float(_prop(obj, "anisotropy", 0.0))
        cov = [[st_ * st_, an_ * st_ * sp_], [an_ * st_ * sp_, sp_ * sp_]]
        mesh = _make_gauss_lobe(
            _vec3(obj, "origin", [0, 0, 0]),
            _vec3(obj, "direction", [0, 0, 1]),
            _vec3(obj, "x_axis", [1, 0, 0]), _vec3(obj, "y_axis", [0, 1, 0]),
            cov, int(_prop(obj, "theta_size", 64)),
            int(_prop(obj, "phi_size", 128)), float(_prop(obj, "scale", 1.0)))
    elif stype in ("external", "obj", "ply", "mitsuba", "inline"):
        fn = obj.get("filename")
        if fn is None:
            raise ValueError(f"Shape '{obj.get('name')}' needs a filename")
        p = resolve_path(fn)
        if stype == "mitsuba" or str(p).endswith((".serialized", ".mts")):
            from ignis_jax.scene.mesh import load_serialized
            mesh = load_serialized(p, int(_prop(obj, "shape_index", 0)))
        else:
            mesh = load_mesh_file(p)
    else:
        raise ValueError(f"Unsupported shape type '{stype}'")

    # Common post-ops (TriMeshProvider.cpp:480-560)
    if "transform" in obj:
        from ignis_jax.scene.transforms import parse_transform
        mesh = mesh.transformed(parse_transform(obj["transform"]))
    if obj.get("flip_normals", False):
        mesh.flip_normals()
    if obj.get("face_normals", False):
        mesh.apply_face_normals()
    # NOTE: the reference keeps zero-area triangles (removeZeroAreaTriangles
    # is commented out in ObjFile.cpp:187 / PlyFile.cpp:361); degenerate tris
    # never intersect, so we keep them too for table-layout parity.
    mesh.ensure_normals()
    mesh.ensure_texcoords()
    return mesh
