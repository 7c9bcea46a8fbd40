"""Two-level instanced traversal (TLAS) in plain XLA.

The reference traverses a top-level entity BVH whose leaves carry
world->local transforms and point at per-shape triangle BVHs
(src/runtime/bvh/SceneBVHAdapter.h:88-131,
src/artic/traversal/mapping_cpu.art:398-493).  Here each unique shape keeps
ONE local copy of its triangles as Baldwin-Weber records (plane and
barycentric functionals precomputed on the host), and every instance is a
~100-byte record holding its transforms: N instances of a mesh cost N
transforms, not N meshes.  `tlas_traverse_xla` loops the instances at
trace time, moves the rays into shape-local space and tests the shape's
records densely.  Local ray directions are NOT normalized, so local t ==
world t.  Outputs include the hit instance id (entity binding: materials,
lights and media resolve per hit, so instances of one shape can carry
different materials).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TRI_TILE = 8   # triangle records per cluster (rows pad to a multiple)
_HI = jax.lax.Precision.HIGHEST


def bw_tables(v0, e1, e2, maskbits):
    """(Tp, 16) float32 Baldwin-Weber triangle records of one shape.

    Per triangle (host, float64): n = e1 x e2, d0 = -n.v0 (plane);
    B1 = (e2 x n) / ((e2 x n).e1), b1 = -B1.v0 (u functional);
    B2 = (n x e1) / ((n x e1).e2), b2 = -B2.v0 (v functional).  A ray then
    hits at t = -(n.o + d0) / (n.d) with u = B1.o + b1 + t B1.d and
    v = B2.o + b2 + t B2.d.  Row: [n, d0, B1, b1, B2, b2, mask, id, pad].

    maskbits: (T,) int visibility bits per triangle (camera=1, light=2,
    bounce=4, shadow=8).  Degenerate triangles get maskbits 0, so they
    never hit.  Rows pad to a multiple of TRI_TILE with mask 0.
    """
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    t = v0.shape[0]
    n = np.cross(e1, e2)
    nn = np.einsum("ij,ij->i", n, n)
    degen = nn < 1e-30
    c1 = np.cross(e2, n)
    c2 = np.cross(n, e1)
    den1 = np.einsum("ij,ij->i", c1, e1)
    den2 = np.einsum("ij,ij->i", c2, e2)
    bad = degen | (np.abs(den1) < 1e-30) | (np.abs(den2) < 1e-30)
    den1 = np.where(bad, 1.0, den1)
    den2 = np.where(bad, 1.0, den2)
    B1 = c1 / den1[:, None]
    B2 = c2 / den2[:, None]
    d0 = -np.einsum("ij,ij->i", n, v0)
    b1 = -np.einsum("ij,ij->i", B1, v0)
    b2 = -np.einsum("ij,ij->i", B2, v0)
    mask = np.where(bad, 0, np.asarray(maskbits, np.int64) & 0xF)

    tp = max(t + (-t) % TRI_TILE, TRI_TILE)
    tab = np.zeros((tp, 16), np.float32)
    tab[:t, 0:3] = n
    tab[:t, 3] = d0
    tab[:t, 4:7] = B1
    tab[:t, 7] = b1
    tab[:t, 8:11] = B2
    tab[:t, 11] = b2
    tab[:t, 12] = mask.astype(np.float32)
    tab[:t, 13] = np.arange(t, dtype=np.float32)   # id, exact < 2^24
    return tab


def build_tlas(shapes, instances):
    """Build the instanced-pool tables.

    shapes: list of dicts per unique LOCAL shape with keys
      v0, e1, e2, n0, n1, n2 (T,3) and uv0, uv1, uv2 (T,2).
    instances: list of (shape_idx, to_local 3x4 np, to_world 3x4 np,
                        normal_mat 3x3 np, ent_id, maskbits).

    Returns dict of np arrays:
      tl_tris  (Tp, 16)  — shared local BW records, shapes concatenated
      tl_shade (Tp, 28)  — shared LOCAL shading rows (v0|e1|e2|n0|n1|n2|
                           uv0|uv1|uv2 in _pack_tri_shade layout)
      tl_inst  (I, 32)   — per instance: wbbox(6) valid(1) cl_off(1)
                           cl_cnt(1) tri_off(1) toLocal(12) ent(1)
                           mask(1) pad
      tl_norm  (I, 24)   — per instance: normal matrix (9, row-major),
                           |det toWorld|, toWorld 3x4 (12), pad
    """
    tri_chunks = []
    shade_chunks = []
    shape_info = []   # (tri_off_rows, cl_off, cl_cnt) per shape
    tri_rows = 0
    for sh in shapes:
        v0, e1, e2 = sh["v0"], sh["e1"], sh["e2"]
        t = np.asarray(v0).shape[0]
        tab = bw_tables(v0, e1, e2, np.full(t, 0xF))
        tri_chunks.append(tab)
        tp = tab.shape[0]
        shade = np.zeros((tp, 28), np.float32)
        shade[:t, 0:3] = np.asarray(v0, np.float32)
        shade[:t, 3:6] = np.asarray(e1, np.float32)
        shade[:t, 6:9] = np.asarray(e2, np.float32)
        shade[:t, 9:12] = np.asarray(sh["n0"], np.float32)
        shade[:t, 12:15] = np.asarray(sh["n1"], np.float32)
        shade[:t, 15:18] = np.asarray(sh["n2"], np.float32)
        shade[:t, 18:20] = np.asarray(sh["uv0"], np.float32)
        shade[:t, 20:22] = np.asarray(sh["uv1"], np.float32)
        shade[:t, 22:24] = np.asarray(sh["uv2"], np.float32)
        shade_chunks.append(shade)
        shape_info.append((tri_rows, tri_rows // TRI_TILE, tp // TRI_TILE))
        tri_rows += tp

    tl_tris = (np.concatenate(tri_chunks) if tri_chunks
               else np.zeros((TRI_TILE, 16), np.float32))
    tl_shade = (np.concatenate(shade_chunks) if shade_chunks
                else np.zeros((TRI_TILE, 28), np.float32))

    ninst = max(1, len(instances))
    inst = np.zeros((ninst, 32), np.float32)
    normt = np.zeros((ninst, 24), np.float32)
    for ii, (si, to_local, to_world, nmat, ent_id, mask) in enumerate(
            instances):
        v0 = np.asarray(shapes[si]["v0"], np.float64)
        e1 = np.asarray(shapes[si]["e1"], np.float64)
        e2 = np.asarray(shapes[si]["e2"], np.float64)
        pts = np.concatenate([v0, v0 + e1, v0 + e2])
        tw = np.asarray(to_world, np.float64)
        wpts = pts @ tw[:, :3].T + tw[:, 3]
        tri_off, cl_off, cl_cnt = shape_info[si]
        inst[ii, 0:3] = wpts.min(axis=0) if len(pts) else 0.0
        inst[ii, 3:6] = wpts.max(axis=0) if len(pts) else 0.0
        inst[ii, 6] = 1.0
        inst[ii, 7] = np.float32(cl_off)
        inst[ii, 8] = np.float32(cl_cnt)
        inst[ii, 9] = np.float32(tri_off)
        inst[ii, 10:22] = np.asarray(to_local, np.float32).reshape(12)
        inst[ii, 22] = np.float32(ent_id)
        inst[ii, 23] = np.float32(int(mask) & 0xF)
        normt[ii, 0:9] = np.asarray(nmat, np.float32).reshape(9)
        normt[ii, 9] = abs(float(np.linalg.det(
            np.asarray(to_world, np.float64)[:, :3])))
        normt[ii, 10:22] = np.asarray(to_world, np.float32).reshape(12)
    return {"tl_tris": tl_tris, "tl_shade": tl_shade, "tl_inst": inst, "tl_norm": normt}


def tlas_traverse_xla(tables, org, d, tmin, tmax, mask_bit=0xF,
                      meta=None):
    """(t, u, v, pool_row, instance) over the instanced pool; -1 = miss.

    Loops the instances at trace time, transforms the rays and tests the
    shape's records densely.  Products run at HIGHEST precision so a
    TF32 matmul unit cannot perturb hit distances.

    `meta` carries the STATIC per-instance structure (valid/mask/toff/
    ccnt python lists, Runtime.scene.tlas_meta) because inside jit the
    tables are tracers; transforms stay traced."""
    org, d, tmin, tmax = map(jax.lax.stop_gradient, (org, d, tmin, tmax))
    n = org.shape[0]
    tmin = jnp.broadcast_to(tmin, (n,)).astype(jnp.float32)
    tmax = jnp.broadcast_to(tmax, (n,)).astype(jnp.float32)
    inst = tables["tl_inst"]
    tris = tables["tl_tris"]
    if meta is None:
        ia = np.asarray(inst)
        meta = dict(valid=[bool(v > 0) for v in ia[:, 6]],
                    mask=[int(v) for v in ia[:, 23]],
                    toff=[int(v) for v in ia[:, 9]],
                    ccnt=[int(v) for v in ia[:, 8]])
    best = (tmax, jnp.zeros_like(tmin), jnp.zeros_like(tmin),
            jnp.full((n,), -1, jnp.int32), jnp.full((n,), -1, jnp.int32))
    mask_bit = jnp.asarray(mask_bit, jnp.int32)
    for ie in range(len(meta["toff"])):
        if not meta["valid"][ie]:
            continue
        evis = (jnp.int32(meta["mask"][ie]) & mask_bit) != 0
        m = inst[ie, 10:22].reshape(3, 4)
        lo = jnp.dot(org, m[:, :3].T, precision=_HI) + m[:, 3]
        ld = jnp.dot(d, m[:, :3].T, precision=_HI)
        toff = meta["toff"][ie]
        tcount = meta["ccnt"][ie] * TRI_TILE
        sl = tris[toff:toff + tcount]
        # rebuild v0/e1/e2 equivalents is unnecessary: BW records hold the
        # plane/barycentric functionals; evaluate them directly.
        nvec = sl[:, 0:3]
        d0 = sl[:, 3]
        b1 = sl[:, 4:7]
        b1c = sl[:, 7]
        b2 = sl[:, 8:11]
        b2c = sl[:, 11]
        msk = sl[:, 12] > 0.0
        k = jnp.dot(ld, nvec.T, precision=_HI)                      # (n, T)
        mm = jnp.dot(lo, nvec.T, precision=_HI) + d0[None, :]
        kk = jnp.where(k == 0.0, 1.0, k)
        tt = -mm / kk
        s1 = jnp.dot(lo, b1.T, precision=_HI) + b1c[None, :]
        r1 = jnp.dot(ld, b1.T, precision=_HI)
        u = s1 + tt * r1
        s2 = jnp.dot(lo, b2.T, precision=_HI) + b2c[None, :]
        r2 = jnp.dot(ld, b2.T, precision=_HI)
        v = s2 + tt * r2
        tol = 1.1920929e-07
        ok = (evis & msk[None, :] & (k != 0.0) & (u >= -tol)
              & (v >= -tol) & (u + v <= 1.0 + tol) & (tt >= tmin[:, None])
              & (tt <= best[0][:, None]))
        tt = jnp.where(ok, tt, jnp.inf)
        j = jnp.argmin(tt, axis=1)
        lanes = jnp.arange(n)
        hit = ok[lanes, j]
        bt = jnp.where(hit, tt[lanes, j], best[0])
        bu = jnp.where(hit, jnp.maximum(u[lanes, j], 0.0), best[1])
        bv = jnp.where(hit, jnp.maximum(v[lanes, j], 0.0), best[2])
        bi = jnp.where(hit, toff + j.astype(jnp.int32), best[3])
        be = jnp.where(hit, ie, best[4])
        best = (bt, bu, bv, bi, be)
    return best
