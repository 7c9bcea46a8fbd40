"""Ray/triangle intersection kernels.

Möller–Trumbore over precomputed (v0, e1, e2) triangles, chunked with
`lax.scan` so peak memory stays bounded at (n_rays, CHUNK) regardless of
scene size.  This is the correctness-first baseline analogous to the
reference's traversal fallback; the BVH path (ignis_jax.ops.bvh) replaces it
for large scenes.  Direction vectors need not be normalized (the reference
traces unnormalized shadow rays with tmax=1-eps, trace/main.cpp semantics).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ignis_jax.core.vec import cross, dot

CHUNK = 512


def _effective_chunk(t, chunk):
    """Shrink the chunk for tiny scenes so padding stays bounded."""
    r = max(8, -(-t // 8) * 8)
    return min(chunk, r)


def _pad_tris(v0, e1, e2, chunk):
    t = v0.shape[0]
    pad = (-t) % chunk
    if pad:
        # degenerate padding triangles never hit
        zpad3 = jnp.zeros((pad, 3), v0.dtype)
        v0 = jnp.concatenate([v0, zpad3])
        e1 = jnp.concatenate([e1, zpad3])
        e2 = jnp.concatenate([e2, zpad3])
    return v0, e1, e2, t + pad


def _pad_mask(tri_mask, t, chunk):
    if tri_mask is None:
        tri_mask = jnp.ones((t,), dtype=bool)
    pad = (-t) % chunk
    if pad:
        tri_mask = jnp.concatenate([tri_mask, jnp.zeros((pad,), bool)])
    return tri_mask


def intersect_closest(org, direction, tmin, tmax, v0, e1, e2, tri_mask=None,
                      chunk=CHUNK):
    """Closest-hit over all triangles.

    Returns (t, u, v, prim_idx) with prim_idx == -1 for misses.
    Intersection predicate matches traversal/intersection.art: barycentric
    inside test and t in (tmin, tmax).  tri_mask (T,) disables triangles
    (per-ray-type entity visibility flags, LoaderEntity.cpp:123-131).
    """
    n = org.shape[0]
    chunk = _effective_chunk(v0.shape[0], chunk)
    v0p, e1p, e2p, tpad = _pad_tris(v0, e1, e2, chunk)
    mask = _pad_mask(tri_mask, v0.shape[0], chunk)
    nchunks = tpad // chunk
    v0c = v0p.reshape(nchunks, chunk, 3)
    e1c = e1p.reshape(nchunks, chunk, 3)
    e2c = e2p.reshape(nchunks, chunk, 3)
    maskc = mask.reshape(nchunks, chunk)
    base = jnp.arange(nchunks, dtype=jnp.int32) * chunk

    init = (jnp.broadcast_to(tmax, (n,)).astype(jnp.float32),
            jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.float32),
            jnp.full((n,), -1, jnp.int32))

    def body(carry, inputs):
        cv0, ce1, ce2, cmask, coff = inputs
        best_t, best_u, best_v, best_i = carry
        t, u, v, ok = _mt_block(org, direction, tmin, best_t, cv0, ce1, ce2)
        ok = ok & cmask[None, :]
        # take the minimum-t hit within this chunk
        t_masked = jnp.where(ok, t, jnp.inf)
        j = jnp.argmin(t_masked, axis=1)
        rows = jnp.arange(n)
        tj = t_masked[rows, j]
        hit = tj < best_t
        best_u = jnp.where(hit, u[rows, j], best_u)
        best_v = jnp.where(hit, v[rows, j], best_v)
        best_i = jnp.where(hit, coff + j.astype(jnp.int32), best_i)
        best_t = jnp.where(hit, tj, best_t)
        return (best_t, best_u, best_v, best_i), None

    (bt, bu, bv, bi), _ = jax.lax.scan(body, init, (v0c, e1c, e2c, maskc, base))
    return bt, bu, bv, bi


def intersect_any(org, direction, tmin, tmax, v0, e1, e2, tri_mask=None,
                  chunk=CHUNK):
    """Any-hit (occlusion) test. Returns bool occluded per ray."""
    n = org.shape[0]
    chunk = _effective_chunk(v0.shape[0], chunk)
    v0p, e1p, e2p, tpad = _pad_tris(v0, e1, e2, chunk)
    mask = _pad_mask(tri_mask, v0.shape[0], chunk)
    nchunks = tpad // chunk
    v0c = v0p.reshape(nchunks, chunk, 3)
    e1c = e1p.reshape(nchunks, chunk, 3)
    e2c = e2p.reshape(nchunks, chunk, 3)
    maskc = mask.reshape(nchunks, chunk)
    tmax_b = jnp.broadcast_to(tmax, (n,)).astype(jnp.float32)

    def body(occluded, inputs):
        cv0, ce1, ce2, cmask = inputs
        _, _, _, ok = _mt_block(org, direction, tmin, tmax_b, cv0, ce1, ce2)
        ok = ok & cmask[None, :]
        return occluded | jnp.any(ok, axis=1), None

    occ, _ = jax.lax.scan(body, jnp.zeros((n,), bool), (v0c, e1c, e2c, maskc))
    return occ


def _mt_block(org, direction, tmin, tmax, v0, e1, e2):
    """Möller–Trumbore for (N,3) rays × (C,3) triangles → (N,C) results."""
    # broadcast: rays (N,1,3), tris (1,C,3)
    o = org[:, None, :]
    d = direction[:, None, :]
    tv0 = v0[None, :, :]
    te1 = e1[None, :, :]
    te2 = e2[None, :, :]

    # Same math as intersect_ray_tri_mt_gen (traversal/intersection.art:70-101)
    # but our edges are standard (e1 = v1-v0, e2 = v2-v0) while the reference
    # stores madmann91-style (e1 = p0-p1, e2 = p2-p0), so the barycentric
    # projections pick up a sign: u = -dot(r, e2)/det, v = +dot(r, e1)/det.
    # (u, v) weight vertices 1 and 2 — the lerp2 convention both use.
    tol = jnp.float32(-1.1920928955078125e-07)
    tn = jnp.cross(te1, te2)
    c = tv0 - o
    r = jnp.cross(d, c)
    det = jnp.sum(tn * d, axis=-1)
    inv_det = jnp.where(det == 0.0, 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det))
    u = -jnp.sum(r * te2, axis=-1) * inv_det
    v = jnp.sum(r * te1, axis=-1) * inv_det
    w = 1.0 - u - v
    t = jnp.sum(c * tn, axis=-1) * inv_det
    ok = ((det != 0.0) & (u >= tol) & (v >= tol) & (w >= tol)
          & (t >= jnp.asarray(tmin)[..., None]) & (t <= jnp.asarray(tmax)[..., None]))
    return t, jnp.maximum(u, 0.0), jnp.maximum(v, 0.0), ok
