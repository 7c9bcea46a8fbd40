"""Analytic sphere primitives — exact hit + UV, no tessellation.

Counterpart of the reference's sphere shape provider
(src/runtime/shape/SphereProvider.cpp:1-71,
src/artic/shapes/sphere.art:102-132): scenes rarely carry more than a
handful of analytic spheres, so the sweep is a DENSE (n_rays, n_spheres)
vectorized quadratic — plain XLA math that runs identically on every
backend, no kernel or per-lane gathers needed.  Results are
combined with the mesh traversal exactly like the TLAS pool
(render/integrator.py _traverse_closest).

Table layout `sph_rows` (S, 16) f32, built by scene/compile.py:
  [0:3] world center, [3] world radius, [4] entity id, [5] visibility
  maskbits, [6:15] world->local rotation (row-major; identity-scaled
  part of the entity transform, for UV orientation), [15] pad.

Intersection predicate replicates sphere.art:102-132 EXACTLY, including
its behind-origin rejection (S < 0 -> miss, i.e. the reference's spheres
report no hit when the center is behind the ray origin): parity with the
reference renderer takes precedence over alternative conventions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import HIGHEST


def sphere_map_uv(dirs):
    """UV from the unit direction, matching sphere.art:1-6 (and the uv/ico
    sphere tessellations): spherical angles of (y, -x, z)."""
    x = dirs[..., 1]
    y = -dirs[..., 0]
    z = dirs[..., 2]
    theta = jnp.arccos(jnp.clip(z, -1.0, 1.0))
    phi = jnp.arctan2(y, x)
    phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
    u = phi / (2 * np.pi)
    v = theta / np.pi
    return u, v


def sphere_unmap_uv(u, v):
    """Inverse of sphere_map_uv (sphere.art:8-13)."""
    theta = v * np.pi
    phi = u * 2 * np.pi
    st = jnp.sin(theta)
    x = st * jnp.cos(phi)
    y = st * jnp.sin(phi)
    z = jnp.cos(theta)
    # dir_from_spherical gives (x, y, z); the map used (y, -x, z)
    return jnp.stack([-y, x, z], axis=-1)


def _hits(tables, org, d, tmin, tmax, mask_bit):
    """(n, S) candidate hit t (inf = miss) per sphere.art:102-132."""
    sph = tables["sph_rows"]
    c = sph[:, 0:3]
    r = sph[:, 3]
    flags = sph[:, 5].astype(jnp.int32)
    mask_bit = jnp.asarray(mask_bit, jnp.int32)
    vis = (flags & mask_bit) != 0                       # (S,)

    L = c[None, :, :] - org[:, None, :]                 # (n, S, 3)
    S_ = jnp.einsum("nsk,nk->ns", L, d,                 # -dot(org-c, d)
                    precision=HIGHEST)
    D2 = jnp.sum(d * d, axis=-1)[:, None]
    L2 = jnp.sum(L * L, axis=-1)
    R2 = (r * r)[None, :] * D2
    M2 = L2 * D2 - S_ * S_
    miss = (S_ < 0) | (M2 > R2)
    Q = jnp.sqrt(jnp.maximum(R2 - M2, 0.0))
    invD2 = 1.0 / jnp.maximum(D2, 1e-30)
    t0 = (S_ - Q) * invD2
    t1 = (S_ + Q) * invD2
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    tm = tmin[:, None]
    tcand = jnp.where(lo < tm, hi, lo)
    ok = (~miss) & vis[None, :] & (tcand >= tm) & (tcand <= tmax[:, None])
    return jnp.where(ok, tcand, jnp.inf)


_CHUNK = 1 << 16   # dense (rays, spheres) sweep: bound the temporaries


def sphere_closest(tables, org, d, tmin, tmax, mask_bit=0xF):
    """Best sphere hit per ray: (t, u, v, idx); idx = -1 on miss."""
    org, d, tmin, tmax = map(jax.lax.stop_gradient, (org, d, tmin, tmax))
    n = org.shape[0]
    tmin = jnp.broadcast_to(tmin, (n,)).astype(jnp.float32)
    tmax = jnp.broadcast_to(tmax, (n,)).astype(jnp.float32)
    if n > _CHUNK:
        outs = [sphere_closest(tables, org[i:i + _CHUNK], d[i:i + _CHUNK],
                               tmin[i:i + _CHUNK], tmax[i:i + _CHUNK],
                               mask_bit)
                for i in range(0, n, _CHUNK)]
        return tuple(jnp.concatenate([o[k] for o in outs])
                     for k in range(4))
    tc = _hits(tables, org, d, tmin, tmax, mask_bit)
    j = jnp.argmin(tc, axis=1)
    lanes = jnp.arange(n)
    bt = tc[lanes, j]
    hit = jnp.isfinite(bt)
    sph = tables["sph_rows"]
    c = sph[j, 0:3]
    r = jnp.maximum(sph[j, 3], 1e-30)
    rot = sph[j, 6:15].reshape(-1, 3, 3)
    t_safe = jnp.where(hit, bt, 1.0)
    p = org + d * t_safe[:, None]
    nrm = (p - c) / r[:, None]
    # UV in SHAPE-LOCAL orientation (rotation part of the entity
    # transform undone) so textures don't spin with the entity
    nl = jnp.einsum("nij,nj->ni", rot, nrm, precision=HIGHEST)
    u, v = sphere_map_uv(nl)
    return (jnp.where(hit, bt, tmax),
            jnp.where(hit, u, 0.0),
            jnp.where(hit, v, 0.0),
            jnp.where(hit, j.astype(jnp.int32), -1))


def sphere_any(tables, org, d, tmin, tmax, mask_bit=0xF):
    """True where any visible sphere blocks the segment."""
    org, d, tmin, tmax = map(jax.lax.stop_gradient, (org, d, tmin, tmax))
    n = org.shape[0]
    tmin = jnp.broadcast_to(tmin, (n,)).astype(jnp.float32)
    tmax = jnp.broadcast_to(tmax, (n,)).astype(jnp.float32)
    if n > _CHUNK:
        return jnp.concatenate(
            [sphere_any(tables, org[i:i + _CHUNK], d[i:i + _CHUNK],
                        tmin[i:i + _CHUNK], tmax[i:i + _CHUNK], mask_bit)
             for i in range(0, n, _CHUNK)])
    tc = _hits(tables, org, d, tmin, tmax, mask_bit)
    return jnp.any(jnp.isfinite(tc), axis=1)


def sphere_area(radius):
    return 4.0 * np.pi * float(radius) ** 2
