"""Batched texture evaluation (src/artic/texture/*.art).

`eval_texture_stack` dispatches per-lane texture ids over the scene's static
texture list with masked branches — the trace-time analog of the reference's
per-closure Texture lambdas.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ignis_jax.core.vec import matmul
from ignis_jax.texture.loader import (
    FILTER_BICUBIC, FILTER_BILINEAR, FILTER_NEAREST, TEX_BRICK,
    TEX_CHECKERBOARD, TEX_EXPR, TEX_IMAGE, TEX_NOISE, WRAP_CLAMP,
    WRAP_MIRROR, WRAP_REPEAT,
)


def _wrap(x, w, mode):
    if mode == WRAP_REPEAT:
        t = x % w
        return jnp.where(t < 0, t + w, t)
    if mode == WRAP_MIRROR:
        t = jnp.where(x < 0, -1 - x, x)
        i = t // w
        k = t - i * w
        return jnp.where((i & 1) == 0, w - 1 - k, k)
    return jnp.clip(x, 0, w - 1)


def _sample_image(img, uv, filt, wrap_u, wrap_v):
    h, w = img.shape[0], img.shape[1]
    if filt == FILTER_NEAREST:
        ix = jnp.floor(uv[..., 0] * w).astype(jnp.int32)
        iy = jnp.floor(uv[..., 1] * h).astype(jnp.int32)
        return img[_wrap(iy, h, wrap_v), _wrap(ix, w, wrap_u)]
    # bilinear (bicubic falls back to bilinear for now; TODO b-spline filter)
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    fx = (u - jnp.floor(u))[..., None]
    fy = (v - jnp.floor(v))[..., None]
    x0 = _wrap(ix, w, wrap_u)
    x1 = _wrap(ix + 1, w, wrap_u)
    y0 = _wrap(iy, h, wrap_v)
    y1 = _wrap(iy + 1, h, wrap_v)
    p00 = img[y0, x0]
    p10 = img[y0, x1]
    p01 = img[y1, x0]
    p11 = img[y1, x1]
    return ((p00 * (1 - fx) + p10 * fx) * (1 - fy)
            + (p01 * (1 - fx) + p11 * fx) * fy)


def _wrapf(x, lo, hi):
    """math::wrap for floats."""
    d = hi - lo
    t = (x - lo) % d
    return jnp.where(t < 0, t + d, t) + lo


def _checkerboard(scene, tables, tex, uv, ctx=None):
    def _dyn(key, const, color=False):
        """Constant or PExpr-string property (registry params etc.)."""
        ref = tex.get(key + "_ref")
        if ref is None:
            return jnp.asarray(const)
        from ignis_jax.texture.pexpr import eval_pexpr
        kind, val = eval_pexpr(scene, tables, ref,
                               {"uv": uv} if ctx is None else ctx)
        val = jnp.asarray(val, jnp.float32)
        if color:
            if kind in ("num", "int", "bool"):
                val = val[..., None] * jnp.ones((3,), jnp.float32)
            elif kind == "vec4":
                val = val[..., :3]
            elif kind == "vec2":
                val = jnp.concatenate(
                    [val, jnp.zeros(val.shape[:-1] + (1,), jnp.float32)], -1)
        return val

    m = jnp.asarray(tex["transform"])
    uv2 = matmul(uv, m[:, :2].T) + m[:, 2]
    sx = jnp.asarray(_dyn("scale_x", tex["scale"][0]), jnp.float32)
    sy = jnp.asarray(_dyn("scale_y", tex["scale"][1]), jnp.float32)
    suv = uv2 * jnp.stack(jnp.broadcast_arrays(sx, sy), axis=-1)
    px = (_wrapf(suv[..., 0], 0.0, 2.0).astype(jnp.int32) % 2) == 0
    py = (_wrapf(suv[..., 1], 0.0, 2.0).astype(jnp.int32) % 2) == 0
    sel = px ^ py
    return jnp.where(sel[..., None], _dyn("color0", tex["color0"], True),
                     _dyn("color1", tex["color1"], True))


def _brick(tex, uv):
    """texture/brick.art: running-bond bricks; body -> color1, gap -> color0
    (note step(edge=x, 1-gap): body when x <= 1-gap)."""
    m = jnp.asarray(tex["transform"])
    uv2 = matmul(uv, m[:, :2].T) + m[:, 2]
    suv = uv2 * jnp.asarray(tex["scale"])
    gx, gy = float(tex["gap"][0]), float(tex["gap"][1])
    fy = suv[..., 1] * 0.5 - jnp.floor(suv[..., 1] * 0.5)
    xs = jnp.where(fy > 0.5, suv[..., 0] + 0.5, suv[..., 0])
    x = xs - jnp.floor(xs)
    y = suv[..., 1] - jnp.floor(suv[..., 1])
    bx = jnp.where(1.0 - gx < x, 0.0, 1.0)
    by = jnp.where(1.0 - gy < y, 0.0, 1.0)
    k = (bx * by)[..., None]
    c0 = jnp.asarray(tex["color0"])
    c1 = jnp.asarray(tex["color1"])
    return c0 * (1.0 - k) + c1 * k


def _hash2(ix, iy, seed):
    h = (ix * jnp.uint32(0x85EBCA6B)) ^ (iy * jnp.uint32(0xC2B2AE35)) ^ jnp.uint32(seed)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0x27D4EB2F)
    h = h ^ (h >> 15)
    return h


def _noise2(p, seed):
    """Value noise with smooth interpolation (texture/noise.art analog)."""
    ix = jnp.floor(p[..., 0]).astype(jnp.int32).astype(jnp.uint32)
    iy = jnp.floor(p[..., 1]).astype(jnp.int32).astype(jnp.uint32)
    fx = p[..., 0] - jnp.floor(p[..., 0])
    fy = p[..., 1] - jnp.floor(p[..., 1])

    def val(dx, dy):
        h = _hash2(ix + jnp.uint32(dx), iy + jnp.uint32(dy), seed)
        return (h & jnp.uint32(0xFFFFFF)).astype(jnp.float32) / jnp.float32(0x1000000)

    sx = fx * fx * (3.0 - 2.0 * fx)
    sy = fy * fy * (3.0 - 2.0 * fy)
    a = val(0, 0) * (1 - sx) + val(1, 0) * sx
    b = val(0, 1) * (1 - sx) + val(1, 1) * sx
    return a * (1 - sy) + b * sy


def _noise(tex, uv):
    p = uv * jnp.asarray([tex["scale_x"], tex["scale_y"]], jnp.float32)
    variant = tex["variant"]
    seed = tex["seed"]
    if variant in ("fbm",):
        v = jnp.zeros(uv.shape[:-1], jnp.float32)
        amp, freq = 0.5, 1.0
        for o in range(4):
            v = v + amp * _noise2(p * freq, seed + o)
            amp *= 0.5
            freq *= 2.0
    elif variant in ("cellnoise", "voronoi"):
        ix = jnp.floor(p[..., 0]).astype(jnp.int32).astype(jnp.uint32)
        iy = jnp.floor(p[..., 1]).astype(jnp.int32).astype(jnp.uint32)
        h = _hash2(ix, iy, seed)
        v = (h & jnp.uint32(0xFFFFFF)).astype(jnp.float32) / jnp.float32(0x1000000)
    else:  # noise / perlin / pnoise → smooth value noise
        v = _noise2(p, seed)
    return jnp.asarray(tex["color"]) * v[..., None]


def eval_one(scene, tables, tex, uv, ctx=None):
    t = tex["type"]
    if t == TEX_IMAGE:
        m = jnp.asarray(tex["transform"])
        uv2 = matmul(uv, m[:, :2].T) + m[:, 2]
        return _sample_image(tables[tex["img_key"]], uv2, tex["filter"],
                             tex["wrap_u"], tex["wrap_v"])
    if t == TEX_CHECKERBOARD:
        return _checkerboard(scene, tables, tex, uv, ctx)
    if t == TEX_NOISE:
        return _noise(tex, uv)
    if t == TEX_BRICK:
        return _brick(tex, uv)
    if t == TEX_EXPR:
        from ignis_jax.texture.pexpr import eval_pexpr_color
        return eval_pexpr_color(scene, tables, tex["expr"], uv, ctx)
    return jnp.broadcast_to(jnp.float32([1, 0, 1]), uv.shape[:-1] + (3,))


def eval_texture_stack(scene, tables, tex_id, uv, ctx=None):
    """Per-lane texture eval: tex_id (N,) int32 (-1 = none → black)."""
    out = jnp.zeros(uv.shape[:-1] + (3,), jnp.float32)
    for i, tex in enumerate(scene.textures):
        m = tex_id == i
        if tex.get("_unused", False):
            continue
        v = eval_one(scene, tables, tex, uv, ctx)
        out = jnp.where(m[..., None], v, out)
    return out


def resolve_color(scene, tables, const_colors, tex_ids, uv, ctx=None):
    """Constant-or-texture color resolution (ShadingTree.addColor analog).

    const_colors: (N, 3); tex_ids: (N,) — lanes with id >= 0 take the texture.
    """
    if not scene.textures:
        return const_colors
    tex = eval_texture_stack(scene, tables, tex_ids, uv, ctx)
    return jnp.where((tex_ids >= 0)[..., None], tex, const_colors)
