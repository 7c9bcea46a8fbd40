"""Pixel samplers (src/artic/sampler/pixel_sampler.art).

independent (uniform), mjitt (4x4 correlated multi-jitter) and halton
(per-pixel scrambled radical inverse).  All are batched over pixel lanes;
the halton per-pixel offset table is precomputed host-side per film size
(setup_halton_pixel_sampler, pixel_sampler.art:92-150).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ignis_jax.core import rng

_F1 = np.uint32(0xA511E9B3)
_F2 = np.uint32(0x63D83595)


def _permute_element(i, l, seed):
    """Correlated permutation (core/common.art:184-219), vectorized with a
    masked rejection loop."""
    import jax
    i = i.astype(jnp.uint32)
    l = jnp.uint32(l)
    seed = seed.astype(jnp.uint32)
    w = l - jnp.uint32(1)
    if int(l) - 1 == 0:
        return jnp.zeros_like(i)
    wv = int(l) - 1
    for shift in (1, 2, 4, 8, 16):
        wv |= wv >> shift
    w = jnp.uint32(wv)

    def round_fn(ii):
        ii = ii ^ seed
        ii = ii * jnp.uint32(0xE170893D)
        ii = ii ^ (seed >> 16)
        ii = ii ^ ((ii & w) >> 4)
        ii = ii ^ (seed >> 8)
        ii = ii * jnp.uint32(0x0929EB3F)
        ii = ii ^ (seed >> 23)
        ii = ii ^ ((ii & w) >> 1)
        ii = ii * (jnp.uint32(1) | (seed >> 27))
        ii = ii * jnp.uint32(0x6935FA69)
        ii = ii ^ ((ii & w) >> 11)
        ii = ii * jnp.uint32(0x74DCB303)
        ii = ii ^ ((ii & w) >> 2)
        ii = ii * jnp.uint32(0x9E501CC3)
        ii = ii ^ ((ii & w) >> 2)
        ii = ii * jnp.uint32(0xC860A3DF)
        ii = ii & w
        ii = ii ^ (ii >> 5)
        return ii

    def cond(state):
        cur, pending = state
        return jnp.any(pending)

    def body(state):
        cur, pending = state
        nxt = round_fn(cur)
        cur = jnp.where(pending, nxt, cur)
        pending = pending & (cur >= l)
        return cur, pending

    cur, _ = jax.lax.while_loop(cond, body,
                                (i, jnp.ones(i.shape, bool)))
    return (cur + seed) % l


def sample_mjitt(seed, counter, index, x, y, bins=(4, 4)):
    """make_mjitt_pixel_sampler (pixel_sampler.art:14-33); 2 rnd draws."""
    bx, by = bins
    h = rng.hash_combine(rng.hash_combine(rng.hash_init(), x.astype(jnp.uint32)),
                         y.astype(jnp.uint32))
    idx = index.astype(jnp.uint32)
    sx = _permute_element(idx % jnp.uint32(bx), bx, h * _F1).astype(jnp.float32)
    sy = _permute_element(idx // jnp.uint32(bx), by, h * _F2).astype(jnp.float32)
    jx, counter = rng.next_f32(seed, counter)
    jy, counter = rng.next_f32(seed, counter)
    rx = (sx + (sy + jx) / by) / bx
    ry = (sy + (sx + jy) / bx) / by
    return rx, ry, counter


# ------------------------------------------------------------------- halton

def _radical_inverse_np(index, base):
    inv_base = 1.0 / base
    inv_base_n = 1.0
    rev = 0
    limit = 0xFFFFFFFF // base - base
    while index != 0 and rev < limit:
        nxt = index // base
        digit = index - nxt * base
        rev = rev * base + digit
        inv_base_n *= inv_base
        index = nxt
    return min(rev * inv_base_n, 1.0 - 1.1920929e-07)


def _inverse_radical_inverse(inv, base, digits):
    index = 0
    for _ in range(digits):
        digit = inv % base
        inv //= base
        index = index * base + digit
    return index


def _halton_base_info(dim, base):
    scale, exp = 1, 0
    while scale < dim:
        scale *= base
        exp += 1
    return scale, exp


def _mult_inverse(a, n):
    def egcd(a, b):
        if b == 0:
            return 1, 0
        x, y = egcd(b, a % b)
        return y, x - (a // b) * y
    x, _ = egcd(a, n)
    return x % n


def build_halton_offsets(width, height):
    """Per-pixel halton index offsets (pixel_sampler.art:92-150)."""
    b1, b2 = 2, 3
    sx, ex = _halton_base_info(width, b1)
    sy, ey = _halton_base_info(height, b2)
    mix = _mult_inverse(sx, sy)
    miy = _mult_inverse(sy, sx)
    stride = sx * sy
    out = np.zeros((height, width), np.int64)
    if stride > 1:
        xs = np.array([_inverse_radical_inverse(x, b1, ex)
                       for x in range(width)], np.int64)
        ys = np.array([_inverse_radical_inverse(y, b2, ey)
                       for y in range(height)], np.int64)
        out = ((xs[None, :] * (stride // sx) * mix
                + ys[:, None] * (stride // sy) * miy) % stride)
    return dict(offsets=out.astype(np.int64).reshape(-1),
                base=(b1, b2), base_scale=(sx, sy), base_exponent=(ex, ey),
                stride=stride)


def _radical_inverse_jnp(index, base, iters=32):
    """Vectorized radical inverse with fixed iteration bound."""
    idx = index.astype(jnp.uint32)
    inv_base = jnp.float32(1.0 / base)
    limit = jnp.uint32(0xFFFFFFFF // base - base)
    rev = jnp.zeros(index.shape, jnp.uint32)
    scale = jnp.ones(index.shape, jnp.float32)
    for _ in range(iters if base == 2 else 21):
        active = (idx != 0) & (rev < limit)
        nxt = idx // jnp.uint32(base)
        digit = idx - nxt * jnp.uint32(base)
        rev = jnp.where(active, rev * jnp.uint32(base) + digit, rev)
        scale = jnp.where(active, scale * inv_base, scale)
        idx = jnp.where(active, nxt, idx)
    return jnp.minimum(rev.astype(jnp.float32) * scale,
                       1.0 - jnp.float32(1.1920929e-07))


def sample_halton(setup, offsets, index, x, y, width):
    """make_halton_pixel_sampler (pixel_sampler.art:155-170); 0 rnd draws."""
    lin = y * width + x
    hindex = (offsets[lin] + index.astype(jnp.int64)
              * np.int64(setup["stride"])).astype(jnp.uint32)
    rx = _radical_inverse_jnp(hindex >> setup["base_exponent"][0],
                              setup["base"][0])
    ry = _radical_inverse_jnp(hindex // jnp.uint32(setup["base_scale"][1]),
                              setup["base"][1])
    return rx, ry
