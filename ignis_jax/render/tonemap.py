"""Tonemapping + image info ops (entrypoints/tonemap.art, imageinfo.art).

Batched jnp versions of the reference operators: luminance-domain mapping in
xyY with NaN/Inf/negative false-coloring, and the on-device image statistics
(min/max/avg/median/soft-percentile/histogram/NaN counts) used by igview's
inspector and auto-exposure.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import matmul

TONEMAP_NONE = 0
TONEMAP_REINHARD = 1
TONEMAP_REINHARD_MODIFIED = 2
TONEMAP_ACES = 3
TONEMAP_UNCHARTED2 = 4

_FLT_EPS = 1.1920928955078125e-07


def srgb_to_xyz(c):
    m = jnp.asarray([[0.4124564, 0.3575761, 0.1804375],
                     [0.2126729, 0.7151522, 0.0721750],
                     [0.0193339, 0.1191920, 0.9503041]], jnp.float32)
    return matmul(c, m.T)


def xyz_to_srgb(c):
    m = jnp.asarray([[3.2404542, -1.5371385, -0.4985314],
                     [-0.9692660, 1.8760108, 0.0415560],
                     [0.0556434, -0.2040259, 1.0572252]], jnp.float32)
    return matmul(c, m.T)


def srgb_to_xyY(c):
    s = srgb_to_xyz(c)
    n = jnp.sum(s, axis=-1, keepdims=True)
    safe = jnp.maximum(n, _FLT_EPS)
    xy = s[..., :2] / safe
    out = jnp.concatenate([xy, s[..., 1:2]], axis=-1)
    return jnp.where(n <= _FLT_EPS, 0.0, out)


def xyY_to_srgb(c):
    x, y, Y = c[..., 0], c[..., 1], c[..., 2]
    safe_y = jnp.maximum(y, _FLT_EPS)
    X = x * Y / safe_y
    Z = (1.0 - x - y) * Y / safe_y
    xyz = jnp.stack([X, Y, Z], axis=-1)
    return jnp.where((y <= _FLT_EPS)[..., None], 0.0, xyz_to_srgb(xyz))


def srgb_gamma(x):
    return jnp.where(x <= 0.0031308, 12.92 * x,
                     1.055 * jnp.power(jnp.maximum(x, 1e-12), 0.416666667) - 0.055)


def srgb_invgamma(x):
    return jnp.where(x <= 0.04045, x / 12.92,
                     (jnp.power(jnp.maximum(x, 0.0), 2.4) + 0.055) / 1.055)


def _reinhard(L):
    return L / (1.0 + L)


def _reinhard_modified(L):
    wp2 = 16.0
    return L * (1.0 + L / wp2) / (1.0 + L)


def _aces(L):
    return jnp.clip(L * (2.51 * L + 0.03) / (L * (2.43 * L + 0.59) + 0.14), 0.0, None)


def _uncharted2(L):
    def f(x):
        a, b, c, d, e, fw = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return (x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * fw) - e / fw
    return f(L) / f(11.2)


def tonemap(image, method=TONEMAP_ACES, scale=1.0, exposure_factor=1.0,
            exposure_offset=0.0, use_gamma=True):
    """(H,W,3) linear → (H,W,3) LDR in [0,1] + false colors for bad pixels."""
    img = jnp.asarray(image, jnp.float32) * scale
    xyY = srgb_to_xyY(img)
    L = exposure_factor * xyY[..., 2] + exposure_offset
    nL = {
        TONEMAP_NONE: lambda l: l,
        TONEMAP_REINHARD: _reinhard,
        TONEMAP_REINHARD_MODIFIED: _reinhard_modified,
        TONEMAP_ACES: _aces,
        TONEMAP_UNCHARTED2: _uncharted2,
    }[method](L)
    color = xyY_to_srgb(jnp.stack([xyY[..., 0], xyY[..., 1], nL], axis=-1))
    if use_gamma:
        color = srgb_gamma(color)
    color = jnp.clip(color, 0.0, 1.0)

    is_nan = jnp.isnan(xyY[..., 2])
    is_inf = ~jnp.isfinite(xyY[..., 2]) & ~is_nan
    is_neg = jnp.any(img < 0.0, axis=-1)
    cyan = jnp.asarray([0.0, 1.0, 1.0], jnp.float32)
    pink = jnp.asarray([1.0, 0.0, 150 / 255], jnp.float32)
    orange = jnp.asarray([1.0, 1.0, 0.0], jnp.float32)
    color = jnp.where(is_neg[..., None], orange, color)
    color = jnp.where(is_inf[..., None], pink, color)
    color = jnp.where(is_nan[..., None], cyan, color)
    return color


def image_info(image, scale=1.0, bins=64, histogram=False,
               percentile=False):
    """min/max/avg luminance + NaN/Inf counts (+ optional extras).

    Mirrors ig_imageinfo_pipeline (entrypoints/imageinfo.art): non-finite
    components are zeroed before the luminance reduce; soft percentiles use
    the same 3x3-window rank-2/rank-8 approximation.
    """
    img = jnp.asarray(image, jnp.float32)
    nan_count = jnp.sum(jnp.any(jnp.isnan(img), axis=-1))
    inf_count = jnp.sum(jnp.any(jnp.isinf(img), axis=-1))
    neg_count = jnp.sum(jnp.any(img < 0, axis=-1))
    safe = jnp.where(jnp.isfinite(img), img, 0.0) * scale
    lum = srgb_to_xyY(safe)[..., 2]
    out = {
        "min": jnp.min(lum), "max": jnp.max(lum), "avg": jnp.mean(lum),
        "nan_count": nan_count, "inf_count": inf_count, "neg_count": neg_count,
    }
    if percentile and lum.ndim == 2 and lum.shape[0] > 10 and lum.shape[1] > 10:
        # 3x3 window rank statistics, interior pixels only
        windows = jnp.stack([lum[1 + di:lum.shape[0] - 1 + di,
                                 1 + dj:lum.shape[1] - 1 + dj]
                             for di in (-1, 0, 1) for dj in (-1, 0, 1)], axis=-1)
        s = jnp.sort(windows, axis=-1)
        out["soft_min"] = jnp.min(s[..., 1])
        out["soft_max"] = jnp.max(s[..., 7])
        out["median"] = jnp.mean(s[..., 4])
    if histogram:
        lo, hi = out["min"], jnp.maximum(out["max"], out["min"] + 1e-20)
        idx = jnp.clip(((lum - lo) / (hi - lo) * bins).astype(jnp.int32), 0, bins - 1)
        out["histogram"] = jnp.zeros(bins, jnp.int32).at[idx.reshape(-1)].add(1)
    return out
