"""Environment-map CDF construction and sampling.

Host build mirrors CDF::computeForImage (src/runtime/CDF.cpp:42-135):
row-conditional CDFs + sin-premultiplied, MIS-compensated marginal.
Device sampling mirrors cdf::make_cdf_2d / make_cdf_1d (core/cdf.art:40-150)
and the textured env light (light/env.art:112-160).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import PI, safe_div, vec3


def build_cdf2d(img: np.ndarray, premultiply_sin=True, compensate=True):
    """img: (H, W, 3) — returns (marginal (H,), conditional (H, W))."""
    h, w = img.shape[0], img.shape[1]
    min_eps = 1e-5
    defect = np.zeros(3, np.float32)
    if compensate:
        defect = np.maximum(img, 0).mean(axis=(0, 1)).astype(np.float32)
    lum = np.maximum(img - defect, 0.0).mean(axis=2)  # (H, W)
    cond = np.cumsum(lum, axis=1)
    row_sum = cond[:, -1].copy()
    good = row_sum > min_eps
    cond = np.where(good[:, None], cond / np.maximum(row_sum[:, None], min_eps),
                    (np.arange(w, dtype=np.float32)[None, :] / (w - 1)))
    cond[:, -1] = 1.0

    marg = row_sum
    if premultiply_sin:
        marg = marg * np.sin(np.pi * (np.arange(h) + 0.5) / h)
    marg = np.cumsum(marg)
    if marg[-1] > min_eps:
        marg = marg / marg[-1]
    else:
        marg = np.arange(h, dtype=np.float32) / (h - 1)
    marg[-1] = 1.0
    return marg.astype(np.float32), cond.astype(np.float32)


def build_sat2d(img: np.ndarray, premultiply_sin=True, compensate=True):
    """Summed-area-table env CDF variant (CDF.cpp:135-193
    computeForImageSAT), selected by `cdf_method: "sat"` on env lights
    (EnvironmentLight.cpp:15).  Returns the normalized (H, W) SAT with
    the reference's exact weighting: sin premultiply per row, the MIS
    compensation defect subtracted per channel, channel-mean / 3."""
    h, w = img.shape[0], img.shape[1]
    min_eps = 1e-5
    defect = np.zeros(3, np.float32)
    if compensate:
        defect = np.maximum(img, 0).mean(axis=(0, 1)).astype(np.float32)
    val = np.maximum(img - defect, 0.0).sum(axis=2) / 3.0
    if premultiply_sin:
        val = val * np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
    sat = np.cumsum(np.cumsum(val, axis=0), axis=1)
    total = sat[-1, -1]
    if total > min_eps:
        sat = sat / total
    else:
        sat = (np.arange(h * w, dtype=np.float64) / (h * w - 1)).reshape(
            h, w)
    sat[-1, -1] = 1.0
    return sat.astype(np.float32)


def sat_to_cdf(sat: np.ndarray):
    """Derive the (marginal, conditional) sampling tables from a SAT —
    the induced distribution is identical (the SAT is just the 2D
    cumulative storage of the same weights), so the existing cdf2d
    sampler/pdf path applies unchanged."""
    h, w = sat.shape
    min_eps = 1e-5
    # per-cell mass via the 4-corner difference, then row cumsums
    cell = np.diff(np.diff(np.pad(sat, ((1, 0), (1, 0))), axis=0), axis=1)
    cell = np.maximum(cell, 0.0)
    cond = np.cumsum(cell, axis=1)
    row_sum = cond[:, -1].copy()
    good = row_sum > min_eps / max(h * w, 1)
    cond = np.where(good[:, None],
                    cond / np.maximum(row_sum[:, None], 1e-20),
                    (np.arange(w, dtype=np.float32)[None, :] / (w - 1)))
    cond[:, -1] = 1.0
    marg = np.cumsum(row_sum)
    if marg[-1] > min_eps:
        marg = marg / marg[-1]
    else:
        marg = np.arange(h, dtype=np.float32) / (h - 1)
    marg[-1] = 1.0
    return marg.astype(np.float32), cond.astype(np.float32)


def _cdf1d_sample(data, u):
    """data: inclusive cumsum [x1..1]; virtual leading 0 (cdf.art:67-70).

    Returns (off, rem, pos, pdf_cont)."""
    size = data.shape[-1]
    off = jnp.clip(jnp.searchsorted(data, u, side="right"), 0, size - 1)
    lo = jnp.where(off == 0, 0.0, data[jnp.maximum(off - 1, 0)])
    pdf = data[off] - lo
    rem = safe_div(u - lo, pdf)
    pos = jnp.clip((off.astype(jnp.float32) + rem) / size, 0.0, 1.0)
    return off, rem, pos, pdf * size


def _cdf1d_sample_rows(data_rows, u):
    """Per-lane row-conditional sampling: data_rows (N, W)."""
    size = data_rows.shape[-1]
    ge = data_rows <= u[..., None]
    off = jnp.clip(jnp.sum(ge.astype(jnp.int32), axis=-1), 0, size - 1)
    lanes = jnp.arange(u.shape[0])
    lo = jnp.where(off == 0, 0.0, data_rows[lanes, jnp.maximum(off - 1, 0)])
    pdf = data_rows[lanes, off] - lo
    rem = safe_div(u - lo, pdf)
    pos = jnp.clip((off.astype(jnp.float32) + rem) / size, 0.0, 1.0)
    return off, rem, pos, pdf * size


def _cdf1d_pdf(data, x):
    size = data.shape[-1]
    off = jnp.clip((x * size).astype(jnp.int32), 0, size - 1)
    lo = jnp.where(off == 0, 0.0, data[jnp.maximum(off - 1, 0)])
    return off, (data[off] - lo) * size


def cdf2d_sample(marginal, conditional, u, v):
    """(x ~ conditional, y ~ marginal) — cdf.art:102-130.

    Returns (pos (N,2), pdf)."""
    yoff, _, ypos, ypdf = _cdf1d_sample(marginal, v)
    rows = conditional[yoff]
    _, _, xpos, xpdf = _cdf1d_sample_rows(rows, u)
    return jnp.stack([xpos, ypos], axis=-1), ypdf * xpdf


def cdf2d_pdf(marginal, conditional, pos):
    yoff, ypdf = _cdf1d_pdf(marginal, pos[..., 1])
    rows = conditional[yoff]
    size = rows.shape[-1]
    xoff = jnp.clip((pos[..., 0] * size).astype(jnp.int32), 0, size - 1)
    lanes = jnp.arange(pos.shape[0])
    lo = jnp.where(xoff == 0, 0.0, rows[lanes, jnp.maximum(xoff - 1, 0)])
    xpdf = (rows[lanes, xoff] - lo) * size
    return ypdf * xpdf


# ---------------------------------------------------------------- mapping

def switch_env_up(v):
    """(x, y, z) ↔ (x, z, y) (light/env.art:13)."""
    return jnp.stack([v[..., 0], v[..., 2], v[..., 1]], axis=-1)


def map_env_uv(d):
    """Z-up dir → uv with (0.5, 0.5) = Y-up (light/env.art:16-22)."""
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    v = theta / PI
    u = phi / (2.0 * PI)
    return jnp.stack([(u + 0.25) % 1.0, 1.0 - v], axis=-1)


def uv_to_dir(pos):
    """Inverse of the sampling map (light/env.art:119-123): Z-up dir."""
    theta = (1.0 - pos[..., 1]) * PI
    phi = (pos[..., 0] - 0.25) * 2.0 * PI
    s = jnp.sin(theta)
    return jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), jnp.cos(theta)],
                     axis=-1)


def sin_theta_of(d):
    return jnp.sqrt(jnp.maximum(1.0 - d[..., 2] * d[..., 2], 0.0))
