"""Glare / DGP (daylight glare probability) analysis.

Counterpart of the thesis's glare pipeline
(src/artic/entrypoints/glare.art:1-242, host API
src/runtime/Runtime.cpp:640-652, structs src/runtime/RuntimeStructs.h:15-30).
Where the reference runs five sequential device-side parallel reductions over
the framebuffer, this build computes every per-pixel quantity (luminance,
solid angle, cos factor, glare mask) as one fused vectorized pass and lets
XLA do the reductions.

Semantics mirrored from glare.art:
  * luminance in Lux = white_efficiency(=179, core/color.art:73) * Y of the
    sRGB pixel scaled by `scale`.
  * a pixel is a glare source when its luminance exceeds avg*mul*179.
  * per-pixel solid angle = spherical excess of the quad spanned by the four
    corner camera rays (glare.art calc_omega, adapted from Radiance
    pict_get_omega).
  * position index: Guth model above the line of sight, Iwata model below,
    clamped to 16 (glare.art calc_posindex).
  * DGP = c1*E_v + c2*log10(1 + Ls^2*omega / (P^2 * E_v^1.87)) + c3
    with c1=5.87e-5, c2=0.0981, c3=0.16.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import matmul
from ignis_jax.render.camera import generate_rays, pixel_coord_from_xy
from ignis_jax.render.tonemap import srgb_to_xyY

WHITE_EFFICIENCY = 179.0  # core/color.art:73, standard illuminant E


@dataclass
class GlareSettings:
    """RuntimeStructs.h:15-22 (minus the AOV name, which the caller resolves)."""
    max: float = 1.0
    avg: float = 0.0
    mul: float = 6.0
    scale: float = 1.0
    vertical_illuminance: float = -1.0  # <0 → computed from the image


@dataclass
class GlareOutput:
    """RuntimeStructs.h:24-30."""
    dgp: float
    vertical_illuminance: float
    avg_lum: float
    avg_omega: float
    num_pixels: int


def _inferno(t):
    """Polynomial fit of matplotlib's inferno colormap (heatmap of
    glare.art:214-223 uses colormap::inferno)."""
    t = jnp.clip(t, 0.0, 1.0)[..., None]
    c0 = jnp.asarray([0.0002189403, 0.001651004, -0.01948089], jnp.float32)
    c1 = jnp.asarray([0.1065134, 0.5639564, 3.932712], jnp.float32)
    c2 = jnp.asarray([11.60249, -3.972853, -15.9424], jnp.float32)
    c3 = jnp.asarray([-41.70399, 17.43639, 44.35414], jnp.float32)
    c4 = jnp.asarray([77.16293, -33.40235, -81.80731], jnp.float32)
    c5 = jnp.asarray([-71.31942, 32.62606, 73.20951], jnp.float32)
    c6 = jnp.asarray([25.13112, -12.24266, -23.07032], jnp.float32)
    r = c0 + t * (c1 + t * (c2 + t * (c3 + t * (c4 + t * (c5 + t * c6)))))
    return jnp.clip(r, 0.0, 1.0)


def _corner_dirs(cam, w, h):
    """Ray directions on the (w+1)x(h+1) pixel-corner grid (sx=sy=0 offsets,
    matching glare.art's make_pixelcoord_from_xy(..., 0, 0) calls)."""
    xs = jnp.arange(w + 1, dtype=jnp.float32)
    ys = jnp.arange(h + 1, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
    nx, ny = pixel_coord_from_xy(gx.reshape(-1), gy.reshape(-1), w, h, 0.0, 0.0)
    _, dirs, _, _ = generate_rays(cam, nx, ny)
    return dirs.reshape(h + 1, w + 1, 3)


def pixel_solid_angles(cam, w, h):
    """Per-pixel solid angle via spherical excess (glare.art calc_omega)."""
    d = _corner_dirs(cam, w, h)
    r1 = d[:-1, :-1]   # (x,   y)
    r2 = d[1:, :-1]    # (x,   y+1)
    r3 = d[1:, 1:]     # (x+1, y+1)
    r4 = d[:-1, 1:]    # (x+1, y)

    def splane(a, b):
        n = jnp.cross(a, b - a)
        l2 = jnp.sum(n * n, axis=-1, keepdims=True)
        return jnp.where(l2 > 0, n / jnp.sqrt(jnp.maximum(l2, 1e-30)), 0.0)

    n1, n2, n3, n4 = splane(r1, r2), splane(r2, r3), splane(r3, r4), splane(r4, r1)

    def ang(a, b):
        dot = jnp.clip(jnp.sum(a * b, axis=-1), -1.0, 1.0)
        return jnp.pi - jnp.abs(jnp.arccos(dot))

    return ang(n1, n2) + ang(n2, n3) + ang(n3, n4) + ang(n4, n1) - 2.0 * jnp.pi


def _position_index(cam, dir):
    """Guth position index (Iwata below sightline) for one view ray —
    glare.art calc_posindex."""
    up = jnp.asarray(cam.up, jnp.float32)
    d = jnp.asarray(cam.dir, jnp.float32)
    right = jnp.cross(d, up)
    right = right / jnp.maximum(jnp.linalg.norm(right), 1e-20)

    vangle = jnp.arccos(jnp.clip(jnp.dot(up, dir), -1.0, 1.0)) - jnp.pi / 2.0
    hangle = jnp.pi / 2.0 - jnp.arccos(jnp.clip(jnp.dot(right, dir), -1.0, 1.0))
    sigma = jnp.arccos(jnp.clip(jnp.dot(d, dir), -1.0, 1.0))

    t = jnp.cos(sigma)
    hv = dir / jnp.where(jnp.abs(t) < 1e-6, 1e-6, t) - dir
    hv = hv / jnp.maximum(jnp.linalg.norm(hv), 1e-20)
    tau = jnp.arccos(jnp.clip(jnp.dot(up, hv), -1.0, 1.0))

    deg = 180.0 / jnp.pi
    phi = jnp.where(vangle == 0.0, 1e-5, vangle)
    theta = jnp.where(hangle == 0.0, 1e-4, hangle)
    sigma = jnp.abs(sigma)
    tau_d = tau * deg
    sig_d = sigma * deg

    guth = jnp.exp(
        (35.2 - 0.31889 * tau_d - 1.22 * jnp.exp(-2.0 * tau_d / 9.0)) / 1000.0
        * sig_d
        + (21.0 + 0.26667 * tau_d - 0.002963 * tau_d * tau_d) / 100000.0
        * sig_d * sig_d)

    # Iwata model below line of sight
    dd = 1.0 / jnp.tan(phi)
    s = jnp.tan(theta) / jnp.tan(phi)
    r = jnp.sqrt(1.0 / (dd * dd) + s * s / (dd * dd))
    fact = jnp.where(r > 0.6, 1.2, 0.8)
    r = jnp.minimum(r, 3.0)
    iwata = 1.0 + fact * r

    return jnp.minimum(jnp.where(phi < 0.0, iwata, guth), 16.0)


def evaluate_glare(cam, image, settings: GlareSettings):
    """Evaluate DGP on a rendered (normalized, linear sRGB) HxWx3 image.

    Returns (GlareOutput-fields dict of traced scalars, heatmap HxWx3 float
    colors, glare-source mask HxW bool).  Pure jnp — jittable and usable
    under vmap for parameter sweeps; `Runtime.evaluateGlare` wraps it with
    concrete outputs.
    """
    h, w = image.shape[0], image.shape[1]
    img = jnp.where(jnp.isfinite(image), image, 0.0)
    lum = WHITE_EFFICIENCY * srgb_to_xyY(img * settings.scale)[..., 2]

    lum_max = WHITE_EFFICIENCY * settings.max
    lum_source = WHITE_EFFICIENCY * (settings.avg * settings.mul)

    omega = pixel_solid_angles(cam, w, h)

    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys, indexing="xy")
    nx, ny = pixel_coord_from_xy(gx.reshape(-1), gy.reshape(-1), w, h, 0.0, 0.0)
    _, dirs, _, _ = generate_rays(cam, nx, ny)
    dirs = dirs.reshape(h, w, 3)
    cam_dir = jnp.asarray(cam.dir, jnp.float32)
    cos_f = jnp.abs(matmul(dirs, cam_dir))

    if settings.vertical_illuminance < 0:
        e_v = jnp.sum(lum * cos_f * omega)
    else:
        e_v = jnp.float32(settings.vertical_illuminance)

    mask = lum > lum_source
    num_pixels = jnp.sum(mask.astype(jnp.int32))
    glare_omega = jnp.sum(jnp.where(mask, omega, 0.0))
    safe_go = jnp.maximum(glare_omega, 1e-20)
    glare_lum = jnp.sum(jnp.where(mask, lum * omega, 0.0)) / safe_go
    glare_x = jnp.sum(jnp.where(mask, gx * omega, 0.0)) / safe_go
    glare_y = jnp.sum(jnp.where(mask, gy * omega, 0.0)) / safe_go

    # position index at the omega-weighted glare centroid (glare.art:227)
    cnx, cny = pixel_coord_from_xy(jnp.floor(glare_x), jnp.floor(glare_y),
                                   w, h, 0.0, 0.0)
    _, cdir, _, _ = generate_rays(cam, cnx[None], cny[None])
    posi = _position_index(cam, cdir[0])

    c1, c2, c3 = 5.87e-5, 0.0981, 0.16
    a1, a2, a3, a4, a5 = 2.0, 1.0, 1.87, 2.0, 1.0
    safe_ev = jnp.maximum(e_v, 1e-20)
    dgp_acc = (jnp.power(glare_lum, a1) / jnp.power(posi, a4)
               * jnp.power(glare_omega, a2) / jnp.power(safe_ev, a3))
    source_dgp = jnp.log10(1.0 + dgp_acc)
    dgp = jnp.where(glare_omega > 0,
                    c1 * jnp.power(safe_ev, a5) + c2 * source_dgp + c3,
                    c1 * jnp.power(safe_ev, a5) + c3)

    # heatmap: inferno ramp on squared relative overshoot (glare.art:214-223)
    max_diff = jnp.maximum(1.1920929e-07, lum_max - lum_source)
    lerp = (lum - lum_source) / max_diff
    heat = _inferno(jnp.clip(lerp * lerp, 0.0, 1.0))

    out = {
        "dgp": dgp,
        "vertical_illuminance": e_v,
        "avg_lum": glare_lum,
        "avg_omega": glare_omega,
        "num_pixels": num_pixels,
    }
    return out, heat, mask


def evaluate_glare_host(cam, image, settings: GlareSettings):
    """Concrete-output wrapper: returns (GlareOutput, heatmap np HxWx3,
    mask np HxW)."""
    out, heat, mask = evaluate_glare(cam, jnp.asarray(image, jnp.float32),
                                     settings)
    return (
        GlareOutput(
            dgp=float(out["dgp"]),
            vertical_illuminance=float(out["vertical_illuminance"]),
            avg_lum=float(out["avg_lum"]),
            avg_omega=float(out["avg_omega"]),
            num_pixels=int(out["num_pixels"]),
        ),
        np.asarray(heat),
        np.asarray(mask),
    )
