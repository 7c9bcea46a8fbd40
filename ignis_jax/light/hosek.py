"""Hosek-Wilkie sky radiance model (RGB variant), host-side bake.

Re-implements the published model "An Analytic Model for Full Spectral
Sky-Dome Radiance" (Hosek & Wilkie 2012) as used by the reference's
src/runtime/skysun/SkyModel.cpp: the sky is evaluated on an azimuth x
elevation grid and baked into an equirect-style environment image, which the
renderer then treats as a textured environment light with a 2D sampling CDF
(src/runtime/light/SkyLight.cpp:30-75, premultiplySin=true,
compensate=false).

The numeric dataset (ignis_jax/data/hosek_rgb.npz) is the authors' published
RGB coefficient table, reshaped to [channel][albedo][turbidity][ctrl][coef].
Coefficient cooking follows the published quintic-Bezier interpolation in
solar elevation with bilinear turbidity/albedo blending
(model/ArHosekSkyModel.cpp:147-233).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

RES_AZ = 512
RES_EL = 256

_DATA = None


def _data():
    global _DATA
    if _DATA is None:
        _DATA = np.load(Path(__file__).parent.parent / "data/hosek_rgb.npz")
    return _DATA


def _bezier5(ctrl, t, axis=1):
    """Quintic Bezier over the 6 elevation control points along `axis`."""
    s = 1.0 - t
    w = np.asarray([s ** 5, 5 * s ** 4 * t, 10 * s ** 3 * t ** 2,
                    10 * s ** 2 * t ** 3, 5 * s * t ** 4, t ** 5])
    return np.tensordot(w, np.moveaxis(ctrl, axis, 0), axes=(0, 0))


def cook_state(turbidity: float, albedo, solar_elevation: float):
    """(configs (3,9), radiances (3,)) for the given conditions.

    Mirrors ArHosekSkyModel_CookConfiguration /
    CookRadianceConfiguration: bilinear in (turbidity, albedo), quintic
    Bezier in normalized elevation^(1/3)."""
    d = _data()
    cfg = d["config"]   # (3, 2, 10, 6, 9)
    rad = d["radiance"]  # (3, 2, 10, 6)
    albedo = np.broadcast_to(np.asarray(albedo, np.float64), (3,))

    t_int = int(turbidity)
    t_int = min(max(t_int, 1), 10)
    t_rem = turbidity - t_int
    te = (max(solar_elevation, 0.0) / (math.pi / 2.0)) ** (1.0 / 3.0)

    def blend(tab):  # tab: (3, 2, 10, 6, ...) -> (3, ...)
        a0_lo = _bezier5(tab[:, 0, t_int - 1], te)
        a1_lo = _bezier5(tab[:, 1, t_int - 1], te)
        alb = albedo.reshape((3,) + (1,) * (a0_lo.ndim - 1))
        res = (1 - alb) * (1 - t_rem) * a0_lo + alb * (1 - t_rem) * a1_lo
        if t_int < 10:
            a0_hi = _bezier5(tab[:, 0, t_int], te)
            a1_hi = _bezier5(tab[:, 1, t_int], te)
            res = res + (1 - alb) * t_rem * a0_hi + alb * t_rem * a1_hi
        return res

    return blend(cfg), blend(rad)


def radiance(configs, radiances, theta, gamma):
    """ArHosekSkyModel_GetRadianceInternal x radiance scale, vectorized.

    theta: zenith angle of the viewing ray; gamma: angle to the sun.
    Returns (..., 3)."""
    theta = np.asarray(theta, np.float64)[..., None]
    gamma = np.asarray(gamma, np.float64)[..., None]
    cfg = configs[None, ...] if configs.ndim == 2 else configs
    A, B, C, D, E = (cfg[..., i] for i in range(5))
    F, G, H, I = (cfg[..., i] for i in range(5, 9))
    cg = np.cos(gamma)
    ct = np.cos(theta)
    exp_m = np.exp(E * gamma)
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / np.power(1.0 + H * H - 2.0 * H * cg, 1.5)
    zenith = np.sqrt(np.maximum(ct, 0.0))
    v = ((1.0 + A * np.exp(B / (ct + 0.01)))
         * (C + D * exp_m + F * ray_m + G * mie_m + I * zenith))
    return v * radiances


def bake_sky_image(ground_albedo, elevation: float, azimuth: float,
                   turbidity: float = 3.0, res_az: int = RES_AZ,
                   res_el: int = RES_EL) -> np.ndarray:
    """SkyModel::SkyModel (SkyModel.cpp:9-55): bake (res_el, res_az, 3)."""
    # NOTE: SkyModel.cpp:13 feeds Pi2 - ea.Elevation (the solar *zenith*
    # angle) into the Hosek state init and the gamma computation alike; we
    # reproduce that exact behavior for image parity.
    solar_zenith = math.pi / 2 - elevation
    sun_se = math.sin(solar_zenith)
    sun_ce = math.cos(solar_zenith)

    configs, rads = cook_state(turbidity, np.asarray(ground_albedo,
                                                     np.float64),
                               solar_zenith)

    ys = np.arange(res_el)
    xs = np.arange(res_az)
    theta = (math.pi / 2) * ys / res_el               # ELEVATION_RANGE * y/N
    az = (2 * math.pi) * xs / res_az - math.pi / 4    # AZIMUTH_RANGE*x/N - Pi4
    az = np.where(az < 0, az + 2 * math.pi, az)
    st, ct = np.sin(theta), np.cos(theta)
    cos_gamma = (ct[:, None] * sun_ce
                 + st[:, None] * sun_se * np.cos(az[None, :] - azimuth))
    gamma = np.arccos(np.clip(cos_gamma, -1.0, 1.0))
    theta2 = np.broadcast_to(theta[:, None], gamma.shape)

    cie_y_sum = 106.856980
    img = radiance(configs, rads, theta2, gamma) / cie_y_sum
    return np.maximum(img, 0.0).astype(np.float32)
