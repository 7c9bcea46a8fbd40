"""Denoiser — edge-avoiding À-Trous wavelet filter (Dammertz et al. 2010).

The reference hooks OpenImageDenoise as an optional external post-pass fed
by the infobuffer AOVs (src/runtime/extra/oidn.cpp, Device.cpp:1604-1607).
External NN denoisers don't exist on this stack, so the equivalent here is
a native JAX implementation of the standard edge-avoiding à-trous filter:
iterative 5x5 B3-spline convolutions with exponentially growing taps, with
per-pixel weights from radiance, normal and depth differences — the same
guide signals OIDN consumes (albedo modulation included).

All ops are dense 2D stencils — ideal XLA work (fused gather-free
rolls), no Python loops over pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# 5-tap B3 spline kernel
_B3 = jnp.asarray([1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16],
                  jnp.float32)


def _shift2(img, dy, dx):
    """Clamp-to-edge shift of an (H, W, C) image."""
    h, w = img.shape[0], img.shape[1]
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


def atrous_denoise(color, normals=None, depth=None, albedo=None,
                   iterations=4, sigma_color=0.45, sigma_normal=0.25,
                   sigma_depth=0.5):
    """Denoise an (H, W, 3) radiance image.

    normals (H, W, 3), depth (H, W), albedo (H, W, 3) are optional guides
    (from the infobuffer technique).  If albedo is given the filter runs on
    the demodulated irradiance (color/albedo) and remodulates at the end,
    preserving texture detail like OIDN's albedo input.
    """
    color = jnp.asarray(color, jnp.float32)
    out = color
    if albedo is not None:
        alb = jnp.maximum(jnp.asarray(albedo, jnp.float32), 1e-3)
        out = out / alb
    if depth is not None:
        d = jnp.asarray(depth, jnp.float32)
        dscale = jnp.maximum(jnp.max(d) - jnp.min(d), 1e-6)
        depth_n = (d - jnp.min(d)) / dscale
    for it in range(iterations):
        step = 1 << it
        acc = jnp.zeros_like(out)
        wacc = jnp.zeros(out.shape[:2] + (1,), jnp.float32)
        for iy in range(5):
            for ix in range(5):
                dy = (iy - 2) * step
                dx = (ix - 2) * step
                k = float(_B3[iy] * _B3[ix])
                q = _shift2(out, dy, dx)
                w = k * jnp.ones(out.shape[:2], jnp.float32)
                dc = jnp.sum((q - out) ** 2, axis=-1)
                w = w * jnp.exp(-dc / (sigma_color * sigma_color
                                       * float(step)))
                if normals is not None:
                    qn = _shift2(normals, dy, dx)
                    dn = jnp.sum((qn - normals) ** 2, axis=-1)
                    w = w * jnp.exp(-dn / (sigma_normal * sigma_normal))
                if depth is not None:
                    qd = _shift2(depth_n[..., None], dy, dx)[..., 0]
                    dd = (qd - depth_n) ** 2
                    w = w * jnp.exp(-dd / (sigma_depth * sigma_depth))
                acc = acc + q * w[..., None]
                wacc = wacc + w[..., None]
        out = acc / jnp.maximum(wacc, 1e-8)
    if albedo is not None:
        out = out * alb
    return out


def denoise_runtime(rt, iterations=4):
    """Denoise a Runtime's current frame using its own infobuffer AOVs
    (the Device::render post-pass hook, Device.cpp:1604-1607)."""
    import numpy as np

    from ignis_jax.render.techniques import infobuffer_aovs
    w, h = rt.scene.width, rt.scene.height
    idx = np.arange(w * h, dtype=np.int32)
    x = jnp.asarray(idx % w)
    y = jnp.asarray(idx // w)
    aovs = infobuffer_aovs(rt.scene, rt.tables, x, y, jnp.uint32(0),
                           jnp.uint32(0), jnp.uint32(0), rt.seed)
    img = jnp.asarray(rt.currentFrame())
    return np.asarray(atrous_denoise(
        img,
        normals=aovs["Normals"].reshape(h, w, 3),
        depth=aovs["Depth"].reshape(h, w),
        albedo=aovs["Albedo"].reshape(h, w, 3),
        iterations=iterations))
