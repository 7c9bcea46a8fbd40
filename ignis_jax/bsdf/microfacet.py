"""Batched microfacet distributions (core/microfacet.art).

Implements the reference's default VNDF-GGX distribution (Heitz 2018
sampling, microfacet.art:318-395) plus the classic GGX/Beckmann NDF
samplers, all in the surface's local frame arrays.

Directions here are WORLD-space; the local frame is passed as (t, b, n)
stacked columns.  alpha==0 cases are dispatched statically by the scene
compiler (delta variants live in union.py), so these functions assume
alpha > 1e-4 (check_if_delta_distribution, microfacet.art:295).
"""

from __future__ import annotations

import jax.numpy as jnp

from ignis_jax.core.vec import (
    FLT_EPS, PI, absolute_cos, dot, normalize, positive_cos, safe_div,
    safe_sqrt, to_local, to_world, vec3,
)
from ignis_jax.core.warp import square_to_concentric_disk


def g1_smith(t, b, n, w, alpha_u, alpha_v):
    """Smith masking for GGX (microfacet.art:158-175)."""
    cos_z = dot(n, w)
    cos_x = dot(t, w)
    cos_y = dot(b, w)
    kx = alpha_u * cos_x
    ky = alpha_v * cos_y
    a2 = kx * kx + ky * ky
    k2 = safe_div(a2, cos_z * cos_z)
    denom = 1.0 + jnp.sqrt(1.0 + k2)
    out = jnp.where(a2 <= FLT_EPS, 1.0, 2.0 / denom)
    return jnp.where(jnp.abs(cos_z) <= FLT_EPS, 0.0, out)


def g1_walter(t, b, n, w, alpha_u, alpha_v):
    """Walter's rational-fit masking for Beckmann (microfacet.art:135-156)."""
    cos_z = dot(n, w)
    cos_x = dot(t, w)
    cos_y = dot(b, w)
    kx = alpha_u * cos_x
    ky = alpha_v * cos_y
    k2 = safe_div(kx * kx + ky * ky, cos_z * cos_z)
    a = safe_div(1.0, jnp.sqrt(jnp.maximum(k2, 1e-30)))
    a2 = safe_div(1.0, jnp.maximum(k2, 1e-30))
    fit = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    out = jnp.where(a >= 1.6, 1.0, fit)
    out = jnp.where(k2 <= FLT_EPS, 1.0, out)
    return jnp.where(jnp.abs(cos_z) <= FLT_EPS, 0.0, out)


def ndf_ggx(t, b, n, m, alpha_u, alpha_v):
    cos_z = dot(n, m)
    cos_x = dot(t, m)
    cos_y = dot(b, m)
    kx = cos_x / alpha_u
    ky = cos_y / alpha_v
    k = kx * kx + ky * ky + cos_z * cos_z
    return safe_div(1.0, PI * alpha_u * alpha_v * k * k)


def ndf_beckmann(t, b, n, m, alpha_u, alpha_v):
    cos_z = dot(n, m)
    cos_x = dot(t, m)
    cos_y = dot(b, m)
    kx = cos_x / alpha_u
    ky = cos_y / alpha_v
    k2 = safe_div(kx * kx + ky * ky, cos_z * cos_z)
    return safe_div(jnp.exp(-k2), PI * alpha_u * alpha_v * cos_z ** 4)


def pdf_vndf_ggx(t, b, n, w, h, alpha_u, alpha_v):
    cos_z = absolute_cos(n, w)
    return safe_div(g1_smith(t, b, n, w, alpha_u, alpha_v)
                    * absolute_cos(w, h) * ndf_ggx(t, b, n, h, alpha_u, alpha_v),
                    cos_z)


def _sample_vndf_ggx_11(u0, u1, cos_theta):
    px, py = square_to_concentric_disk(u0, u1)
    s = 0.5 * (1.0 + cos_theta)
    y = (1.0 - s) * safe_sqrt(1.0 - px * px) + s * py
    z = safe_sqrt(1.0 - y * y - px * px)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    norm = safe_div(1.0, sin_theta * y + cos_theta * z)
    return (cos_theta * y - sin_theta * z) * norm, px * norm


def sample_vndf_ggx(u0, u1, t, b, n, w, alpha_u, alpha_v):
    """Heitz VNDF sampling; returns half-vector in world space (2 draws)."""
    vl = to_local(w, t, b, n)
    sl = normalize(vec3(alpha_u * vl[..., 0], alpha_v * vl[..., 1], vl[..., 2]))
    sin2 = sl[..., 0] ** 2 + sl[..., 1] ** 2
    inv_len = safe_div(1.0, jnp.sqrt(jnp.maximum(sin2, 1e-30)))
    cos_phi = jnp.where(sin2 <= 1e-30, 1.0, sl[..., 0] * inv_len)
    sin_phi = jnp.where(sin2 <= 1e-30, 0.0, sl[..., 1] * inv_len)
    sx, sy = _sample_vndf_ggx_11(u0, u1, jnp.abs(sl[..., 2]))
    s2x = (cos_phi * sx - sin_phi * sy) * alpha_u
    s2y = (sin_phi * sx + cos_phi * sy) * alpha_v
    bad = ~jnp.isfinite(s2x)
    nh = normalize(vec3(jnp.where(bad, 0.0, -s2x), jnp.where(bad, 0.0, -s2y),
                        jnp.where(bad, 1e-8, 1.0)))
    return to_world(nh, t, b, n)


def halfway(a, bdir):
    return normalize(a + bdir)


def halfway_refractive(a, bdir, eta):
    return normalize(a + bdir * eta[..., None])


def reflective_jacobian(cos_h_o):
    """shading::halfway_reflective_jacobian ~ 1/(4 cos)"""
    return safe_div(1.0, 4.0 * cos_h_o)


def refractive_jacobian(eta, cos_h_i, cos_h_o):
    """shading::halfway_refractive_jacobian ~ eta^2 cos_h_i/(cos_h_i+eta cos_h_o)^2"""
    d = cos_h_i + eta * cos_h_o
    return safe_div(eta * eta * cos_h_i, d * d)
