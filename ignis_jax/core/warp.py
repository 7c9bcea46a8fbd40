"""Sampling warps, batched (mirrors src/artic/core/sampling.art + warp.art)."""

from __future__ import annotations

import jax.numpy as jnp

from ignis_jax.core.vec import PI, safe_div, safe_sqrt, vec2, vec3


def sample_triangle(u, v):
    """Uniform point on the unit triangle (sampling.art:34-36)."""
    flip = (u + v) > 1.0
    return jnp.where(flip, 1.0 - u, u), jnp.where(flip, 1.0 - v, v)


def uniform_sphere_pdf():
    return jnp.float32(1.0 / (4.0 * 3.14159265358979323846))


def sample_uniform_sphere(u, v):
    c = 2.0 * v - 1.0
    s = safe_sqrt(1.0 - c * c)
    phi = 2.0 * PI * u
    return vec3(s * jnp.cos(phi), s * jnp.sin(phi), c), jnp.broadcast_to(uniform_sphere_pdf(), jnp.shape(u))


def cosine_hemisphere_pdf(c):
    return c * jnp.float32(1.0 / 3.14159265358979323846)


def sample_cosine_hemisphere(u, v):
    """Z-up cosine hemisphere (sampling.art:65-71)."""
    c = safe_sqrt(v)
    s = safe_sqrt(1.0 - v)
    phi = 2.0 * PI * u
    return vec3(s * jnp.cos(phi), s * jnp.sin(phi), c), cosine_hemisphere_pdf(c)


def cosine_power_hemisphere_pdf(c, k):
    return jnp.power(jnp.maximum(c, 0.0), k) * (k + 1.0) * jnp.float32(1.0 / (2.0 * 3.14159265358979323846))


def sample_cosine_power_hemisphere(k, u, v):
    c = jnp.minimum(jnp.power(v, 1.0 / (k + 1.0)), 1.0)
    s = jnp.sqrt(jnp.maximum(1.0 - c * c, 0.0))
    phi = 2.0 * PI * u
    pow_c_k = jnp.where(c != 0.0, v / jnp.where(c != 0.0, c, 1.0), 0.0)
    pdf = pow_c_k * (k + 1.0) * jnp.float32(1.0 / (2.0 * 3.14159265358979323846))
    return vec3(s * jnp.cos(phi), s * jnp.sin(phi), c), pdf


def square_to_concentric_disk(px, py):
    """Concentric disk map (warp.art:2-28)."""
    a = 2.0 * px - 1.0
    b = 2.0 * py - 1.0
    zero = (a == 0.0) & (b == 0.0)
    top = a * a > b * b
    sa = jnp.where(top, a, b)
    phi = jnp.where(top,
                    (PI / 4.0) * safe_div(b, a),
                    (PI / 2.0) - (PI / 4.0) * safe_div(a, b))
    x = jnp.cos(phi) * sa
    y = jnp.sin(phi) * sa
    return jnp.where(zero, 0.0, x), jnp.where(zero, 0.0, y)


def uniform_disk_pdf(radius):
    return 1.0 / (PI * radius * radius)


def sample_uniform_disk(u, v, radius):
    x, y = square_to_concentric_disk(u, v)
    return vec3(x * radius, y * radius, jnp.zeros_like(x)), jnp.broadcast_to(uniform_disk_pdf(radius), jnp.shape(u))


def uniform_cone_pdf(cos_angle):
    denom = 2.0 * PI * (1.0 - cos_angle)
    return jnp.where(denom == 0.0, jnp.float32(1.0), 1.0 / jnp.where(denom == 0.0, 1.0, denom))


def sample_uniform_cone(u, v, cos_angle):
    c1 = 1.0 - cos_angle
    px, py = square_to_concentric_disk(u, v)
    n2 = px * px + py * py
    z = cos_angle + c1 * (1.0 - n2)
    f = safe_sqrt(c1 * (2.0 - c1 * n2))
    return vec3(px * f, py * f, z), jnp.broadcast_to(uniform_cone_pdf(cos_angle), jnp.shape(u))


def equal_area_square_to_sphere(px, py):
    """Clarberg equal-area square→sphere; (0.5,0.5) → +Z (warp.art:63-91)."""
    u = 2.0 * px - 1.0
    v = 2.0 * py - 1.0
    au = jnp.abs(u)
    av = jnp.abs(v)
    signed_distance = 1.0 - (au + av)
    d = jnp.abs(signed_distance)
    r = 1.0 - d
    phi = jnp.where(r == 0.0, 1.0, (av - au) / jnp.where(r == 0.0, 1.0, r) + 1.0) * (PI / 4.0)
    cos_theta = jnp.copysign(1.0 - r * r, signed_distance)
    sin_theta = safe_sqrt(2.0 - r * r) * r
    cos_phi = jnp.copysign(jnp.cos(phi), u)
    sin_phi = jnp.copysign(jnp.sin(phi), v)
    return vec3(cos_phi * sin_theta, sin_phi * sin_theta, cos_theta)


def equal_area_sphere_to_square(d):
    """Inverse map (warp.art:93-126)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    r = safe_sqrt(1.0 - az)
    a = jnp.maximum(ax, ay)
    b_ = jnp.minimum(ax, ay)
    b = safe_div(b_, a)
    phi_ = jnp.arctan(b) * jnp.float32(2.0 / 3.14159265358979323846)
    phi = jnp.where(ax < ay, 1.0 - phi_, phi_)
    v_ = phi * r
    u_ = r - v_
    u = jnp.where(z < 0.0, 1.0 - v_, u_)
    v = jnp.where(z < 0.0, 1.0 - u_, v_)
    cu = jnp.copysign(u, x)
    cv = jnp.copysign(v, y)
    return vec2(0.5 * (cu + 1.0), 0.5 * (cv + 1.0))


def equal_area_sphere_pdf():
    return uniform_sphere_pdf()


def sample_equal_area_sphere(u, v):
    return equal_area_square_to_sphere(u, v), jnp.broadcast_to(equal_area_sphere_pdf(), jnp.shape(u))


def spherical_from_dir(d):
    """Z-up spherical coords; returns (theta, phi) with phi in [0, 2pi)."""
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    return theta, phi


def dir_from_spherical(theta, phi):
    s = jnp.sin(theta)
    return vec3(s * jnp.cos(phi), s * jnp.sin(phi), jnp.cos(theta))
