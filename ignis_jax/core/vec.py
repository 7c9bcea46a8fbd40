"""Vector helpers over stacked arrays of shape (..., 3)/(..., 2).

Unlike the reference's scalar Vec3 structs (src/artic/core/vector.art), all
math here is batched: the last axis is the component axis and every leading
axis is a ray/sample lane.  This keeps the whole renderer in large fused
array ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# float32 products of geometry, colour and gradients run at full precision:
# a GPU may otherwise take them through TF32 (about 3 decimal digits)
HIGHEST = jax.lax.Precision.HIGHEST

FLT_EPS = np.float32(1.1920928955078125e-07)  # 2^-23, matches flt_eps
FLT_MAX = np.float32(3.4028234663852886e38)
FLT_INF = np.float32(np.inf)
PI = np.float32(3.14159265358979323846)
INV_PI = np.float32(1.0 / 3.14159265358979323846)


def vec3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def vec2(x, y):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)), axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length2(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length2(a))


def normalize(a):
    return a * safe_div(1.0, length(a))[..., None]


def safe_div(a, b):
    """a/b with 0 where b == 0 (matches safe_div in the reference)."""
    b = jnp.asarray(b)
    return jnp.where(b == 0, jnp.zeros_like(b), a / jnp.where(b == 0, jnp.ones_like(b), b))


def safe_sqrt(a):
    return jnp.sqrt(jnp.maximum(a, 0.0))


def reflect(v, n):
    """Mirror v at n; v points away from the surface (vector.art semantics)."""
    return 2.0 * dot(n, v)[..., None] * n - v


def refract(v, n, eta, cos_i, cos_t):
    """Refraction direction given precomputed cosines (vector.art vec3_refract).

    v points away from the surface; eta = n1/n2 on the v side; cos_i = dot(v, n);
    cos_t = signed transmitted cosine from `fresnel`.
    """
    return n * (eta * cos_i - cos_t)[..., None] - v * eta[..., None]


def lerp2(a, b, c, u, v):
    """Barycentric interpolation a*(1-u-v) + b*u + c*v."""
    w = (1.0 - u - v)[..., None]
    return a * w + b * u[..., None] + c * v[..., None]


def mulf(a, f):
    return a * jnp.asarray(f)[..., None]


def luminance(c):
    return (c[..., 0] * jnp.float32(0.2126)
            + c[..., 1] * jnp.float32(0.7152)
            + c[..., 2] * jnp.float32(0.0722))


def max_component(c):
    return jnp.max(c, axis=-1)


def saturate_color(c, clamp_value):
    """Clamp color luminance-preservingly? Reference color_saturate clamps
    each channel to clamp_value (core/color.art)."""
    return jnp.minimum(c, clamp_value)


def orthonormal_basis(n):
    """Duff et al. branchless ONB, matching make_orthonormal_mat3x3
    (core/matrix.art:20-28).  Returns (t, b) with columns (t, b, n).
    """
    sign = jnp.where(n[..., 2] >= 0, jnp.float32(1.0), jnp.float32(-1.0))
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = vec3(1.0 + sign * n[..., 0] * n[..., 0] * a,
             sign * b,
             -sign * n[..., 0])
    bt = vec3(b,
              sign + n[..., 1] * n[..., 1] * a,
              -n[..., 1])
    return t, bt


def to_world(local_dir, t, b, n):
    """Transform a local (tangent-space) direction to world given ONB columns."""
    return (t * local_dir[..., 0:1]
            + b * local_dir[..., 1:2]
            + n * local_dir[..., 2:3])


def to_local(world_dir, t, b, n):
    return vec3(dot(world_dir, t), dot(world_dir, b), dot(world_dir, n))


def positive_cos(a, b):
    return jnp.maximum(dot(a, b), 0.0)


def absolute_cos(a, b):
    return jnp.abs(dot(a, b))


def matmul(a, b):
    """a @ b at HIGHEST precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def transform_point(m, p):
    """Apply (..., 3, 4) affine matrix to points (..., 3)."""
    return jnp.einsum('...ij,...j->...i', m[..., :3], p,
                      precision=HIGHEST) + m[..., 3]


def transform_vector(m, v):
    return jnp.einsum('...ij,...j->...i', m[..., :3], v, precision=HIGHEST)


def transform_normal(nm, n):
    """Apply (..., 3, 3) normal matrix (inverse-transpose of linear part)."""
    return jnp.einsum('...ij,...j->...i', nm, n, precision=HIGHEST)
