"""Klems measured BSDF (src/artic/bsdf/klems.art make_klems_bsdf), batched.

Per-material data lives in tables under the prefix `klems{mat_id}`; the
static totals/color/up come from scene.klems_info[mat_id].

The world frame is built from the un-flipped shading normal and the user
`up` vector (Radiance convention, klems.art:208-211), NOT the faceforwarded
frame.  Sampling is the reference's cosine-hemisphere fallback with a
reflection/transmission probability split.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import (
    FLT_EPS, cross, dot, normalize, safe_div, to_local as _tl,
)
from ignis_jax.core.warp import cosine_hemisphere_pdf, sample_cosine_hemisphere
from ignis_jax.measured.klems import klems_eval_component

_FLIP = np.asarray([1.0, 1.0, -1.0], np.float32)


def _tt_frame(surf, up):
    """tt_transform_matrix (tensortree.art:169-177) with the unflipped normal."""
    n = jnp.where(surf["is_entering"][..., None], surf["n"], -surf["n"])
    upv = jnp.broadcast_to(jnp.asarray(up, jnp.float32), n.shape)
    right = cross(upv, n)
    l2 = jnp.sum(right * right, axis=-1)
    degen = l2 <= FLT_EPS
    right = jnp.where(degen[..., None], np.asarray([1.0, 0, 0], np.float32),
                      right * safe_div(1.0, jnp.sqrt(jnp.maximum(l2, 1e-30)))[..., None])
    nup = cross(n, right)
    # degenerate: identity frame
    right = jnp.where(degen[..., None], np.asarray([1.0, 0, 0], np.float32), right)
    nup = jnp.where(degen[..., None], np.asarray([0, 1.0, 0], np.float32), nup)
    nn = jnp.where(degen[..., None], np.asarray([0, 0, 1.0], np.float32), n)
    return right, nup, nn


def _k_fi(v):
    return v * np.asarray([-1.0, -1.0, 1.0], np.float32)


def _k_bo(v):
    return v * _FLIP


def _k_bi(v):
    return -v


def _local_eval(tables, prefix, info, base_color, wi, wo):
    in_front = wi[..., 2] >= 0
    out_front = wo[..., 2] >= 0
    totals = info["totals"]
    zero = jnp.zeros(wi.shape[:-1], jnp.float32)
    # (inFront, outFront) dispatch (klems.art:225-233)
    f_rr = (klems_eval_component(tables, prefix, "front_reflection",
                                 _k_fi(wo), wi)
            if totals[0] > 0 else zero)
    f_tt = (klems_eval_component(tables, prefix, "front_transmission",
                                 wi, _k_bi(wo))
            if totals[1] > 0 else zero)
    b_tt = (klems_eval_component(tables, prefix, "back_transmission",
                                 _k_bi(wi), wo)
            if totals[3] > 0 else zero)
    b_rr = (klems_eval_component(tables, prefix, "back_reflection",
                                 _k_bi(wo), _k_bo(wi))
            if totals[2] > 0 else zero)
    factor = jnp.where(in_front & out_front, f_rr,
                       jnp.where(in_front & ~out_front, f_tt,
                                 jnp.where(~in_front & out_front, b_tt, b_rr)))
    return base_color * (factor * jnp.abs(wi[..., 2]))[..., None]


def _refl_prob(info, wo):
    t = info["totals"]
    fp = t[0] / max(t[0] + t[3], 1e-20) if (t[0] + t[3]) > 0 else 0.0
    bp = t[2] / max(t[2] + t[1], 1e-20) if (t[2] + t[1]) > 0 else 0.0
    return jnp.where(wo[..., 2] >= 0, jnp.float32(fp), jnp.float32(bp))


def klems_eval(tables, prefix, info, base_color, up, surf, in_dir, out_dir):
    r, u, n = _tt_frame(surf, up)
    wo = _tl(out_dir, r, u, n)
    wi = _tl(in_dir, r, u, n)
    return _local_eval(tables, prefix, info, base_color, wi, wo)


def klems_pdf(tables, prefix, info, up, surf, in_dir, out_dir):
    r, u, n = _tt_frame(surf, up)
    wo = _tl(out_dir, r, u, n)
    wi = _tl(in_dir, r, u, n)
    rp = _refl_prob(info, wo)
    same = (wo[..., 2] * wi[..., 2]) >= 0
    prob = jnp.where(same, rp, 1.0 - rp)
    return prob * cosine_hemisphere_pdf(jnp.abs(wi[..., 2]))


def klems_sample(tables, prefix, info, base_color, up, surf, u0, u1, u2,
                 out_dir):
    """cosine-hemisphere fallback sampler (klems.art:255-277): 3 draws."""
    r, u, n = _tt_frame(surf, up)
    wo = _tl(out_dir, r, u, n)
    local, pdf = sample_cosine_hemisphere(u0, u1)
    # make_same_hemisphere(wo, dir)
    flip = jnp.signbit(wo[..., 2])
    same = jnp.where(flip[..., None], local * _FLIP, local)
    rp = _refl_prob(info, wo)
    is_refl = (rp > 0) & (u2 < rp)
    wi = jnp.where(is_refl[..., None], same, -same)
    prob = jnp.where(is_refl, rp, 1.0 - rp)
    e_pdf = prob * pdf
    ev = _local_eval(tables, prefix, info, base_color, wi, wo)
    weight = ev * safe_div(1.0, e_pdf)[..., None]
    in_dir = r * wi[..., 0:1] + u * wi[..., 1:2] + n * wi[..., 2:3]
    valid = (pdf > FLT_EPS) & (e_pdf > FLT_EPS)
    return in_dir, e_pdf, weight, jnp.ones_like(e_pdf), valid
