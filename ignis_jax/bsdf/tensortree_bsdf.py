"""Tensor-tree measured BSDF (src/artic/bsdf/tensortree.art), batched.

Shares the Radiance up-vector frame and probability-split cosine sampler with
the Klems BSDF; evaluation delegates to the flattened tree climb."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.bsdf.klems_bsdf import _FLIP, _refl_prob, _tt_frame
from ignis_jax.core.vec import FLT_EPS, safe_div, to_local as _tl
from ignis_jax.core.warp import cosine_hemisphere_pdf, sample_cosine_hemisphere
from ignis_jax.measured.tensortree import tt_eval_component


def _make_positive(v):
    return jnp.where(jnp.signbit(v[..., 2])[..., None], v * _FLIP, v)


def _tree_eval(tables, prefix, info, wi, wo):
    """TensorTreeModel.eval (tensortree.art:146-166)."""
    bad = (jnp.abs(wi[..., 2]) <= FLT_EPS) | (jnp.abs(wo[..., 2]) <= FLT_EPS)
    in_front = wi[..., 2] >= 0
    out_front = wo[..., 2] >= 0
    pos = _make_positive
    neg = lambda v: -_make_positive(v)
    totals = info["totals"]
    zero = jnp.zeros(wi.shape[:-1], jnp.float32)
    f_rr = (tt_eval_component(tables, prefix, "front_reflection", 0, info,
                              pos(wo), pos(wi)) if totals[0] > 0 else zero)
    f_tt = (tt_eval_component(tables, prefix, "front_transmission", 1, info,
                              pos(wi), neg(wo)) if totals[1] > 0 else zero)
    b_tt = (tt_eval_component(tables, prefix, "back_transmission", 3, info,
                              pos(wo), neg(wi)) if totals[3] > 0 else zero)
    b_rr = (tt_eval_component(tables, prefix, "back_reflection", 2, info,
                              neg(wo), neg(wi)) if totals[2] > 0 else zero)
    factor = jnp.where(in_front & out_front, f_rr,
                       jnp.where(in_front & ~out_front, f_tt,
                                 jnp.where(~in_front & out_front, b_tt, b_rr)))
    return jnp.where(bad, 0.0, factor * jnp.abs(wi[..., 2]))


def tensortree_eval(tables, prefix, info, base_color, up, surf, in_dir,
                    out_dir):
    r, u, n = _tt_frame(surf, up)
    wo = _tl(out_dir, r, u, n)
    wi = _tl(in_dir, r, u, n)
    return base_color * _tree_eval(tables, prefix, info, wi, wo)[..., None]


def tensortree_pdf(tables, prefix, info, up, surf, in_dir, out_dir):
    r, u, n = _tt_frame(surf, up)
    wo = _tl(out_dir, r, u, n)
    wi = _tl(in_dir, r, u, n)
    rp = _refl_prob(info, wo)
    same = (wo[..., 2] * wi[..., 2]) >= 0
    prob = jnp.where(same, rp, 1.0 - rp)
    return prob * cosine_hemisphere_pdf(jnp.abs(wi[..., 2]))


def tensortree_sample(tables, prefix, info, base_color, up, surf, u0, u1, u2,
                      out_dir):
    r, u, n = _tt_frame(surf, up)
    wo = _tl(out_dir, r, u, n)
    local, pdf = sample_cosine_hemisphere(u0, u1)
    flip = jnp.signbit(wo[..., 2])
    same = jnp.where(flip[..., None], local * _FLIP, local)
    rp = _refl_prob(info, wo)
    is_refl = (rp > 0) & (u2 < rp)
    wi = jnp.where(is_refl[..., None], same, -same)
    prob = jnp.where(is_refl, rp, 1.0 - rp)
    e_pdf = prob * pdf
    ev = base_color * safe_div(_tree_eval(tables, prefix, info, wi, wo),
                               e_pdf)[..., None]
    in_dir = r * wi[..., 0:1] + u * wi[..., 1:2] + n * wi[..., 2:3]
    valid = (pdf > FLT_EPS) & (e_pdf > FLT_EPS)
    return in_dir, e_pdf, ev, jnp.ones_like(e_pdf), valid
