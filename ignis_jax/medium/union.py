"""Participating media union (src/artic/medium/ + phase/).

Batched per-lane medium functions dispatching over the scene's static medium
list.  Homogeneous media use the closed forms of medium/homogeneous.art;
medium id -1 is vacuum.  Coefficients may be PExpr expressions evaluated at
the current shading context (the reference evaluates them once per medium
closure at the hit context, src/runtime/medium/HomogeneousMedium.cpp).

Phase functions: Henyey-Greenstein + isotropic (src/artic/phase/) — note the
reference's anisotropic HG sampler emits the direction in the canonical frame
without rotating around out_dir (phase/henyeygreenstein.art:19-35); we
reproduce that faithfully for parity.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.core import rng
from ignis_jax.core.vec import FLT_EPS, absolute_cos, length, safe_div, vec3
from ignis_jax.core.warp import sample_uniform_sphere, uniform_sphere_pdf

_EPS = np.float32(1e-3)


def medium_coefficients(scene, tables, medium_id, ctx):
    """Per-lane (sigma_a, sigma_s, g) for the lane's medium id (-1 → zeros).

    ctx supplies the PExpr lane context for expression-valued coefficients.
    """
    n = medium_id.shape[0]
    sa = jnp.zeros((n, 3), jnp.float32)
    ss = jnp.zeros((n, 3), jnp.float32)
    g = jnp.zeros((n,), jnp.float32)
    for mi, med in enumerate(scene.media):
        m = medium_id == mi
        if med["type"] == "vacuum":
            continue
        data = tables["medium_data"][mi]
        msa = jnp.broadcast_to(data[0:3], (n, 3))
        mss = jnp.broadcast_to(data[3:6], (n, 3))
        if med.get("sigma_a_expr"):
            from ignis_jax.texture.pexpr import eval_pexpr_color
            msa = eval_pexpr_color(scene, tables, med["sigma_a_expr"],
                                   ctx["uv"], ctx)
        if med.get("sigma_s_expr"):
            from ignis_jax.texture.pexpr import eval_pexpr_color
            mss = eval_pexpr_color(scene, tables, med["sigma_s_expr"],
                                   ctx["uv"], ctx)
        sa = jnp.where(m[..., None], msa, sa)
        ss = jnp.where(m[..., None], mss, ss)
        g = jnp.where(m, data[6], g)
    return sa, ss, g


def _hetero_media(scene):
    return [(mi, m) for mi, m in enumerate(scene.media)
            if m["type"].startswith("hetero")]


def _hetero_props_at(scene, tables, mi, med, world_p):
    """(sigma_s, sigma_a, emission) of hetero medium mi at world points
    (n,3) — shader application per medium/shaders/*.art."""
    from ignis_jax.medium.volume import (
        apply_density_shader, grid_lookup, to_normalized_point)
    ref = med["ref_entity"]
    lpos = jnp.clip(to_normalized_point(tables, ref, world_p), 1e-5,
                    1.0 - 1e-5)
    interp = med.get("interpolate", False)
    row = tables["medium_shader"][mi]
    if med["type"] == "hetero_voxel":
        # simple_volume shader (shaders/simple_volume.art:4-9) with the
        # scalar_density×scalar_* premultiplication of
        # HeterogeneousMedium.cpp:203-216
        ss = grid_lookup(tables[f"vol{mi}_sigma_s"], lpos, interp) \
            * (row[2:5] * row[0] * row[18])
        sa = grid_lookup(tables[f"vol{mi}_sigma_a"], lpos, interp) \
            * (row[5:8] * row[0] * row[17])
        em = grid_lookup(tables[f"vol{mi}_emission"], lpos, interp) \
            * (row[8:11] * row[0] * row[1])
        return ss, sa, em
    dens = grid_lookup(tables[f"vol{mi}_density"][..., None], lpos,
                       interp)[..., 0]
    temp = None
    if med.get("has_temperature"):
        temp = grid_lookup(tables[f"vol{mi}_temperature"][..., None], lpos,
                           interp)[..., 0]
    return apply_density_shader(med.get("shader", "monochromatic"), row,
                                dens, temp)


# Static quadrature resolution for heterogeneous transmittance marching.
# The reference's eval_tr uses stochastic ratio tracking
# (medium/methods/delta_tracking.art:100-137); we use deterministic
# midpoint quadrature of the optical thickness (the reference's
# ray-marching method family, medium/methods/ray_marching.art) —
# fixed trip count vectorizes over lanes and differentiates cleanly.
_TR_STEPS = 32


def _hetero_transmittance(scene, tables, mi, med, p_start, p_end):
    """exp(-∫σ_t) along the [p_start,p_end] segment, masked to in-volume
    sample points."""
    from ignis_jax.medium.volume import inside_unit, to_normalized_point
    seg = p_end - p_start
    dist = length(seg)
    ts = (jnp.arange(_TR_STEPS, dtype=jnp.float32) + 0.5) / _TR_STEPS
    # (steps, n, 3) sample points
    pts = p_start[None] + seg[None] * ts[:, None, None]
    flat = pts.reshape(-1, 3)
    ss, sa, _ = _hetero_props_at(scene, tables, mi, med, flat)
    ext = (ss + sa).reshape(_TR_STEPS, -1, 3)
    lref = to_normalized_point(tables, med["ref_entity"], flat)
    inside = inside_unit(lref).reshape(_TR_STEPS, -1)
    ext = jnp.where(inside[..., None], ext, 0.0)
    tau = ext.sum(axis=0) * (dist / _TR_STEPS)[..., None]
    return jnp.exp(-tau)


# fixed flight budget for the stochastic ratio tracker; the product is
# clamped after the last flight (practically converged: the expected
# flight count is tau_majorant, single-digit for real volumes)
_RT_FLIGHTS = 32
# independent RNG substream salt: transmittance draws must not correlate
# with the technique's (seed, counter) stream, and threading an advanced
# counter through every transmittance call site would leak the estimator
# choice into the wavefront payload — a salted seed gives a parallel
# stateless stream instead
_RT_SALT = np.uint32(0x9E3779B9)


def _hetero_ratio_transmittance(scene, tables, mi, med, p_start, p_end,
                                seed, counter):
    """Stochastic ratio tracking (medium/methods/delta_tracking.art:100-137
    eval_tr): Tr ≈ prod_k (1 - sigma_t(x_k)/mu_bar) over majorant free
    flights.  Unbiased per-flight; fixed _RT_FLIGHTS unrolled trips."""
    from ignis_jax.medium.volume import inside_unit, to_normalized_point
    seg = p_end - p_start
    dist = length(seg)
    dirn = seg * safe_div(1.0, dist)[..., None]
    maj = tables["medium_majorant"][mi]
    mu = jnp.maximum(jnp.max(maj), 1e-6)
    t = jnp.zeros_like(dist)
    tr = jnp.ones(p_start.shape[:-1] + (3,), jnp.float32)
    salted = seed ^ jnp.uint32(_RT_SALT)
    c = counter
    for _k in range(_RT_FLIGHTS):
        u, c = rng.next_f32(salted, c)
        t = t - jnp.log(jnp.maximum(1.0 - u * 0.99999, 1e-30)) / mu
        on = t < dist
        pos = p_start + dirn * t[..., None]
        ss, sa, _ = _hetero_props_at(scene, tables, mi, med, pos)
        lref = to_normalized_point(tables, med["ref_entity"], pos)
        ext = jnp.where(inside_unit(lref)[..., None], ss + sa, 0.0)
        f = jnp.clip(1.0 - ext / mu, 0.0, 1.0)
        tr = jnp.where(on[..., None], tr * f, tr)
    return tr


def medium_eval(scene, tables, medium_id, sigma_a, sigma_s, p_start, p_end,
                seed=None, counter=None):
    """Transmittance between two points.

    Homogeneous: closed form (medium/homogeneous.art).  Heterogeneous: the
    scene-selected method family (HeterogeneousMedium.cpp:223-236) —
    `method: delta_tracking` uses stochastic ratio tracking when an RNG
    stream is available; `regular` / `ray_marching` (default) use the
    deterministic optical-thickness quadrature, which also serves as the
    differentiable path (the ratio tracker's clip() kinks its gradient).
    """
    sigma_t = sigma_a + sigma_s
    dist = length(p_end - p_start)
    tr = jnp.exp(-sigma_t * dist[..., None])
    tr = jnp.where((medium_id >= 0)[..., None], tr, 1.0)
    for mi, med in _hetero_media(scene):
        if (med.get("method") == "delta_tracking" and seed is not None
                and counter is not None):
            h = _hetero_ratio_transmittance(scene, tables, mi, med,
                                            p_start, p_end, seed, counter)
        else:
            h = _hetero_transmittance(scene, tables, mi, med, p_start,
                                      p_end)
        tr = jnp.where((medium_id == mi)[..., None], h, tr)
    return tr


def medium_eval_inf(scene, tables, medium_id, sigma_a, sigma_s, p_start,
                    direction):
    """Transmittance to infinity: white iff extinction ~ 0; heterogeneous
    media bound the ray inside an entity so eval_inf is black
    (delta_tracking.art:142 eval_inf)."""
    sigma_t = sigma_a + sigma_s
    black_t = jnp.all(sigma_t <= 1e-4, axis=-1)
    val = jnp.where(black_t[..., None], 1.0, 0.0)
    for mi, med in _hetero_media(scene):
        val = jnp.where((medium_id == mi)[..., None], 0.0, val)
    return jnp.where((medium_id >= 0)[..., None], val, 1.0)


def medium_sample(scene, tables, medium_id, sigma_a, sigma_s, seed, counter,
                  p_start, p_end, active):
    """Collision-distance sampling.

    Homogeneous: closed-form free flight (medium/homogeneous.art:40-60).
    Heterogeneous: single-flight delta tracking against the medium's global
    majorant (medium/methods/delta_tracking.art:24-88 free_flight) — the
    fictional-collision continuation is the volpath technique's null event.

    Returns dict(valid, pos, pdf, color, sigma_a, sigma_s, sigma_n,
    emission at the sample) + advanced counter.  Lanes that consume a draw:
    scattering homogeneous media and in-bounds heterogeneous media.
    """
    n = medium_id.shape[0]
    sigma_t = sigma_a + sigma_s
    has_scatter = jnp.any(sigma_s > 1e-4, axis=-1) & (medium_id >= 0)
    sigma_ind = jnp.argmin(sigma_t, axis=-1)
    lanes = jnp.arange(n)
    sigma_t_p = sigma_t[lanes, sigma_ind]

    u, counter_next = rng.next_f32(seed, counter)

    dir_u = p_end - p_start
    dist = length(dir_u)
    # where-substitute (not clamp) the zero-extinction lanes: a clamp to
    # 1e-30 keeps the PRIMAL finite but d(L/sigma)/d sigma = -L/sigma^2
    # still overflows, and the zero cotangent from the enclosing min/where
    # turns that inf into NaN in reverse mode (0 * inf)
    sigma_t_s = jnp.where(sigma_t_p > 1e-6, sigma_t_p, 1.0)
    ndist = jnp.minimum(dist, -jnp.log(jnp.maximum(1.0 - u * 0.99999, 1e-30))
                        / sigma_t_s)
    valid = (has_scatter & active
             & (jnp.abs(dist - ndist) > _EPS))
    d = dir_u * safe_div(1.0, dist)[..., None]
    pos = p_start + d * ndist[..., None]
    tr = jnp.exp(-sigma_t * ndist[..., None])
    pdf = tr[lanes, sigma_ind] * sigma_t_p
    inv_pdf_s = jnp.where(pdf > 1e-20,
                          1.0 / jnp.where(pdf > 1e-20, pdf, 1.0), 0.0)
    color = tr * inv_pdf_s[..., None]

    out_sa, out_ss = sigma_a, sigma_s
    out_sn = jnp.zeros((n, 3), jnp.float32)
    out_em = jnp.zeros((n, 3), jnp.float32)
    consumed = active & has_scatter

    from ignis_jax.medium.volume import inside_unit, to_normalized_point
    for mi, med in _hetero_media(scene):
        m = medium_id == mi
        maj = tables["medium_majorant"][mi]
        mu_t_p = jnp.max(maj)
        lstart = to_normalized_point(tables, med["ref_entity"], p_start)
        inside = inside_unit(lstart)
        draws = m & active & inside
        mu_t_s = jnp.where(mu_t_p > 1e-6, mu_t_p, 1.0)
        sampled = -jnp.log(jnp.maximum(1.0 - u * 0.99999, 1e-30)) / mu_t_s
        v_m = draws & (sampled < dist) & (mu_t_p > FLT_EPS)
        pos_m = p_start + d * sampled[..., None]
        ss_m, sa_m, em_m = _hetero_props_at(scene, tables, mi, med, pos_m)
        sn_m = jnp.maximum(maj - (ss_m + sa_m), 0.0)
        pdf_m = (1.0 - u * 0.99999) * mu_t_p
        inv_pm = jnp.where(pdf_m > 1e-20,
                           1.0 / jnp.where(pdf_m > 1e-20, pdf_m, 1.0), 0.0)
        color_m = jnp.exp(-maj * sampled[..., None]) * inv_pm[..., None]

        mc = m[..., None]
        valid = jnp.where(m, v_m, valid)
        pos = jnp.where(mc, pos_m, pos)
        pdf = jnp.where(m, pdf_m, pdf)
        color = jnp.where(mc, color_m, color)
        out_sa = jnp.where(mc, sa_m, out_sa)
        out_ss = jnp.where(mc, ss_m, out_ss)
        out_sn = jnp.where(mc, sn_m, out_sn)
        out_em = jnp.where(mc, em_m, out_em)
        consumed = jnp.where(m, draws, consumed)

    counter = jnp.where(consumed, counter_next, counter)
    return dict(valid=valid, pos=pos, pdf=pdf, color=color,
                sigma_a=out_sa, sigma_s=out_ss, sigma_n=out_sn,
                emission=out_em), counter


def phase_sample(g, seed, counter, out_dir, active):
    """HG / isotropic sampling; 2 draws (phase/*.art).  Returns
    (in_dir, pdf, weight, counter)."""
    u1, c = rng.next_f32(seed, counter)
    u2, c = rng.next_f32(seed, c)
    counter = jnp.where(active, c, counter)

    iso_dir, iso_pdf = sample_uniform_sphere(u1, u2)

    # where-substitute g for the HG branch: max(2g, 1e-20) breaks
    # NEGATIVE g outright (back-scattering media sampled the wrong lobe)
    # and its VJP (-1/den^2 = 1e40) overflows f32 to inf, NaN-ing the
    # masked isotropic lanes' zero cotangent
    is_iso = jnp.abs(g) <= 1e-3
    g_ = jnp.where(is_iso, 0.5, g)
    den = 1.0 + g_ - 2.0 * g_ * u1
    den = jnp.where(jnp.abs(den) > 1e-6, den, 1e-6)
    sqr = (1.0 - g_ * g_) / den
    cos_t = -(1.0 + g_ * g_ - sqr * sqr) / (2.0 * g_)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u2
    hg_dir = vec3(sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t)
    hg_pdf = _hg(g_, absolute_cos(hg_dir, out_dir))

    in_dir = jnp.where(is_iso[..., None], iso_dir, hg_dir)
    pdf = jnp.where(is_iso, iso_pdf, hg_pdf)
    weight = jnp.ones_like(pdf)
    return in_dir, pdf, weight, counter


def phase_eval(g, in_dir, out_dir):
    iso = jnp.broadcast_to(jnp.float32(1.0 / (4.0 * np.pi)),
                           g.shape)
    hg = _hg(g, absolute_cos(in_dir, out_dir))
    return jnp.where(jnp.abs(g) <= 1e-3, iso, hg)


def _hg(g, cos_theta):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return safe_div(jnp.float32(1.0 / np.pi) * (1.0 - g * g),
                    4.0 * denom * jnp.sqrt(jnp.maximum(denom, 1e-20)))
