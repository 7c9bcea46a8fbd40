"""Disney principled BSDF (src/artic/bsdf/principled.art), batched.

All directions are converted to the surface local frame (z = oriented
shading normal).  Lobe mixture, fresnel, sheen, clearcoat, thin-surface
translucency and refraction follow the reference formulas line for line.

Parameter layout (mat_scalars, 16 slots for principled materials):
  [0]=roughness_u(alpha ax), [4]=roughness_v(ay) — post compute_roughness,
  [1]=ior, [3]=thin, [5]=diffuse_transmission, [6]=specular_transmission,
  [7]=specular_tint, [8]=flatness, [9]=metallic, [10]=sheen, [11]=sheen_tint,
  [12]=clearcoat, [13]=clearcoat_gloss, [14]=clearcoat_roughness,
  [15]=clearcoat_top_only
base_color = mat_colors slot 0.
"""

from __future__ import annotations

import jax.numpy as jnp

from ignis_jax.bsdf import microfacet as mf
from ignis_jax.core.vec import (
    FLT_EPS, INV_PI, absolute_cos, dot, normalize, safe_div, to_local,
    to_world, vec3,
)
from ignis_jax.core.warp import cosine_hemisphere_pdf, sample_cosine_hemisphere

_GRAZING_EPS = 1e-5
_MICRO_EPS = 1e-5

import numpy as _np
# plain numpy: jnp constants at module scope would become trace-bound if this
# module is first imported inside a jit trace
_ID_T = _np.asarray([1.0, 0.0, 0.0], _np.float32)
_ID_B = _np.asarray([0.0, 1.0, 0.0], _np.float32)
_ID_N = _np.asarray([0.0, 0.0, 1.0], _np.float32)


def _idframe(shape):
    t = jnp.broadcast_to(_ID_T, shape)
    b = jnp.broadcast_to(_ID_B, shape)
    n = jnp.broadcast_to(_ID_N, shape)
    return t, b, n


def _luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def _schlick_approx(c):
    """(1-cos)^5"""
    k = jnp.clip(1.0 - c, 0.0, 1.0)
    return k * k * k * k * k


def _schlick_r0(eta):
    f = (eta - 1.0) / (eta + 1.0)
    return f * f


def _schlick(r0, c):
    return r0 + (1.0 - r0) * _schlick_approx(c)[..., None]


def _tint_color(c):
    lum = _luminance(c)
    return jnp.where((lum <= FLT_EPS)[..., None], 1.0,
                     c * safe_div(1.0, lum)[..., None])


def _fresnel_dielectric(eta, cos_i):
    from ignis_jax.bsdf.union import _fresnel_dielectric as fd
    return fd(eta, cos_i)


class P:
    """Per-lane closure arrays unpacked from the material tables."""

    def __init__(self, colors, scalars, surf):
        self.base_color = colors[:, 0]
        self.ru = jnp.maximum(scalars[:, 0], 1e-3)
        self.rv = jnp.maximum(scalars[:, 4], 1e-3)
        self.ior = scalars[:, 1]
        self.thin = scalars[:, 3] > 0.5
        self.diff_trans = scalars[:, 5]
        self.spec_trans = scalars[:, 6]
        self.spec_tint = scalars[:, 7]
        self.flatness = scalars[:, 8]
        self.metallic = scalars[:, 9]
        self.sheen = scalars[:, 10]
        self.sheen_tint = scalars[:, 11]
        self.clearcoat = scalars[:, 12]
        self.cc_gloss = scalars[:, 13]
        self.cc_rough = scalars[:, 14]
        self.cc_top_only = scalars[:, 15] > 0.5
        self.eta = jnp.where(surf["is_entering"] | self.thin,
                             1.0 / self.ior, self.ior)
        # thin refraction roughness remap (principled.art:73-80)
        f = jnp.clip((0.65 * self.ior - 0.35), 0.0, None)
        self.ru_refr = jnp.where(self.thin, jnp.clip(f * self.ru, 0.0, 1.0), self.ru)
        self.rv_refr = jnp.where(self.thin, jnp.clip(f * self.rv, 0.0, 1.0), self.rv)


def _same_hemi(a, b):
    return (a[..., 2] * b[..., 2]) >= 0.0


def _make_same_hemisphere(ref, v):
    """flip v's z so it lies in ref's hemisphere (shading.art)."""
    flip = jnp.signbit(ref[..., 2])
    return jnp.where(flip[..., None],
                     v * _np.asarray([1.0, 1.0, -1.0], _np.float32), v)


def _make_positive(v):
    return jnp.where(jnp.signbit(v[..., 2])[..., None],
                     v * _np.asarray([1.0, 1.0, -1.0], _np.float32), v)


def _eval_fresnel_term(p, wo, wi, h):
    hdv = absolute_cos(wo, h)
    hdl = absolute_cos(wi, h)
    bad = hdv * hdl <= FLT_EPS
    f1 = _fresnel_dielectric(p.eta, hdv)[..., None] * jnp.ones(3)
    color = _tint_color(p.base_color)
    a = (1.0 - p.spec_tint)[..., None] + color * p.spec_tint[..., None]
    r0 = (a * _schlick_r0(p.eta)[..., None] * (1.0 - p.metallic)[..., None]
          + p.base_color * p.metallic[..., None])
    f2 = _schlick(r0, hdl)
    out = f1 * (1.0 - p.metallic)[..., None] + f2 * p.metallic[..., None]
    return jnp.where(bad[..., None], 0.0, out)


def _eval_diffuse(p, wo, wi):
    lk = _schlick_approx(jnp.abs(wi[..., 2]))
    vk = _schlick_approx(jnp.abs(wo[..., 2]))
    diff = (1.0 - 0.5 * lk) * (1.0 - 0.5 * vk)
    vdl = absolute_cos(wi, wo)
    rr = (vdl + 1.0) * (p.ru + p.rv) / 2.0
    retro = rr * (lk + vk + lk * vk * (rr - 1.0))
    # subsurface (thin flatness)
    r2 = p.ru * p.rv
    hdl2 = dot(wi, normalize(wi + wo)) ** 2
    fss90 = hdl2 * r2
    andl = jnp.abs(wi[..., 2])
    andv = jnp.abs(wo[..., 2])
    fss = (1.0 - lk + fss90 * lk) * (1.0 - vk + fss90 * vk)
    sst = 1.25 * (fss * (1.0 / (andl + andv + 1e-5) - 0.5) + 0.5)
    ss = jnp.where(p.thin, 1.0 - p.flatness + sst * p.flatness, 1.0)
    return INV_PI * (diff + retro) * ss * andl


def _eval_translucent(p, wo, wi):
    lk = _schlick_approx(jnp.abs(wi[..., 2]))
    vk = _schlick_approx(jnp.abs(wo[..., 2]))
    return INV_PI * (1.0 - 0.5 * lk) * (1.0 - 0.5 * vk) * jnp.abs(wi[..., 2])


def _eval_sheen(p, wi):
    lk = _schlick_approx(jnp.abs(wi[..., 2]))
    tint = ((1.0 - p.sheen_tint)[..., None]
            + _tint_color(p.base_color) * p.sheen_tint[..., None])
    return tint * (p.sheen * lk * jnp.abs(wi[..., 2]))[..., None]


def _micro(p, wo, wi, h, au, av):
    t, b, n = _idframe(wo.shape)
    d = mf.ndf_ggx(t, b, n, h, au, av)
    g = (mf.g1_smith(t, b, n, wi, au, av)
         * mf.g1_smith(t, b, n, wo, au, av))
    return d, g


def _eval_reflection(p, wo, wi, h):
    f = _eval_fresnel_term(p, wo, wi, h)
    d, g = _micro(p, wo, wi, h, p.ru, p.rv)
    jac = safe_div(1.0, 4.0 * wo[..., 2])
    return f * jnp.abs(d * g * jac)[..., None]


def _eval_refraction(p, wo, wi, h):
    # thin branch
    ft = _fresnel_dielectric(p.eta, jnp.abs(wo[..., 2]))
    f_thin = ft + (1.0 - ft) * ft / (ft + 1.0)
    term_thin = 1.0 - f_thin
    # solid branch
    hdi = dot(wi, h)
    hdo = dot(wo, h)
    f = _fresnel_dielectric(p.eta, jnp.abs(hdo))
    d, g = _micro(p, wo, wi, h, p.ru_refr, p.rv_refr)
    jac = mf.refractive_jacobian(p.eta, hdi, hdo)
    norm = jnp.abs(safe_div(hdo * jac, wo[..., 2]))
    term_solid = (1.0 - f) * d * g * norm
    term = jnp.where(p.thin, term_thin, term_solid)
    col = jnp.where(p.thin[..., None], jnp.sqrt(jnp.maximum(p.base_color, 0.0)),
                    p.base_color)
    return col * term[..., None]


def _eval_clearcoat(p, wo, wi, h):
    f0 = jnp.float32(0.04)
    r = jnp.float32(0.25)
    r2 = jnp.maximum(0.001, p.cc_rough * (1.0 - p.cc_gloss) + 0.01 * p.cc_gloss)
    ahdl = absolute_cos(wi, h)
    t, b, n = _idframe(wo.shape)
    d = mf.ndf_ggx(t, b, n, h, r2, r2)
    f = f0 + (1.0 - f0) * _schlick_approx(ahdl)
    g = (mf.g1_smith(t, b, n, wi, jnp.broadcast_to(r, ahdl.shape),
                     jnp.broadcast_to(r, ahdl.shape))
         * mf.g1_smith(t, b, n, wo, jnp.broadcast_to(r, ahdl.shape),
                       jnp.broadcast_to(r, ahdl.shape)))
    jac = safe_div(1.0, 4.0 * wo[..., 2])
    return jnp.abs(r * d * f * g * jac * wi[..., 2])[..., None] * jnp.ones(3)


def _lobes(p, wo):
    """calcLobeDistribution (principled.art:198-234)."""
    metallic = jnp.clip(p.metallic, 0.0, 1.0)
    dt = jnp.clip(p.diff_trans, 0.0, 1.0)
    st = jnp.clip(p.spec_trans, 0.0, 1.0)
    abs_gen = _luminance(p.base_color)
    abs_spec = 1.0 + p.spec_tint * (_luminance(_tint_color(p.base_color)) - 1.0)
    diff_refl = jnp.clip(abs_gen * (1.0 - metallic) * (1.0 - st), 0.0, 1.0)
    f = _fresnel_dielectric(p.eta, jnp.abs(wo[..., 2]))
    spec_refl = jnp.clip(abs_spec * (1.0 - f) + f, 0.0, 1.0)
    has_t = (dt > 0.0) | (st > 0.0)
    diff_t = jnp.clip(abs_gen * dt * diff_refl, 0.0, 1.0)
    spec_t = jnp.clip((1.0 - f) * abs_gen * (1.0 - metallic) * st, 0.0, 1.0)
    diff_t = jnp.where(has_t, diff_t, 0.0)
    spec_t = jnp.where(has_t, spec_t, 0.0)
    norm = diff_refl + spec_refl + diff_t + spec_t
    bad = norm <= FLT_EPS
    normi = safe_div(1.0, jnp.where(bad, 1.0, norm))
    return (jnp.where(bad, 1.0, diff_refl * normi),
            jnp.where(bad, 0.0, diff_t * normi),
            jnp.where(bad, 0.0, spec_refl * normi),
            jnp.where(bad, 0.0, spec_t * normi))


def _half_for(p, wo, wi):
    trans = ~_same_hemi(wo, wi)
    h_r = normalize(wi + wo)
    h_t = normalize(wi + wo * p.eta[..., None])
    h = jnp.where(trans[..., None], h_t, h_r)
    return _make_same_hemisphere(wo, h)


def principled_eval(colors, scalars, surf, in_dir, out_dir):
    p = P(colors, scalars, surf)
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    wi = to_local(in_dir, surf["t"], surf["b"], surf["n"])
    h = _half_for(p, wo, wi)
    trans = ~_same_hemi(wo, wi)
    andl = jnp.abs(wi[..., 2])

    diffuse_w = (jnp.where(p.thin, 1.0, 1.0 - jnp.clip(p.metallic, 0, 1))
                 * (1.0 - jnp.clip(p.spec_trans, 0, 1)))
    trans_w = (1.0 - jnp.clip(p.metallic, 0, 1)) * jnp.clip(p.spec_trans, 0, 1)

    refl = (p.base_color * (_eval_diffuse(p, wo, wi) * diffuse_w)[..., None]
            + _eval_sheen(p, wi) * diffuse_w[..., None]
            + _eval_reflection(p, wo, wi, h))
    # clearcoat (upper hemisphere gate when top_only)
    in_front = surf["is_entering"] == (wi[..., 2] >= 0)
    out_front = surf["is_entering"] == (wo[..., 2] >= 0)
    cc_ok = (~p.cc_top_only) | (in_front & out_front)
    refl = refl + jnp.where(cc_ok[..., None],
                            _eval_clearcoat(p, wo, wi, h)
                            * p.clearcoat[..., None], 0.0)

    tr = (p.base_color * jnp.where(p.thin,
                                   _eval_translucent(p, wo, wi) * p.diff_trans,
                                   0.0)[..., None]
          + _eval_refraction(p, wo, wi, h) * trans_w[..., None])

    out = jnp.where(trans[..., None], tr, refl)
    return jnp.where((andl <= _GRAZING_EPS)[..., None], 0.0, out)


def _spec_refl_pdf_local(p, wo, wi):
    pwo = _make_positive(wo)
    pwi = _make_positive(wi)
    h = normalize(pwo + pwi)
    cos_h_o = dot(pwo, h)
    t, b, n = _idframe(wo.shape)
    mpdf = mf.pdf_vndf_ggx(t, b, n, pwo, h, p.ru, p.rv)
    mpdf = jnp.where(mpdf <= _MICRO_EPS, 0.0, mpdf)
    return jnp.abs(mpdf * safe_div(1.0, 4.0 * cos_h_o))


def _spec_trans_pdf_local(p, wo, wi):
    pwo = _make_positive(wo)
    pwi = -_make_positive(wi)
    h = normalize(pwi + pwo * p.eta[..., None])
    cos_h_i = dot(pwi, h)
    cos_h_o = dot(pwo, h)
    t, b, n = _idframe(wo.shape)
    mpdf = mf.pdf_vndf_ggx(t, b, n, pwo, h, p.ru_refr, p.rv_refr)
    mpdf = jnp.where(mpdf <= _MICRO_EPS, 0.0, mpdf)
    return jnp.abs(mpdf * mf.refractive_jacobian(p.eta, cos_h_i, cos_h_o))


def principled_pdf(colors, scalars, surf, in_dir, out_dir):
    p = P(colors, scalars, surf)
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    wi = to_local(in_dir, surf["t"], surf["b"], surf["n"])
    bad = (jnp.abs(wo[..., 2]) <= _GRAZING_EPS) | (jnp.abs(wi[..., 2]) <= _GRAZING_EPS)
    dr, dt, sr, st = _lobes(p, wo)
    diff_pdf = cosine_hemisphere_pdf(jnp.abs(wi[..., 2]))
    same = _same_hemi(wo, wi)
    v_same = dr * diff_pdf + sr * _spec_refl_pdf_local(p, wo, wi)
    v_thin = dt * diff_pdf + st
    v_solid = dt * diff_pdf + st * _spec_trans_pdf_local(p, wo, wi)
    out = jnp.where(same, v_same, jnp.where(p.thin, v_thin, v_solid))
    return jnp.where(bad, 0.0, out)


def principled_sample(colors, scalars, surf, u0, u1, u2, out_dir):
    """3 rnd draws (lobe pick + 2); thin spec-transmission uses only 1 but we
    keep the counter at the per-lane actual count via the returned draws."""
    p = P(colors, scalars, surf)
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    ok_wo = jnp.abs(wo[..., 2]) > _GRAZING_EPS
    dr, dt, sr, st = _lobes(p, wo)
    pick = u0

    t, b, n = _idframe(wo.shape)

    # diffuse refl/trans candidate
    s_local, s_pdf = sample_cosine_hemisphere(u1, u2)
    wi_dr = _make_same_hemisphere(wo, s_local)
    pdf_dr = s_pdf * dr + _spec_refl_pdf_local(p, wo, wi_dr) * sr
    wi_dt = -wi_dr
    pdf_dt = s_pdf * dt + _spec_trans_pdf_local(p, wo, wi_dt) * st

    # spec refl candidate
    pwo = _make_positive(wo)
    oh_r = mf.sample_vndf_ggx(u1, u2, t, b, n, pwo, p.ru, p.rv)
    h_r = jnp.where(jnp.signbit(dot(oh_r, pwo))[..., None], -oh_r, oh_r)
    mpdf_r = mf.pdf_vndf_ggx(t, b, n, pwo, h_r, p.ru, p.rv)
    cos_h_o_r = dot(pwo, h_r)
    pwi_r = normalize(2.0 * cos_h_o_r[..., None] * h_r - pwo)
    ok_sr = (_same_hemi(pwo, pwi_r) & (cos_h_o_r > FLT_EPS)
             & (pwi_r[..., 2] > _GRAZING_EPS) & (mpdf_r > _MICRO_EPS))
    wi_sr = _make_same_hemisphere(wo, pwi_r)
    pdf_sr = (jnp.abs(mpdf_r * safe_div(1.0, 4.0 * cos_h_o_r)) * sr
              + cosine_hemisphere_pdf(jnp.abs(wi_sr[..., 2])) * dr)

    # spec trans candidate
    oh_t = mf.sample_vndf_ggx(u1, u2, t, b, n, pwo, p.ru_refr, p.rv_refr)
    h_t = jnp.where(jnp.signbit(dot(oh_t, pwo))[..., None], -oh_t, oh_t)
    mpdf_t = mf.pdf_vndf_ggx(t, b, n, pwo, h_t, p.ru_refr, p.rv_refr)
    cos_h_o_t = dot(pwo, h_t)
    from ignis_jax.bsdf.union import _fresnel
    cos_t, _factor, total = _fresnel(p.eta, cos_h_o_t)
    # refraction direction (vec3_refract semantics)
    refr_dir = normalize(h_t * (p.eta * cos_h_o_t - cos_t)[..., None]
                         - pwo * p.eta[..., None])
    refl_dir = normalize(2.0 * cos_h_o_t[..., None] * h_t - pwo)
    # non-total: refract; total: reflect
    pwi_t = jnp.where(total[..., None], refl_dir, refr_dir)
    ok_refr = (~_same_hemi(pwo, refr_dir) & (cos_h_o_t > FLT_EPS)
               & (-refr_dir[..., 2] > _GRAZING_EPS))
    ok_tirr = (_same_hemi(pwo, refl_dir) & (cos_h_o_t > FLT_EPS)
               & (refl_dir[..., 2] > _GRAZING_EPS))
    ok_st_solid = ((mpdf_t > _MICRO_EPS)
                   & jnp.where(total, ok_tirr, ok_refr))
    wi_st_solid = jnp.where(total[..., None],
                            _make_same_hemisphere(wo, refl_dir),
                            -_make_same_hemisphere(wo, refr_dir))
    jac_t = mf.refractive_jacobian(p.eta, dot(refr_dir, h_t), cos_h_o_t)
    pdf_st_refr = (jnp.abs(mpdf_t * jac_t) * st
                   + cosine_hemisphere_pdf(jnp.abs(wi_st_solid[..., 2])) * dt)
    pdf_st_tir = (mpdf_t * safe_div(1.0, 4.0 * cos_h_o_t) * st
                  + cosine_hemisphere_pdf(jnp.abs(wi_st_solid[..., 2])) * dt)
    pdf_st_solid = jnp.where(total, pdf_st_tir, pdf_st_refr)
    # thin: straight through
    wi_st = jnp.where(p.thin[..., None], -wo, wi_st_solid)
    pdf_st = jnp.where(p.thin, st, pdf_st_solid)
    ok_st = jnp.where(p.thin, jnp.ones_like(ok_st_solid), ok_st_solid)

    # --- pick lobe
    c1 = dr
    c2 = dr + dt
    c3 = dr + dt + st
    is_dr = pick < c1
    is_dt = (~is_dr) & (pick < c2)
    is_st = (~is_dr) & (~is_dt) & (pick < c3)
    is_sr = ~(is_dr | is_dt | is_st)

    wi = jnp.where(is_dr[..., None], wi_dr,
                   jnp.where(is_dt[..., None], wi_dt,
                             jnp.where(is_st[..., None], wi_st, wi_sr)))
    pdf = jnp.where(is_dr, pdf_dr,
                    jnp.where(is_dt, pdf_dt,
                              jnp.where(is_st, pdf_st, pdf_sr)))
    ok = jnp.where(is_st, ok_st, jnp.where(is_sr, ok_sr, s_pdf > 0))
    valid = ok_wo & ok & (pdf > FLT_EPS)

    s_eta = jnp.where(p.thin | _same_hemi(wo, wi), 1.0, p.eta)
    in_dir = to_world(wi, surf["t"], surf["b"], surf["n"])
    ev = principled_eval(colors, scalars, surf, in_dir, out_dir)
    weight = ev * safe_div(1.0, pdf)[..., None]
    draws = jnp.where(is_st & p.thin, jnp.uint32(1), jnp.uint32(3))
    return in_dir, pdf, weight, s_eta, valid, draws
