"""Wavefront path tracer (the `path` technique).

Restructuring of the reference pipeline for whole-array JAX code: instead of
JIT-specialized per-material hit shaders dispatched over sorted ray ranges
(driver/mapping_cpu.art:694-836), every bounce processes a fixed-capacity ray
wave with masked lanes — divergence-free array code under a `lax.while_loop`.
Technique logic (NEE, MIS weights, russian roulette, payload layout) mirrors
src/artic/technique/pathtracer.art exactly, and the RNG draw order matches the
reference per lane, giving bit-stable path replay (SURVEY.md §8.10).

Two drivers share the same bounce core:

* `trace_wave` — one ray per lane traced to completion (igtrace ray lists,
  and the differentiable fixed-depth scan for path-replay gradients).
* `render_wavefront` — the production camera path: dead lanes are refilled
  with fresh (pixel, sample) work every bounce, which is the reference's
  regenerate/compact design (mapping_cpu.art:724-731) expressed as masked
  in-place refill instead of stream compaction; radiance is scatter-added
  into the framebuffer by pixel id.

Payload (pathtracer.art:7-31): inv_pdf, contrib, depth (starts at 1), eta.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ignis_jax.bsdf import (
    bsdf_eval, bsdf_pdf, bsdf_sample, bsdf_specular_mask, prepare_surface,
)
from ignis_jax.core import rng
from ignis_jax.core.dgather import gather_rows
from ignis_jax.core.vec import (
    FLT_EPS, FLT_MAX, cross, dot, length, normalize, orthonormal_basis,
    safe_div,
)
from ignis_jax.light import (
    env_emission_and_pdf, light_pdf_direct_solid, sample_light_direct,
    select_light_uniform,
)
from ignis_jax.light.union import light_select_pdf, select_light
from ignis_jax.ops import traverse
from ignis_jax.ops.bw_tlas import tlas_traverse_xla
from ignis_jax.render.camera import generate_rays, pixel_coord_from_xy

OFFSET = np.float32(0.001)  # ray offset (pathtracer.art:41)

RAY_CAMERA = 0x1
RAY_LIGHT = 0x2
RAY_BOUNCE = 0x4
RAY_SHADOW = 0x8

def _handle_color(c, clamp_value):
    if clamp_value > 0:
        return jnp.minimum(c, jnp.float32(clamp_value))
    return c


def _tri_mask_for(tables, flag_bit):
    ent_flags = tables["ent_flags"]
    return (ent_flags[tables["tri_ent"]] & flag_bit) != 0


def _flags_trivial(scene, bit=None):
    ent_flags = np.asarray(scene.tables["ent_flags"])
    if bit is None:
        return bool((ent_flags == 0xF).all())
    return bool(((ent_flags & bit) != 0).all())


def sphere_prim_base(tables):
    """First prim id of the analytic-sphere range: past the soup and the
    instanced pool (see _traverse_closest combine and _surface_at)."""
    base = tables["tri_v0"].shape[0]
    if "tl_inst" in tables:
        base += tables["tl_inst"].shape[0] * tables["tl_tris"].shape[0]
    return base


def _traverse_closest(scene, tables, org, d, tmin, tmax, tri_mask,
                      mask_bit=None):
    """Closest hit over the soup (ops/traverse.py picks the path), the
    instanced pool and the analytic spheres.

    `tri_mask` is the per-triangle visibility array of the soup; `mask_bit`
    the equivalent ray-class bit (MASK_CAMERA/BOUNCE/SHADOW) for the
    instanced pool and the spheres, whose records carry packed
    visibility bits.

    Traversal is DETACHED (path-replay backprop, SURVEY.md §7.1): hit
    results (t, u, v, prim) are piecewise-constant in the differentiable
    parameter set (BSDF/texture/light/medium values — geometry and
    visibility are out of scope), so reverse AD must not trace through
    intersection.  stop_gradient on the ray inputs cuts the tape here,
    which (a) zeroes the sample-placement term exactly as the detached
    path-replay estimator prescribes and (b) leaves the traversal kernel
    without tangents, so it needs no differentiation rule.
    """
    org, d, tmin, tmax = map(jax.lax.stop_gradient, (org, d, tmin, tmax))
    out = traverse.closest(tables, org, d, tmin, tmax, tri_mask)
    mb = traverse.MASK_BOUNCE if mask_bit is None else mask_bit
    if "tl_inst" in tables:
        # ---- instanced pool (two-level TLAS, ops/bw_tlas.py): combine
        # with the soup result; pool hits are encoded past the soup id
        # range as base + instance*pool_rows + pool_row so the instance
        # binding survives the (t, u, v, prim) plumbing.
        tt, tu, tv, ti, te = tlas_traverse_xla(
            tables, org, d, tmin, tmax, mask_bit=mb,
            meta=getattr(scene, "tlas_meta", None))
        t0, u0, v0, p0 = out
        base = tables["tri_v0"].shape[0]
        pool_rows = tables["tl_tris"].shape[0]
        pick = (ti >= 0) & ((tt < t0) | (p0 < 0))
        enc = base + te * pool_rows + ti
        out = (jnp.where(pick, tt, t0), jnp.where(pick, tu, u0),
               jnp.where(pick, tv, v0), jnp.where(pick, enc, p0))
    if "sph_rows" in tables:
        # ---- analytic spheres (ops/spheres.py): dense XLA sweep combined
        # the same way; ids encode past soup + pool.
        from ignis_jax.ops.spheres import sphere_closest
        st_, su, sv, si = sphere_closest(tables, org, d, tmin, tmax,
                                         mask_bit=mb)
        t0, u0, v0, p0 = out
        pick = (si >= 0) & ((st_ < t0) | (p0 < 0))
        enc = sphere_prim_base(tables) + si
        out = (jnp.where(pick, st_, t0), jnp.where(pick, su, u0),
               jnp.where(pick, sv, v0), jnp.where(pick, enc, p0))
    return out


def _traverse_any(scene, tables, org, d, tmin, tmax, tri_mask,
                  mask_bit=None):
    """Any-hit dispatch; detached like `_traverse_closest` (occlusion is a
    visibility discontinuity — zero derivative almost everywhere)."""
    org, d, tmin, tmax = map(jax.lax.stop_gradient, (org, d, tmin, tmax))
    occ = traverse.any_hit(tables, org, d, tmin, tmax, tri_mask)
    mb = traverse.MASK_SHADOW if mask_bit is None else mask_bit
    if "tl_inst" in tables:
        out = tlas_traverse_xla(tables, org, d, tmin, tmax, mask_bit=mb,
                                meta=getattr(scene, "tlas_meta", None))
        occ = occ | (out[3] >= 0)
    if "sph_rows" in tables:
        from ignis_jax.ops.spheres import sphere_any
        occ = occ | sphere_any(tables, org, d, tmin, tmax, mask_bit=mb)
    return occ


def _surface_at(tables, prim, org, direction, t, u, v):
    """SurfaceElement for hit lanes (shapes/trimesh.art:14-40).

    All per-triangle attributes come from ONE consolidated gather of the
    packed (T, 28) `tri_shade` row (api.py _pack_tri_shade) instead of a
    dozen separate gathers.
    """
    if "tri_shade" in tables:
        base = tables["tri_shade"].shape[0]
        row = gather_rows(tables["tri_shade"], jnp.minimum(prim, base - 1))
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
        ent = row[:, 24].astype(jnp.int32)
        mat_id = row[:, 25].astype(jnp.int32)
        light_id = row[:, 26].astype(jnp.int32)
        if "tl_inst" in tables:
            # pooled (instanced) hits: decode instance/row, fetch LOCAL
            # attributes from the shared pool and lift them to world space
            # with the instance's transform (normals via the inverse-
            # transpose; edges via toWorld so the shared cross-product
            # math below yields correct world face normal AND area)
            pool_rows = tables["tl_tris"].shape[0]
            ninst = tables["tl_inst"].shape[0]
            pooled = (prim >= base) & (prim < base + ninst * pool_rows)
            enc = jnp.maximum(prim - base, 0)
            inst = jnp.minimum(enc // pool_rows, ninst - 1)
            lrow_i = jnp.minimum(enc % pool_rows, pool_rows - 1)
            prow = gather_rows(tables["tl_shade"], lrow_i)
            irow = gather_rows(tables["tl_inst"], inst)
            nrow = gather_rows(tables["tl_norm"], inst)
            nm = nrow[:, 0:9].reshape(-1, 3, 3)
            tw = nrow[:, 10:22].reshape(-1, 3, 4)
            aply = lambda M, x: jnp.einsum(
                "nij,nj->ni", M, x, precision=jax.lax.Precision.HIGHEST)
            pv0 = aply(tw[:, :, :3], prow[:, 0:3]) + tw[:, :, 3]
            pe1 = aply(tw[:, :, :3], prow[:, 3:6])
            pe2 = aply(tw[:, :, :3], prow[:, 6:9])
            pn0 = normalize(aply(nm, prow[:, 9:12]))
            pn1 = normalize(aply(nm, prow[:, 12:15]))
            pn2 = normalize(aply(nm, prow[:, 15:18]))
            sel = pooled[..., None]
            v0 = jnp.where(sel, pv0, v0)
            e1 = jnp.where(sel, pe1, e1)
            e2 = jnp.where(sel, pe2, e2)
            n0 = jnp.where(sel, pn0, n0)
            n1 = jnp.where(sel, pn1, n1)
            n2 = jnp.where(sel, pn2, n2)
            uv0 = jnp.where(sel, prow[:, 18:20], uv0)
            uv1 = jnp.where(sel, prow[:, 20:22], uv1)
            uv2 = jnp.where(sel, prow[:, 22:24], uv2)
            p_ent = irow[:, 22].astype(jnp.int32)
            ent = jnp.where(pooled, p_ent, ent)
            mat_id = jnp.where(
                pooled, gather_rows(tables["ent_mat"], p_ent), mat_id)
            light_id = jnp.where(pooled, -1, light_id)  # pool is non-emissive
    else:
        v0 = tables["tri_v0"][prim]
        e1 = tables["tri_e1"][prim]
        e2 = tables["tri_e2"][prim]
        n0 = tables["tri_n0"][prim]
        n1 = tables["tri_n1"][prim]
        n2 = tables["tri_n2"][prim]
        uv0 = tables["tri_uv0"][prim]
        uv1 = tables["tri_uv1"][prim]
        uv2 = tables["tri_uv2"][prim]
        ent = tables["tri_ent"][prim]
        mat_id = tables["ent_mat"][ent]
        light_id = tables["ent_light"][ent]
    nraw = cross(e1, e2)
    nlen = length(nraw)
    face_n = nraw * safe_div(1.0, nlen)[..., None]
    inv_area = safe_div(1.0, 0.5 * nlen)
    ns = normalize(n0 * (1.0 - u - v)[..., None] + n1 * u[..., None] + n2 * v[..., None])
    point = org + direction * t[..., None]
    tex = (uv0 * (1.0 - u - v)[..., None] + uv1 * u[..., None] + uv2 * v[..., None])
    if "sph_rows" in tables:
        # analytic sphere hits (ops/spheres.py; sphere.art:45-70): normal
        # straight from the center, uv carried in (u, v) by the traversal
        sbase = sphere_prim_base(tables)
        issph = prim >= sbase
        srows = tables["sph_rows"].shape[0]
        srow = gather_rows(tables["sph_rows"],
                           jnp.clip(prim - sbase, 0, srows - 1))
        sc = srow[:, 0:3]
        sr = jnp.maximum(srow[:, 3], 1e-30)
        s_ent = srow[:, 4].astype(jnp.int32)
        n_out = (point - sc) / sr[:, None]
        n_out = normalize(n_out)
        sel = issph[..., None]
        face_n = jnp.where(sel, n_out, face_n)
        ns = jnp.where(sel, n_out, ns)
        inv_area = jnp.where(issph, 1.0 / (4.0 * np.pi * sr * sr),
                             inv_area)
        tex = jnp.where(sel, jnp.stack([u, v], axis=-1), tex)
        ent = jnp.where(issph, s_ent, ent)
        mat_id = jnp.where(issph, gather_rows(tables["ent_mat"], s_ent),
                           mat_id)
        light_id = jnp.where(issph, gather_rows(tables["ent_light"], s_ent),
                             light_id)
    entering = dot(direction, face_n) <= 0.0
    sgn = jnp.where(entering, 1.0, -1.0)[..., None]
    ns = ns * sgn
    face_n = face_n * sgn
    tb, bb = orthonormal_basis(ns)
    return dict(point=point, n=ns, ng=face_n, is_entering=entering,
                inv_area=inv_area, tex=tex, t=tb, b=bb,
                ent=ent, mat_id=mat_id, light_id=light_id,
                prim_coords=jnp.stack([u, v], axis=-1))


def _pexpr_ctx(tables, surf, org, d):
    """Lane context for PExpr-valued properties (Transpiler.cpp:261-287)."""
    ent = surf["ent"]
    lm = gather_rows(tables["ent_local_mat"], ent)  # (N, 3, 4)
    lp = jnp.einsum("nij,nj->ni", lm[:, :, :3], surf["point"],
                    precision=jax.lax.Precision.HIGHEST) + lm[:, :, 3]
    lo = gather_rows(tables["ent_lbbox_min"], ent)
    hi = gather_rows(tables["ent_lbbox_max"], ent)
    ext = hi - lo
    np_ = jnp.where(ext == 0, 0.0, (lp - lo) / jnp.where(ext == 0, 1.0, ext))
    return dict(uv=surf["tex"],
                uvw=jnp.concatenate(
                    [surf["tex"], jnp.zeros(surf["tex"].shape[:-1] + (1,),
                                            jnp.float32)], axis=-1),
                prim_coords=surf["prim_coords"], P=surf["point"], Np=np_,
                V=-d, Ro=org, N=surf["n"], Ng=surf["ng"], Nx=surf["t"],
                Ny=surf["b"], frontside=surf["is_entering"],
                entity_id=surf["ent"])


def _bounce_core(scene, tables, st, tri_mask, shadow_mask, mask_bit=None):
    """One wavefront bounce for all lanes of `st`.

    st keys: org, dir, tmin, tmax, alive, seed, counter, inv_pdf, contrib,
    depth, eta (+ medium, voldepth under volpath).  Returns (splat (N,3),
    st_next) — splat holds this bounce's radiance contributions
    (miss/emissive/NEE) for alive lanes.

    With technique `volpath` the bounce additionally performs homogeneous
    medium transport (src/artic/technique/volpathtracer.art): transmittance on
    every contribution, distance-sampled absorption/scatter events, and
    medium-interface tracking on transmissive surface bounces.
    """
    tech = scene.technique
    is_vol = tech.type == "volpath"
    num_lights = scene.num_lights
    sel_pdf_const = (jnp.float32(1.0 / num_lights) if num_lights > 0
                     else jnp.float32(1.0))
    inf_ids = [i for i, l in enumerate(scene.lights)
               if l.infinite and not l.delta]

    org, d = st["org"], st["dir"]
    alive = st["alive"]
    seed = st["seed"]
    counter = st["counter"]
    contrib = st["contrib"]
    inv_pdf = st["inv_pdf"]
    depth = st["depth"]
    eta = st["eta"]
    n = org.shape[0]

    t, u, v, prim = _traverse_closest(scene, tables, org, d, st["tmin"],
                                      st["tmax"], tri_mask, mask_bit=mask_bit)
    hit = alive & (prim >= 0)
    miss = alive & ~hit
    splat = jnp.zeros((n, 3), jnp.float32)

    # ---- surface for hit lanes (miss lanes carry t = FLT_MAX → clamp so the
    # masked-lane surface stays finite; inf would leak NaNs into the backward
    # pass through 0 * inf cotangents)
    prim_s = jnp.maximum(prim, 0)
    t_safe = jnp.where(hit, t, 1.0)
    surf = _surface_at(tables, prim_s, org, d, t_safe, u, v)
    mat_type, specular = prepare_surface(scene, tables, surf, d, org)

    # ---- medium coefficients of each lane's current medium (volpath)
    if is_vol:
        from ignis_jax.medium import (
            medium_coefficients, medium_eval, medium_eval_inf)
        med = st["medium"]
        mctx = _pexpr_ctx(tables, surf, org, d)
        m_sa, m_ss, m_g = medium_coefficients(scene, tables, med, mctx)
        hitvol = medium_eval(scene, tables, med, m_sa, m_ss, org,
                             surf["point"], seed=seed, counter=counter)
        inf_tr = medium_eval_inf(scene, tables, med, m_sa, m_ss, org, d)
        was_medium = jnp.signbit(inv_pdf)
        inv_pdf_eff = jnp.maximum(inv_pdf, 0.0)
        # Lanes continuing a null-scattering flight re-trace the same
        # segment: suppress the surface/miss/NEE splats they already
        # contributed at first arrival (the reference loops the null chain
        # inside on_bounce — volpathtracer.art:209-260 sample_rec — so
        # those callbacks fire once per original segment).
        nullfl = st.get("nullfl", jnp.zeros((n,), bool))
    else:
        nullfl = jnp.zeros((n,), bool)
        hitvol = jnp.ones((n, 3), jnp.float32)
        inf_tr = jnp.ones((n, 3), jnp.float32)
        was_medium = jnp.zeros((n,), bool)
        inv_pdf_eff = inv_pdf

    # ---- on_miss: infinite, non-delta lights (pathtracer.art:137-162)
    if inf_ids:
        miss_color = jnp.zeros((n, 3), jnp.float32)
        for lid in inf_ids:
            emit, pdf_s = env_emission_and_pdf(scene, tables, lid, d)
            if tech.enable_nee and num_lights > 0:
                lpdf = tables["light_sel_pdf"][lid]
                mis = 1.0 / (1.0 + inv_pdf_eff * lpdf * pdf_s)
            else:
                mis = jnp.ones((n,), jnp.float32)
            miss_color = miss_color + _handle_color(
                contrib * emit * inf_tr * mis[..., None], tech.clamp)
        splat = splat + jnp.where((miss & ~nullfl)[..., None],
                                  miss_color, 0.0)

    # ---- on_hit: emissive surfaces (pathtracer.art:115-135)
    if any(l.type in (1, 2, 8) for l in scene.lights):
        is_emissive = surf["light_id"] >= 0
        dot_n = -dot(d, surf["n"])
        lidx = jnp.maximum(surf["light_id"], 0)
        pdf_s = light_pdf_direct_solid(
            scene, tables, lidx, org, d, t_safe, -dot(d, surf["ng"]),
            surf["prim_coords"], is_emissive)
        radiance = _area_light_radiance(scene, tables, lidx)
        if tech.enable_nee:
            lpdf = light_select_pdf(scene, tables, lidx, org)
            mis = 1.0 / (1.0 + inv_pdf_eff * lpdf * pdf_s)
        else:
            mis = jnp.ones((n,), jnp.float32)
        emit_ok = (hit & is_emissive & surf["is_entering"]
                   & (dot_n > FLT_EPS) & ~nullfl)
        ec = _handle_color(contrib * radiance * hitvol * mis[..., None],
                           tech.clamp)
        splat = splat + jnp.where(emit_ok[..., None], ec, 0.0)

    # ---- on_shadow: NEE (pathtracer.art:52-113)
    do_nee = (tech.enable_nee and num_lights > 0)
    if do_nee:
        nee_active = hit & ~specular & (depth + 1 <= tech.max_depth) & ~nullfl
        lsel, sel_pdf, counter = select_light(
            scene, tables, seed, counter, nee_active,
            from_pos=surf["point"])
        ls, counter = sample_light_direct(
            scene, tables, lsel, surf["point"], surf["is_entering"],
            seed, counter, nee_active)
        pdf_l_s = ls["pdf_solid"] * sel_pdf
        out_dir = -d
        pdf_e_s = bsdf_pdf(scene, tables, mat_type, surf,
                           ls["dir"], out_dir)
        mis = jnp.where(ls["delta"] | was_medium, 1.0,
                        1.0 / (1.0 + safe_div(pdf_e_s, pdf_l_s)))
        factor = safe_div(ls["pdf_value"], pdf_l_s)
        bsdf_c = bsdf_eval(scene, tables, mat_type, surf,
                           ls["dir"], out_dir)
        sc = _handle_color(
            ls["intensity"] * contrib * bsdf_c * (mis * factor)[..., None],
            tech.clamp)
        if is_vol:
            # attenuate by transmittance to this hit + toward the light
            # (volpathtracer.art:40-83)
            from ignis_jax.medium import medium_eval, medium_eval_inf
            seg_fin = medium_eval(scene, tables, med, m_sa, m_ss,
                                  surf["point"], ls["pos"],
                                  seed=seed, counter=counter)
            seg_inf = medium_eval_inf(scene, tables, med, m_sa, m_ss,
                                      surf["point"], ls["dir"])
            seg = jnp.where(ls["infinite"][..., None], seg_inf, seg_fin)
            sc = sc * hitvol * seg
        shadow_valid = (nee_active & (pdf_l_s > FLT_EPS)
                        & (ls["cos"] > FLT_EPS))
        shadow_contrib = jnp.where(shadow_valid[..., None], sc, 0.0)
        s_org = surf["point"]
        finite_dir = ls["pos"] - surf["point"]
        s_dir = jnp.where(ls["infinite"][..., None], ls["dir"], finite_dir)
        s_tmax = jnp.where(ls["infinite"], FLT_MAX, 1.0 - OFFSET)

    # ---- on_bounce (pathtracer.art:166-200 / volpathtracer.art:155-296)
    can_bounce = hit & (depth + 1 <= tech.max_depth)
    out_dir = -d

    if is_vol:
        from ignis_jax.medium import medium_eval, medium_sample, phase_sample
        voldepth = st["voldepth"]
        max_scat = max([m.get("max_scattering", 8)
                        for m in scene.media] + [8])
        # Pure-absorption homogeneous media (glTF KHR_materials_volume
        # attenuation): deterministic closed-form transmittance (hitvol)
        # instead of absorb-event sampling — identical in expectation,
        # cheaper, and pathwise-differentiable w.r.t. sigma_a (the
        # DragonAttenuation inverse-rendering path).
        absorb_only = [m["type"] in ("homogeneous", "constant")
                       and not m.get("sigma_s_expr")
                       and not m.get("sigma_a_expr")
                       and float(np.asarray(
                           scene.tables["medium_data"][mi, 3:6]).max()) == 0.0
                       for mi, m in enumerate(scene.media)]
        if any(absorb_only):
            ao_mask = jnp.asarray(absorb_only)[jnp.maximum(med, 0)] \
                & (med >= 0)
        else:
            ao_mask = jnp.zeros((n,), bool)
        allow_medium = (voldepth + 1 <= max_scat) & ~ao_mask
        ms, counter = medium_sample(scene, tables, med, m_sa, m_ss, seed,
                                    counter, org, surf["point"],
                                    can_bounce & allow_medium)
        medium_event = ms["valid"]

        # particle event probabilities from the sample-local homogenized
        # properties (volpathtracer/common.art:39-52); for heterogeneous
        # media sigma_n is the fictional (null) coefficient
        ext_h = ms["sigma_a"] + ms["sigma_s"] + ms["sigma_n"]
        lanes = jnp.arange(n)
        mu_ind = jnp.argmax(ext_h, axis=-1)
        mu_t_p = jnp.maximum(ext_h[lanes, mu_ind], 1e-30)
        mu_a_p = ms["sigma_a"][lanes, mu_ind]
        mu_s_p = ms["sigma_s"][lanes, mu_ind]
        p_a = jnp.where(mu_a_p <= FLT_EPS, 0.0, mu_a_p / mu_t_p)
        p_s = jnp.where(mu_s_p <= FLT_EPS, 0.0, mu_s_p / mu_t_p)
        p_f = jnp.maximum(1.0 - p_a - p_s, 0.0)

        r_ev, counter_ev = rng.next_f32(seed, counter)
        counter = jnp.where(medium_event, counter_ev, counter)
        absorb = medium_event & (r_ev < p_a)
        scatter = medium_event & ~absorb & (r_ev < p_a + p_s)
        null_ev = medium_event & ~absorb & ~scatter

        # absorption event: emission splat (volpathtracer.art:216-221)
        # NOTE: 1/max(p, 1e-30) keeps the PRIMAL finite but its VJP is
        # -1/p^2 = 1e60, which overflows f32 to inf and NaNs the zero
        # cotangent of masked lanes; where-substitute instead.
        inv_pa = jnp.where(p_a > 1e-6,
                           1.0 / jnp.where(p_a > 1e-6, p_a, 1.0), 0.0)
        em_c = (contrib * ms["color"] * ms["sigma_a"] * ms["emission"]
                * inv_pa[..., None])
        splat = splat + jnp.where(absorb[..., None],
                                  _handle_color(em_c, tech.clamp), 0.0)

        # scatter branch: phase sample + RR
        ph_dir, ph_pdf, ph_w, counter = phase_sample(m_g, seed, counter,
                                                     out_dir, scatter)
        inv_ps = jnp.where(p_s > 1e-6,
                           1.0 / jnp.where(p_s > 1e-6, p_s, 1.0), 0.0)
        path_contrib = (ms["color"] * ms["sigma_s"]
                        * inv_ps[..., None] * ph_w[..., None])
        contrib_m = contrib * path_contrib
        rr_m = jax.lax.stop_gradient(jnp.clip(
            jnp.max(contrib_m * (eta * eta)[..., None], axis=-1), 0.05, 0.95))
        u_rr_m, c_rr_m = rng.next_f32(seed, counter)
        counter = jnp.where(scatter, c_rr_m, counter)
        scatter_alive = scatter & (u_rr_m < rr_m)

        # surface branch: attenuated background when the volume depth is
        # exhausted (transmittance eval), plain pass otherwise (weight white)
        surf_branch = can_bounce & ~medium_event
        in_dir, b_pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, seed, counter, out_dir,
            active=surf_branch)
        vol_trans = jnp.where(allow_medium[..., None], 1.0, hitvol)
        contrib_s = contrib * vol_trans * b_weight
        rr_s = jnp.where(specular, 1.0, jnp.clip(
            jnp.max(contrib_s * (eta * eta)[..., None], axis=-1), 0.05, 0.95))
        rr_s = jax.lax.stop_gradient(rr_s)
        u_rr_s, c_rr_s = rng.next_f32(seed, counter)
        counter = jnp.where(surf_branch & b_valid, c_rr_s, counter)
        surf_alive = surf_branch & b_valid & (u_rr_s < rr_s)
        # medium interface crossing (volpathtracer.art:183-186,274-276)
        is_transmission = jnp.signbit(dot(surf["n"], in_dir))
        inner = gather_rows(tables["ent_inner_medium"], surf["ent"])
        outer = gather_rows(tables["ent_outer_medium"], surf["ent"])
        picked = jnp.where(surf["is_entering"], inner, outer)
        med_s = jnp.where(is_transmission, picked, med)
        depth_s = jnp.where(is_transmission, depth, depth + 1)
        voldepth_s = jnp.where(is_transmission, 0, voldepth)

        # null-scattering event: continue forward from the fictional
        # collision with reweighted contribution, voldepth unchanged
        # (volpathtracer.art:249-259 — the sample_rec recursion)
        inv_pf = jnp.where(p_f > 1e-6,
                           1.0 / jnp.where(p_f > 1e-6, p_f, 1.0), 0.0)
        null_contrib = (contrib * ms["color"] * ms["sigma_n"]
                        * inv_pf[..., None])

        alive_next = scatter_alive | surf_alive | null_ev
        sc_c = scatter_alive[..., None]
        nl_c = null_ev[..., None]
        med_ev = scatter_alive | null_ev
        org_next = jnp.where(med_ev[..., None], ms["pos"], surf["point"])
        dir_next = jnp.where(sc_c, ph_dir, jnp.where(nl_c, d, in_dir))
        tmin_next = jnp.where(med_ev, 0.0, OFFSET)
        contrib_next = jnp.where(
            sc_c, contrib_m * safe_div(1.0, rr_m)[..., None],
            jnp.where(nl_c, null_contrib,
                      contrib_s * safe_div(1.0, rr_s)[..., None]))
        inv_pdf_next = jnp.where(med_ev, -1.0,
                                 jnp.where(specular, 0.0,
                                           safe_div(1.0, b_pdf)))
        depth_next = jnp.where(med_ev, depth, depth_s)
        voldepth_next = jnp.where(scatter_alive, voldepth + 1,
                                  jnp.where(null_ev, voldepth, voldepth_s))
        eta_next = jnp.where(med_ev, eta, eta * b_eta)
        med_next = jnp.where(med_ev, med, med_s)
        nullfl_next = null_ev
    else:
        in_dir, b_pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, seed, counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        # russian roulette (pbrt v4 variant, pathtracer.art:5, :185);
        # detached — a sampling decision, not part of the integrand.
        rr_base = jnp.max(new_contrib * (eta * eta)[..., None], axis=-1)
        rr_prob = jnp.where(depth + 1 > tech.min_depth,
                            jnp.clip(rr_base, 0.05, 0.95), 1.0)
        rr_prob = jax.lax.stop_gradient(rr_prob)
        u_rr, counter_rr = rng.next_f32(seed, counter)
        rr_draw = can_bounce & b_valid
        counter = jnp.where(rr_draw, counter_rr, counter)
        survive = u_rr < rr_prob
        alive_next = rr_draw & survive
        org_next = surf["point"]
        dir_next = in_dir
        tmin_next = jnp.full((n,), OFFSET, jnp.float32)
        contrib_next = new_contrib * safe_div(1.0, rr_prob)[..., None]
        inv_pdf_next = jnp.where(specular, 0.0, safe_div(1.0, b_pdf))
        depth_next = depth + 1
        voldepth_next = st.get("voldepth", jnp.zeros((n,), jnp.int32))
        eta_next = eta * b_eta
        med_next = st.get("medium", jnp.full((n,), -1, jnp.int32))
        nullfl_next = jnp.zeros((n,), bool)

    # ---- trace shadow rays & splat (mapping on_shadow_miss)
    if do_nee:
        occ = _traverse_any(scene, tables, s_org, s_dir,
                            jnp.full((n,), OFFSET, jnp.float32),
                            s_tmax, shadow_mask)
        splat = splat + jnp.where((shadow_valid & ~occ)[..., None],
                                  shadow_contrib, 0.0)
        n_shadow = jnp.sum(shadow_valid.astype(jnp.float32))
        n_shadow_hit = jnp.sum((shadow_valid & occ).astype(jnp.float32))
    else:
        n_shadow = jnp.float32(0.0)
        n_shadow_hit = jnp.float32(0.0)

    # per-bounce quantities (Statistics.h:9-66 Quantity analogs), carried
    # as cheap scalars: [hits, misses, shadow rays, occluded shadow rays,
    # bounce continuations]
    quants = jnp.stack([
        jnp.sum(hit.astype(jnp.float32)),
        jnp.sum(miss.astype(jnp.float32)),
        n_shadow, n_shadow_hit,
        jnp.sum(alive_next.astype(jnp.float32)),
    ])

    st_next = dict(
        org=jnp.where(alive_next[..., None], org_next, org),
        dir=jnp.where(alive_next[..., None], dir_next, d),
        tmin=jnp.where(alive_next, tmin_next, st["tmin"]),
        tmax=jnp.where(alive_next, FLT_MAX, st["tmax"]),
        alive=alive_next,
        seed=seed,
        counter=counter,
        inv_pdf=jnp.where(alive_next, inv_pdf_next, inv_pdf),
        contrib=jnp.where(alive_next[..., None], contrib_next, contrib),
        depth=jnp.where(alive_next, depth_next, depth),
        eta=jnp.where(alive_next, eta_next, eta),
        medium=jnp.where(alive_next, med_next,
                         st.get("medium", jnp.full((n,), -1, jnp.int32))),
        voldepth=jnp.where(alive_next, voldepth_next,
                           st.get("voldepth", jnp.zeros((n,), jnp.int32))),
        nullfl=jnp.where(alive_next, nullfl_next, nullfl) & alive_next,
    )
    return splat, st_next, quants


def _emit_camera(scene, x, y, sample, iteration, frame, user_seed,
                 tables=None, spi=1):
    """Camera emitter (driver/emitter.art:6-16): seed, sampler draws, ray."""
    n = x.shape[0]
    seed = rng.create_seed(sample, iteration, frame, x, y, jnp.uint32(user_seed))
    counter = jnp.full((n,), 1, dtype=jnp.uint32)
    sampler = scene.sampler
    # sample index for low-discrepancy samplers (emitter.art:9: iter*spi+sample)
    spp_index = (iteration.astype(jnp.int32) * jnp.int32(spi)
                 + sample.astype(jnp.int32))
    if sampler in ("mjitt", "multijitt", "multijittered"):
        from ignis_jax.render.sampler import sample_mjitt
        rx, ry, counter = sample_mjitt(seed, counter, spp_index, x, y)
    elif sampler == "halton" and tables is not None and \
            "halton_offsets" in tables:
        from ignis_jax.render.sampler import sample_halton
        rx, ry = sample_halton(scene.halton_setup, tables["halton_offsets"],
                               spp_index, x, y, scene.width)
    else:  # independent/uniform
        rx, counter = rng.next_f32(seed, counter)
        ry, counter = rng.next_f32(seed, counter)
    nx, ny = pixel_coord_from_xy(x, y, scene.width, scene.height, rx, ry)
    # camera pose from the parameter registry (__camera_* keys,
    # Runtime.cpp:703-708): traced, so pose changes never recompile
    dyn = None
    reg = getattr(scene, "param_registry", None)
    if tables is not None and reg and "__camera_eye" in reg \
            and "params" in tables:
        p = tables["params"]

        def _sl(nm):
            _, off, sz = reg[nm]
            return p[off:off + sz]
        dyn = (_sl("__camera_eye"), _sl("__camera_dir"), _sl("__camera_up"))
    lens_uv = None
    if scene.camera.aperture_radius > 0.0:
        u1, counter = rng.next_f32(seed, counter)
        u2, counter = rng.next_f32(seed, counter)
        lens_uv = (u1, u2)
    org, direction, tmin, tmax = generate_rays(scene.camera, nx, ny, dyn=dyn,
                                               lens_uv=lens_uv)
    return seed, counter, org, direction, tmin, tmax


def trace_wave(scene, tables, x, y, sample, iteration, frame, user_seed,
               org=None, direction=None, tmin=None, tmax=None,
               differentiable=False):
    """Trace one wave of rays to completion; returns per-lane radiance (N, 3).

    If org/direction are given, acts as the list emitter (igtrace semantics,
    driver/emitter.art:18-31): no pixel-sampler draws, rays used as provided.

    differentiable=True swaps the `while_loop` for a fixed-length `lax.scan`
    over max_depth bounces so reverse-mode AD works (while_loop has no
    transpose rule).
    """
    tech = scene.technique
    n = x.shape[0]

    if tech.type in ("debug", "ao", "wireframe", "lightvisibility",
                     "camera_check", "infobuffer"):
        from ignis_jax.render.techniques import simple_technique_wave
        return simple_technique_wave(scene, tables, x, y, sample, iteration,
                                     frame, user_seed, org, direction,
                                     tmin, tmax)

    if org is None:
        seed, counter, org, direction, tmin, tmax = _emit_camera(
            scene, x, y, sample, iteration, frame, user_seed, tables)
    else:
        seed = rng.create_seed(sample, iteration, frame, x, y,
                               jnp.uint32(user_seed))
        counter = jnp.full((n,), 1, dtype=jnp.uint32)

    state = dict(
        org=org, dir=direction, tmin=tmin, tmax=tmax,
        alive=jnp.ones((n,), bool),
        seed=seed, counter=counter,
        inv_pdf=jnp.zeros((n,), jnp.float32),
        contrib=jnp.ones((n, 3), jnp.float32),
        depth=jnp.ones((n,), jnp.int32),
        eta=jnp.ones((n,), jnp.float32),
        medium=jnp.full((n,), -1, jnp.int32),
        voldepth=jnp.zeros((n,), jnp.int32),
        nullfl=jnp.zeros((n,), bool),
        accum=jnp.zeros((n, 3), jnp.float32),
        bounce_index=jnp.int32(0),
    )

    trivial = _flags_trivial(scene)
    mask_cam = None if trivial else _tri_mask_for(tables, RAY_CAMERA)
    mask_bounce = None if trivial else _tri_mask_for(tables, RAY_BOUNCE)
    shadow_mask = (None if _flags_trivial(scene, RAY_SHADOW)
                   else _tri_mask_for(tables, RAY_SHADOW))

    def bounce_body(state):
        if trivial:
            tri_mask = None
        else:
            tri_mask = jnp.where(state["bounce_index"] == 0, mask_cam,
                                 mask_bounce)
        mbit = jnp.where(state["bounce_index"] == 0,
                         jnp.int32(traverse.MASK_CAMERA),
                         jnp.int32(traverse.MASK_BOUNCE))
        splat, st_next, _q = _bounce_core(scene, tables, state, tri_mask,
                                          shadow_mask, mask_bit=mbit)
        st_next["accum"] = state["accum"] + splat
        st_next["bounce_index"] = state["bounce_index"] + 1
        return st_next

    def cond(state):
        return jnp.any(state["alive"])

    if differentiable:
        def scan_body(s, _):
            return bounce_body(s), None
        state, _ = jax.lax.scan(scan_body, state, None,
                                length=min(tech.max_depth, 64))
        return state["accum"]

    tail_cap = 2048
    if n <= tail_cap * 2:
        state = jax.lax.while_loop(cond, bounce_body, state)
        return state["accum"]

    # tail cascade (see render_wavefront): full-width waves while busy, then
    # compact the survivors into a narrow wave and scatter their radiance
    # back per lane.
    def cond_wide(st):
        return jnp.sum(st["alive"].astype(jnp.int32)) > tail_cap

    state = jax.lax.while_loop(cond_wide, bounce_body, state)
    order = jnp.argsort(~state["alive"])[:tail_cap]
    tail = {k: (v[order] if k not in ("bounce_index",) else v)
            for k, v in state.items()}
    tail["accum"] = jnp.zeros((tail_cap, 3), jnp.float32)
    tail = jax.lax.while_loop(cond, bounce_body, tail)
    return state["accum"].at[order].add(tail["accum"])


def render_wavefront(scene, tables, work_x, work_y, work_sample,
                     iteration, frame, user_seed, capacity, spi=1,
                     tail_capacity=4096, work_mode="tables",
                     work_total=None):
    """Render a full work list through a fixed-capacity regenerating wave.

    work_*: (W,) per-work-item pixel x/y and sample index.  Returns the
    unnormalized framebuffer sum (H*W, 3) for this iteration.  Equivalent to
    the reference's regenerate/trace/shade loop with bounded queues
    (mapping_cpu.art:694-836) — dead lanes immediately pick up fresh camera
    work, so tail bounces of long paths never run at low occupancy.

    work_mode="arith" (production fast path): the work list is the
    canonical pixel×sample enumeration, derived ARITHMETICALLY from the
    work id (work_* may be None) and radiance lands in a per-work-item
    slot buffer scattered with unique indices, so the regenerate step has
    no per-lane gather of work tables and no colliding pixel scatter.

    Tail cascade: once the work list is exhausted and the survivor count
    fits `tail_capacity`, the alive lanes are compacted into a narrow wave
    so the long-path tail doesn't pay full-wave cost per bounce (on glass
    scenes most iterations otherwise run at a few percent occupancy).
    """
    tech = scene.technique
    npix = scene.width * scene.height
    arith = work_mode == "arith"
    w_total = int(work_total) if arith else work_x.shape[0]
    if arith:
        assert w_total == npix * spi, "arith work mode is pixel x sample"
    c = capacity

    trivial = _flags_trivial(scene)
    # Mixed camera/bounce lanes per wave: exact per-ray visibility needs
    # camera==bounce masks; scenes violating that fall back to trace_wave in
    # the Runtime (api.py).
    prim_mask = None if trivial else _tri_mask_for(tables, RAY_BOUNCE)
    shadow_mask = (None if _flags_trivial(scene, RAY_SHADOW)
                   else _tri_mask_for(tables, RAY_SHADOW))

    state = dict(
        org=jnp.zeros((c, 3), jnp.float32),
        dir=jnp.concatenate([jnp.zeros((c, 2), jnp.float32),
                             jnp.ones((c, 1), jnp.float32)], axis=1),
        tmin=jnp.zeros((c,), jnp.float32),
        tmax=jnp.zeros((c,), jnp.float32),
        alive=jnp.zeros((c,), bool),
        seed=jnp.zeros((c,), jnp.uint32),
        counter=jnp.ones((c,), jnp.uint32),
        inv_pdf=jnp.zeros((c,), jnp.float32),
        contrib=jnp.ones((c, 3), jnp.float32),
        depth=jnp.ones((c,), jnp.int32),
        eta=jnp.ones((c,), jnp.float32),
        medium=jnp.full((c,), -1, jnp.int32),
        voldepth=jnp.zeros((c,), jnp.int32),
        nullfl=jnp.zeros((c,), bool),
        # In arith mode `pixel` holds the WORK-ITEM id (unique per lane at
        # all times — init slots sit past the buffer so jnp drops them)
        pixel=(jnp.int32(w_total) + jnp.arange(c, dtype=jnp.int32)
               if arith else jnp.zeros((c,), jnp.int32)),
        next_work=jnp.int32(0),
        fb=jnp.zeros((w_total if arith else npix, 3), jnp.float32),
        # stats: [wave iters, alive-lane visits, tail iters, camera rays
        # emitted, hits, misses, shadow rays, occluded shadows, bounce
        # continuations] (Statistics.h quantity analogs, cheap scalars)
        stats=jnp.zeros((9,), jnp.float32),
    )

    def body(st):
        # ---- regenerate: dead lanes pull the next work items
        dead = ~st["alive"]
        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        wid = st["next_work"] + rank
        take = dead & (wid < w_total)
        wid_c = jnp.clip(wid, 0, w_total - 1)
        if arith:
            pix = wid_c % npix
            gx = pix % scene.width
            gy = pix // scene.width
            gs = (wid_c // npix).astype(jnp.uint32)
        else:
            gx = work_x[wid_c]
            gy = work_y[wid_c]
            gs = work_sample[wid_c]
        seed_n, counter_n, org_n, dir_n, tmin_n, tmax_n = _emit_camera(
            scene, gx, gy, gs, iteration, frame, user_seed, tables, spi)

        sel = take[..., None]
        st = dict(st)
        st["org"] = jnp.where(sel, org_n, st["org"])
        st["dir"] = jnp.where(sel, dir_n, st["dir"])
        st["tmin"] = jnp.where(take, tmin_n, st["tmin"])
        st["tmax"] = jnp.where(take, tmax_n, st["tmax"])
        st["seed"] = jnp.where(take, seed_n, st["seed"])
        st["counter"] = jnp.where(take, counter_n, st["counter"])
        st["inv_pdf"] = jnp.where(take, 0.0, st["inv_pdf"])
        st["contrib"] = jnp.where(sel, 1.0, st["contrib"])
        st["depth"] = jnp.where(take, 1, st["depth"])
        st["eta"] = jnp.where(take, 1.0, st["eta"])
        st["medium"] = jnp.where(take, -1, st["medium"])
        st["voldepth"] = jnp.where(take, 0, st["voldepth"])
        st["nullfl"] = jnp.where(take, False, st["nullfl"])
        st["pixel"] = jnp.where(take, wid_c if arith
                                else gy * scene.width + gx, st["pixel"])
        st["alive"] = st["alive"] | take
        st["next_work"] = st["next_work"] + jnp.sum(take.astype(jnp.int32))

        # ---- one bounce for the whole wave
        splat, st_next, q = _bounce_core(scene, tables, st, prim_mask,
                                         shadow_mask)
        fb = st["fb"].at[st["pixel"]].add(
            jnp.where(st["alive"][..., None], splat, 0.0),
            unique_indices=arith)
        st_next["pixel"] = st["pixel"]
        st_next["next_work"] = st["next_work"]
        st_next["fb"] = fb
        inc = jnp.concatenate([
            jnp.stack([jnp.float32(1.0),
                       jnp.sum(st["alive"].astype(jnp.float32)),
                       jnp.float32(0.0),
                       jnp.sum(take.astype(jnp.float32))]), q])
        st_next["stats"] = st["stats"] + inc
        return st_next

    def _fb_out(fb):
        # arith mode: per-work-item slots → per-pixel sums
        return fb.reshape(spi, npix, 3).sum(axis=0) if arith else fb

    tail_cap = int(min(tail_capacity, c))
    if tail_cap >= c:
        def cond(st):
            return (st["next_work"] < w_total) | jnp.any(st["alive"])
        state = jax.lax.while_loop(cond, body, state)
        return _fb_out(state["fb"]), state["stats"]

    def cond_wide(st):
        return ((st["next_work"] < w_total)
                | (jnp.sum(st["alive"].astype(jnp.int32)) > tail_cap))

    state = jax.lax.while_loop(cond_wide, body, state)

    # ---- compact survivors into the narrow tail wave (alive lanes first)
    order = jnp.argsort(~state["alive"])[:tail_cap]
    lane_keys = ("org", "dir", "tmin", "tmax", "alive", "seed", "counter",
                 "inv_pdf", "contrib", "depth", "eta", "medium", "voldepth",
                 "nullfl", "pixel")
    tail = {k: state[k][order] for k in lane_keys}
    tail["fb"] = state["fb"]
    tail["stats"] = state["stats"]

    def tail_body(st):
        splat, st_next, q = _bounce_core(scene, tables, st, prim_mask,
                                         shadow_mask)
        st_next["fb"] = st["fb"].at[st["pixel"]].add(
            jnp.where(st["alive"][..., None], splat, 0.0),
            unique_indices=arith)
        st_next["pixel"] = st["pixel"]
        inc = jnp.concatenate([
            jnp.stack([jnp.float32(0.0),
                       jnp.sum(st["alive"].astype(jnp.float32)),
                       jnp.float32(1.0), jnp.float32(0.0)]), q])
        st_next["stats"] = st["stats"] + inc
        return st_next

    def tail_cond(st):
        return jnp.any(st["alive"])

    tail = jax.lax.while_loop(tail_cond, tail_body, tail)
    return _fb_out(tail["fb"]), tail["stats"]


def _gather_mat_type(scene, tables, mat_id):
    types = jnp.asarray(scene.bsdf_types, dtype=jnp.int32)
    return gather_rows(types, mat_id)


def _area_light_radiance(scene, tables, light_idx):
    """Radiance color of area lights by id (layout per light type)."""
    data = gather_rows(tables["light_data"], light_idx)
    ltype = gather_rows(tables["light_type"], light_idx)
    from ignis_jax.scene.compile import LIGHT_AREA_PLANE
    return jnp.where((ltype == LIGHT_AREA_PLANE)[..., None],
                     data[:, 13:16], data[:, 0:3])
