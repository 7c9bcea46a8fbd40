"""Light emission sampling — photon/light-path starting points.

Batched counterpart of the reference lights' `sample_emission`
(src/artic/light/{point,area,directional,spot,env}.art) used by the
light tracer and photon mapper emitters
(src/artic/technique/{lighttracer.art:35-59, photonmapper.art:147-171}).

Counter discipline: every active lane consumes exactly 4 draws regardless
of light type, keeping the batched union's RNG counters aligned (light
emitters are separate from the camera emitter, so only self-consistency
and determinism matter — not draw-for-draw parity with the reference).

`intensity` is returned already divided by (pos_pdf × dir_pdf), matching
make_emission_sample semantics (src/artic/driver/light.art).
"""

from __future__ import annotations

import jax.numpy as jnp

from ignis_jax.core import rng
from ignis_jax.core.vec import (
    length, orthonormal_basis, safe_div, to_world)
from ignis_jax.core.warp import (
    sample_cosine_hemisphere, sample_equal_area_sphere, sample_triangle,
    sample_uniform_cone, sample_uniform_disk, sample_uniform_sphere)
from ignis_jax.scene.compile import (
    LIGHT_AREA_MESH, LIGHT_AREA_PLANE, LIGHT_AREA_SPHERE,
    LIGHT_DIRECTIONAL, LIGHT_ENV,
    LIGHT_ENV_CDF, LIGHT_POINT, LIGHT_SPOT, LIGHT_SUN)


def _env_sample_pos(u1, u2, out_dir, center, radius):
    """Position on the scene-bounding disk behind an infinite light
    (light/env.art:2-7 env_sample_pos).  out_dir points TOWARD the light."""
    disk, pdf = sample_uniform_disk(u1, u2, radius)
    t, b = orthonormal_basis(out_dir)
    pos = (center + out_dir * radius
           + t * disk[..., 0:1] + b * disk[..., 1:2])
    return pos, pdf


def sample_light_emission(scene, tables, light_idx, seed, counter, active):
    """Sample an outgoing photon (pos, dir, intensity, cos) for each lane's
    selected light.  Returns (dict, counter)."""
    n = light_idx.shape[0]
    u1, c = rng.next_f32(seed, counter)
    u2, c = rng.next_f32(seed, c)
    u3, c = rng.next_f32(seed, c)
    u4, c = rng.next_f32(seed, c)
    counter = jnp.where(active, c, counter)

    center = jnp.asarray(scene.scene_center(), jnp.float32)
    radius = jnp.float32(scene.scene_radius())

    pos = jnp.zeros((n, 3), jnp.float32)
    d = jnp.zeros((n, 3), jnp.float32)
    d = d.at[:, 2].set(1.0)
    inten = jnp.zeros((n, 3), jnp.float32)
    cos = jnp.ones((n,), jnp.float32)
    infinite = jnp.zeros((n,), bool)
    # direct-visibility helpers for the light tracer's depth-0 camera
    # connection (the vertex the reference's LT drops, lighttracer.art:60):
    # le_area = Le / pdf_A (0 for delta/infinite emitters), nrm = face normal
    le_area = jnp.zeros((n, 3), jnp.float32)
    nrm_out = jnp.zeros((n, 3), jnp.float32)

    for lid, info in enumerate(scene.lights):
        m = light_idx == lid
        data = tables["light_data"][lid]
        if info.type == LIGHT_POINT:
            sd, sp = sample_uniform_sphere(u1, u2)
            p_l = jnp.broadcast_to(data[0:3], (n, 3))
            i_l = data[3:6] * safe_div(1.0, sp)[..., None]
            c_l = jnp.ones((n,), jnp.float32)
        elif info.type == LIGHT_AREA_PLANE:
            origin, xa, ya, nrm = data[0:3], data[3:6], data[6:9], data[9:12]
            area, radiance = data[12], data[13:16]
            p_l = origin + xa * u1[..., None] + ya * u2[..., None]
            local, cpdf = sample_cosine_hemisphere(u3, u4)
            nn = jnp.broadcast_to(nrm, (n, 3))
            t, b = orthonormal_basis(nn)
            sd = to_world(local, t, b, nn)
            w = safe_div(area, cpdf)  # 1/(area_pdf * dir_pdf)
            i_l = radiance * w[..., None]
            c_l = local[..., 2]
        elif info.type == LIGHT_AREA_MESH:
            radiance = data[0:3]
            toff = data[3].astype(jnp.int32)
            tcount = data[4]
            ux = u1 * tcount
            f = jnp.minimum(ux.astype(jnp.int32),
                            tcount.astype(jnp.int32) - 1)
            bu, bv = sample_triangle(ux - f.astype(jnp.float32), u2)
            t_i = toff + f
            v0 = tables["tri_v0"][t_i]
            e1 = tables["tri_e1"][t_i]
            e2 = tables["tri_e2"][t_i]
            nraw = jnp.cross(e1, e2)
            nlen = jnp.maximum(length(nraw), 1e-20)
            fn = nraw / nlen[..., None]
            area = 0.5 * nlen
            pdfv = safe_div(1.0, area) / jnp.maximum(tcount, 1.0)
            p_l = v0 + e1 * bu[..., None] + e2 * bv[..., None]
            local, cpdf = sample_cosine_hemisphere(u3, u4)
            t, b = orthonormal_basis(fn)
            sd = to_world(local, t, b, fn)
            i_l = radiance * safe_div(1.0, pdfv * cpdf)[..., None]
            c_l = local[..., 2]
        elif info.type == LIGHT_AREA_SPHERE:
            # sample_emission (light/area.art:276-279): equal-area point,
            # cosine direction about the outward normal
            radiance = data[0:3]
            r_s, c_s, area_s = data[3], data[4:7], data[8]
            outward, _dp = sample_equal_area_sphere(u1, u2)
            fn = outward
            p_l = c_s + outward * r_s
            local, cpdf = sample_cosine_hemisphere(u3, u4)
            t, b = orthonormal_basis(fn)
            sd = to_world(local, t, b, fn)
            pdfv = safe_div(1.0, area_s)
            i_l = jnp.broadcast_to(radiance, (n, 3)) * safe_div(
                1.0, pdfv * cpdf)[..., None]
            c_l = local[..., 2]
        elif info.type == LIGHT_DIRECTIONAL:
            prop = jnp.broadcast_to(data[0:3], (n, 3))  # toward the scene
            p_l, ppdf = _env_sample_pos(u1, u2, -prop, center, radius)
            sd = prop
            i_l = data[3:6] * safe_div(1.0, ppdf)[..., None]
            c_l = jnp.ones((n,), jnp.float32)
        elif info.type == LIGHT_SPOT:
            axis = jnp.broadcast_to(data[3:6], (n, 3))
            cos_cut, cos_fall = data[9], data[10]
            local, cpdf = sample_uniform_cone(u1, u2, cos_cut)
            t, b = orthonormal_basis(axis)
            sd = to_world(local, t, b, axis)
            blend = cos_fall - cos_cut
            ca = local[..., 2]
            tt = jnp.clip(safe_div(ca - cos_cut, blend), 0.0, 1.0)
            smooth = tt * tt * (3.0 - 2.0 * tt)
            fall = jnp.where(blend <= 1e-6,
                             jnp.where(ca <= cos_cut, 0.0, 1.0), smooth)
            # spot_area * cone_pdf = 1 for uniform cone (light/spot.art:41-47)
            i_l = data[6:9] * fall[..., None]
            p_l = jnp.broadcast_to(data[0:3], (n, 3))
            c_l = ca
        elif info.type == LIGHT_SUN:
            sdir = jnp.broadcast_to(data[0:3], (n, 3))  # toward the sun
            cos_angle = data[9]
            local, cpdf = sample_uniform_cone(u1, u2, cos_angle)
            t, b = orthonormal_basis(sdir)
            outward = to_world(local, t, b, sdir)
            p_l, ppdf = _env_sample_pos(u3, u4, outward, center, radius)
            sd = -outward
            i_l = data[3:6] * safe_div(1.0, ppdf * cpdf)[..., None]
            c_l = jnp.ones((n,), jnp.float32)
        elif info.type in (LIGHT_ENV, LIGHT_ENV_CDF):
            # equal-area sphere direction + disk position
            # (light/env.art:87-93; the CDF variant uses the same unbiased
            # uniform-direction emission estimator here)
            outward, dpdf = sample_equal_area_sphere(u1, u2)
            rad = _env_radiance_dir(scene, tables, lid, outward)
            p_l, ppdf = _env_sample_pos(u3, u4, outward, center, radius)
            sd = -outward
            i_l = rad * safe_div(1.0, ppdf * dpdf)[..., None]
            c_l = jnp.ones((n,), jnp.float32)
        else:
            continue
        if info.type == LIGHT_AREA_PLANE:
            data_ = tables["light_data"][lid]
            la = data_[13:16] * data_[12]            # radiance * area
            ln = jnp.broadcast_to(data_[9:12], (n, 3))
        elif info.type in (LIGHT_AREA_MESH, LIGHT_AREA_SPHERE):
            la = i_l * cpdf[..., None]               # radiance / pdf_A
            ln = fn
        else:
            la = jnp.zeros((n, 3), jnp.float32)
            ln = sd
        mc = m[..., None]
        pos = jnp.where(mc, p_l, pos)
        d = jnp.where(mc, sd, d)
        inten = jnp.where(mc, i_l, inten)
        cos = jnp.where(m, c_l, cos)
        infinite = jnp.where(m, info.infinite, infinite)
        le_area = jnp.where(mc, la, le_area)
        nrm_out = jnp.where(mc, ln, nrm_out)

    return dict(pos=pos, dir=d, intensity=inten, cos=cos,
                infinite=infinite, le_area=le_area, nrm=nrm_out), counter


def _env_radiance_dir(scene, tables, lid, out_dir):
    """Env radiance along an outward direction (shared with union's
    emission eval)."""
    from ignis_jax.light.union import env_emission_and_pdf
    # env emission evaluates along the ray direction toward the env,
    # which is the outward direction here (light/env.art:94)
    emit, _ = env_emission_and_pdf(scene, tables, lid, out_dir)
    return emit
