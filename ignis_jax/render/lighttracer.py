"""Light tracer technique (src/artic/technique/lighttracer.art).

Paths start on lights (sample_emission), bounce through the scene, and at
every non-specular vertex connect to the camera: an occlusion ray toward
the eye plus a framebuffer splat at the projected pixel
(lighttracer.art:71-113 on_shadow + on_advanced_shadow_miss).

Shape: one fori_loop over bounces with all light paths in flight; the
camera splat is a masked scatter-add into the (npix, 3) framebuffer.

Deviation noted for the record: the reference passes adjoint=true to
bsdf.sample (importance transport); our BSDF union currently samples in
radiance convention for all lobes — symmetric lobes are unaffected, the
dielectric eta² factor is not applied (lighttracer.art:120-160).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ignis_jax.bsdf import bsdf_eval, bsdf_sample
from ignis_jax.bsdf.union import bsdf_specular_mask, material_params
from ignis_jax.core import rng
from ignis_jax.core.vec import FLT_EPS, FLT_MAX, dot, normalize, safe_div
from ignis_jax.light.emission import sample_light_emission
from ignis_jax.light.union import select_light
from ignis_jax.render.camera import sample_pixel
from ignis_jax.render.integrator import (
    OFFSET, RAY_BOUNCE, RAY_LIGHT, RAY_SHADOW, _flags_trivial,
    _gather_mat_type, _surface_at, _traverse_any, _traverse_closest,
    _tri_mask_for)

_handle = lambda c, clamp: jnp.minimum(c, clamp) if clamp > 0 else c  # noqa


def render_lighttracer(scene, tables, n_paths, iteration, frame, user_seed):
    """Trace n_paths light paths; returns the unnormalized framebuffer sum
    (npix, 3) for this iteration."""
    tech = scene.technique
    w, h = scene.width, scene.height
    npix = w * h

    idx = jnp.arange(n_paths, dtype=jnp.int32)
    x = idx % w
    y = (idx // w) % h
    sample = (idx // npix).astype(jnp.uint32)
    seed = rng.create_seed(sample, iteration, frame, x, y,
                           jnp.uint32(user_seed))
    counter = jnp.ones((n_paths,), jnp.uint32)

    active = jnp.ones((n_paths,), bool)
    lsel, sel_pdf, counter = select_light(scene, tables, seed, counter,
                                          active)
    em, counter = sample_light_emission(scene, tables, lsel, seed, counter,
                                        active)
    contrib = (em["intensity"]
               * safe_div(jnp.abs(em["cos"]), sel_pdf)[..., None])
    org = em["pos"]
    d = em["dir"]
    tmin = jnp.where(em["infinite"], 0.0, OFFSET)

    fb = jnp.zeros((npix, 3), jnp.float32)

    # ray visibility masks (light rays use the light flag bit first, then
    # bounce; shadow rays use the shadow bit — LoaderEntity.cpp:123-131)
    trav_mask = (None if _flags_trivial(scene)
                 else _tri_mask_for(tables, RAY_BOUNCE))
    shadow_mask = (None if _flags_trivial(scene, RAY_SHADOW)
                   else _tri_mask_for(tables, RAY_SHADOW))

    # depth-0 splat: connect the emission vertex itself to the camera so
    # directly visible area lights render.  The reference's LT drops this
    # vertex (lighttracer.art:60 "TODO: This ignores the first vertex on
    # the light surface"); we keep it for path-tracer parity.
    cs0 = sample_pixel(scene.camera, org)
    in0 = normalize(cs0["dir"])
    cos_e = dot(in0, em["nrm"])          # > 0: camera sees emitting face
    has_le = jnp.max(em["le_area"], axis=-1) > 0.0
    can0 = active & ~em["infinite"] & has_le & cs0["valid"] & (cos_e > FLT_EPS)
    d2_0 = jnp.maximum(dot(cs0["dir"], cs0["dir"]), 1e-12)
    occ0 = _traverse_any(scene, tables, org, cs0["dir"],
                         jnp.full((n_paths,), OFFSET, jnp.float32),
                         jnp.full((n_paths,), 1.0 - OFFSET, jnp.float32),
                         shadow_mask)
    splat0 = _handle(em["le_area"] * safe_div(1.0, sel_pdf)[..., None]
                     * (cs0["weight"] * cos_e / d2_0)[..., None], tech.clamp)
    px0 = jnp.clip(((cs0["nx"] + 1.0) * 0.5 * w).astype(jnp.int32), 0, w - 1)
    py0 = jnp.clip(((1.0 - cs0["ny"]) * 0.5 * h).astype(jnp.int32), 0, h - 1)
    fb = fb.at[py0 * w + px0].add(
        jnp.where((can0 & ~occ0)[..., None], splat0, 0.0))

    st = dict(org=org, dir=d, tmin=tmin, alive=active, contrib=contrib,
              counter=counter, eta=jnp.ones((n_paths,), jnp.float32),
              fb=fb)

    def bounce(depth, st):
        org, d = st["org"], st["dir"]
        alive, contrib, counter = st["alive"], st["contrib"], st["counter"]
        t, u, v, prim = _traverse_closest(scene, tables, org, d, st["tmin"],
                                          jnp.full_like(st["tmin"], FLT_MAX),
                                          trav_mask)
        hit = alive & (prim >= 0)
        prim_s = jnp.maximum(prim, 0)
        t_safe = jnp.where(hit, t, 1.0)
        surf = _surface_at(tables, prim_s, org, d, t_safe, u, v)
        from ignis_jax.bsdf import prepare_surface
        mat_type, specular = prepare_surface(scene, tables, surf, d, org)
        out_dir = -d

        # camera connection (on_shadow, lighttracer.art:71-113)
        cs = sample_pixel(scene.camera, surf["point"])
        in_dir = normalize(cs["dir"])
        cos_o = dot(out_dir, surf["n"])
        cos_i = dot(in_dir, surf["n"])
        can_connect = (hit & ~specular & cs["valid"]
                       & (cos_o * cos_i > FLT_EPS)
                       & (depth + 1 <= tech.max_depth))
        d2 = jnp.maximum(dot(cs["dir"], cs["dir"]), 1e-12)
        factor = safe_div(cos_i, cos_o * d2)
        # adjoint-order eval: light-side dir plays `in` so bsdf_eval's
        # cosine factor is cos_o; `factor` then converts to cos_i/d²
        # (lighttracer.art:95-99)
        f = bsdf_eval(scene, tables, mat_type, surf, out_dir, in_dir)
        splat = _handle(contrib * f * (cs["weight"] * factor)[..., None],
                        tech.clamp)
        occ = _traverse_any(scene, tables, surf["point"], cs["dir"],
                            jnp.full((n_paths,), OFFSET, jnp.float32),
                            jnp.full((n_paths,), 1.0 - OFFSET, jnp.float32),
                            shadow_mask)
        ok = can_connect & ~occ
        px = jnp.clip(((cs["nx"] + 1.0) * 0.5 * w).astype(jnp.int32),
                      0, w - 1)
        py = jnp.clip(((1.0 - cs["ny"]) * 0.5 * h).astype(jnp.int32),
                      0, h - 1)
        pidx = py * w + px
        fb = st["fb"].at[pidx].add(jnp.where(ok[..., None], splat, 0.0))

        # bounce (same as pathtracer but adjoint, lighttracer.art:118-160)
        can_bounce = hit & (depth + 1 <= tech.max_depth)
        bdir, b_pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, st["seed"], counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        eta = st["eta"] * jnp.where(can_bounce & b_valid, b_eta, 1.0)
        rr = jnp.where(specular, 1.0, jnp.clip(
            jnp.max(new_contrib * (eta * eta)[..., None], axis=-1),
            0.05, 0.95))
        rr = jax.lax.stop_gradient(rr)
        u_rr, c_rr = rng.next_f32(st["seed"], counter)
        counter = jnp.where(can_bounce & b_valid, c_rr, counter)
        alive_next = can_bounce & b_valid & (u_rr < rr)
        return dict(
            org=jnp.where(alive_next[..., None], surf["point"], org),
            dir=jnp.where(alive_next[..., None], bdir, d),
            tmin=jnp.full((n_paths,), OFFSET, jnp.float32),
            alive=alive_next,
            contrib=jnp.where(alive_next[..., None],
                              new_contrib * safe_div(1.0, rr)[..., None],
                              contrib),
            counter=counter, eta=eta, seed=st["seed"], fb=fb)

    st["seed"] = seed
    st = jax.lax.fori_loop(1, tech.max_depth + 1, bounce, st)
    return st["fb"]
