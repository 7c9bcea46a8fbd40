"""Progressive photon mapping (src/artic/technique/photonmapper.art).

Two passes per iteration, as in the reference's two-variant technique
(src/runtime/technique/PhotonMappingTechnique.cpp:54-88):

1. **Light pass** — photons start on lights, bounce only through specular
   surfaces, and deposit at the first diffuse vertex (LS*D paths,
   photonmapper.art:175-245: on_hit stores, on_bounce continues only when
   specular).  Shape: fixed photon count, bounded fori over depth.
2. **Camera pass** — a path tracer without NEE; at every diffuse vertex it
   gathers photons within a progressively shrinking radius using the
   Simpson kernel (photonmapper.art:50-55), direct light hits count only
   for specular-only paths (path_type gate, :287-300).

Photon map: instead of the reference's morton-hashed 128³ grid with atomic
counters (photonmapper.art:424-470), photons are sorted by linear cell id
(one XLA sort) and queried per 3×3×3 neighborhood via searchsorted +
bounded gather — regular memory traffic, no atomics.  The per-cell scan
cap bounds worst-case work; overflow photons beyond the cap in one cell
are dropped from the estimate (logged cap, default 64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ignis_jax.bsdf import bsdf_eval, bsdf_sample
from ignis_jax.bsdf.union import bsdf_specular_mask, material_params
from ignis_jax.core import rng
from ignis_jax.core.vec import FLT_EPS, FLT_MAX, dot, safe_div
from ignis_jax.light.emission import sample_light_emission
from ignis_jax.light.union import env_emission_and_pdf, select_light
from ignis_jax.render.integrator import (
    OFFSET, RAY_BOUNCE, _area_light_radiance, _flags_trivial,
    _gather_mat_type, _surface_at, _traverse_closest, _tri_mask_for)

GRID = 32          # photon-grid resolution per axis (reference: 128)
CELL_CAP = 64      # max photons scanned per cell per query


def ppm_compute_radius(max_radius: float, it: int) -> float:
    """Progressive radius shrink (photonmapper.art:248-258)."""
    contract = 0.8
    r = max_radius
    for i in range(it):
        r *= (i + 1 + contract) / (i + 2)
    return max(r, 1e-5)


def _cell_of(pos, bbox_min, inv_ext):
    q = jnp.clip((pos - bbox_min) * inv_ext * 0.99, 0.0, 0.999999)
    idx = (q * GRID).astype(jnp.int32)
    return idx


def _cell_id(idx):
    return (idx[..., 2] * GRID + idx[..., 1]) * GRID + idx[..., 0]


def trace_photons(scene, tables, n_photons, iteration, frame, user_seed):
    """Light pass: returns dict of photon arrays (pos, in_dir, power,
    depth, valid) with shape (n_photons, ...)."""
    tech = scene.technique
    w, h = scene.width, scene.height

    idx = jnp.arange(n_photons, dtype=jnp.int32)
    # photon work ids hash like pixel work (photonmapper.art:151)
    x = idx % jnp.int32(w)
    y = (idx // jnp.int32(w))
    seed = rng.create_seed(jnp.zeros((n_photons,), jnp.uint32),
                           iteration, frame, x, y, jnp.uint32(user_seed))
    counter = jnp.ones((n_photons,), jnp.uint32)

    active = jnp.ones((n_photons,), bool)
    lsel, sel_pdf, counter = select_light(scene, tables, seed, counter,
                                          active)
    em, counter = sample_light_emission(scene, tables, lsel, seed, counter,
                                        active)
    contrib = (em["intensity"]
               * safe_div(jnp.abs(em["cos"]), sel_pdf)[..., None])

    trav_mask = (None if _flags_trivial(scene)
                 else _tri_mask_for(tables, RAY_BOUNCE))

    st = dict(org=em["pos"], dir=em["dir"],
              tmin=jnp.where(em["infinite"], 0.0, OFFSET),
              alive=active, contrib=contrib, counter=counter, seed=seed,
              eta=jnp.ones((n_photons,), jnp.float32), light=lsel,
              p_pos=jnp.zeros((n_photons, 3), jnp.float32),
              p_dir=jnp.zeros((n_photons, 3), jnp.float32),
              p_pow=jnp.zeros((n_photons, 3), jnp.float32),
              p_depth=jnp.zeros((n_photons,), jnp.int32),
              p_valid=jnp.zeros((n_photons,), bool))

    max_light_depth = min(tech.max_light_depth, tech.max_depth)

    def bounce(depth, st):
        org, d = st["org"], st["dir"]
        alive, contrib, counter = st["alive"], st["contrib"], st["counter"]
        t, u, v, prim = _traverse_closest(scene, tables, org, d, st["tmin"],
                                          jnp.full_like(st["tmin"], FLT_MAX),
                                          trav_mask)
        hit = alive & (prim >= 0)
        prim_s = jnp.maximum(prim, 0)
        surf = _surface_at(tables, prim_s, org, d, jnp.where(hit, t, 1.0),
                           u, v)
        from ignis_jax.bsdf import prepare_surface
        mat_type, specular = prepare_surface(scene, tables, surf, d, org)
        emissive = surf["light_id"] >= 0
        out_dir = -d
        cos_o = dot(out_dir, surf["n"])

        # deposit (photonmapper.art:181-201): first diffuse vertex
        store = hit & ~emissive & ~specular & (cos_o > FLT_EPS) \
            & ~st["p_valid"]
        sc = store[..., None]
        st = dict(st,
                  p_pos=jnp.where(sc, surf["point"], st["p_pos"]),
                  p_dir=jnp.where(sc, out_dir, st["p_dir"]),
                  p_pow=jnp.where(sc, contrib, st["p_pow"]),
                  p_depth=jnp.where(store, depth, st["p_depth"]),
                  p_valid=st["p_valid"] | store)

        # continue only through specular (photonmapper.art:204-233)
        can_bounce = hit & specular & (depth + 2 <= max_light_depth)
        bdir, b_pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, st["seed"], counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        nonzero = jnp.max(new_contrib, axis=-1) > FLT_EPS
        alive_next = can_bounce & b_valid & nonzero
        return dict(
            st,
            org=jnp.where(alive_next[..., None], surf["point"], org),
            dir=jnp.where(alive_next[..., None], bdir, d),
            tmin=jnp.full((n_photons,), OFFSET, jnp.float32),
            alive=alive_next,
            contrib=jnp.where(alive_next[..., None], new_contrib, contrib),
            counter=counter,
            eta=st["eta"] * jnp.where(alive_next, b_eta, 1.0))

    st = jax.lax.fori_loop(1, max_light_depth + 1, bounce, st)
    return dict(pos=st["p_pos"], in_dir=st["p_dir"], power=st["p_pow"],
                depth=st["p_depth"], valid=st["p_valid"], light=st["light"])


def build_photon_grid(scene, photons):
    """Sort photons by linear grid cell; returns grid dict for gathers."""
    bbox_min = jnp.asarray(scene.bbox_min, jnp.float32)
    ext = jnp.asarray(scene.bbox_max - scene.bbox_min, jnp.float32)
    inv_ext = safe_div(1.0, jnp.maximum(ext, 1e-20))

    cid = _cell_id(_cell_of(photons["pos"], bbox_min, inv_ext))
    cid = jnp.where(photons["valid"], cid, GRID * GRID * GRID)  # dead → end
    order = jnp.argsort(cid)
    return dict(
        cell_sorted=cid[order],
        pos=photons["pos"][order],
        in_dir=photons["in_dir"][order],
        power=photons["power"][order],
        depth=photons["depth"][order],
        valid=photons["valid"][order],
        bbox_min=bbox_min, inv_ext=inv_ext)


def gather_photons(scene, tables, grid, surf, mat_type, out_dir, radius,
                   cam_depth, active, max_count):
    """Density-estimation gather (photonmapper.art:305-330): Simpson-kernel
    weighted BSDF response of photons within `radius`, / max photon count."""
    tech = scene.technique
    n = out_dir.shape[0]
    pos = surf["point"]
    r2 = radius * radius
    cos_o = dot(out_dir, surf["n"])

    lo = _cell_of(pos - radius[..., None], grid["bbox_min"],
                  grid["inv_ext"])
    contrib = jnp.zeros((n, 3), jnp.float32)

    csort = grid["cell_sorted"]
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                idx = lo + jnp.asarray([dx, dy, dz], jnp.int32)
                ok_cell = jnp.all(idx < GRID, axis=-1) & active
                cell = _cell_id(jnp.clip(idx, 0, GRID - 1))
                start = jnp.searchsorted(csort, cell)
                end = jnp.searchsorted(csort, cell + 1)
                count = jnp.minimum(end - start, CELL_CAP)

                def body(j, acc):
                    pi = jnp.minimum(start + j,
                                     csort.shape[0] - 1)
                    in_range = (j < count) & ok_cell
                    ppos = grid["pos"][pi]
                    d2 = jnp.sum((pos - ppos) ** 2, axis=-1)
                    pdir = grid["in_dir"][pi]
                    cos_i = dot(pdir, surf["n"])
                    depth_ok = (cam_depth + grid["depth"][pi]
                                <= tech.max_depth)
                    use = (in_range & (d2 <= r2) & depth_ok
                           & (cos_o * cos_i > FLT_EPS))
                    # Simpson kernel (photonmapper.art:50-55)
                    ir2 = safe_div(1.0, r2)
                    term = 1.0 - d2 * ir2
                    k = term * term * 3.0 * ir2 * jnp.float32(1.0 / np.pi)
                    f = bsdf_eval(scene, tables, mat_type, surf, pdir,
                                  out_dir)
                    # strip eval's cos_i: the projection is handled on the
                    # light side (photonmapper.art:320-323)
                    wgt = safe_div(k, jnp.abs(cos_i))
                    add = grid["power"][pi] * f * wgt[..., None]
                    return acc + jnp.where(use[..., None], add, 0.0)

                contrib = jax.lax.fori_loop(0, CELL_CAP, body, contrib)
    return contrib / jnp.float32(max_count)


def render_ppm(scene, tables, grid, work_x, work_y, work_sample, iteration,
               frame, user_seed, radius, max_count):
    """Camera pass over a work list; returns (npix,3) framebuffer sum."""
    tech = scene.technique
    w, h = scene.width, scene.height
    npix = w * h
    n = work_x.shape[0]

    from ignis_jax.render.integrator import _emit_camera
    seed, counter, org, d, tmin, tmax = _emit_camera(
        scene, work_x, work_y, work_sample, iteration, frame, user_seed,
        tables=tables)
    pixel = work_y * w + work_x

    trav_mask = (None if _flags_trivial(scene)
                 else _tri_mask_for(tables, RAY_BOUNCE))
    inf_ids = [i for i, l in enumerate(scene.lights)
               if l.infinite and not l.delta]

    st = dict(org=org, dir=d, tmin=tmin, alive=jnp.ones((n,), bool),
              seed=seed, counter=counter,
              contrib=jnp.ones((n, 3), jnp.float32),
              eta=jnp.ones((n,), jnp.float32),
              path_type=jnp.zeros((n,), jnp.int32),
              radius=jnp.zeros((n,), jnp.float32),
              fb=jnp.zeros((npix, 3), jnp.float32))

    def handle(c):
        return jnp.minimum(c, tech.clamp) if tech.clamp > 0 else c

    def bounce(depth, st):
        org, d = st["org"], st["dir"]
        alive, contrib, counter = st["alive"], st["contrib"], st["counter"]
        t, u, v, prim = _traverse_closest(scene, tables, org, d, st["tmin"],
                                          jnp.full_like(st["tmin"], FLT_MAX),
                                          trav_mask)
        hit = alive & (prim >= 0)
        miss = alive & ~hit
        prim_s = jnp.maximum(prim, 0)
        t_safe = jnp.where(hit, t, 1.0)
        surf = _surface_at(tables, prim_s, org, d, t_safe, u, v)
        from ignis_jax.bsdf import prepare_surface
        mat_type, specular = prepare_surface(scene, tables, surf, d, org)
        out_dir = -d
        splat = jnp.zeros((n, 3), jnp.float32)

        # miss: env only for specular-only paths (photonmapper.art:287-300)
        if inf_ids:
            mc = jnp.zeros((n, 3), jnp.float32)
            for lid in inf_ids:
                emit, _ = env_emission_and_pdf(scene, tables, lid, d)
                mc = mc + handle(contrib * emit)
            splat = splat + jnp.where(
                (miss & (st["path_type"] == 0))[..., None], mc, 0.0)

        # direct light hit, LS*E only (photonmapper.art:283-297)
        is_emissive = surf["light_id"] >= 0
        dot_n = -dot(d, surf["n"])
        lidx = jnp.maximum(surf["light_id"], 0)
        radiance = _area_light_radiance(scene, tables, lidx)
        emit_ok = (hit & is_emissive & surf["is_entering"]
                   & (dot_n > FLT_EPS) & (st["path_type"] == 0))
        splat = splat + jnp.where(emit_ok[..., None],
                                  handle(contrib * radiance), 0.0)

        # final gather at diffuse vertices (photonmapper.art:302-334)
        footprint = t_safe * jnp.float32(0.017455064)
        r_here = jnp.where(depth > 1, st["radius"],
                           jnp.minimum(radius, footprint))
        gather_ok = (hit & ~is_emissive & ~specular
                     & (depth + 1 <= tech.max_depth)
                     & (jnp.abs(dot(out_dir, surf["n"])) > FLT_EPS))
        g = gather_photons(scene, tables, grid, surf, mat_type, out_dir,
                           r_here, depth, gather_ok, max_count)
        splat = splat + jnp.where(gather_ok[..., None],
                                  handle(contrib * g), 0.0)

        fb = st["fb"].at[pixel].add(jnp.where(alive[..., None], splat, 0.0))

        # bounce (photonmapper.art:363-399)
        can_bounce = hit & (depth + 1 <= tech.max_depth)
        bdir, b_pdf, b_weight, b_eta, b_valid, counter = bsdf_sample(
            scene, tables, mat_type, surf, st["seed"], counter, out_dir,
            active=can_bounce)
        new_contrib = contrib * b_weight
        eta = st["eta"] * jnp.where(can_bounce & b_valid, b_eta, 1.0)
        rr = jnp.where(depth + 1 > tech.min_depth, jnp.clip(
            jnp.max(new_contrib * (eta * eta)[..., None], axis=-1),
            0.05, 0.95), 1.0)
        rr = jax.lax.stop_gradient(rr)
        u_rr, c_rr = rng.next_f32(st["seed"], counter)
        counter = jnp.where(can_bounce & b_valid, c_rr, counter)
        alive_next = can_bounce & b_valid & (u_rr < rr)
        return dict(
            st,
            org=jnp.where(alive_next[..., None], surf["point"], org),
            dir=jnp.where(alive_next[..., None], bdir, d),
            tmin=jnp.full((n,), OFFSET, jnp.float32),
            alive=alive_next,
            contrib=jnp.where(alive_next[..., None],
                              new_contrib * safe_div(1.0, rr)[..., None],
                              contrib),
            counter=counter, eta=eta,
            path_type=jnp.where(alive_next & ~specular, 1, st["path_type"]),
            radius=jnp.where(alive_next, r_here, st["radius"]),
            fb=fb)

    st = jax.lax.fori_loop(1, tech.max_depth + 1, bounce, st)
    return st["fb"]
