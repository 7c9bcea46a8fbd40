"""Auxiliary (non-path) techniques: debug, ao, wireframe, lightvisibility,
camera_check, infobuffer.

Counterparts of src/artic/technique/{debugtracer,aotracer,wireframe,
lightvisibility,camera_check,infobuffer}.art — all single-intersection
programs batched over the whole wave.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ignis_jax.core import rng
from ignis_jax.core.vec import (
    FLT_EPS, FLT_MAX, absolute_cos, dot, length, safe_div, to_world, vec3,
)
from ignis_jax.core.warp import sample_cosine_hemisphere

# DebugMode enum values in scene-name order (DebugMode.cpp:5-34)
DEBUG_MODES = [
    "normal", "tangent", "bitangent", "geometric normal", "local normal",
    "local tangent", "local bitangent", "local geometric normal",
    "texture coords", "prim coords", "point", "local point",
    "generated coords", "hit distance", "area", "raw prim id", "prim id",
    "raw entity id", "entity id", "raw material id", "material id",
    "is emissive", "is specular", "is entering", "check bsdf", "albedo",
    "medium inner", "medium outer",
]

# color_map from debugtracer.art:1-26
_COLOR_MAP = np.array([
    [0.450000, 0.376630, 0.112500], [0.112500, 0.450000, 0.405978],
    [0.112500, 0.450000, 0.229891], [0.450000, 0.112500, 0.376630],
    [0.435326, 0.450000, 0.112500], [0.112500, 0.141848, 0.450000],
    [0.435326, 0.112500, 0.450000], [0.112500, 0.450000, 0.141848],
    [0.347283, 0.450000, 0.112500], [0.450000, 0.112500, 0.200543],
    [0.112500, 0.229891, 0.450000], [0.450000, 0.288587, 0.112500],
    [0.347283, 0.112500, 0.450000], [0.450000, 0.112500, 0.288587],
    [0.450000, 0.112500, 0.112500], [0.450000, 0.200543, 0.112500],
    [0.171196, 0.450000, 0.112500], [0.112500, 0.450000, 0.317935],
    [0.259239, 0.450000, 0.112500], [0.259239, 0.112500, 0.450000],
    [0.112500, 0.405978, 0.450000], [0.171196, 0.112500, 0.450000],
    [0.112500, 0.317935, 0.450000],
], np.float32)


def simple_technique_wave(scene, tables, x, y, sample, iteration, frame,
                          user_seed, org=None, direction=None, tmin=None,
                          tmax=None):
    """One-intersection techniques; returns per-lane color (N, 3)."""
    from ignis_jax.render.integrator import (
        OFFSET, _emit_camera, _gather_mat_type, _pexpr_ctx, _surface_at,
        _traverse_any, _traverse_closest)
    from ignis_jax.bsdf import bsdf_specular_mask
    from ignis_jax.bsdf.union import material_params

    tech = scene.technique
    n = x.shape[0]
    if org is None:
        seed, counter, org, direction, tmin, tmax = _emit_camera(
            scene, x, y, sample, iteration, frame, user_seed, tables)
    else:
        seed = rng.create_seed(sample, iteration, frame, x, y,
                               jnp.uint32(user_seed))
        counter = jnp.full((n,), 1, dtype=jnp.uint32)

    t, u, v, prim = _traverse_closest(scene, tables, org, direction, tmin,
                                      tmax, None, mask_bit=jnp.int32(0x1))
    hit = prim >= 0
    prim_s = jnp.maximum(prim, 0)
    surf = _surface_at(tables, prim_s, org, direction, t, u, v)
    black = jnp.zeros((n, 3), jnp.float32)

    if tech.type == "ao":
        # aotracer.art: one cosine-hemisphere occlusion sample
        u1, counter = rng.next_f32(seed, counter)
        u2, counter = rng.next_f32(seed, counter)
        local, pdf = sample_cosine_hemisphere(u1, u2)
        gdir = to_world(local, surf["t"], surf["b"], surf["n"])
        occ = _traverse_any(scene, tables, surf["point"], gdir,
                            jnp.full((n,), OFFSET, jnp.float32),
                            jnp.full((n,), FLT_MAX, jnp.float32), None)
        val = jnp.where((hit & ~occ)[..., None], 1.0, 0.0)
        return val

    if tech.type == "wireframe":
        # wireframe.art:24-32 edge detection on first hit
        from ignis_jax.render.camera import camera_frame
        right, up, dcam = camera_frame(scene.camera)
        sw, sh = float(scene.camera.scale[0]), float(scene.camera.scale[1])
        footprint_u = length(jnp.cross(right * sw, up * sh))
        edge_t = jnp.minimum(jnp.minimum(u, v), jnp.clip(1.0 - u - v, 0.0, 1.0))
        footprint = t * footprint_u
        cond = 0.01 * footprint * jnp.sqrt(jnp.maximum(surf["inv_area"], 0.0))
        is_edge = hit & (edge_t <= cond)
        shade = jnp.clip(1.0 - edge_t, 0.0, 1.0)
        return jnp.where(is_edge[..., None], shade[..., None], black)

    if tech.type in ("lightvisibility", "camera_check"):
        # visibility of any light / plain hit check
        return jnp.where(hit[..., None], 1.0, 0.0) * jnp.ones((n, 3))

    if tech.type == "infobuffer":
        # main framebuffer gets shading normals; AOVs carried separately
        return jnp.where(hit[..., None], jnp.abs(surf["n"]), black)

    # ---- debug (debugtracer.art)
    mode = tech.debug_mode if tech.debug_mode in DEBUG_MODES else "normal"
    mat_type = _gather_mat_type(scene, tables, surf["mat_id"])
    if mode == "normal":
        val = jnp.abs(surf["n"])
    elif mode == "tangent":
        val = jnp.abs(surf["t"])
    elif mode == "bitangent":
        val = jnp.abs(surf["b"])
    elif mode == "geometric normal":
        val = jnp.abs(surf["ng"])
    elif mode == "texture coords":
        val = jnp.concatenate([jnp.abs(surf["tex"]),
                               jnp.zeros((n, 1), jnp.float32)], axis=-1)
    elif mode == "prim coords":
        val = jnp.stack([jnp.abs(u), jnp.abs(v), jnp.zeros_like(u)], axis=-1)
    elif mode == "point":
        val = surf["point"]
    elif mode == "hit distance":
        val = jnp.broadcast_to(t[..., None], (n, 3))
    elif mode == "area":
        val = jnp.broadcast_to(
            safe_div(1.0, jnp.maximum(surf["inv_area"], 1e-20))[..., None],
            (n, 3))
    elif mode in ("raw prim id", "prim id"):
        pid = tables["tri_prim"][prim_s]
        if mode == "prim id":
            val = jnp.asarray(_COLOR_MAP)[pid % 23]
        else:
            val = jnp.broadcast_to(pid.astype(jnp.float32)[..., None], (n, 3))
    elif mode in ("raw entity id", "entity id"):
        eid = surf["ent"]
        if mode == "entity id":
            val = jnp.asarray(_COLOR_MAP)[eid % 23]
        else:
            val = jnp.broadcast_to(eid.astype(jnp.float32)[..., None], (n, 3))
    elif mode in ("raw material id", "material id"):
        mid = surf["mat_id"]
        if mode == "material id":
            val = jnp.asarray(_COLOR_MAP)[mid % 23]
        else:
            val = jnp.broadcast_to(mid.astype(jnp.float32)[..., None], (n, 3))
    elif mode == "is emissive":
        val = jnp.where((surf["light_id"] >= 0)[..., None],
                        jnp.asarray([0.0, 1.0, 0.0]), jnp.asarray([1.0, 0.0, 0.0]))
        val = jnp.broadcast_to(val, (n, 3))
    elif mode == "is specular":
        spec = bsdf_specular_mask(scene.bsdf_types, mat_type)
        val = jnp.where(spec[..., None], jnp.asarray([0.0, 1.0, 0.0]),
                        jnp.asarray([1.0, 0.0, 0.0]))
        val = jnp.broadcast_to(val, (n, 3))
    elif mode == "is entering":
        val = jnp.where(surf["is_entering"][..., None],
                        jnp.asarray([0.0, 1.0, 0.0]),
                        jnp.asarray([1.0, 0.0, 0.0]))
        val = jnp.broadcast_to(val, (n, 3))
    elif mode == "albedo":
        surf2 = dict(surf)
        surf2["colors"], surf2["scalars"] = material_params(scene, tables, surf)
        val = surf2["colors"][:, 0]
    elif mode in ("medium inner", "medium outer"):
        key = ("ent_inner_medium" if mode == "medium inner"
               else "ent_outer_medium")
        mid = tables[key][surf["ent"]]
        val = jnp.where((mid >= 0)[..., None],
                        jnp.asarray(_COLOR_MAP)[jnp.maximum(mid, 0) % 23],
                        jnp.zeros((n, 3)))
    else:
        val = jnp.abs(surf["n"])
    return jnp.where(hit[..., None], val, black)


def infobuffer_aovs(scene, tables, x, y, sample, iteration, frame, user_seed):
    """Normals / albedo / depth AOVs (technique/infobuffer.art) for the
    denoiser hook and igview inspector."""
    from ignis_jax.render.integrator import (
        _emit_camera, _surface_at, _traverse_closest)
    from ignis_jax.bsdf.union import material_params

    n = x.shape[0]
    seed, counter, org, direction, tmin, tmax = _emit_camera(
        scene, x, y, sample, iteration, frame, user_seed, tables)
    t, u, v, prim = _traverse_closest(scene, tables, org, direction, tmin,
                                      tmax, None, mask_bit=jnp.int32(0x1))
    hit = prim >= 0
    surf = _surface_at(tables, jnp.maximum(prim, 0), org, direction, t, u, v)
    colors, _ = material_params(scene, tables, surf)
    zero = jnp.zeros((n, 3), jnp.float32)
    return {
        "Normals": jnp.where(hit[..., None], surf["n"], zero),
        "Albedo": jnp.where(hit[..., None], colors[:, 0], zero),
        "Depth": jnp.where(hit, t, 0.0),
    }
