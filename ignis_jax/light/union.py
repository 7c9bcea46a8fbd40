"""Batched light union: sampling, pdfs, and emission for all light types.

Mirrors src/artic/light/{point,area,env}.art and driver/light.art with the
same measure conventions (driver/pdf.art): every branch reports its pdf both
raw (`pdf_value`) and converted to solid angle (`pdf_solid`), which is what
the path technique consumes (technique/pathtracer.art:77,96).

Light parameter rows live in tables["light_data"] (N_lights, 32) with layouts
set by the scene compiler:
  POINT:       pos[0:3], intensity[3:6]
  AREA_PLANE:  origin[0:3], x_axis[3:6], y_axis[6:9], normal[9:12], area[12],
               radiance[13:16]
  AREA_MESH:   radiance[0:3], tri_offset[3], tri_count[4], entity[5]
  ENV:         radiance*scale[0:3], transform3x3[3:12]
  DIRECTIONAL: dir[0:3], irradiance[3:6]
  SPOT:        pos[0:3], dir[3:6], intensity[6:9], cos_cutoff[9], cos_falloff[10]
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.core import rng
from ignis_jax.core.dgather import gather_rows
from ignis_jax.core.vec import (
    FLT_EPS, FLT_MAX, PI, cross, dot, length, matmul, mulf, normalize,
    safe_div, safe_sqrt, vec3,
)
from ignis_jax.core.warp import (
    equal_area_sphere_pdf, equal_area_square_to_sphere, sample_triangle,
)
from ignis_jax.scene.compile import (
    LIGHT_AREA_MESH, LIGHT_AREA_PLANE, LIGHT_AREA_SPHERE,
    LIGHT_DIRECTIONAL, LIGHT_ENV, LIGHT_ENV_CDF, LIGHT_POINT, LIGHT_SPOT,
    LIGHT_SUN,
)


def _sample_sun(data, from_point, u1, u2):
    """make_sun_light.sample_direct (light/sun.art:4-16): uniform cone around
    the (scene-incoming) sun direction; delta pdf."""
    from ignis_jax.core.vec import orthonormal_basis, to_world
    from ignis_jax.core.warp import sample_uniform_cone
    n = from_point.shape[0]
    sdir = data[:, 0:3]
    cos_angle = data[:, 9]
    color = data[:, 3:6]
    sun_radius = jnp.sqrt(jnp.maximum(1.0 - cos_angle * cos_angle, 0.0)) /         jnp.maximum(cos_angle, 1e-8)
    sun_area = jnp.pi * sun_radius * sun_radius
    local, pdf = sample_uniform_cone(u1, u2, cos_angle)
    tb, bb = orthonormal_basis(sdir)
    wdir = to_world(local, tb, bb, sdir)
    intensity = color * safe_div(1.0, sun_area * pdf)[..., None]
    one = jnp.ones((n,), jnp.float32)
    return dict(dir=-wdir, dist=jnp.full((n,), FLT_MAX, jnp.float32),
                cos=local[..., 2], pos=jnp.zeros((n, 3), jnp.float32),
                intensity=intensity, pdf_value=one, pdf_solid=one)


def _safe_len(v):
    """length with an epsilon floor: d/dx sqrt(x) is infinite at 0 and a
    coincident light/shading point (NEE from a point on the light itself)
    would NaN the backward pass."""
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), 1e-24))


def _ldata(tables, light_idx):
    return gather_rows(tables["light_data"], light_idx)  # (N, 32)


def select_light_uniform(num_lights, seed, counter, active):
    """Uniform light selection (light/light_selector.art:26-44).

    Draws next_i32(0, n-1) only when n > 1 (pick_light_id specializes n<=1
    statically, consuming no randomness).
    Returns (light_idx, select_pdf, counter).
    """
    if num_lights <= 1:
        idx = jnp.zeros(counter.shape, dtype=jnp.int32)
        return idx, jnp.float32(1.0 if num_lights == 0 else 1.0), counter
    idx, counter = rng.next_i32(seed, counter, 0, num_lights - 1, active)
    return idx, jnp.float32(1.0 / num_lights), counter


def select_light(scene, tables, seed, counter, active, from_pos=None):
    """Selector dispatch (light/light_selector.art:46-76).

    `simple`/`cdf` use the flux-weighted finite-light CDF with a 0.5
    infinite/finite split when both exist; `hierarchy` descends the
    point-BVH cut (light_hierarchy.art) using the shading point `from_pos`.
    Returns (light_idx, select_pdf (per-lane), counter)."""
    kind = scene.technique.light_selector
    num_lights = scene.num_lights
    finite_ids = [i for i, l in enumerate(scene.lights) if not l.infinite]
    inf_ids = [i for i, l in enumerate(scene.lights) if l.infinite]

    if (num_lights <= 1 or kind not in ("simple", "cdf", "hierarchy")
            or not finite_ids):
        idx, pdf, counter = select_light_uniform(num_lights, seed, counter,
                                                 active)
        return idx, jnp.broadcast_to(pdf, counter.shape), counter

    if (kind == "hierarchy" and "lh_child" in tables
            and from_pos is not None and len(finite_ids) >= 2):
        from ignis_jax.light.hierarchy import hierarchy_sample
        fin_map = jnp.asarray(finite_ids, jnp.int32)
        depth = scene.lh_depth
        if inf_ids:
            ratio = jnp.float32(0.5)
            q, counter_q = rng.next_f32(seed, counter)
            counter = jnp.where(active, counter_q, counter)
            pick_inf = q < ratio
            if len(inf_ids) > 1:
                iidx, counter_i = rng.next_i32(
                    seed, counter, 0, len(inf_ids) - 1, active & pick_inf)
                counter = counter_i
            else:
                iidx = jnp.zeros(counter.shape, jnp.int32)
            inf_light = jnp.asarray(inf_ids, jnp.int32)[iidx]
            loc, hpdf, counter = hierarchy_sample(
                tables, from_pos, seed, counter, active & ~pick_inf, depth)
            idx = jnp.where(pick_inf, inf_light, fin_map[loc])
            pdf = jnp.where(pick_inf,
                            ratio / len(inf_ids), hpdf * (1.0 - ratio))
            return idx, pdf, counter
        loc, hpdf, counter = hierarchy_sample(
            tables, from_pos, seed, counter, active, depth)
        return fin_map[loc], hpdf, counter

    cdf = tables["light_sel_cdf"]
    fin_map = jnp.asarray(finite_ids, jnp.int32)
    sel_pdf_tab = tables["light_sel_pdf"]

    if inf_ids:
        ratio = jnp.float32(0.5)
        q, counter_q = rng.next_f32(seed, counter)
        counter = jnp.where(active, counter_q, counter)
        pick_inf = q < ratio
        # infinite branch: uniform among infinite (draw only if > 1)
        if len(inf_ids) > 1:
            iidx, counter_i = rng.next_i32(seed, counter, 0, len(inf_ids) - 1,
                                           active & pick_inf)
            counter = counter_i
        else:
            iidx = jnp.zeros(counter.shape, jnp.int32)
        inf_light = jnp.asarray(inf_ids, jnp.int32)[iidx]
        # finite branch: discrete CDF sample (1 draw)
        u, counter_f = rng.next_f32(seed, counter)
        counter = jnp.where(active & ~pick_inf, counter_f, counter)
        off = jnp.clip(jnp.searchsorted(cdf, u, side="right"), 0,
                       cdf.shape[0] - 1)
        fin_light = fin_map[off]
        idx = jnp.where(pick_inf, inf_light, fin_light)
    else:
        u, counter_f = rng.next_f32(seed, counter)
        counter = jnp.where(active, counter_f, counter)
        off = jnp.clip(jnp.searchsorted(cdf, u, side="right"), 0,
                       cdf.shape[0] - 1)
        idx = fin_map[off]
    return idx, sel_pdf_tab[idx], counter


def light_select_pdf(scene, tables, light_idx, from_pos):
    """Per-lane pdf of the selector choosing `light_idx` (global id) from
    `from_pos` — the MIS counterpart of select_light (LightSelector.pdf,
    light_selector.art).  Static table for uniform/CDF; position-dependent
    replay for the hierarchy."""
    kind = scene.technique.light_selector
    finite_ids = [i for i, l in enumerate(scene.lights) if not l.infinite]
    inf_ids = [i for i, l in enumerate(scene.lights) if l.infinite]
    static = gather_rows(tables["light_sel_pdf"], light_idx)
    if (kind != "hierarchy" or "lh_child" not in tables
            or from_pos is None or len(finite_ids) < 2):
        return static
    from ignis_jax.light.hierarchy import hierarchy_pdf
    loc = gather_rows(tables["light_fin_local"], light_idx)
    hpdf = hierarchy_pdf(tables, jnp.maximum(loc, 0), from_pos,
                         scene.lh_depth)
    if inf_ids:
        hpdf = hpdf * jnp.float32(0.5)
    # infinite lights keep the static split pdf
    return jnp.where(loc >= 0, hpdf, static)


# ---------------------------------------------------------------- sampling

def _sample_point(data, from_point):
    pos = data[:, 0:3]
    intensity = data[:, 3:6]
    dir_ = pos - from_point
    dist = _safe_len(dir_)
    d = dir_ * safe_div(1.0, dist)[..., None]
    # pdf = make_area_pdf(1), cos = 1 (light/point.art:1-8)
    return dict(dir=d, dist=dist, cos=jnp.ones_like(dist), pos=pos,
                intensity=intensity,
                pdf_value=jnp.ones_like(dist),
                pdf_solid=dist * dist,   # to_solid(1, cos=1, d2)
                )


def _sample_directional(data, from_point, scene_radius):
    d = -data[:, 0:3]  # direction property points FROM the light
    irr = data[:, 3:6]
    dist = jnp.full(from_point.shape[:-1], scene_radius, jnp.float32)
    return dict(dir=d, dist=dist, cos=jnp.ones_like(dist),
                pos=from_point + d * scene_radius,
                intensity=irr,
                pdf_value=jnp.ones_like(dist),
                pdf_solid=jnp.ones_like(dist))


def _sample_spot(data, from_point):
    """make_spot_light.sample_direct (light/spot.art:8-41): area-measure pdf 1
    inside the cone (0 outside), light-side cosine fed through as_solid, and
    smoothstep falloff between cutoff and falloff cosines."""
    pos = data[:, 0:3]
    ldir = data[:, 3:6]
    intensity = data[:, 6:9]
    cos_cutoff = data[:, 9]
    cos_falloff = data[:, 10]
    dir_ = pos - from_point
    dist = _safe_len(dir_)
    d = dir_ * safe_div(1.0, dist)[..., None]
    cos_a = dot(-d, ldir)   # angle of (light → surface) vs spot axis
    blend = cos_falloff - cos_cutoff
    t = jnp.clip(safe_div(cos_a - cos_cutoff, blend), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    fall = jnp.where(blend <= FLT_EPS,
                     jnp.where(cos_a <= cos_cutoff, 0.0, 1.0), smooth)
    valid = cos_a > cos_cutoff
    pdf_value = jnp.where(valid, 1.0, 0.0)
    return dict(dir=d, dist=dist, cos=cos_a, pos=pos,
                intensity=intensity * fall[..., None],
                pdf_value=pdf_value,
                pdf_solid=pdf_value * safe_div(dist * dist, jnp.abs(cos_a)))


def _compute_sq(origin, ex, ey, nrm, width, height, from_point):
    """Spherical-rectangle precomputation (light/area.art:119-160)."""
    dirv = origin - from_point
    x0 = dot(dirv, ex)
    y0 = dot(dirv, ey)
    z0_ = dot(dirv, nrm)
    x1 = x0 + width
    y1 = y0 + height
    pos_side = ~jnp.signbit(z0_)
    z0 = jnp.where(pos_side, -z0_, z0_)
    n = jnp.where(pos_side[..., None], -nrm, nrm)

    v4 = jnp.stack([x0, y1, x1, y0], axis=-1)
    w4 = jnp.stack([x1, y0, x0, y1], axis=-1)
    diff = v4 - w4
    m4 = jnp.stack([y0, x1, y1, x0], axis=-1)
    nz_ = m4 * diff
    denom = jnp.sqrt(jnp.maximum(diff * diff * (z0 * z0)[..., None]
                                 + nz_ * nz_, 1e-20))
    nz = nz_ / denom

    def sacos(a):
        # clamp strictly inside (-1, 1): d/dx arccos is infinite at the poles
        # and masked lanes would turn 0*inf into NaN in the backward pass
        return jnp.arccos(jnp.clip(a, -1.0 + 1e-7, 1.0 - 1e-7))

    g0 = sacos(-nz[..., 0] * nz[..., 1])
    g1 = sacos(-nz[..., 1] * nz[..., 2])
    g2 = sacos(-nz[..., 2] * nz[..., 3])
    g3 = sacos(-nz[..., 3] * nz[..., 0])
    b0 = nz[..., 0]
    b1 = nz[..., 2]
    k = 2.0 * PI - g2 - g3
    s = g0 + g1 - k
    return dict(x0=x0, y0=y0, z0=z0, x1=x1, y1=y1, b0=b0, b1=b1, k=k, s=s, n=n)


def _sample_area_plane(data, from_point, is_entering, u1, u2):
    """Ureña spherical-rectangle sampling (light/area.art:161-207)."""
    origin = data[:, 0:3]
    xa = data[:, 3:6]
    ya = data[:, 6:9]
    nrm = data[:, 9:12]
    radiance = data[:, 13:16]
    width = length(xa)
    height = length(ya)
    ex = xa * safe_div(1.0, width)[..., None]
    ey = ya * safe_div(1.0, height)[..., None]

    sq = _compute_sq(origin, ex, ey, nrm, width, height, from_point)

    au = u1 * sq["s"] + sq["k"]
    sin_au = jnp.sin(au)
    sin_au = jnp.where(jnp.abs(sin_au) < 1e-12,
                       jnp.copysign(1e-12, sin_au), sin_au)
    fu = (jnp.cos(au) * sq["b0"] - sq["b1"]) / sin_au
    cu_d = jnp.sqrt(jnp.maximum(fu * fu + sq["b0"] * sq["b0"], 1e-20))
    cu = jnp.clip(jnp.copysign(1.0, fu) / cu_d, -1.0, 1.0)
    xu = jnp.clip(-(cu * sq["z0"]) / jnp.sqrt(jnp.maximum(1.0 - cu * cu, 1e-20)),
                  sq["x0"], sq["x1"])
    d = jnp.sqrt(jnp.maximum(xu * xu + sq["z0"] * sq["z0"], 1e-20))
    h0 = sq["y0"] / jnp.sqrt(jnp.maximum(d * d + sq["y0"] * sq["y0"], 1e-20))
    h1 = sq["y1"] / jnp.sqrt(jnp.maximum(d * d + sq["y1"] * sq["y1"], 1e-20))
    hv = h0 + u2 * (h1 - h0)
    hv2 = hv * hv
    yv = jnp.where(hv2 < 1.0 - 1e-6,
                   (hv * d) / jnp.sqrt(jnp.maximum(1.0 - hv2, 1e-20)),
                   sq["y1"])

    p = (from_point + ex * xu[..., None] + ey * yv[..., None]
         + sq["n"] * sq["z0"][..., None])
    pdf_s = safe_div(1.0, sq["s"])
    weight = sq["s"]

    dir_ = p - from_point
    dist = _safe_len(dir_)
    dirn = dir_ * safe_div(1.0, dist)[..., None]
    cos = dot(dirn, nrm) * jnp.where(is_entering, -1.0, 1.0)
    return dict(dir=dirn, dist=dist, cos=cos, pos=p,
                intensity=radiance * weight[..., None],
                pdf_value=pdf_s, pdf_solid=pdf_s)


def _sample_area_mesh(data, tables, from_point, is_entering, u1, u2):
    """Uniform-triangle mesh emitter (light/area.art:45-90), batched.

    Triangles are rows [tri_offset, tri_offset+count) of the global soup.
    """
    radiance = data[:, 0:3]
    tri_offset = data[:, 3].astype(jnp.int32)
    tri_count = data[:, 4]
    ux = u1 * tri_count
    f = jnp.minimum(ux.astype(jnp.int32), tri_count.astype(jnp.int32) - 1)
    bu, bv = sample_triangle(ux - f.astype(jnp.float32), u2)
    t = tri_offset + f
    v0 = tables["tri_v0"][t]
    e1 = tables["tri_e1"][t]
    e2 = tables["tri_e2"][t]
    nraw = cross(e1, e2)
    nlen = _safe_len(nraw)
    area = 0.5 * nlen
    face_n = nraw * safe_div(1.0, nlen)[..., None]
    inv_area = safe_div(1.0, area)
    p = v0 + e1 * bu[..., None] + e2 * bv[..., None]
    pdfv = inv_area / tri_count
    weight = tri_count / jnp.where(inv_area == 0, 1.0, inv_area)

    dir_ = p - from_point
    dist = _safe_len(dir_)
    dirn = dir_ * safe_div(1.0, dist)[..., None]
    cos = dot(dirn, face_n) * jnp.where(is_entering, -1.0, 1.0)
    d2 = dist * dist
    return dict(dir=dirn, dist=dist, cos=cos, pos=p,
                intensity=radiance * weight[..., None],
                pdf_value=pdfv,
                pdf_solid=pdfv * safe_div(d2, jnp.abs(cos)))


def _env_radiance(scene, tables, info, data, uv):
    """scale*radiance at env uv (texture or constant)."""
    base = data[0:3]
    if getattr(info, "tex", -1) >= 0:
        from ignis_jax.texture.eval import eval_one
        tex = eval_one(scene, tables, scene.textures[info.tex], uv)
        return tex * base  # base holds scale for textured lights
    return jnp.broadcast_to(base, uv.shape[:-1] + (3,))


def _cie_wmean(cos_theta, c1, c2):
    """cie_wmean (light/cie.art:1-7)."""
    a = jnp.power(cos_theta + 1.01, 10.0)
    a2 = a * a
    f1 = (a2 / (a2 + 1.0))[..., None]
    f2 = (1.0 / (a2 + 1.0))[..., None]
    return c1 * f1 + c2 * f2


def _env_func_eval(scene, tables, info, data, ldir):
    """Radiance function of the LIGHT-space direction (transform applied).

    Dispatch: constant/texture env or CIE sky models
    (light/cie.art make_cie_sky_light)."""
    sky = getattr(info, "sky", None)
    if sky is None:
        from ignis_jax.light.env_cdf import map_env_uv, switch_env_up
        uv = map_env_uv(switch_env_up(ldir))
        return _env_radiance(scene, tables, info, data, uv)
    cos_theta = ldir[..., 1]  # env lights use Y as up
    if sky["kind"] in ("cie_uniform", "cie_cloudy"):
        zenith = data[0:3]
        ground = data[12:15]
        gb = data[15]
        cloudy = sky["kind"] == "cie_cloudy"
        c1 = (1.0 + 2.0 * cos_theta) / 3.0 if cloudy else jnp.ones_like(cos_theta)
        c2 = 0.777777777 if cloudy else 1.0
        v = _cie_wmean(cos_theta, zenith * c1[..., None],
                       jnp.broadcast_to(ground * gb * c2, ldir.shape))
        if not sky["has_ground"]:
            v = jnp.where((cos_theta < 0)[..., None], 0.0, v)
        return v
    if sky["kind"] == "cie_sunny":
        # make_cie_sunny_light (light/cie.art:20-38); zenith*zb and
        # ground*gb*c2 are pre-folded into the data row at compile time
        zcol = data[0:3]
        gcol = data[12:15]
        sun_dir = jnp.asarray(sky["sun_dir"], jnp.float32)
        cos_gamma = jnp.clip(jnp.sum(ldir * sun_dir, axis=-1), -1.0, 1.0)
        gamma = jnp.arccos(jnp.clip(cos_gamma, -1.0 + 1e-7, 1.0 - 1e-7))
        if sky["is_clear"]:
            ct_safe = jnp.where(cos_theta >= 0.01, cos_theta, 1.0)
            horiz = jnp.where(cos_theta >= 0.01,
                              1.0 - jnp.exp(-0.32 / ct_safe), 1.0)
            c1 = (0.91 + 10.0 * jnp.exp(-3.0 * gamma)
                  + 0.45 * cos_gamma * cos_gamma) * horiz
        else:
            theta = jnp.arccos(jnp.clip(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7))
            stheta = float(np.arccos(np.clip(sky["sun_dir"][1], -1.0, 1.0)))
            c1 = (((1.35 * jnp.sin(5.631 - 3.59 * theta) + 3.12)
                   * np.sin(4.396 - 2.6 * stheta) + 6.37 - theta) / 2.326
                  * jnp.exp(gamma * (-0.563)
                            * ((2.629 - theta) * (1.562 - stheta) + 0.812)))
        v = _cie_wmean(cos_theta, zcol * c1[..., None],
                       jnp.broadcast_to(gcol, ldir.shape))
        if not sky["has_ground"]:
            v = jnp.where((cos_theta < 0)[..., None], 0.0, v)
        return v
    if sky["kind"] == "perez":
        # make_perez_light (light/cie.art:49-57); lum pre-folded w/ diffnorm
        lum = data[0:3]
        ground = data[12:15]
        sun_dir = jnp.asarray(sky["sun_dir"], jnp.float32)
        a, b, c, d, e = sky["abcde"]
        sun_c = jnp.clip(jnp.sum(ldir * sun_dir, axis=-1), -1.0, 1.0)
        sun_a = jnp.arccos(jnp.clip(sun_c, -1.0 + 1e-7, 1.0 - 1e-7))
        A = 1.0 + a * jnp.exp(b / jnp.maximum(0.01, cos_theta))
        B = 1.0 + c * jnp.exp(d * sun_a) + e * sun_c * sun_c
        fac = A * B
        v = _cie_wmean(cos_theta, lum * fac[..., None],
                       jnp.broadcast_to(ground, ldir.shape))
        if not sky["has_ground"]:
            v = jnp.where((cos_theta < 0)[..., None], 0.0, v)
        return v
    return jnp.broadcast_to(data[0:3], ldir.shape)


def _sample_env(scene, tables, info, data, from_point, scene_radius, u1, u2):
    """make_environment_light_function_{spherical,hemi} (light/env.art:26-103)."""
    from ignis_jax.core.warp import (cosine_hemisphere_pdf,
                                     sample_cosine_hemisphere)
    from ignis_jax.light.env_cdf import switch_env_up
    trans = data[3:12].reshape(3, 3)
    sky = getattr(info, "sky", None)
    half = bool(sky and sky.get("hemi", not sky.get("has_ground", True)))
    if half:
        # hemi: cosine sample around Y-up in light space (env.art:26-47)
        sz, pdf = sample_cosine_hemisphere(u1, u2)
        ld = switch_env_up(sz)                    # Y-up light dir
        intensity = (_env_func_eval(scene, tables, info, data, ld)
                     * safe_div(1.0, pdf)[..., None])
        gdir = matmul(ld, trans)                   # mat3x3_left_mul
        return dict(dir=gdir,
                    dist=jnp.full(u1.shape, scene_radius, jnp.float32),
                    cos=jnp.ones_like(u1),
                    pos=from_point + gdir * scene_radius,
                    intensity=intensity, pdf_value=pdf, pdf_solid=pdf)
    d = equal_area_square_to_sphere(u1, u2)
    pdf = jnp.broadcast_to(equal_area_sphere_pdf(), u1.shape)
    ldir = matmul(d, trans.T)  # mat3x3_mul(transform, dir)
    intensity = (_env_func_eval(scene, tables, info, data, ldir)
                 * safe_div(1.0, pdf)[..., None])
    return dict(dir=d, dist=jnp.full(u1.shape, scene_radius, jnp.float32),
                cos=jnp.ones_like(u1),
                pos=from_point + d * scene_radius,
                intensity=intensity,
                pdf_value=pdf, pdf_solid=pdf)


def _sample_env_cdf(scene, tables, info, data, lid, from_point, scene_radius,
                    u1, u2):
    """make_environment_light_textured.sample_direct (light/env.art:112-140)."""
    from ignis_jax.light.env_cdf import (
        cdf2d_sample, sin_theta_of, switch_env_up, uv_to_dir)
    marg = tables[f"light{lid}_cdf_m"]
    cond = tables[f"light{lid}_cdf_c"]
    pos, pdf = cdf2d_sample(marg, cond, u1, u2)
    intensity = _env_radiance(scene, tables, info, data, pos)
    dz = uv_to_dir(pos)
    sin_t = sin_theta_of(dz)
    pdf_dir = safe_div(pdf, sin_t * jnp.float32(2.0) * PI * PI)
    trans = data[3:12].reshape(3, 3)
    wdir = matmul(switch_env_up(dz), trans)  # mat3x3_left_mul = transpose
    return dict(dir=wdir, dist=jnp.full(u1.shape, scene_radius, jnp.float32),
                cos=jnp.ones_like(u1),
                pos=from_point + wdir * scene_radius,
                intensity=intensity * safe_div(1.0, pdf_dir)[..., None],
                pdf_value=pdf_dir, pdf_solid=pdf_dir)


# draw counts per light type (sample_direct)
_LIGHT_DRAWS = {
    LIGHT_POINT: 0, LIGHT_DIRECTIONAL: 0, LIGHT_SPOT: 0,
    LIGHT_AREA_PLANE: 2, LIGHT_AREA_MESH: 2, LIGHT_ENV: 2,
    LIGHT_ENV_CDF: 2, LIGHT_SUN: 2, LIGHT_AREA_SPHERE: 2,
}


def _sample_area_sphere(data, from_point, is_entering, u1, u2):
    """Analytic sphere emitter (light/area.art:241-297): equal-area point
    on the sphere, flipped to the half VISIBLE from the shading point;
    area pdf is 2/area for the visible-half measure.

    Row layout (scene/compile.py): [0:3] radiance, [3] radius,
    [4:7] world center, [7] entity, [8] total area 4*pi*r^2."""
    radiance = data[:, 0:3]
    r = data[:, 3]
    c = data[:, 4:7]
    area = data[:, 8]
    nrm = equal_area_square_to_sphere(u1, u2)
    p = c + nrm * r[..., None]
    # visible-side flip: if the center is closer than the sampled point,
    # mirror the point through the center (area.art:259-273)
    os2 = jnp.sum((from_point - c) ** 2, axis=-1)
    ps2 = jnp.sum((from_point - p) ** 2, axis=-1)
    flip = ps2 > os2
    p = jnp.where(flip[..., None], 2.0 * c - p, p)
    nrm = jnp.where(flip[..., None], -nrm, nrm)
    pdfv = safe_div(2.0, area)
    weight = area * 0.5
    dir_ = p - from_point
    dist = _safe_len(dir_)
    dirn = dir_ * safe_div(1.0, dist)[..., None]
    cos = dot(dirn, nrm) * jnp.where(is_entering, -1.0, 1.0)
    d2 = dist * dist
    return dict(dir=dirn, dist=dist, cos=cos, pos=p,
                intensity=radiance * weight[..., None],
                pdf_value=pdfv,
                pdf_solid=pdfv * safe_div(d2, jnp.abs(cos)))


def sample_light_direct(scene, tables, light_idx, from_point, is_entering,
                        seed, counter, active):
    """Dispatch sample_direct over the per-lane selected light.

    Returns (sample dict incl. infinite/delta masks, counter).
    """
    types_present = sorted({l.type for l in scene.lights})
    light_type = gather_rows(tables["light_type"], light_idx)
    data = _ldata(tables, light_idx)
    scene_radius = scene.scene_radius() * 1.01

    max_draws = max([_LIGHT_DRAWS[t] for t in types_present] + [0])
    us = []
    c = counter
    for _ in range(max_draws):
        u, c = rng.next_f32(seed, c)
        us.append(u)
    while len(us) < 2:
        us.append(jnp.zeros(counter.shape, dtype=jnp.float32))

    n = from_point.shape[0]
    out = dict(dir=jnp.zeros((n, 3), jnp.float32),
               dist=jnp.zeros((n,), jnp.float32),
               cos=jnp.zeros((n,), jnp.float32),
               pos=jnp.zeros((n, 3), jnp.float32),
               intensity=jnp.zeros((n, 3), jnp.float32),
               pdf_value=jnp.zeros((n,), jnp.float32),
               pdf_solid=jnp.zeros((n,), jnp.float32))
    draws = jnp.zeros((n,), dtype=jnp.uint32)

    for t in types_present:
        if t in (LIGHT_ENV, LIGHT_ENV_CDF):
            # env lights carry per-light textures/CDF tables → per-light masks
            for lid, info in enumerate(scene.lights):
                if info.type != t:
                    continue
                ld = tables["light_data"][lid]
                if t == LIGHT_ENV:
                    r = _sample_env(scene, tables, info, ld, from_point,
                                    scene_radius, us[0], us[1])
                else:
                    r = _sample_env_cdf(scene, tables, info, ld, lid,
                                        from_point, scene_radius, us[0], us[1])
                m = light_idx == lid
                for k in out:
                    out[k] = jnp.where(m[..., None] if out[k].ndim == 2 else m,
                                       r[k], out[k])
                draws = jnp.where(m, jnp.uint32(2), draws)
            continue
        if t == LIGHT_SUN:
            r = _sample_sun(data, from_point, us[0], us[1])
        elif t == LIGHT_POINT:
            r = _sample_point(data, from_point)
        elif t == LIGHT_AREA_PLANE:
            r = _sample_area_plane(data, from_point, is_entering, us[0], us[1])
        elif t == LIGHT_AREA_MESH:
            r = _sample_area_mesh(data, tables, from_point, is_entering, us[0], us[1])
        elif t == LIGHT_AREA_SPHERE:
            r = _sample_area_sphere(data, from_point, is_entering,
                                    us[0], us[1])
        elif t == LIGHT_DIRECTIONAL:
            r = _sample_directional(data, from_point, scene_radius)
        elif t == LIGHT_SPOT:
            r = _sample_spot(data, from_point)
        else:
            continue
        m = light_type == t
        for k in out:
            out[k] = jnp.where(m[..., None] if out[k].ndim == 2 else m, r[k], out[k])
        draws = jnp.where(m, jnp.uint32(_LIGHT_DRAWS[t]), draws)

    out["infinite"] = gather_rows(tables["light_infinite"], light_idx)
    out["delta"] = gather_rows(tables["light_delta"], light_idx)
    counter = jnp.where(active, counter + draws, counter)
    return out, counter


# ---------------------------------------------------------- pdfs & emission

def light_pdf_direct_solid(scene, tables, light_idx, ray_org, ray_dir,
                           hit_dist, hit_cos, prim_coords, valid):
    """pdf of NEE-sampling the given light toward the hit point, in solid
    angle (what on_hit's MIS needs: emit.pdf.as_solid(dot, dist^2)).

    `prim_coords` are the hit barycentrics — the mesh branch reproduces the
    reference's prim_coords→triangle quirk (light/area.art:60-66: the pdf
    lookup reuses sample()'s uv mapping on hit barycentrics, exact for
    uniform-area meshes).
    """
    types_present = sorted({l.type for l in scene.lights})
    light_type = gather_rows(tables["light_type"], light_idx)
    data = _ldata(tables, light_idx)
    out = jnp.zeros(hit_dist.shape, dtype=jnp.float32)
    d2 = hit_dist * hit_dist
    for t in types_present:
        if t == LIGHT_AREA_PLANE:
            origin = data[:, 0:3]
            xa = data[:, 3:6]
            ya = data[:, 6:9]
            nrm = data[:, 9:12]
            width = length(xa)
            height = length(ya)
            ex = xa * safe_div(1.0, width)[..., None]
            ey = ya * safe_div(1.0, height)[..., None]
            sq = _compute_sq(origin, ex, ey, nrm, width, height, ray_org)
            v = safe_div(1.0, sq["s"])
        elif t == LIGHT_AREA_MESH:
            tri_offset = data[:, 3].astype(jnp.int32)
            tri_count = data[:, 4]
            ux = prim_coords[..., 0] * tri_count
            f = jnp.minimum(ux.astype(jnp.int32),
                            jnp.maximum(tri_count.astype(jnp.int32) - 1, 0))
            tt = tri_offset + f
            e1 = tables["tri_e1"][tt]
            e2 = tables["tri_e2"][tt]
            area = 0.5 * length(cross(e1, e2))
            pdf_area = safe_div(1.0, area) / jnp.maximum(tri_count, 1.0)
            v = pdf_area * safe_div(d2, jnp.abs(hit_cos))
        elif t == LIGHT_AREA_SPHERE:
            # pdf_direct = 2/area in area measure (area.art:282-284)
            v = safe_div(2.0, data[:, 8]) * safe_div(d2, jnp.abs(hit_cos))
        elif t == LIGHT_ENV:
            v = jnp.broadcast_to(equal_area_sphere_pdf(), hit_dist.shape)
        else:
            v = jnp.ones_like(hit_dist)  # delta lights: never hit
        out = jnp.where(light_type == t, v, out)
    return jnp.where(valid, out, 0.0)


def env_emission_and_pdf(scene, tables, light_id, ray_dir):
    """Emission + pdf_direct (solid) of one infinite light for escaped rays
    (pathtracer.art on_miss).  light_id is a static python int.
    """
    info = scene.lights[light_id]
    data = tables["light_data"][light_id]
    from ignis_jax.light.env_cdf import map_env_uv, switch_env_up
    if info.type == LIGHT_ENV:
        trans = data[3:12].reshape(3, 3)
        ldir = matmul(ray_dir, trans.T)
        color = _env_func_eval(scene, tables, info, data, ldir)
        sky = getattr(info, "sky", None)
        if sky and sky.get("hemi", not sky.get("has_ground", True)):
            # hemi variant (env.art:48-67): black + cosine pdf above horizon
            from ignis_jax.core.warp import cosine_hemisphere_pdf
            above = ldir[..., 1] > 1.1920929e-07
            color = jnp.where(above[..., None], color, 0.0)
            pdf = jnp.where(above, cosine_hemisphere_pdf(ldir[..., 1]), 0.0)
            return color, pdf
        pdf = jnp.broadcast_to(equal_area_sphere_pdf(), ray_dir.shape[:-1])
        return color, pdf
    if info.type == LIGHT_ENV_CDF:
        from ignis_jax.light.env_cdf import cdf2d_pdf, sin_theta_of
        trans = data[3:12].reshape(3, 3)
        ldir = switch_env_up(matmul(ray_dir, trans.T))
        uv = map_env_uv(ldir)
        color = _env_radiance(scene, tables, info, data, uv)
        marg = tables[f"light{light_id}_cdf_m"]
        cond = tables[f"light{light_id}_cdf_c"]
        pdf_uv = cdf2d_pdf(marg, cond, uv)
        pdf = safe_div(pdf_uv, sin_theta_of(ldir) * jnp.float32(2.0) * PI * PI)
        return color, pdf
    # delta infinite lights (directional/sun) are never hit by chance
    zero = jnp.zeros(ray_dir.shape, jnp.float32)
    return zero, jnp.zeros(ray_dir.shape[:-1], jnp.float32)


