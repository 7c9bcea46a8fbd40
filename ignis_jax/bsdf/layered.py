"""Two-lobe layered materials + normal modifiers — the wrapper-BSDF layer.

The reference composes BSDFs with closure wrappers (mix/add/mask/cutoff —
src/artic/bsdf/mix.art; bumpmap/normalmap/transform — src/artic/bsdf/map.art;
twosided — src/runtime/bsdf/IgnoreBSDF.cpp).  The scene compiler flattens
those chains into at most two leaf lobes per material plus one normal
modifier (scene/compile.py `_flatten_bsdf`); this module applies them at
trace time with masked per-lane selects, so scenes without wrappers pay
nothing (all static checks resolve to the single-lobe fast path).

Semantics matched to mix.art:
  * eval  = lerp(evalA, evalB, k)              (mix.art:10-13)
  * pdf   = lerp(pdfA,  pdfB,  k)              (mix.art:23-25)
  * sample: u < 1-k -> lobe A else B, one-sample MIS combine with the other
    lobe unless it is specular (mix.art:33-47); `add` samples lobe A only
    (mix.art:77-107) and sums evals.
  * is_specular = specA & specB                (mix.art:70)
Normal modifiers (map.art): strength-lerped normal map, forward-difference
bump gradients (texture/common.art:28-37, delta = 1e-3), constant
normal/tangent set; the shading frame is rotated by the minimal rotation
aligning old->new normal (mat3x3_align_vectors analog).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.bsdf import union
from ignis_jax.core import rng
from ignis_jax.core.dgather import gather_rows
from ignis_jax.core.vec import FLT_EPS, cross, dot, normalize, safe_div


def scene_has_lobes(scene) -> bool:
    return any(t >= 0 for t in getattr(scene, "bsdf_types_b", []))


def scene_has_nmod(scene) -> bool:
    return any(getattr(scene, "nmod_kinds", []))


def _gather_mat_type_b(scene, mat_id):
    types = jnp.asarray([max(t, 0) for t in scene.bsdf_types_b],
                        dtype=jnp.int32)
    return types[mat_id]


# ------------------------------------------------------------ normal mods
def _align_rotation_apply(a, b, x):
    """Rotate x by the minimal rotation taking unit vector a to unit b."""
    v = cross(a, b)
    c = dot(a, b)
    # Rodrigues; degenerate antiparallel case falls back to identity (the
    # guard in apply_normal_mod keeps n_new in the hemisphere anyway)
    f = safe_div(1.0, jnp.maximum(1.0 + c, 1e-6))
    return (x * c[..., None] + cross(v, x)
            + v * (dot(v, x) * f)[..., None])


def apply_normal_mod(scene, tables, surf, d, org=None):
    """Perturb the shading frame per material normal modifier (map.art)."""
    if not scene_has_nmod(scene):
        return surf
    mat_id = surf["mat_id"]
    kind = tables["mat_nmod_kind"][mat_id]          # (N,)
    f = tables["mat_nmod_f"][mat_id]                # (N, 8)
    tex = tables["mat_nmod_tex"][mat_id]            # (N,)
    uv = surf["tex"]
    n, t, b = surf["n"], surf["t"], surf["b"]
    strength = f[:, 0]

    kinds_present = set(scene.nmod_kinds)
    n_new = n
    if 1 in kinds_present:  # normalmap (map.art:56-60)
        from ignis_jax.texture import resolve_color
        c = resolve_color(scene, tables, f[:, 1:4], tex, uv)
        local = normalize(2.0 * c - 1.0)
        oN = (t * local[:, 0:1] + b * local[:, 1:2] + n * local[:, 2:3])
        nm = normalize(n + (oN - n) * strength[..., None])
        n_new = jnp.where((kind == 1)[..., None], nm, n_new)
    if 2 in kinds_present:  # bumpmap (map.art:64-67; texture_dx/dy delta)
        from ignis_jax.texture.eval import eval_texture_stack
        delta = jnp.float32(1e-3)
        h0 = eval_texture_stack(scene, tables, tex, uv)[:, 0]
        hx = eval_texture_stack(
            scene, tables, tex, uv + jnp.float32([1e-3, 0.0]))[:, 0]
        hy = eval_texture_stack(
            scene, tables, tex, uv + jnp.float32([0.0, 1e-3]))[:, 0]
        dx = (hx - h0) / delta
        dy = (hy - h0) / delta
        nb = normalize(n - (t * dx[..., None] + b * dy[..., None])
                       * strength[..., None])
        n_new = jnp.where((kind == 2)[..., None], nb, n_new)
    if 3 in kinds_present:  # normal(-tangent) set (map.art:36-51)
        ns = normalize(f[:, 1:4])
        n_new = jnp.where((kind == 3)[..., None], ns, n_new)
    if 4 in kinds_present:  # PExpr-valued normal (transform w/ expression)
        # evaluate the registered expression texture with the FULL
        # shading context so bump()/ensure_valid_reflection() see the
        # real N/Nx/Ny/Ng/V bindings (Transpiler.cpp:261-287)
        from ignis_jax.render.integrator import _pexpr_ctx
        from ignis_jax.texture.eval import eval_texture_stack
        ctx = _pexpr_ctx(tables, surf,
                         surf["point"] - d if org is None else org, d)
        c = eval_texture_stack(scene, tables, tex, uv, ctx)
        ne = normalize(c)
        n_new = jnp.where((kind == 4)[..., None], ne, n_new)

    # ensure_valid_reflection simplification: reject perturbations that put
    # the view below the shading horizon (keeps reflection rays valid)
    ok = dot(-d, n_new) > FLT_EPS
    n_new = jnp.where(ok[..., None], n_new, n)

    t_new = normalize(_align_rotation_apply(n, n_new, t))
    b_new = normalize(_align_rotation_apply(n, n_new, b))
    if 3 in kinds_present:
        has_tan = f[:, 7] > 0.5
        tan = normalize(f[:, 4:7])
        sel = ((kind == 3) & has_tan)[..., None]
        t_new = jnp.where(sel, tan, t_new)
        b_new = jnp.where(sel, normalize(cross(tan, n_new)), b_new)
    surf["n"] = n_new
    surf["t"] = t_new
    surf["b"] = b_new
    return surf


# ---------------------------------------------------------------- prepare
def prepare_surface(scene, tables, surf, d, org=None):
    """Normal mods + lobe param resolution + per-lane mix weights.

    Returns (mat_type, specular_mask); mutates surf in place with colors,
    scalars[, colors_b, scalars_b, mix_k, mix_kind, mat_type_b].
    """
    apply_normal_mod(scene, tables, surf, d, org)
    types = jnp.asarray(scene.bsdf_types, dtype=jnp.int32)
    mat_type = types[surf["mat_id"]]
    surf["colors"], surf["scalars"] = union.material_params(
        scene, tables, surf)
    spec = union.bsdf_specular_mask(scene.bsdf_types, mat_type)
    if not scene_has_lobes(scene):
        return mat_type, spec

    mat_id = surf["mat_id"]
    mat_type_b = _gather_mat_type_b(scene, mat_id)
    surf["mat_type_b"] = mat_type_b
    surf["mix_kind"] = tables["mat_mix_kind"][mat_id]

    # lobe-B params (textured slots resolved like lobe A)
    colors_b = gather_rows(tables["mat_colors_b"], mat_id)
    scalars_b = gather_rows(tables["mat_scalars_b"], mat_id)
    if scene.textures:
        mat_tex_np = np.asarray(scene.tables["mat_tex_b"])
        if (mat_tex_np >= 0).any():
            from ignis_jax.texture import resolve_color
            tex_ids = tables["mat_tex_b"][mat_id]
            for slot in range(mat_tex_np.shape[1]):
                if (mat_tex_np[:, slot] >= 0).any():
                    colors_b = colors_b.at[:, slot].set(resolve_color(
                        scene, tables, colors_b[:, slot], tex_ids[:, slot],
                        surf["tex"]))
    surf["colors_b"] = colors_b
    surf["scalars_b"] = scalars_b

    # mix weight k (weight of lobe B), optionally textured, then cutoff
    wf = tables["mat_wrap_f"][mat_id]
    k = wf[:, 0]
    if (np.asarray(scene.tables["mat_wrap_tex"]) >= 0).any():
        from ignis_jax.texture import resolve_color
        ktex = resolve_color(scene, tables, k[..., None].repeat(3, -1),
                             tables["mat_wrap_tex"][mat_id], surf["tex"])
        k = ktex[:, 0]
    cut = wf[:, 1]
    k = jnp.where(cut >= 0.0, jnp.where(k < cut, 0.0, 1.0), k)
    surf["mix_k"] = jnp.clip(k, 0.0, 1.0)

    spec_b = union.bsdf_specular_mask(
        [t for t in scene.bsdf_types_b if t >= 0], mat_type_b)
    two = surf["mix_kind"] > 0
    return mat_type, jnp.where(two, spec & spec_b, spec)


# ------------------------------------------------------------- eval / pdf
def bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir):
    ea = union.bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir)
    if not scene_has_lobes(scene) or "mat_type_b" not in surf:
        return ea
    eb = union.bsdf_eval(scene, tables, surf["mat_type_b"], surf, in_dir,
                         out_dir, lobe="b")
    k = surf["mix_k"][..., None]
    kind = surf["mix_kind"]
    mixed = jnp.where((kind == 2)[..., None], ea + eb,
                      ea * (1.0 - k) + eb * k)
    return jnp.where((kind > 0)[..., None], mixed, ea)


def bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir):
    pa = union.bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir)
    if not scene_has_lobes(scene) or "mat_type_b" not in surf:
        return pa
    pb = union.bsdf_pdf(scene, tables, surf["mat_type_b"], surf, in_dir,
                        out_dir, lobe="b")
    k = surf["mix_k"]
    kind = surf["mix_kind"]
    spec_a = union.bsdf_specular_mask(scene.bsdf_types, mat_type)
    # add: first lobe's pdf unless it is specular (mix.art:90-95)
    add_pdf = jnp.where(spec_a, pb, pa)
    mixed = jnp.where(kind == 2, add_pdf, pa * (1.0 - k) + pb * k)
    return jnp.where(kind > 0, mixed, pa)


# ----------------------------------------------------------------- sample
def bsdf_sample(scene, tables, mat_type, surf, seed, counter, out_dir,
                active=None, adjoint=False):
    if not scene_has_lobes(scene) or "mat_type_b" not in surf:
        return union.bsdf_sample(scene, tables, mat_type, surf, seed,
                                 counter, out_dir, active=active,
                                 adjoint=adjoint)
    if active is None:
        active = jnp.ones(mat_type.shape, dtype=bool)
    kind = surf["mix_kind"]
    k = surf["mix_k"]
    is_mix = (kind == 1) & active

    # NOTE deviation from mix.art:58-65: when the chosen lobe's sample is
    # invalid the reference retries with the OTHER lobe; we kill the lane
    # instead.  A masked fallback would double the per-mix sample cost for
    # a case that is rare outside grazing-angle rejects; the resulting
    # energy deficit is bounded by the rejected-sample probability.
    # lobe pick draw, mix lanes only (mix.art:55)
    u_pick, c_pick = rng.next_f32(seed, counter)
    c0 = jnp.where(is_mix, c_pick, counter)
    pick_b = is_mix & (u_pick >= 1.0 - k)

    mat_type_b = surf["mat_type_b"]
    ra = union.bsdf_sample(scene, tables, mat_type, surf, seed, c0, out_dir,
                           active=active & ~pick_b, adjoint=adjoint)
    rb = union.bsdf_sample(scene, tables, mat_type_b, surf, seed, c0,
                           out_dir, active=pick_b, adjoint=adjoint, lobe="b")
    pb_c = pick_b[..., None]
    in_dir = jnp.where(pb_c, rb[0], ra[0])
    pdf = jnp.where(pick_b, rb[1], ra[1])
    weight = jnp.where(pb_c, rb[2], ra[2])
    eta = jnp.where(pick_b, rb[3], ra[3])
    valid = jnp.where(pick_b, rb[4], ra[4])
    new_counter = jnp.where(pick_b, rb[5], ra[5])

    # one-sample MIS combine against the unchosen lobe (mix.art:33-47);
    # skipped when the other lobe is specular
    spec_a = union.bsdf_specular_mask(scene.bsdf_types, mat_type)
    spec_b = union.bsdf_specular_mask(
        [t for t in scene.bsdf_types_b if t >= 0], mat_type_b)
    other_spec = jnp.where(pick_b, spec_a, spec_b)
    do_mis = is_mix & valid & ~other_spec
    ea = union.bsdf_eval(scene, tables, mat_type, surf, in_dir, out_dir)
    eb = union.bsdf_eval(scene, tables, mat_type_b, surf, in_dir, out_dir,
                         lobe="b")
    pa = union.bsdf_pdf(scene, tables, mat_type, surf, in_dir, out_dir)
    pb = union.bsdf_pdf(scene, tables, mat_type_b, surf, in_dir, out_dir,
                        lobe="b")
    # substitute the chosen lobe's sampled pdf/eval for consistency
    pa_m = jnp.where(pick_b, pa, pdf)
    pb_m = jnp.where(pick_b, pdf, pb)
    ea_m = jnp.where(pb_c, ea, weight * pdf[..., None])
    eb_m = jnp.where(pb_c, weight * pdf[..., None], eb)
    p_mix = pa_m * (1.0 - k) + pb_m * k
    c_mix = ea_m * (1.0 - k)[..., None] + eb_m * k[..., None]
    w_mix = c_mix * safe_div(1.0, p_mix)[..., None]
    ok = do_mis & (p_mix > 0.0)
    pdf = jnp.where(ok, p_mix, pdf)
    weight = jnp.where(ok[..., None], w_mix, weight)
    return in_dir, pdf, weight, eta, valid, new_counter
