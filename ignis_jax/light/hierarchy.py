"""Light hierarchy selector — point-BVH importance sampling of many lights.

Reference: src/artic/light/light_hierarchy.art:1-130 (device traversal,
after Moreau & Clarberg, "Importance Sampling of Many Lights on the GPU",
Ray Tracing Gems ch. 18) and src/runtime/light/LightHierarchy.cpp:29-125
(host build: PointBvh over light positions; inner entry = bbox center,
summed flux with delta-direction sign convention, normalized average
direction; per-light backtrack codes, bit i set = right turn at depth i).

Design: the binary tree flattens to one (E, 8) float table + an (E,)
int child/leaf index array; the descent runs as a fixed-trip fori_loop
with per-lane done masks (no data-dependent while_loop, so the sampler is
usable inside the differentiable bounce scan).  Selection probabilities
are treated as detached importance weights (no gradient flows through the
descent costs — they come from the host-built flux table, like the
reference's static light_hierarchy.bin).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ignis_jax.core import rng
from ignis_jax.core.vec import safe_div


# ------------------------------------------------------------------- build
def build_light_hierarchy(pos, dirs, has_dir, flux):
    """Median-split point BVH over finite lights.

    pos (L,3), dirs (L,3), has_dir (L,), flux (L,) — positive estimates.
    Returns dict(lh_pos (E,3), lh_flux (E,) signed, lh_dir (E,3),
    lh_child (E,) int32 [leaf: local light index; inner: -(left+1), right
    child = left+1], lh_codes (L,) uint32, lh_depth python int).
    """
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    dirs = np.asarray(dirs, np.float32).reshape(-1, 3)
    has_dir = np.asarray(has_dir, bool).reshape(-1)
    flux = np.asarray(flux, np.float32).reshape(-1)
    n = pos.shape[0]
    assert n >= 1

    entries = []          # (pos, flux_signed, dir, child_code)
    codes = np.zeros(n, np.uint32)
    max_depth = [1]

    def emit():
        entries.append([np.zeros(3, np.float32), 0.0,
                        np.zeros(3, np.float32), 0])
        return len(entries) - 1

    def build(idx, code, depth):
        """Returns (entry_index, pos, flux_signed, dir)."""
        me = emit()
        max_depth[0] = max(max_depth[0], depth + 1)
        if len(idx) == 1:
            li = int(idx[0])
            f = float(flux[li])
            fs = f if has_dir[li] else -f
            d = dirs[li] if has_dir[li] else np.float32([0, 0, 1])
            entries[me] = [pos[li], fs, d, li]
            codes[li] = code
            return me, pos[li], fs, d
        p = pos[idx]
        axis = int(np.argmax(p.max(0) - p.min(0)))
        order = np.argsort(p[:, axis], kind="stable")
        half = len(idx) // 2
        left_idx = idx[order[:half]]
        right_idx = idx[order[half:]]
        # children must be contiguous (entry.id -> left, left+1 -> right):
        # reserve nothing here — build left, then right, then fix `me`.
        lidx, lp, lf, ld = build(left_idx, code, depth + 1)
        ridx, rp, rf, rd = build(right_idx,
                                 code | np.uint32(1 << depth), depth + 1)
        # NOTE: reference loads children at (id, id+1); our recursive build
        # does not place siblings adjacently, so lh_child stores the left
        # child index and lh_right stores the right one explicitly.
        center = (p.min(0) + p.max(0)) * 0.5
        # delta flux sign handling (LightHierarchy.cpp:63-77)
        if lf < 0 and rf < 0:
            d = np.float32([0, 0, 1])
            fs = lf + rf
        elif lf < 0:
            d = np.float32([0, 0, 1])
            fs = -(-lf + rf)
        elif rf < 0:
            d = np.float32([0, 0, 1])
            fs = -(lf - rf)
        else:
            s = ld + rd
            nl = np.linalg.norm(s)
            d = (s / nl if nl > 1e-12 else np.float32([0, 0, 1]))
            fs = lf + rf
        entries[me] = [center, fs, d, -(lidx + 1)]
        _right[me] = ridx
        return me, center, fs, d

    _right = {}
    build(np.arange(n), np.uint32(0), 0)
    e = len(entries)
    lh_pos = np.stack([x[0] for x in entries]).astype(np.float32)
    lh_flux = np.asarray([x[1] for x in entries], np.float32)
    lh_dir = np.stack([np.asarray(x[2], np.float32) for x in entries])
    lh_child = np.asarray([x[3] for x in entries], np.int32)
    lh_right = np.zeros(e, np.int32)
    for k, v in _right.items():
        lh_right[k] = v
    if max_depth[0] > 32:
        raise ValueError("light hierarchy deeper than 32 (code bits)")
    return dict(lh_pos=lh_pos, lh_flux=lh_flux, lh_dir=lh_dir,
                lh_child=lh_child, lh_right=lh_right,
                lh_codes=codes), int(max_depth[0])


# ---------------------------------------------------------------- traversal
def _entry_cost(tables, node, from_pos):
    """flux * |cos(dir, to-node)| / dist^2 (light_hierarchy.art:39-51)."""
    from ignis_jax.core.dgather import gather_rows
    p = gather_rows(tables["lh_pos"], node)
    f = gather_rows(tables["lh_flux"], node)
    d = gather_rows(tables["lh_dir"], node)
    cdir = p - from_pos
    dist2 = jnp.sum(cdir * cdir, axis=-1)
    inv_len = safe_div(1.0, jnp.sqrt(jnp.maximum(dist2, 1e-20)))
    cosd = jnp.where(f >= 0.0,
                     jnp.abs(jnp.sum(d * cdir, axis=-1) * inv_len),
                     1.0)
    return safe_div(jnp.abs(f) * cosd, dist2)


def _left_prop(tables, left, right, from_pos):
    cl = _entry_cost(tables, left, from_pos)
    cr = _entry_cost(tables, right, from_pos)
    return 1.0 / (1.0 + safe_div(cr, cl))


def hierarchy_sample(tables, from_pos, seed, counter, active, depth):
    """Descend the hierarchy; returns (local light index, pdf, counter).

    Always consumes `depth` random draws per active lane (fixed-trip loop
    keeps the RNG replay deterministic and the program scan-friendly).
    """
    n = from_pos.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    pdf = jnp.ones((n,), jnp.float32)

    child0 = tables["lh_child"]
    right0 = tables["lh_right"]

    def body(_, carry):
        node, pdf, counter = carry
        ch = child0[node]
        is_inner = ch < 0
        left = jnp.where(is_inner, -ch - 1, node)
        right = jnp.where(is_inner, right0[node], node)
        prop = _left_prop(tables, left, right, from_pos)
        u, c2 = rng.next_f32(seed, counter)
        counter = jnp.where(active & is_inner, c2, counter)
        go_left = u < prop
        node = jnp.where(is_inner, jnp.where(go_left, left, right), node)
        pdf = pdf * jnp.where(is_inner,
                              jnp.where(go_left, prop, 1.0 - prop), 1.0)
        return node, pdf, counter

    node, pdf, counter = jax.lax.fori_loop(
        0, depth, body, (node, pdf, counter))
    leaf = child0[node]
    return jnp.maximum(leaf, 0), pdf, counter


def hierarchy_pdf(tables, local_idx, from_pos, depth):
    """pdf of selecting finite light `local_idx` from `from_pos` (replay of
    the descent via backtrack codes, light_hierarchy.art:81-98)."""
    n = from_pos.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    pdf = jnp.ones((n,), jnp.float32)
    from ignis_jax.core.dgather import gather_rows as _gr
    code = _gr(tables["lh_codes"], local_idx)

    child0 = tables["lh_child"]
    right0 = tables["lh_right"]

    def body(_, carry):
        node, pdf, code = carry
        ch = child0[node]
        is_inner = ch < 0
        left = jnp.where(is_inner, -ch - 1, node)
        right = jnp.where(is_inner, right0[node], node)
        prop = _left_prop(tables, left, right, from_pos)
        go_left = (code & jnp.uint32(1)) == 0
        node = jnp.where(is_inner, jnp.where(go_left, left, right), node)
        pdf = pdf * jnp.where(is_inner,
                              jnp.where(go_left, prop, 1.0 - prop), 1.0)
        code = jnp.where(is_inner, code >> 1, code)
        return node, pdf, code

    node, pdf, _ = jax.lax.fori_loop(0, depth, body, (node, pdf, code))
    return pdf
