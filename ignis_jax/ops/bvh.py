"""BVH build (host, binned SAH) and batched stack traversal (XLA).

The reference builds spatial-split SAH BVHs with N-wide nodes
(src/runtime/bvh/, src/runtime/shape/TriMeshProvider.cpp:556-560).  Here
one binary world-space BVH covers the flat triangle soup (entity
transforms are baked, so no two-level re-transform).  The XLA traversal
below moves the whole ray wave in lockstep: each lane owns a short stack
and every `while_loop` step does one node visit (slab test + leaf batch
intersection), fully masked with no data-dependent shapes.  The CUDA
kernel (ops/cuda_bvh.py) runs the same algorithm with one ray per thread
on the same node record, so one layout serves both.

Node record (`pack_nodes`): (M, 8) float32, [min.xyz, a, max.xyz, b] with
a and b int32 bit patterns: an inner node has a = left child, b = right
child (>= 1); a leaf has a = first triangle row, b = -1 - count (< 0).

Build: binned SAH (16 bins, largest axis, leaf<=4) — same cost model as the
reference's builders, minus spatial splits (TODO).  The build records the
tree depth; a traversal stack never holds more than `depth` entries, and
`bvh_tables` refuses a tree deeper than STACK_DEPTH.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

LEAF_SIZE = 4
STACK_DEPTH = 64   # traversal stack slots (ops/cuda/bvh_traverse.cu too)
N_BINS = 16


@dataclass
class BVH:
    node_min: np.ndarray    # (M, 3)
    node_max: np.ndarray    # (M, 3)
    node_left: np.ndarray   # (M,) child idx (inner) or tri start (leaf)
    node_right: np.ndarray  # (M,) child idx (inner); unused for leaf
    node_count: np.ndarray  # (M,) 0 = inner, >0 = leaf tri count
    tri_order: np.ndarray   # (T,) permutation into the original soup
    depth: int = 1          # levels, root = 1


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> BVH:
    t = v0.shape[0]
    if t == 0:
        return BVH(np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                   np.zeros(1, np.int32), np.zeros(1, np.int32),
                   np.zeros(1, np.int32), np.zeros(0, np.int32), 1)
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_min = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tri_max = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    cent = (tri_min + tri_max) * 0.5

    order = np.arange(t, dtype=np.int32)
    node_min, node_max = [], []
    node_left, node_right, node_count = [], [], []

    def new_node():
        node_min.append(None)
        node_max.append(None)
        node_left.append(0)
        node_right.append(0)
        node_count.append(0)
        return len(node_min) - 1

    stack = [(new_node(), 0, t, 1)]
    max_depth = 1
    while stack:
        ni, lo, hi, depth = stack.pop()
        max_depth = max(max_depth, depth)
        idx = order[lo:hi]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        node_min[ni] = bmin
        node_max[ni] = bmax
        n = hi - lo
        if n <= leaf_size:
            node_left[ni] = lo
            node_count[ni] = n
            continue

        c = cent[idx]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # degenerate spread: median split
            mid = n // 2
            part = np.argsort(c[:, axis], kind="stable")
            order[lo:hi] = idx[part]
            split = lo + mid
        else:
            # binned SAH
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int32),
                              N_BINS - 1)
            counts = np.bincount(bins, minlength=N_BINS)
            bin_min = np.full((N_BINS, 3), np.inf, np.float32)
            bin_max = np.full((N_BINS, 3), -np.inf, np.float32)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bin_min[b] = tri_min[idx[sel]].min(axis=0)
                    bin_max[b] = tri_max[idx[sel]].max(axis=0)
            # prefix/suffix areas
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = (area(lmin, lmax)[:-1] * lcnt[:-1]
                    + area(rmin[1:], rmax[1:]) * rcnt[1:])
            cost = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if not np.isfinite(cost[best]):
                mid = n // 2
                part = np.argsort(c[:, axis], kind="stable")
                order[lo:hi] = idx[part]
                split = lo + mid
            else:
                sel = bins <= best
                part = np.concatenate([np.nonzero(sel)[0], np.nonzero(~sel)[0]])
                order[lo:hi] = idx[part]
                split = lo + int(sel.sum())

        li = new_node()
        ri = new_node()
        node_left[ni] = li
        node_right[ni] = ri
        stack.append((ri, split, hi, depth + 1))
        stack.append((li, lo, split, depth + 1))

    return BVH(np.asarray(node_min, np.float32), np.asarray(node_max, np.float32),
               np.asarray(node_left, np.int32), np.asarray(node_right, np.int32),
               np.asarray(node_count, np.int32), order, max_depth)


def pack_nodes(bvh: BVH) -> np.ndarray:
    """The (M, 8) float32 node record (module docstring).  A node whose
    two children coincide is the empty tree's root: a leaf of 0 triangles."""
    count = np.asarray(bvh.node_count, np.int32)
    left = np.asarray(bvh.node_left, np.int32)
    right = np.asarray(bvh.node_right, np.int32)
    leaf = (count > 0) | (left == right)
    rec = np.zeros((count.shape[0], 8), np.float32)
    rec[:, 0:3] = bvh.node_min
    rec[:, 4:7] = bvh.node_max
    rec[:, 3] = left.view(np.float32)
    rec[:, 7] = np.where(leaf, -1 - count, right).astype(np.int32).view(
        np.float32)
    return rec


def unpack_nodes(rec: np.ndarray):
    """Inverse of `pack_nodes`: (node_min, node_max, left, right, count),
    with right = 0 for leaves and count = 0 for inner nodes."""
    rec = np.ascontiguousarray(rec, np.float32)
    a = rec[:, 3].view(np.int32)
    b = rec[:, 7].view(np.int32)
    leaf = b < 0
    return (rec[:, 0:3], rec[:, 4:7], a, np.where(leaf, 0, b),
            np.where(leaf, -1 - b, 0))


def bvh_tables(bvh: BVH, tables: dict) -> dict:
    """Attach the node record + BVH-ordered geometry copies.

    Shading arrays (tri_n*, tri_uv*, tri_ent, …) stay in ORIGINAL order so
    entity-contiguous ranges (area-light triangle spans,
    LoaderEntity-grouping semantics) keep working; traversal uses its own
    reordered v0/e1/e2 copies and maps hits back through bvh_tri_to_orig.
    Raises ValueError when the tree is deeper than the traversal stack.
    """
    if int(bvh.depth) > STACK_DEPTH:
        raise ValueError(
            f"BVH depth {int(bvh.depth)} exceeds the traversal stack of "
            f"{STACK_DEPTH} entries")
    out = dict(tables)
    o = bvh.tri_order
    for k in ("tri_v0", "tri_e1", "tri_e2"):
        if k in tables and tables[k].shape[0] == o.shape[0]:
            out["bvh_" + k] = np.asarray(tables[k])[o]
        else:
            out["bvh_" + k] = np.zeros((max(1, o.shape[0]), 3), np.float32)
    out["bvh_nodes"] = pack_nodes(bvh)
    out["bvh_tri_to_orig"] = (o if o.size else np.zeros(1, np.int32))
    return out


def _slab(org, inv_d, tmin, tmax, bmin, bmax):
    t0 = (bmin - org) * inv_d
    t1 = (bmax - org) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tn, axis=-1), tmin)
    far = jnp.minimum(jnp.min(tf, axis=-1), tmax)
    return near, far, near <= far


def _node(nodes, idx):
    """Decode node records at `idx`: (min, max, a, b, is_leaf, count)."""
    rec = nodes[idx]
    a = jax.lax.bitcast_convert_type(rec[:, 3], jnp.int32)
    b = jax.lax.bitcast_convert_type(rec[:, 7], jnp.int32)
    is_leaf = b < 0
    return (rec[:, 0:3], rec[:, 4:7], a, jnp.where(is_leaf, 0, b), is_leaf,
            jnp.where(is_leaf, -1 - b, 0))


def _leaf_intersect(tables, start, count, org, d, tmin, best_t, leaf_size,
                    tri_mask):
    """Intersect up to leaf_size triangles at tri rows [start, start+count);
    `tri_mask` (reordered rows) hides triangles before the closest pick."""
    n = org.shape[0]
    offs = jnp.arange(leaf_size, dtype=jnp.int32)
    rows = start[:, None] + offs[None, :]              # (N, L)
    valid = offs[None, :] < count[:, None]
    rows = jnp.clip(rows, 0, tables["bvh_tri_v0"].shape[0] - 1)
    v0 = tables["bvh_tri_v0"][rows]                    # (N, L, 3)
    e1 = tables["bvh_tri_e1"][rows]
    e2 = tables["bvh_tri_e2"][rows]
    t, u, v, ok = _mt_row(org, d, tmin, best_t, v0, e1, e2)
    ok = ok & valid
    if tri_mask is not None:
        ok = ok & tri_mask[rows]
    t_masked = jnp.where(ok, t, jnp.inf)
    j = jnp.argmin(t_masked, axis=1)
    lanes = jnp.arange(n)
    tj = t_masked[lanes, j]
    hit = tj < best_t
    return hit, tj, u[lanes, j], v[lanes, j], rows[lanes, j]


def _mt_row(org, direction, tmin, tmax, v0, e1, e2):
    """Möller–Trumbore with per-lane triangle batches (N, L, 3)."""
    # sign convention note: see ops/intersect.py _mt_block
    tol = jnp.float32(-1.1920928955078125e-07)
    o = org[:, None, :]
    d = direction[:, None, :]
    tn = jnp.cross(e1, e2)
    c = v0 - o
    r = jnp.cross(d, c)
    det = jnp.sum(tn * d, axis=-1)
    inv_det = jnp.where(det == 0.0, 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det))
    u = -jnp.sum(r * e2, axis=-1) * inv_det
    v = jnp.sum(r * e1, axis=-1) * inv_det
    w = 1.0 - u - v
    t = jnp.sum(c * tn, axis=-1) * inv_det
    ok = ((det != 0.0) & (u >= tol) & (v >= tol) & (w >= tol)
          & (t >= tmin[:, None]) & (t <= tmax[:, None]))
    return t, jnp.maximum(u, 0.0), jnp.maximum(v, 0.0), ok


def _push(stack, sp, lanes, node, do):
    """Push `node` on the lanes where `do` holds (sp < STACK_DEPTH there:
    the build bounds the depth)."""
    stack = stack.at[lanes, sp].set(jnp.where(do, node, stack[lanes, sp]),
                                    mode="drop")
    return stack, jnp.where(do, sp + 1, sp)


def bvh_closest(tables, org, d, tmin, tmax, tri_mask=None,
                leaf_size=LEAF_SIZE, stack_depth=STACK_DEPTH):
    """Closest-hit via per-lane short-stack traversal.

    Returns (t, u, v, prim) with ORIGINAL prim ids; -1 for miss.
    """
    n = org.shape[0]
    inv_d = jnp.where(d == 0.0, jnp.float32(1e30), 1.0 / jnp.where(d == 0.0, 1.0, d))
    lanes = jnp.arange(n)

    stack = jnp.zeros((n, stack_depth), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root pushed at slot 0

    best_t = jnp.broadcast_to(tmax, (n,)).astype(jnp.float32)
    best_u = jnp.zeros((n,), jnp.float32)
    best_v = jnp.zeros((n,), jnp.float32)
    best_i = jnp.full((n,), -1, jnp.int32)

    nodes = tables["bvh_nodes"]
    to_orig = tables["bvh_tri_to_orig"]
    if tri_mask is not None:
        tri_mask = jnp.asarray(tri_mask)[to_orig]  # reordered-space mask

    def cond(s):
        return jnp.any(s[0] > 0)

    def body(s):
        sp, stack, best_t, best_u, best_v, best_i = s
        active = sp > 0
        node = stack[lanes, jnp.maximum(sp - 1, 0)]
        sp = jnp.where(active, sp - 1, sp)

        bmin, bmax, left, right, is_leaf, count = _node(nodes, node)
        _, _, box_hit = _slab(org, inv_d, tmin, best_t, bmin, bmax)
        box_hit = box_hit & active

        # ---- leaf: batched triangle tests
        do_leaf = box_hit & is_leaf
        lhit, lt, lu, lv, lrow = _leaf_intersect(
            tables, left, jnp.where(do_leaf, count, 0), org, d, tmin, best_t,
            leaf_size, tri_mask)
        best_u = jnp.where(lhit, lu, best_u)
        best_v = jnp.where(lhit, lv, best_v)
        best_i = jnp.where(lhit, lrow, best_i)
        best_t = jnp.where(lhit, lt, best_t)

        # ---- inner: push children, near child on top
        do_inner = box_hit & ~is_leaf
        lmin, lmax = _node(nodes, left)[:2]
        rmin, rmax = _node(nodes, right)[:2]
        lnear, _, lhitb = _slab(org, inv_d, tmin, best_t, lmin, lmax)
        rnear, _, rhitb = _slab(org, inv_d, tmin, best_t, rmin, rmax)
        left_first = lnear <= rnear
        first = jnp.where(left_first, left, right)
        second = jnp.where(left_first, right, left)
        first_hit = jnp.where(left_first, lhitb, rhitb) & do_inner
        second_hit = jnp.where(left_first, rhitb, lhitb) & do_inner

        # push far (second) then near (first) so near pops first
        stack, sp = _push(stack, sp, lanes, second, second_hit)
        stack, sp = _push(stack, sp, lanes, first, first_hit)
        return sp, stack, best_t, best_u, best_v, best_i

    sp, stack, best_t, best_u, best_v, best_i = jax.lax.while_loop(
        cond, body, (sp, stack, best_t, best_u, best_v, best_i))
    prim = jnp.where(best_i >= 0, to_orig[jnp.maximum(best_i, 0)], -1)
    return best_t, best_u, best_v, prim


def bvh_any(tables, org, d, tmin, tmax, tri_mask=None,
            leaf_size=LEAF_SIZE, stack_depth=STACK_DEPTH):
    """Occlusion query: returns bool per lane.  Early-outs by clearing the
    lane's stack once any hit is found."""
    n = org.shape[0]
    inv_d = jnp.where(d == 0.0, jnp.float32(1e30), 1.0 / jnp.where(d == 0.0, 1.0, d))
    lanes = jnp.arange(n)
    stack = jnp.zeros((n, stack_depth), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)
    occluded = jnp.zeros((n,), bool)
    tmax_b = jnp.broadcast_to(tmax, (n,)).astype(jnp.float32)

    nodes = tables["bvh_nodes"]
    if tri_mask is not None:
        tri_mask = jnp.asarray(tri_mask)[tables["bvh_tri_to_orig"]]

    def cond(s):
        return jnp.any(s[0] > 0)

    def body(s):
        sp, stack, occluded = s
        active = (sp > 0) & ~occluded
        sp = jnp.where(occluded, 0, sp)  # drop remaining work for done lanes
        node = stack[lanes, jnp.maximum(sp - 1, 0)]
        sp = jnp.where(active, sp - 1, sp)

        bmin, bmax, left, right, is_leaf, count = _node(nodes, node)
        _, _, box_hit = _slab(org, inv_d, tmin, tmax_b, bmin, bmax)
        box_hit = box_hit & active

        do_leaf = box_hit & is_leaf
        lhit = _leaf_intersect(
            tables, left, jnp.where(do_leaf, count, 0), org, d, tmin, tmax_b,
            leaf_size, tri_mask)[0]
        occluded = occluded | lhit

        do_inner = box_hit & ~is_leaf
        for child in (right, left):
            cmin, cmax = _node(nodes, child)[:2]
            _, _, chit = _slab(org, inv_d, tmin, tmax_b, cmin, cmax)
            stack, sp = _push(stack, sp, lanes, child,
                              do_inner & chit & ~occluded)
        return sp, stack, occluded

    sp, stack, occluded = jax.lax.while_loop(cond, body, (sp, stack, occluded))
    return occluded
