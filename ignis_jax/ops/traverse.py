"""Traversal dispatch: the one place that picks how rays meet the soup.

`traversal_path(platform, tables)` names the path from the platform and
the scene:

* "cuda"/"gpu" with a BVH -> "cuda_bvh", the kernel of ops/cuda_bvh.py.
  On an H100 it ties the brute-force sweep at 98 triangles and beats it
  11x at 5,122 triangles (PERF.md), so Runtime builds a BVH for every soup;
* other platforms with a BVH over more than XLA_BVH_MIN_TRIS triangles
  -> "xla_bvh", ops/bvh.py;
* otherwise -> "brute", the fused Möller-Trumbore sweep of
  ops/intersect.py.

`closest` and `any_hit` stage the per-platform choice with
`lax.platform_dependent`, so it is made when the program is lowered for
its device: a computation placed on the CPU of a GPU machine still gets
an XLA path.
"""

from __future__ import annotations

import jax

from ignis_jax.ops.bvh import bvh_any, bvh_closest
from ignis_jax.ops.cuda_bvh import cuda_any, cuda_closest
from ignis_jax.ops.intersect import intersect_any, intersect_closest

# ray-class bits of the per-entity visibility flags, identical to the
# reference's ray flags (LoaderEntity.cpp:123-131)
MASK_CAMERA = 0x1
MASK_LIGHT = 0x2
MASK_BOUNCE = 0x4
MASK_SHADOW = 0x8

# Soup size from which the CPU takes the XLA BVH instead of the sweep
# (the threshold the XLA path had before the GPU port; not re-measured on
# the CPU, which runs tests only).
XLA_BVH_MIN_TRIS = 8192


def traversal_path(platform: str, tables) -> str:
    if "bvh_nodes" not in tables:
        return "brute"
    if platform in ("cuda", "gpu"):
        return "cuda_bvh"
    if tables["tri_v0"].shape[0] > XLA_BVH_MIN_TRIS:
        return "xla_bvh"
    return "brute"


def _brute(sweep):
    def fn(tables, org, d, tmin, tmax, tri_mask=None):
        return sweep(org, d, tmin, tmax, tables["tri_v0"], tables["tri_e1"],
                     tables["tri_e2"], tri_mask=tri_mask)
    return fn


_CLOSEST = {"brute": _brute(intersect_closest), "xla_bvh": bvh_closest,
            "cuda_bvh": cuda_closest}
_ANY = {"brute": _brute(intersect_any), "xla_bvh": bvh_any,
        "cuda_bvh": cuda_any}


def _dispatch(fns, tables, org, d, tmin, tmax, tri_mask):
    cuda = fns[traversal_path("cuda", tables)]
    other = fns[traversal_path("cpu", tables)]
    if cuda is other:
        return other(tables, org, d, tmin, tmax, tri_mask=tri_mask)
    return jax.lax.platform_dependent(
        org, d, tmin, tmax,
        cuda=lambda *r: cuda(tables, *r, tri_mask=tri_mask),
        default=lambda *r: other(tables, *r, tri_mask=tri_mask))


def closest(tables, org, d, tmin, tmax, tri_mask=None):
    """(t, u, v, prim) of the closest visible triangle; prim -1 = miss."""
    return _dispatch(_CLOSEST, tables, org, d, tmin, tmax, tri_mask)


def any_hit(tables, org, d, tmin, tmax, tri_mask=None):
    """bool per lane: some visible triangle lies in [tmin, tmax)."""
    return _dispatch(_ANY, tables, org, d, tmin, tmax, tri_mask)
