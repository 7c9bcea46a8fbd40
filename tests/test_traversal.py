"""Ray traversal: the XLA BVH and the brute sweep against plain references,
the CUDA kernel's wrapper (packing, padding, build command, node record),
the per-platform path choice, sharding under shard_map, and the
compile-cache rules.  The kernel itself runs only on a GPU (`gpu` marker).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from ignis_jax.ops import cuda_bvh, traverse
from ignis_jax.ops.bvh import (BVH, STACK_DEPTH, build_bvh, bvh_any, bvh_closest,
                               bvh_tables, pack_nodes, unpack_nodes)
from ignis_jax.ops.intersect import intersect_any, intersect_closest

REPO = Path(__file__).resolve().parents[1]


def _random_soup(n_tris, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v0 = c + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def _random_rays(n, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _bvh_tables(v0, e1, e2):
    tab = bvh_tables(build_bvh(v0, e1, e2),
                     {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2})
    return {k: jnp.asarray(v) for k, v in tab.items()}


def _brute(org, d, tmin, tmax, v0, e1, e2, tri_mask=None):
    return intersect_closest(jnp.asarray(org), jnp.asarray(d), tmin, tmax,
                             jnp.asarray(v0), jnp.asarray(e1),
                             jnp.asarray(e2), tri_mask=tri_mask)


def _mt_float64(org, d, tmin, tmax, v0, e1, e2, mask=None):
    """Plain float64 Möller-Trumbore over every ray x triangle pair:
    (t, prim) of the closest hit, prim -1 for a miss."""
    o = org.astype(np.float64)[:, None, :]
    dd = d.astype(np.float64)[:, None, :]
    a, b, c = (x.astype(np.float64)[None] for x in (v0, e1, e2))
    n = np.cross(b, c)
    q = a - o
    r = np.cross(dd, q)
    det = np.sum(n * dd, -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(det == 0, 0.0, 1.0 / det)
    u = -np.sum(r * c, -1) * inv
    v = np.sum(r * b, -1) * inv
    t = np.sum(q * n, -1) * inv
    ok = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t >= np.asarray(tmin)[:, None]) & (t <= np.asarray(tmax)[:, None]))
    if mask is not None:
        ok &= mask[None, :]
    tt = np.where(ok, t, np.inf)
    prim = np.where(ok.any(1), tt.argmin(1), -1)
    return tt.min(1), prim


# ------------------------------------------------------------- XLA BVH
@pytest.mark.parametrize("n_tris,n_rays", [(3, 64), (37, 256), (500, 1500)])
def test_bvh_closest_matches_brute(n_tris, n_rays):
    v0, e1, e2 = _random_soup(n_tris, seed=n_tris)
    org, d = _random_rays(n_rays, seed=n_rays)
    tmin = jnp.zeros(n_rays, jnp.float32)
    tmax = jnp.full(n_rays, 1e30, jnp.float32)
    tb, ub, vb, pb = map(np.asarray, _brute(org, d, tmin, tmax, v0, e1, e2))
    tk, uk, vk, pk = map(np.asarray, bvh_closest(
        _bvh_tables(v0, e1, e2), jnp.asarray(org), jnp.asarray(d), tmin,
        tmax))
    np.testing.assert_array_equal(pk, pb)
    hit = pb >= 0
    np.testing.assert_allclose(tk[hit], tb[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(uk[hit], ub[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vk[hit], vb[hit], rtol=1e-4, atol=1e-5)


def test_bvh_any_matches_brute():
    v0, e1, e2 = _random_soup(200, seed=9)
    org, d = _random_rays(700, seed=10)
    n = org.shape[0]
    tmin = jnp.zeros(n, jnp.float32)
    tmax = jnp.full(n, 3.0, jnp.float32)   # finite segments: some blocked
    pb = np.asarray(_brute(org, d, tmin, tmax, v0, e1, e2)[3])
    blocked = np.asarray(bvh_any(_bvh_tables(v0, e1, e2), jnp.asarray(org),
                                 jnp.asarray(d), tmin, tmax))
    assert 0 < blocked.sum() < n
    np.testing.assert_array_equal(blocked, pb >= 0)


@pytest.mark.parametrize("query", ["closest", "any"])
def test_bvh_visibility_mask_respected(query):
    # triangle 0 sits in front but is hidden from this ray class; the
    # closest hit must be triangle 1 behind it, inside the same leaf
    v0 = np.float32([[-5, -5, 1], [-5, -5, 2]])
    e1 = np.float32([[10, 0, 0], [10, 0, 0]])
    e2 = np.float32([[0, 10, 0], [0, 10, 0]])
    tables = _bvh_tables(v0, e1, e2)
    org = jnp.asarray(np.float32([[0, 0, 0]]))
    d = jnp.asarray(np.float32([[0, 0, 1]]))
    tmin = jnp.zeros(1, jnp.float32)
    if query == "closest":
        tmax = jnp.full(1, 1e30, jnp.float32)
        t, _, _, p = bvh_closest(tables, org, d, tmin, tmax,
                                 tri_mask=jnp.asarray([False, True]))
        assert int(np.asarray(p)[0]) == 1
        np.testing.assert_allclose(np.asarray(t)[0], 2.0, rtol=1e-6)
    else:
        tmax = jnp.full(1, 1.5, jnp.float32)   # reaches triangle 0 only
        hidden = bvh_any(tables, org, d, tmin, tmax,
                         tri_mask=jnp.asarray([False, True]))
        shown = bvh_any(tables, org, d, tmin, tmax,
                        tri_mask=jnp.asarray([True, False]))
        assert not bool(np.asarray(hidden)[0])
        assert bool(np.asarray(shown)[0])


@pytest.mark.parametrize("path", ["brute", "bvh"])
def test_degenerate_triangles_never_hit(path):
    v0, e1, e2 = _random_soup(16, seed=7)
    e2[3] = e1[3]  # zero area
    e1[9] = 0.0
    org, d = _random_rays(256, seed=8, spread=3.0)
    tmin = jnp.zeros(256, jnp.float32)
    tmax = jnp.full(256, 1e30, jnp.float32)
    if path == "brute":
        pi = _brute(org, d, tmin, tmax, v0, e1, e2)[3]
    else:
        pi = bvh_closest(_bvh_tables(v0, e1, e2), jnp.asarray(org),
                         jnp.asarray(d), tmin, tmax)[3]
    pi = np.asarray(pi)
    assert (pi >= 0).any()
    assert not np.isin(pi, [3, 9]).any()


# ------------------------------------------------------------- brute sweep
def _uniform_soup(t, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    return v0, e1, e2


@pytest.mark.parametrize("t", [5, 100, 733])
def test_brute_closest_matches_float64(t):
    v0, e1, e2 = _uniform_soup(t)
    org, d = _random_rays(256, seed=1, spread=3.0)
    tmin = np.zeros(256, np.float32)
    tmax = np.full(256, 1e30, np.float32)
    bt, _, _, bi = map(np.asarray, _brute(org, d, jnp.asarray(tmin),
                                          jnp.asarray(tmax), v0, e1, e2))
    rt, ri = _mt_float64(org, d, tmin, tmax, v0, e1, e2)
    # near-tangent rays may classify differently in float32
    agree = bi == ri
    assert agree.mean() > 0.99, (bi[~agree], ri[~agree])
    hit = agree & (bi >= 0)
    np.testing.assert_allclose(bt[hit], rt[hit], rtol=2e-5, atol=2e-6)


def test_brute_any_matches_float64():
    v0, e1, e2 = _uniform_soup(200, seed=3)
    org, d = _random_rays(512, seed=4, spread=3.0)
    tmin = np.full(512, 1e-3, np.float32)
    tmax = np.full(512, 2.5, np.float32)
    occ = np.asarray(intersect_any(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), jnp.asarray(v0), jnp.asarray(e1),
        jnp.asarray(e2)))
    ref = _mt_float64(org, d, tmin, tmax, v0, e1, e2)[1] >= 0
    assert 0 < ref.sum() < ref.size
    assert (occ == ref).mean() > 0.995


def test_brute_mask_bits():
    v0, e1, e2 = _uniform_soup(64, seed=5)
    visible = np.ones(64, bool)
    visible[::2] = False        # even triangles hidden from this class
    org, d = _random_rays(128, seed=6, spread=3.0)
    tmin = jnp.zeros(128, jnp.float32)
    tmax = jnp.full(128, 1e30, jnp.float32)
    pi = np.asarray(_brute(org, d, tmin, tmax, v0, e1, e2,
                           tri_mask=jnp.asarray(visible))[3])
    ref = _mt_float64(org, d, np.zeros(128), np.full(128, 1e30), v0, e1, e2,
                      mask=visible)[1]
    hit = pi >= 0
    assert hit.any()
    assert np.all(pi[hit] % 2 == 1)
    assert (pi == ref).mean() > 0.99


# ------------------------------------------------------------- sharding
@pytest.mark.parametrize("path", ["bvh", "brute"])
def test_sharded_matches_unsharded(path):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("rays",))
    v0, e1, e2 = _random_soup(traverse.XLA_BVH_MIN_TRIS + 1000, seed=2,
                              spread=12.0)
    tables = _bvh_tables(v0, e1, e2)
    if path == "brute":
        tables = {k: v for k, v in tables.items() if not k.startswith("bvh")}
        tables.update(tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(e1),
                      tri_e2=jnp.asarray(e2))
    org, d = _random_rays(1024, seed=3)
    org, d = jnp.asarray(org), jnp.asarray(d)
    tmin = jnp.zeros(1024, jnp.float32)
    tmax = jnp.full(1024, 1e30, jnp.float32)
    call = lambda o, dd, a, b: traverse.closest(tables, o, dd, a, b)
    ref = call(org, d, tmin, tmax)
    lanes = (P("rays"),) * 4
    out = jax.jit(jax.shard_map(call, mesh=mesh, in_specs=lanes,
                                out_specs=lanes, check_vma=False))(
        org, d, tmin, tmax)
    assert (np.asarray(ref[3]) >= 0).any()
    np.testing.assert_array_equal(np.asarray(out[3]), np.asarray(ref[3]))
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- BVH layout
def test_node_record_round_trip():
    v0, e1, e2 = _random_soup(300, seed=4)
    b = build_bvh(v0, e1, e2)
    lo, hi, left, right, count = unpack_nodes(pack_nodes(b))
    np.testing.assert_array_equal(lo, b.node_min)
    np.testing.assert_array_equal(hi, b.node_max)
    np.testing.assert_array_equal(count, b.node_count)
    inner = b.node_count == 0
    np.testing.assert_array_equal(left, b.node_left)
    np.testing.assert_array_equal(right[inner], b.node_right[inner])
    assert (right[~inner] == 0).all()


def test_bvh_depth_recorded_and_bounded():
    v0, e1, e2 = _random_soup(500, seed=5)
    b = build_bvh(v0, e1, e2)
    # walk the tree: the recorded depth is the deepest node's level
    depth, stack = 0, [(0, 1)]
    while stack:
        i, lvl = stack.pop()
        depth = max(depth, lvl)
        if b.node_count[i] == 0:
            stack += [(b.node_left[i], lvl + 1), (b.node_right[i], lvl + 1)]
    assert b.depth == depth
    assert b.depth <= STACK_DEPTH


def _skewed_soup(t):
    # centroids spaced 1.5^i apart: each SAH split peels a few triangles
    # off the near end, so the tree is far deeper than a balanced one
    x = (1.5 ** np.arange(t)).astype(np.float32)
    v0 = np.stack([x, np.zeros(t), np.zeros(t)], 1).astype(np.float32)
    e1 = np.tile(np.float32([[0.1, 0, 0]]), (t, 1))
    e2 = np.tile(np.float32([[0, 0.1, 0]]), (t, 1))
    return v0, e1, e2


def test_skewed_deep_tree_traverses_exactly():
    v0, e1, e2 = _skewed_soup(192)
    b = build_bvh(v0, e1, e2)
    assert b.depth > 3 * int(np.ceil(np.log2(192 / 4)))
    n = 512
    rng = np.random.default_rng(0)
    org = np.stack([rng.uniform(0, 2e33, n), rng.uniform(-0.05, 0.15, n),
                    np.full(n, -1.0)], 1).astype(np.float32)
    d = np.tile(np.float32([[0, 0, 1]]), (n, 1))
    tmin = jnp.zeros(n, jnp.float32)
    tmax = jnp.full(n, 1e30, jnp.float32)
    pb = np.asarray(_brute(org, d, tmin, tmax, v0, e1, e2)[3])
    pk = np.asarray(bvh_closest(_bvh_tables(v0, e1, e2), jnp.asarray(org),
                                jnp.asarray(d), tmin, tmax)[3])
    np.testing.assert_array_equal(pk, pb)


def test_tree_deeper_than_the_stack_is_refused():
    # a chain: every inner node holds one leaf and the next inner node
    depth = STACK_DEPTH + 1
    t = depth
    v0, e1, e2 = _skewed_soup(t)
    m = 2 * depth - 1
    left = np.zeros(m, np.int32)
    right = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    inner = np.arange(0, m - 1, 2)
    left[inner], right[inner] = inner + 1, inner + 2
    leaves = np.r_[inner + 1, m - 1]
    left[leaves], count[leaves] = np.arange(t), 1
    lo = np.zeros((m, 3), np.float32)
    hi = np.ones((m, 3), np.float32)
    b = BVH(lo, hi, left, right, count, np.arange(t, dtype=np.int32), depth)
    assert unpack_nodes(pack_nodes(b))[4].sum() == t
    with pytest.raises(ValueError, match="depth"):
        bvh_tables(b, {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2})


# ------------------------------------------------------------- kernel wrapper
@pytest.mark.parametrize("n", [1, 127, 128, 300])
def test_pack_rays_pads_to_lane_block(n):
    org, d = _random_rays(n, seed=n)
    rays = np.asarray(cuda_bvh.pack_rays(jnp.asarray(org), jnp.asarray(d),
                                         jnp.float32(0.0), jnp.float32(5.0)))
    npad = -(-n // cuda_bvh.LANE_BLOCK) * cuda_bvh.LANE_BLOCK
    assert rays.shape == (npad, 8)
    np.testing.assert_array_equal(rays[:n, 0:3], org)
    np.testing.assert_array_equal(rays[:n, 4:7], d)
    assert (rays[:n, 3] == 0.0).all() and (rays[:n, 7] == 5.0).all()
    # padding lanes: a valid direction and tmax < tmin, so nothing is hit
    assert (rays[n:, 7] < rays[n:, 3]).all()
    assert (np.linalg.norm(rays[n:, 4:7], axis=1) > 0).all()


def test_kernel_operands():
    v0, e1, e2 = _random_soup(40, seed=6)
    tables = _bvh_tables(v0, e1, e2)
    org, d = _random_rays(5, seed=7)
    mask = np.arange(40) % 3 != 0
    ops, has_mask = cuda_bvh._operands(
        tables, jnp.asarray(org), jnp.asarray(d), jnp.zeros(5),
        jnp.full(5, 9.0), jnp.asarray(mask))
    rays, nodes, tv0, _, _, to_orig, m = ops
    assert has_mask == 1 and m.dtype == jnp.uint8
    # the mask moves into BVH row order, like bvh_closest's
    np.testing.assert_array_equal(np.asarray(m),
                                  mask[np.asarray(to_orig)].astype(np.uint8))
    assert nodes.shape[1] == 8 and nodes.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(tv0),
                                  v0[np.asarray(to_orig)])
    ops, has_mask = cuda_bvh._operands(
        tables, jnp.asarray(org), jnp.asarray(d), jnp.zeros(5),
        jnp.full(5, 9.0), None)
    assert has_mask == 0 and ops[-1].shape == (1,)


def test_nvcc_command_targets_hopper_into_ignored_dir():
    out = cuda_bvh.library_path()
    cmd = cuda_bvh.nvcc_command(cuda_bvh._SRC, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and str(out) in cmd
    assert str(cuda_bvh._SRC) == cmd[-1] and cuda_bvh._SRC.exists()
    rel = out.relative_to(REPO)
    assert rel.parts[0] == "build"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored


@pytest.mark.parametrize("platform,ntris,has_bvh,expect", [
    ("cpu", 20000, True, "xla_bvh"), ("cpu", 100, True, "brute"),
    ("gpu", 20000, True, "cuda_bvh"), ("gpu", 100, True, "cuda_bvh"),
    ("cuda", 100, True, "cuda_bvh"), ("cpu", 20000, False, "brute"),
    ("gpu", 100, False, "brute")])
def test_traversal_path(platform, ntris, has_bvh, expect):
    tables = {"tri_v0": np.zeros((ntris, 3), np.float32)}
    if has_bvh:
        tables["bvh_nodes"] = None
    assert traverse.traversal_path(platform, tables) == expect


@pytest.mark.parametrize("ntris", [100, traverse.XLA_BVH_MIN_TRIS + 1000])
def test_dispatch_on_cpu_equals_the_chosen_path(ntris):
    """closest/any_hit lowered for the CPU give exactly what the path
    that traversal_path names for the CPU gives."""
    v0, e1, e2 = _random_soup(ntris, seed=13, spread=20.0)
    tables = _bvh_tables(v0, e1, e2)
    org, d = _random_rays(300, seed=14, spread=25.0)
    org, d = jnp.asarray(org), jnp.asarray(d)
    tmin = jnp.zeros(300, jnp.float32)
    tmax = jnp.full(300, 1e30, jnp.float32)
    path = traverse.traversal_path("cpu", tables)
    assert path == ("brute" if ntris < traverse.XLA_BVH_MIN_TRIS
                    else "xla_bvh")
    got = jax.jit(lambda *r: traverse.closest(tables, *r))(org, d, tmin,
                                                           tmax)
    want = jax.jit(lambda *r: traverse._CLOSEST[path](tables, *r))(
        org, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
    assert (np.asarray(want[3]) >= 0).any()
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)
    seg = jnp.full(300, 8.0, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda *r: traverse.any_hit(tables, *r))(
            org, d, tmin, seg)),
        np.asarray(jax.jit(lambda *r: traverse._ANY[path](tables, *r))(
            org, d, tmin, seg)))


def test_grad_traces_past_the_kernel_call():
    """jax.grad through the differentiable scan stages the CUDA branch of
    every traversal without asking it for a derivative, and the CPU
    lowering keeps only the XLA branch."""
    from ignis_jax.api import Runtime
    from ignis_jax.render.integrator import trace_wave
    from ignis_jax.scene.generated import demo_scene

    rt = Runtime(demo_scene(), width=8, height=8)
    scene, tables = rt.scene, rt.tables
    assert "bvh_nodes" in tables
    x = jnp.arange(16, dtype=jnp.int32) % 8
    y = jnp.arange(16, dtype=jnp.int32) // 8

    def loss(mc):
        t = dict(tables)
        t["mat_colors"] = mc
        c = trace_wave(scene, t, x, y, jnp.uint32(0), jnp.uint32(0),
                       jnp.uint32(0), 0, differentiable=True)
        return jnp.sum(c ** 2)

    grad = jax.grad(loss)
    assert "ignis_bvh_closest" in str(jax.make_jaxpr(grad)(
        tables["mat_colors"]))
    g = np.asarray(jax.jit(grad)(tables["mat_colors"]))
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_cuda_kernel_matches_xla_bvh(gpu):
    v0, e1, e2 = _random_soup(20000, seed=11, spread=20.0)
    tables = _bvh_tables(v0, e1, e2)
    org, d = _random_rays(4000, seed=12, spread=25.0)
    org, d = jnp.asarray(org), jnp.asarray(d)
    tmin = jnp.zeros(4000, jnp.float32)
    tmax = jnp.full(4000, 1e30, jnp.float32)
    mask = jnp.asarray(np.arange(20000) % 5 != 0)
    k = [np.asarray(a) for a in cuda_bvh.cuda_closest(
        tables, org, d, tmin, tmax, tri_mask=mask)]
    r = [np.asarray(a) for a in bvh_closest(tables, org, d, tmin, tmax,
                                            tri_mask=mask)]
    assert (k[3] == r[3]).mean() > 0.9999
    same = (k[3] == r[3]) & (r[3] >= 0)
    np.testing.assert_allclose(k[0][same], r[0][same], rtol=1e-5, atol=1e-6)
    occ_k = np.asarray(cuda_bvh.cuda_any(tables, org, d, tmin,
                                         jnp.full(4000, 8.0), tri_mask=mask))
    occ_r = np.asarray(bvh_any(tables, org, d, tmin, jnp.full(4000, 8.0),
                               tri_mask=mask))
    assert (occ_k == occ_r).mean() > 0.9999
