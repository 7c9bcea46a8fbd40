#!/usr/bin/env python3
"""Smoke run of the renderer on one NVIDIA GPU, in one process.

Phases (any failure exits non-zero; the last line of a passing run is
{"ok": true, "device": {...}}):

  0. device: a GPU or exit 1; card name and power limit, JAX version,
     compile-cache directory.
  1. traversal: the CUDA BVH kernel against the XLA BVH (ops/bvh.py) on
     the 512,002-triangle generated scene, 65,536-lane waves of camera
     rays and of incoherent rays, closest and any hit; both timed over
     windows of calls looped inside one jit.
  2. render: Runtime at 1000x1000, 8 samples per iteration, 3 timed
     iterations; then igcli.main on the same scene writes an EXR.
  3. plain reference: the demo scene on the GPU (CUDA kernel) and on the
     CPU backend (brute-force sweep), 128x128 at 4 spp, and Runtime.trace
     on a ray list.
  4. gradient: jax.grad of a squared error w.r.t. mat_colors through
     trace_wave(differentiable=True): 65,536 lanes on the GPU, and 4,096
     lanes against the CPU backend.

`--four` runs only the four-GPU path on the 512,002-triangle scene:
sharded traversal, render (1000x1000 x 8 samples, 2M lanes per device)
and train step on a 4-device mesh against plain single-device calls, and
rays and samples per second on 1 and 4 devices.

Usage: python chip_smoke.py [--four]
"""

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import ignis_jax  # noqa: F401  (a lone copy of this script fails here)
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ignis_jax.api import Runtime, enable_compile_cache
from ignis_jax.cli import igcli
from ignis_jax.ops import traverse
from ignis_jax.ops.bvh import bvh_any, bvh_closest
from ignis_jax.ops.cuda_bvh import cuda_any, cuda_closest
from ignis_jax.parallel.sharding import (make_mesh, replicate, shard_wave,
                                         sharded_render_fn,
                                         sharded_train_step)
from ignis_jax.render.camera import generate_rays, pixel_coord_from_xy
from ignis_jax.render.integrator import trace_wave
from ignis_jax.scene.generated import demo_scene, sphere_field
from ignis_jax.utils.exr import read_exr


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def host_seconds(fn):
    t0 = time.perf_counter()
    np.asarray(fn())
    return time.perf_counter() - t0


def looped_seconds(call, tmin, min_s=0.8, windows=3, lo=64):
    """Seconds per `call(tmin)` over windows of at least about `min_s`.

    The calls loop inside one jit (a static trip count, so no host round
    trip per call).  Each call's tmin carries the previous call's result
    times a zero passed in at run time, which the compiler cannot fold, so
    no call can be hoisted or elided; each window ends in a host copy of
    that carry.  `call` returns a finite f32 scalar.  Returns (median, min,
    max) seconds per call over the windows, and the calls per window.
    """
    def looped(n):
        f = jax.jit(lambda z: jax.lax.fori_loop(
            0, n, lambda i, c: call(tmin + c) * z, jnp.float32(0)))
        return lambda: f(jnp.float32(0))

    f_lo = looped(lo)
    host_seconds(f_lo)
    n = lo + int(np.ceil(min_s / (host_seconds(f_lo) / lo)))
    f_hi = looped(n)
    host_seconds(f_hi)
    per = sorted(host_seconds(f_hi) / n for _ in range(windows))
    return per[len(per) // 2], per[0], per[-1], n


def windowed_seconds(fn, min_s=2.0):
    """Seconds per fn() call over a window of at least `min_s`: calls
    dispatched back to back, the window ended by a host copy of the last
    result (whose cost the window's length keeps to a few percent).
    Returns (seconds per call, calls)."""
    def window(n):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        np.asarray(out)
        return time.perf_counter() - t0

    n = 2
    window(1)
    while (t := window(n)) < min_s:
        n = int(np.ceil(n * 1.2 * min_s / t))
    return t / n, n


def window_str(secs, calls):
    return f"{secs * 1e3:.3f} ms/call x {calls} = {secs * calls:.2f} s"


class CompileClock:
    """Sums JAX's backend-compile durations (a persistent-cache hit is
    counted at its retrieval time)."""

    def __init__(self):
        import jax
        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.secs += secs


@contextlib.contextmanager
def on_cpu():
    """JAX work on the CPU backend inside this GPU process.  Its
    executables stay out of the persistent compile cache, which keeps the
    CPU excluded (api.compile_cache_config)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            yield
    finally:
        jax.config.update(key, old)


def phase_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's default device is "
              f"{dev.platform}", file=sys.stderr)
        sys.exit(1)
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {card}")
    log(f"jax {jax.__version__}, devices {len(jax.devices())} x "
        f"{dev.device_kind}, compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    return dev


def wave_rays(rt, kind, n=65536, seed=0):
    """Camera rays through a 256x256 grid, or incoherent rays from random
    points inside the scene's box in random directions."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        side = int(np.sqrt(n))
        idx = jnp.arange(n, dtype=jnp.int32)
        nx, ny = pixel_coord_from_xy(idx % side, idx // side, side, side,
                                     0.5, 0.5)
        org, d, _, _ = generate_rays(rt.scene.camera, nx, ny)
    else:
        org = jnp.asarray(rng.uniform([-6, -0.9, -6], [6, 2, 6], (n, 3)),
                          jnp.float32)
        d = rng.normal(size=(n, 3))
        d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                        jnp.float32)
    tmin = jnp.full((n,), 1e-4, jnp.float32)
    return org, d, tmin, jnp.full((n,), 3.4e38, jnp.float32), \
        jnp.asarray(rng.uniform(0.5, 30.0, n), jnp.float32)


def phase_traversal(rt, n=65536):
    tab = rt.tables
    fns = {"kernel_closest": cuda_closest, "xla_closest": bvh_closest,
           "kernel_any": cuda_any, "xla_any": bvh_any}
    for kind in ("camera", "incoherent"):
        org, d, tmin, tmax, seg = wave_rays(rt, kind, n)
        n = org.shape[0]

        def run(name, tmin):
            f = fns[name]
            return f(tab, org, d, tmin, seg if "any" in name else tmax)

        out = {name: jax.jit(run, static_argnums=0)(name, tmin)
               for name in fns}
        kc, xc = ([np.asarray(a) for a in out[k]]
                  for k in ("kernel_closest", "xla_closest"))
        ka, xa = np.asarray(out["kernel_any"]), np.asarray(out["xla_any"])
        # same algorithm and node record on both sides; only the order of
        # float operations differs (nvcc contracts to FMA), so hit/miss may
        # flip only for rays grazing an edge or a box face
        hit_agree = np.mean((kc[3] >= 0) == (xc[3] >= 0))
        any_agree = np.mean(ka == xa)
        same = (kc[3] == xc[3]) & (xc[3] >= 0)
        dt = np.abs(kc[0][same] - xc[0][same])
        t_ok = np.all(dt <= 1e-5 * np.abs(xc[0][same]) + 1e-6)
        log(f"traversal {kind}: {n} lanes, hits {int((xc[3] >= 0).sum())}, "
            f"hit/miss agree {hit_agree:.6f}, any-hit agree "
            f"{any_agree:.6f}, max |dt| {dt.max() if dt.size else 0:.3g}")
        for name in fns:
            # the loop carry is a prim id or a hit flag: finite
            def scalar(tmin, name=name):
                r = run(name, tmin)
                return (r[3][0] if "closest" in name else r[0]).astype(
                    jnp.float32)
            med, lo, hi, calls = looped_seconds(scalar, tmin)
            log(f"  {name}: {med * 1e3:.4f} ms/call (3 windows of {calls} "
                f"calls, {med * calls:.2f} s: {lo * 1e3:.4f}-{hi * 1e3:.4f}), "
                f"{n / med / 1e6:.2f} Mrays/s")
        check(hit_agree >= 0.9999, f"{kind}: closest hit/miss agreement")
        check(any_agree >= 0.9999, f"{kind}: any-hit agreement")
        check(t_ok, f"{kind}: |dt| <= 1e-5 t + 1e-6 where prims agree")


def render_timed(rt, spi, iters):
    """Msamples/s of Runtime.step after a warm-up step (which includes
    compilation); the timed region ends in currentFrame()."""
    t0 = time.perf_counter()
    rt.step(spi=spi)
    rt.currentFrame()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        rt.step(spi=spi)
    img = rt.currentFrame()
    dt = (time.perf_counter() - t0) / iters
    msps = rt.width * rt.height * spi / dt / 1e6
    return msps, first - dt, dt, img


def phase_render(scene_dict, rt, load_s, size=1000):
    msps, comp, step, img = render_timed(rt, 8, 3)
    check(img.shape == (size, size, 3) and np.isfinite(img).all(),
          "frame finite")
    log(f"render kernel {size}x{size} spi 8: {msps:.3f} Msamples/s "
        f"({step:.3f} s/iteration), load_s {load_s:.1f}, compile_s "
        f"{comp:.1f}, mean {img.mean():.5f}")
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = Path(tmp) / "spheres.json"
        scene_path.write_text(json.dumps(scene_dict))
        out = Path(tmp) / "spheres.exr"
        rc = igcli.main([str(scene_path), "--width", str(size), "--height",
                         str(size), "--spp", "8", "--spi", "8", "-o",
                         str(out)])
        exr = read_exr(str(out))
        check(rc == 0 and exr.shape == (size, size, 3)
              and np.isfinite(exr).all(), "igcli EXR")
        log(f"igcli: wrote {exr.shape} EXR, mean {exr.mean():.5f}")


def close_enough(a, b, rel, abs_):
    return np.abs(a - b) <= rel * np.abs(b) + abs_


def phase_reference():
    rng = np.random.default_rng(3)
    rays = [(rng.uniform(-0.8, 0.8, 3), rng.normal(size=3)) for _ in range(500)]
    out = {}
    for where in ("gpu", "cpu"):
        with (contextlib.nullcontext() if where == "gpu" else on_cpu()):
            rt = Runtime(demo_scene(), width=128, height=128, seed=0)
            rt.step(spi=4)
            out[where] = (rt.currentFrame(), rt.trace(rays, spp=4))
    (img_g, tr_g), (img_c, tr_c) = out["gpu"], out["cpu"]
    # per-lane RNG makes both backends trace the same paths; float rounding
    # differs (GPU FMA contraction), which may flip a rare Russian-roulette
    # or edge decision: hence a per-pixel share, not all pixels
    pix = close_enough(img_g, img_c, 1e-4, 1e-5).all(axis=-1).mean()
    mean_rel = abs(img_g.mean() - img_c.mean()) / abs(img_c.mean())
    ray = close_enough(tr_g, tr_c, 1e-4, 1e-5).all(axis=-1).mean()
    log(f"reference demo 128x128x4: pixels within 1e-4 rel + 1e-5 abs "
        f"{pix:.5f}, mean gpu {img_g.mean():.6f} cpu {img_c.mean():.6f} "
        f"(rel {mean_rel:.2e}); Runtime.trace rays within bound {ray:.5f}")
    check(np.isfinite(img_g).all() and pix >= 0.99, "GPU vs CPU pixels")
    check(mean_rel <= 1e-3, "GPU vs CPU image mean")
    check(ray >= 0.99, "GPU vs CPU Runtime.trace")


def grad_wave(rt, n, width):
    scene, tables = rt.scene, rt.tables
    side = int(np.sqrt(n))            # an evenly spaced side x side grid
    step = width // side
    idx = np.arange(n, dtype=np.int32)
    x, y = jnp.asarray(idx % side * step), jnp.asarray(idx // side * step)
    target = jnp.full((n, 3), 0.25, jnp.float32)

    def loss(mc):
        t = dict(tables)
        t["mat_colors"] = mc
        c = trace_wave(scene, t, x, y, jnp.uint32(0), jnp.uint32(0),
                       jnp.uint32(0), 0, differentiable=True)
        return jnp.mean((c - target) ** 2)

    return np.asarray(jax.jit(jax.grad(loss))(tables["mat_colors"]))


def phase_gradient(n=65536, n_ref=4096):
    rt = Runtime(demo_scene(), width=512, height=512)
    t0 = time.perf_counter()
    g = grad_wave(rt, n, 512)
    log(f"gradient {n} lanes: finite {np.isfinite(g).all()}, |g| "
        f"{np.abs(g).sum():.4g} ({time.perf_counter() - t0:.1f} s with "
        f"compile)")
    check(np.isfinite(g).all() and np.abs(g).sum() > 0, "finite gradient")
    g_gpu = grad_wave(rt, n_ref, 512)
    with on_cpu():
        rt_c = Runtime(demo_scene(), width=512, height=512)
        g_cpu = grad_wave(rt_c, n_ref, 512)
    # gradients are sums over the same paths; the backward one-hot matmuls
    # run at HIGHEST precision, so only summation order differs
    rel = np.abs(g_gpu - g_cpu).max() / np.abs(g_cpu).max()
    log(f"gradient {n_ref} lanes GPU vs CPU: max rel diff {rel:.3g}")
    check(np.abs(g_cpu).max() > 0 and rel <= 1e-3,
          "GPU vs CPU gradient within 1e-3 relative")


def plain_train_step(scene, tables, x, y, target,
                     param_keys=("mat_colors", "light_data"), lr=1e-2):
    """One SGD step on one device, written out without sharding: the
    reference for sharded_train_step."""
    params = {k: tables[k] for k in param_keys}

    def sq_err(p):
        t = dict(tables)
        t.update(p)
        c = trace_wave(scene, t, x, y, jnp.uint32(0), jnp.uint32(0),
                       jnp.uint32(0), 0, differentiable=True)
        return jnp.sum((c - target) ** 2)

    loss, g = jax.value_and_grad(sq_err)(params)
    count = jnp.float32(target.size)
    return loss / count, {k: params[k] - lr * g[k] / count for k in params}


def phase_four(scene_dict=None, size=1000, spp=8, train_lanes=16384,
               min_s=2.0):
    """Sharded traversal, render and train step on four devices against
    plain calls on one, at the upstream step: size x size pixels x spp
    samples, one lane each."""
    check(len(jax.devices()) >= 4, "four devices")
    rt = Runtime(scene_dict or sphere_field(), width=size, height=size)
    check("bvh_nodes" in rt.tables, "BVH in the 4-device scene")
    scene, tables = rt.scene, rt.tables
    mesh = make_mesh(4)
    tables4 = replicate(mesh, tables)
    zero = jnp.uint32(0)
    n = size * size * spp
    lane = P("rays")
    log(f"four: {int(tables['tri_v0'].shape[0])} triangles, {n} lanes, "
        f"{n // 4} per device")

    # traversal alone: one kernel call per device, no loop around it
    org, d, tmin, tmax, _ = wave_rays(rt, "incoherent", n)
    one = jax.jit(lambda *r: traverse.closest(tables, *r))
    four = jax.jit(jax.shard_map(
        lambda t, *r: traverse.closest(t, *r), mesh=mesh,
        in_specs=(P(),) + (lane,) * 4, out_specs=(lane,) * 4,
        check_vma=False))
    rays4 = shard_wave(mesh, org, d, tmin, tmax)
    p1 = np.asarray(one(org, d, tmin, tmax)[3])
    p4 = np.asarray(four(tables4, *rays4)[3])
    s1, c1 = windowed_seconds(lambda: one(org, d, tmin, tmax)[3], min_s)
    s4, c4 = windowed_seconds(lambda: four(tables4, *rays4)[3], min_s)
    log(f"four: traversal alone, incoherent rays: prim ids equal on "
        f"{np.mean(p1 == p4):.6f} of lanes; {n / s1 / 1e6:.1f} Mrays/s on "
        f"1 ({window_str(s1, c1)}), {n / s4 / 1e6:.1f} on 4 "
        f"({window_str(s4, c4)}), scaling efficiency {s1 / s4 / 4:.3f}")
    check(np.mean(p1 == p4) >= 0.9999, "4-device traversal matches one")
    del org, d, tmin, tmax, rays4

    idx = np.arange(n, dtype=np.int64)
    x = jnp.asarray((idx % size).astype(np.int32))
    y = jnp.asarray((idx // size % size).astype(np.int32))
    smp = jnp.asarray((idx // (size * size)).astype(np.uint32))
    render1 = jax.jit(lambda t, x, y, s: trace_wave(scene, t, x, y, s, zero,
                                                    zero, 0))
    # one device renders the same lanes as four calls of a device's share:
    # a trace_wave call holds about 10 KB per lane, too much for all lanes
    # at once on one card
    q = n // 4
    chunks = [(x[i * q:(i + 1) * q], y[i * q:(i + 1) * q],
               smp[i * q:(i + 1) * q]) for i in range(4)]

    def render_one():
        return [render1(tables, *c) for c in chunks]

    render4 = sharded_render_fn(scene, mesh)
    work4 = shard_wave(mesh, x, y, smp)
    img1 = np.concatenate([np.asarray(a) for a in render_one()])
    img4 = np.asarray(render4(tables4, *work4, zero, zero, 0))
    s1, c1 = windowed_seconds(lambda: render_one()[-1], min_s)
    s4, c4 = windowed_seconds(lambda: render4(tables4, *work4, zero, zero,
                                              0), min_s)
    # each lane traces the same path on one device or four (per-lane RNG,
    # same kernel); only XLA's per-program choices can move the last bits
    close = close_enough(img4, img1, 1e-4, 1e-5).all(-1).mean()
    log(f"four: sharded render vs plain trace_wave on one device, lanes "
        f"within 1e-4 rel + 1e-5 abs {close:.5f}; {n / s1 / 1e6:.3f} "
        f"Msamples/s on 1 ({window_str(s1, c1)}), {n / s4 / 1e6:.3f} on 4 "
        f"({window_str(s4, c4)}), scaling efficiency {s1 / s4 / 4:.3f}")
    check(np.isfinite(img1).all() and close >= 0.99,
          "4-device render matches one device")
    del x, y, smp, chunks, work4, img1, img4

    # train step on an evenly spaced pixel grid (rows of sky alone would
    # give a zero gradient)
    side = int(np.sqrt(train_lanes))
    ti = np.arange(side * side, dtype=np.int32)
    xt = jnp.asarray(ti % side * (size // side))
    yt = jnp.asarray(ti // side * (size // side))
    target = jnp.full((side * side, 3), 0.25, jnp.float32)
    loss1, new1 = jax.jit(lambda t, x, y, g: plain_train_step(
        scene, t, x, y, g))(tables, xt, yt, target)
    loss4, new4 = sharded_train_step(scene, mesh)(
        tables4, *shard_wave(mesh, xt, yt), zero, zero, zero, 0,
        shard_wave(mesh, target)[0])
    loss1, loss4 = float(loss1), float(loss4)
    mc0 = np.asarray(tables["mat_colors"])
    mc1, mc4 = np.asarray(new1["mat_colors"]), np.asarray(new4["mat_colors"])
    # the psum adds four partial sums where one device adds one: float
    # summation order alone separates them
    rel = abs(loss4 - loss1) / abs(loss1)
    step = np.abs(mc1 - mc0).max()
    prel = np.abs(mc4 - mc1).max() / max(step, 1e-30)
    log(f"four: train step loss {loss4:.6g} vs {loss1:.6g} on one device "
        f"(rel {rel:.2e}); parameter update max {step:.3g}, 4-device vs "
        f"1-device difference {prel:.2e} of it")
    check(step > 0, "train step moves the parameters")
    check(rel <= 1e-4, "4-device train-step loss within 1e-4 relative")
    check(prel <= 1e-3, "4-device parameter update matches one device")


def main(argv):
    four = "--four" in argv
    t_start = time.perf_counter()
    dev = phase_device()
    clock = CompileClock()
    if four:
        phase_four()
    else:
        scene_dict = sphere_field()
        t0 = time.perf_counter()
        rt = Runtime(scene_dict, width=1000, height=1000)
        load_s = time.perf_counter() - t0
        log(f"loaded {int(rt.tables['tri_v0'].shape[0])} triangles, "
            f"{int(rt.tables['bvh_nodes'].shape[0])} BVH nodes, in "
            f"{load_s:.1f} s")
        phase_traversal(rt)
        phase_render(scene_dict, rt, load_s)
        del rt
        phase_reference()
        phase_gradient()
    log(f"compile seconds (backend compile or cache retrieval): "
        f"{clock.secs:.1f}; wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
