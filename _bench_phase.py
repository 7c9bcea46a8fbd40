#!/usr/bin/env python3
"""One bench phase per process (see bench.py for why).

Timing protocol:
  * rep loop runs INSIDE one jit (lax.fori_loop), chained through a carry
    so no rep can be elided or cached,
  * the timed region ends in np.asarray of the carry (real bytes),
  * throughput = marginal time between a low and high rep count, which
    cancels dispatch/transfer overhead.

Usage: python _bench_phase.py {fwd|fwdbwd|big}
Prints one JSON line, which names the device.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

SCENE = Path("/root/reference/scenes/diamond_scene.json")


def _diamond(size=512):
    from ignis_jax.api import Runtime
    from ignis_jax.scene.parser import load_scene_dict
    src = json.loads(SCENE.read_text())
    src.setdefault("technique", {})["max_depth"] = 6
    t0 = time.perf_counter()
    rt = Runtime(load_scene_dict(src, base_dir=SCENE.parent),
                 width=size, height=size)
    return rt, time.perf_counter() - t0


def _device():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _marginal(make, lo, hi):
    """make(n) -> jitted zero-arg fn; returns (sec/rep, compile_s)."""
    t0 = time.perf_counter()
    f_lo, f_hi = make(lo), make(hi)

    def run(f):
        t = time.perf_counter()
        _ = np.asarray(f())
        return time.perf_counter() - t

    run(f_lo)
    run(f_hi)
    compile_s = time.perf_counter() - t0
    t_lo = min(run(f_lo), run(f_lo))
    t_hi = min(run(f_hi), run(f_hi))
    return max((t_hi - t_lo) / (hi - lo), 1e-9), compile_s


def phase_fwd():
    import jax
    import jax.numpy as jnp
    from ignis_jax.render.integrator import render_wavefront
    rt, load_s = _diamond()
    scene, tables = rt.scene, rt.tables
    size = scene.width
    npix = size * size
    pix = np.arange(npix, dtype=np.int64)
    wx = jnp.asarray((pix % npix % size).astype(np.int32))
    wy = jnp.asarray((pix % npix // size).astype(np.int32))
    ws = jnp.asarray((pix // npix).astype(np.uint32))

    def make(n):
        def body(i, c):
            fb, _ = render_wavefront(
                scene, tables, None, None, None,
                i.astype(jnp.uint32) + (0.0 * c).astype(jnp.uint32),
                jnp.uint32(0), 0, capacity=65536, spi=1,
                work_mode="arith", work_total=npix)
            return c + jnp.sum(fb) * jnp.float32(1e-12)
        return jax.jit(lambda: jax.lax.fori_loop(0, n, body,
                                                 jnp.float32(0.0)))

    dt, compile_s = _marginal(make, 1, 4)
    # correctness sentinel: one real step must be finite
    rt.step(spi=1)
    finite = bool(np.isfinite(rt.currentFrame()).all())
    print(json.dumps({
        "phase": "fwd", "device": _device(), "msps": round(npix / dt / 1e6, 3),
        "ms_per_step": round(dt * 1e3, 1), "finite": finite,
        "load_s": round(load_s, 2), "compile_s": round(compile_s, 1),
    }), flush=True)


def phase_fwdbwd():
    import jax
    import jax.numpy as jnp
    from ignis_jax.render.integrator import trace_wave
    rt, load_s = _diamond()
    scene, tables = rt.scene, rt.tables
    size = scene.width
    n = 1 << 19
    idx = np.arange(n, dtype=np.int32)
    x = jnp.asarray(idx % size)
    y = jnp.asarray((idx // size) % size)

    def loss(mc, it):
        t = dict(tables)
        t["mat_colors"] = mc
        c = trace_wave(scene, t, x, y, jnp.uint32(0), it, jnp.uint32(0), 0,
                       differentiable=True)
        return jnp.sum(c) * 1e-6

    grad = jax.grad(loss)
    mc0 = tables["mat_colors"]

    def make(reps):
        def body(i, c):
            g = grad(mc0 + c * 0.0, i.astype(jnp.uint32))
            return c + jnp.sum(g) * jnp.float32(1e-12)
        return jax.jit(lambda: jax.lax.fori_loop(0, reps, body,
                                                 jnp.float32(0.0)))

    dt, compile_s = _marginal(make, 1, 3)
    g = grad(mc0, jnp.uint32(0))
    grad_ok = bool(np.isfinite(np.asarray(g)).all())
    print(json.dumps({
        "phase": "fwdbwd", "device": _device(), "msps": round(n / dt / 1e6, 3),
        "ms_per_call": round(dt * 1e3, 1), "grad_finite": grad_ok,
        "load_s": round(load_s, 2), "compile_s": round(compile_s, 1),
    }), flush=True)


def phase_big():
    import jax
    import jax.numpy as jnp
    from ignis_jax.api import Runtime
    from ignis_jax.render.integrator import render_wavefront
    from ignis_jax.scene.generated import sphere_field
    t0 = time.perf_counter()
    rt = Runtime(sphere_field())
    load_s = time.perf_counter() - t0
    scene, tables = rt.scene, rt.tables
    ntris = int(tables["tri_v0"].shape[0])
    size = scene.width
    npix = size * size
    pix = np.arange(npix, dtype=np.int64)
    wx = jnp.asarray((pix % size).astype(np.int32))
    wy = jnp.asarray((pix // size).astype(np.int32))
    ws = jnp.asarray((pix // npix).astype(np.uint32))

    def make(n):
        def body(i, c):
            fb, _ = render_wavefront(
                scene, tables, None, None, None,
                i.astype(jnp.uint32) + (0.0 * c).astype(jnp.uint32),
                jnp.uint32(0), 0, capacity=65536, spi=1,
                work_mode="arith", work_total=npix)
            return c + jnp.sum(fb) * jnp.float32(1e-12)
        return jax.jit(lambda: jax.lax.fori_loop(0, n, body,
                                                 jnp.float32(0.0)))

    dt, compile_s = _marginal(make, 1, 3)
    rt.step(spi=1)
    finite = bool(np.isfinite(rt.currentFrame()).all())
    print(json.dumps({
        "phase": "big", "device": _device(), "msps": round(npix / dt / 1e6, 3), "ntris": ntris,
        "ms_per_step": round(dt * 1e3, 1), "finite": finite,
        "load_s": round(load_s, 2), "compile_s": round(compile_s, 1),
    }), flush=True)


if __name__ == "__main__":
    {"fwd": phase_fwd, "fwdbwd": phase_fwdbwd,
     "big": phase_big}[sys.argv[1]]()
