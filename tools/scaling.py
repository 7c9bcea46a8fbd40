#!/usr/bin/env python3
"""Scaling-efficiency measurement on a virtual device mesh.

BASELINE.json gates >=80% rays/s scaling at 1 chip / 1 host / >=2 hosts;
real multi-chip hardware is not available in this environment, so this
harness measures the sharded render step on the
--xla_force_host_platform_device_count virtual CPU mesh (the same code
path the driver's dryrun_multichip validates) and records SCALING.json.

IMPORTANT caveat recorded in the output: virtual CPU devices SHARE the
host's physical cores (this box has 2), so wall-clock efficiency is
physically capped at min(n_devices, n_cores)/n_devices — the table's
`efficiency_vs_cores` column normalizes by that bound; per-shard work
division (the thing that must not regress) is additionally validated by
equality of the sharded and single-device outputs (test_determinism.py).
"""

import json
import os
import time

N = int(os.environ.get("SCALING_DEVICES", "8"))
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={N}").strip()

import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    from ignis_jax.api import Runtime
    from ignis_jax.parallel.sharding import (
        make_mesh, replicate, shard_wave, sharded_render_fn)

    ncores = os.cpu_count() or 1
    rt = Runtime("/root/reference/scenes/diamond_scene.json",
                 width=128, height=128)
    scene = rt.scene
    n = 1 << 14
    idx = np.arange(n, dtype=np.int32)
    x_np = (idx % 128).astype(np.int32)
    y_np = ((idx // 128) % 128).astype(np.int32)

    rows = []
    base_rps = None
    for nd in (1, 2, 4, 8):
        if nd > N:
            break
        mesh = make_mesh(nd)
        tables = replicate(mesh, rt.tables)
        x, y = shard_wave(mesh, jnp.asarray(x_np), jnp.asarray(y_np))
        fn = sharded_render_fn(scene, mesh)
        r = fn(tables, x, y, jnp.uint32(0), jnp.uint32(0), jnp.uint32(0), 0)
        jax.block_until_ready(r)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(tables, x, y, jnp.uint32(0), jnp.uint32(0),
                   jnp.uint32(0), 0)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t0) / reps
        rps = n / dt
        if base_rps is None:
            base_rps = rps
        speedup = rps / base_rps
        bound = min(nd, ncores)
        rows.append(dict(devices=nd, rays_per_s=round(rps),
                         speedup=round(speedup, 3),
                         efficiency_pct=round(100 * speedup / nd, 1),
                         efficiency_vs_cores_pct=round(
                             100 * speedup / bound, 1)))
        print(rows[-1], flush=True)

    out = dict(
        mesh="virtual CPU (xla_force_host_platform_device_count)",
        physical_cores=ncores,
        caveat=("virtual CPU devices share this host's physical cores AND "
                "the 1-device baseline already uses all cores via XLA "
                "intra-op threading, so wall-clock speedup on this box is "
                "structurally impossible; the table documents partition "
                "overhead, not parallel efficiency. The >=80% BASELINE "
                "gate needs real multi-chip hardware. What IS validated "
                "here: the sharded step partitions without extra "
                "collectives and its output equals the single-device "
                "render bitwise-modulo-reduction "
                "(tests/test_determinism.py, dryrun_multichip)."),
        scene="diamond_scene.json 128x128",
        rays=n,
        table=rows,
    )
    with open("SCALING.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"rows": len(rows), "written": "SCALING.json"}))


if __name__ == "__main__":
    main()
