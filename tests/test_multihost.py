"""REAL multi-host path (VERDICT r4 #6): two OS processes on the CPU
backend through jax.distributed.initialize + host_local_work
(make_array_from_process_local_data) must reproduce the single-process
render — exercising the mechanism SCALING.json can only describe."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.slow
def test_two_process_distributed_render_matches_single():
    port = _free_port()
    env = dict(os.environ)
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    workers = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_mh_worker.py"),
             f"127.0.0.1:{port}", "2", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)
    ]
    outs = []
    for w in workers:
        try:
            out, _ = w.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for w2 in workers:
                w2.kill()
            raise
        outs.append(out)
    for i, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
    sums = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("MHSUM")][-1]
        sums.append(float(line.split()[1]))
    # both processes see the same fully-gathered global result
    assert abs(sums[0] - sums[1]) < 1e-3, sums

    # single-process oracle on the same work list
    from ignis_jax.api import Runtime
    from ignis_jax.render.integrator import trace_wave
    import jax.numpy as jnp
    scene_dict = {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": {"translate": [0, 0, -3]}},
        "film": {"size": [32, 32]},
        "bsdfs": [{"type": "diffuse", "name": "m",
                   "reflectance": [0.8, 0.4, 0.2]}],
        "shapes": [{"type": "rectangle", "name": "sq", "width": 2,
                    "height": 2}],
        "entities": [{"name": "sq", "shape": "sq", "bsdf": "m"}],
        "lights": [{"type": "env", "name": "sky",
                    "radiance": [1.0, 1.0, 1.0]}],
    }
    rt = Runtime(scene_dict)
    n = 256
    idx = np.arange(n, dtype=np.int32)
    x = jnp.asarray((idx % 32).astype(np.int32))
    y = jnp.asarray(((idx // 32) % 32).astype(np.int32))
    out = trace_wave(rt.scene, rt.tables, x, y, jnp.uint32(0),
                     jnp.uint32(0), jnp.uint32(0), 0)
    expected = float(jnp.sum(out))
    np.testing.assert_allclose(sums[0], expected, rtol=1e-4)
