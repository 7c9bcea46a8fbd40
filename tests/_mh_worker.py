"""Worker process for test_multihost: real 2-process jax.distributed run
on the CPU backend.  Prints the global radiance sum on the last line.

Usage: python tests/_mh_worker.py <coordinator> <num_procs> <proc_id>
"""
import sys

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])


def main():
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import ignis_jax  # noqa: F401  (pins the CPU platform first)
    from ignis_jax.parallel.sharding import (host_local_work,
                                             init_distributed, make_mesh,
                                             replicate, sharded_render_fn)
    init_distributed(coordinator=coord, num_processes=nproc, process_id=pid)
    import jax
    import numpy as np
    assert jax.process_count() == nproc, jax.process_count()
    ndev = len(jax.devices())
    assert ndev == 2 * nproc, ndev  # 2 local devices per process

    from ignis_jax.api import Runtime
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
    mesh = make_mesh()
    n = 256
    idx = np.arange(n, dtype=np.int32)
    x_all = (idx % 32).astype(np.int32)
    y_all = ((idx // 32) % 32).astype(np.int32)
    s_all = np.zeros(n, np.uint32)
    # each process contributes ITS slice; host_local_work assembles the
    # global sharded arrays via make_array_from_process_local_data
    lo, hi = pid * n // nproc, (pid + 1) * n // nproc
    x, y, s = host_local_work(mesh, x_all[lo:hi], y_all[lo:hi],
                              s_all[lo:hi])
    assert x.shape[0] == n, x.shape
    tables = replicate(mesh, rt.tables)
    fn = sharded_render_fn(rt.scene, mesh)
    import jax.numpy as jnp
    out = fn(tables, x, y, jnp.asarray(s), jnp.uint32(0), jnp.uint32(0),
             jnp.uint32(0))
    from jax.experimental import multihost_utils
    total = float(jnp.sum(multihost_utils.process_allgather(
        out, tiled=True).reshape(-1)))
    print(f"MHSUM {total:.6f}", flush=True)


if __name__ == "__main__":
    main()
