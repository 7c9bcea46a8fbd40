"""Multi-device sharding of the render/training step.

The reference is single-process (SURVEY.md §2.5); this module is the
scaling layer it lacks: rays/pixels shard over the `rays` axis of a 1-D
`jax.sharding.Mesh`, scene tables are replicated, and each device traces
its own lanes inside `shard_map`.  That keeps the CUDA traversal call
(ops/cuda_bvh.py) per device: XLA's partitioner cannot split an FFI call
and would otherwise gather every ray to every device.  The only
collective is the psum of the loss and the parameter gradients.  Every
device reaches every other at the same rate over NVLink, so the mesh
follows the algorithm alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-host initialization (SURVEY.md §5.8).

    Call once per host before any jax use on a multi-host cluster; the
    arguments default to the standard JAX env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  After
    this, `jax.devices()` spans every host and `make_mesh()` builds a
    global mesh.  No-op when already initialized or when running
    single-process.
    """
    import os
    # NB: do NOT probe jax.process_count() here — it initializes the XLA
    # backend, after which jax.distributed.initialize refuses to run
    # (found by tests/test_multihost.py).  The distributed client handle
    # is the side-effect-free "already initialized" signal.
    try:
        from jax._src import distributed as _dist
        if _dist.global_state.client is not None:
            return  # already initialized
    except Exception:
        pass
    kw = {}
    if coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kw["coordinator_address"] = (
            coordinator or os.environ["JAX_COORDINATOR_ADDRESS"])
        if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
            kw["num_processes"] = int(
                num_processes or os.environ["JAX_NUM_PROCESSES"])
        if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
            kw["process_id"] = int(
                process_id if process_id is not None
                else os.environ["JAX_PROCESS_ID"])
        jax.distributed.initialize(**kw)


def host_local_work(mesh, x, y, sample, axis="rays"):
    """Build global sharded work arrays from per-process local shards
    (multi-host analog of shard_wave): each host contributes its slice of
    the pixel work list; the result is one global array addressable by the
    jitted step."""
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return shard_wave(mesh, x, y, sample, axis=axis)
    mk = jax.make_array_from_process_local_data
    return (mk(sharding, np.asarray(x)), mk(sharding, np.asarray(y)),
            mk(sharding, np.asarray(sample)))


def make_mesh(n_devices=None, axis="rays", devices=None):
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"Requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are visible; for virtual CPU "
                f"meshes set XLA_FLAGS=--xla_force_host_platform_device_count"
                f"=<n> and pin jax.config.update('jax_platforms', 'cpu') "
                f"before first jax use")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_wave(mesh, *arrays, axis="rays"):
    """Place per-ray arrays with the lane dim sharded over the mesh."""
    out = []
    for a in arrays:
        spec = P(axis) if a.ndim >= 1 else P()
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def replicate(mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def _lane_specs(axis, *args):
    """Per-lane arrays shard over `axis`; scalars are replicated."""
    return tuple(P(axis) if jnp.ndim(a) else P() for a in args)


def sharded_render_fn(scene, mesh, differentiable=False, axis="rays"):
    """jit-compiled render step, each device tracing its own lanes.

    Returns fn(tables, x, y, sample, iteration, frame, seed) -> (N,3)
    radiance, with x/y (and a per-lane `sample`) sharded over `axis` and
    tables replicated.  Pixel work is embarrassingly parallel: no
    collective in forward.
    """
    from ignis_jax.render.integrator import trace_wave

    def local(tables, x, y, sample, iteration, frame, seed):
        return trace_wave(scene, tables, x, y, sample, iteration, frame,
                          seed, differentiable=differentiable)

    @jax.jit
    def fn(tables, x, y, sample, iteration, frame, seed):
        args = (x, y, sample, iteration, frame, jnp.asarray(seed))
        return jax.shard_map(
            local, mesh=mesh, in_specs=(P(),) + _lane_specs(axis, *args),
            out_specs=P(axis), check_vma=False)(tables, *args)

    return fn


def sharded_train_step(scene, mesh, param_keys=("mat_colors", "light_data"),
                       lr=1e-2, axis="rays"):
    """One inverse-rendering SGD step, sharded over rays.

    loss = mean over lanes of |render - target|^2; each device computes
    its lanes' squared-error sum and gradient, one psum adds them, and
    parameters stay replicated.
    """
    from ignis_jax.render.integrator import trace_wave

    def local(params, rest, x, y, sample, iteration, frame, seed, target):
        def sq_err(p):
            t = dict(rest)
            t.update(p)
            color = trace_wave(scene, t, x, y, sample, iteration, frame,
                               seed, differentiable=True)
            return jnp.sum((color - target) ** 2)

        loss, grads = jax.value_and_grad(sq_err)(params)
        return jax.lax.psum((loss, grads), axis)

    @jax.jit
    def step(tables, x, y, sample, iteration, frame, seed, target):
        params = {k: tables[k] for k in param_keys}
        rest = {k: v for k, v in tables.items() if k not in param_keys}
        args = (x, y, sample, iteration, frame, jnp.asarray(seed), target)
        loss, grads = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P()) + _lane_specs(axis, *args),
            out_specs=(P(), P()), check_vma=False)(params, rest, *args)
        count = jnp.float32(target.size)
        new_params = jax.tree.map(lambda p, g: p - lr * g / count, params,
                                  grads)
        out = dict(rest)
        out.update(new_params)
        return loss / count, out

    return step
