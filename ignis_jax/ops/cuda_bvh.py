"""CUDA BVH traversal (ops/cuda/bvh_traverse.cu) called through `jax.ffi`.

One ray per thread with its stack in local memory, near child first,
early exit for any-hit: the reference's GPU traversal design
(mapping_gpu.art).  It reads the node record and BVH-ordered triangles
that `ops.bvh.bvh_tables` builds and returns what `bvh_closest` /
`bvh_any` return, so `ops.traverse` can swap one for the other.

The library is compiled by `nvcc` for sm_90a at first use into `build/`
of the checkout (listed in .gitignore); its file name carries a hash of
the source and the command, so an edit rebuilds it.  A failed build or
load raises: there is no fallback to the XLA traversal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

LANE_BLOCK = 128      # threads per block; rays pad to a multiple of it
_SRC = Path(__file__).parent / "cuda" / "bvh_traverse.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
_TARGETS = {"closest": "ignis_bvh_closest", "any": "ignis_bvh_any"}
_SYMBOLS = {"closest": "IgnisBvhClosest", "any": "IgnisBvhAny"}
_lock = threading.Lock()
_registered = False


def nvcc_command(src: Path, out: Path) -> list[str]:
    """The compile command for the traversal library."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", str(jax.ffi.include_dir()), "-o", str(out), str(src)]


def library_path() -> Path:
    """Where the library for the current source lives."""
    cmd = nvcc_command(_SRC, Path("lib.so"))[1:]
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(cmd).encode())
    return BUILD_DIR / f"libignis_bvh-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source was already built."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    r = subprocess.run(nvcc_command(_SRC, tmp), capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {_SRC.name}:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def ensure_registered():
    """Build, load and register the FFI targets once per process."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        for kind, target in _TARGETS.items():
            jax.ffi.register_ffi_target(
                target, jax.ffi.pycapsule(getattr(lib, _SYMBOLS[kind])),
                platform="CUDA")
        _registered = True


def _gpu_present() -> bool:
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:
        return False


def padded_lanes(n: int) -> int:
    return -(-max(n, 1) // LANE_BLOCK) * LANE_BLOCK


def pack_rays(org, d, tmin, tmax):
    """(Npad, 8) float32 rows [org.xyz, tmin, dir.xyz, tmax], Npad a
    multiple of LANE_BLOCK; padding lanes have tmax = -1 and never hit."""
    n = org.shape[0]
    tmin = jnp.broadcast_to(tmin, (n,)).astype(jnp.float32)
    tmax = jnp.broadcast_to(tmax, (n,)).astype(jnp.float32)
    rays = jnp.concatenate([org.astype(jnp.float32), tmin[:, None],
                            d.astype(jnp.float32), tmax[:, None]], axis=1)
    pad = padded_lanes(n) - n
    if pad:
        dead = jnp.zeros((pad, 8), jnp.float32).at[:, 6].set(1.0) \
            .at[:, 7].set(-1.0)
        rays = jnp.concatenate([rays, dead])
    return rays


def _operands(tables, org, d, tmin, tmax, tri_mask):
    rays = pack_rays(org, d, tmin, tmax)
    to_orig = tables["bvh_tri_to_orig"].astype(jnp.int32)
    if tri_mask is None:
        mask = jnp.ones((1,), jnp.uint8)
    else:
        mask = jnp.asarray(tri_mask)[to_orig].astype(jnp.uint8)
    return (rays, tables["bvh_nodes"], tables["bvh_tri_v0"],
            tables["bvh_tri_e1"], tables["bvh_tri_e2"], to_orig, mask), \
        np.int32(tri_mask is not None)


def _call(kind, result_shapes, operands, has_mask):
    if _gpu_present():
        ensure_registered()
    return jax.ffi.ffi_call(_TARGETS[kind], result_shapes)(
        *operands, has_mask=has_mask)


def cuda_closest(tables, org, d, tmin, tmax, tri_mask=None):
    """Closest hit: (t, u, v, prim) like `ops.bvh.bvh_closest`."""
    n = org.shape[0]
    operands, has_mask = _operands(tables, org, d, tmin, tmax, tri_mask)
    npad = operands[0].shape[0]
    f32 = jax.ShapeDtypeStruct((npad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((npad,), jnp.int32)
    t, u, v, prim = _call("closest", (f32, f32, f32, i32), operands,
                          has_mask)
    return t[:n], u[:n], v[:n], prim[:n]


def cuda_any(tables, org, d, tmin, tmax, tri_mask=None):
    """Occlusion: bool per lane like `ops.bvh.bvh_any`."""
    n = org.shape[0]
    operands, has_mask = _operands(tables, org, d, tmin, tmax, tri_mask)
    npad = operands[0].shape[0]
    occ = _call("any", jax.ShapeDtypeStruct((npad,), jnp.int32), operands,
                has_mask)
    return occ[:n] != 0
