"""Asset CacheManager — on-disk cache of converted assets.

Counterpart of src/runtime/CacheManager.{h,cpp} (SHA-256-keyed cache of
converted meshes / measured BSDFs / CDFs) — converted numpy tables are
stored as .npz next to a content hash so repeated scene loads skip the
OBJ/PLY/XML parsing entirely.  Set IGNIS_NO_CACHE=1 to disable.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

_VERSION = 1


def cache_dir() -> Path:
    d = Path(os.environ.get("IGNIS_CACHE",
                            os.path.expanduser("~/.cache/ignis_jax_assets")))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _key(path: Path, kind: str, extra: str = "") -> str:
    h = hashlib.sha256()
    h.update(f"{kind}:v{_VERSION}:{extra}:".encode())
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def data_key(arrays, kind: str, extra: str = "") -> str:
    """Content hash over in-memory arrays (shape + dtype + bytes)."""
    h = hashlib.sha256()
    h.update(f"{kind}:v{_VERSION}:{extra}:".encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def cached_arrays_data(key_arrays, kind: str, builder, extra: str = ""):
    """Like cached_arrays but keyed on in-memory geometry instead of a
    file — covers BVH/packet-table/measured builds whose inputs are
    already-parsed arrays (CacheManager.h:7-33 caches per-shape BVHs the
    same way, keyed by content hash)."""
    if os.environ.get("IGNIS_NO_CACHE"):
        return builder()
    key = data_key(key_arrays, kind, extra)
    f = cache_dir() / f"{kind}-{key[:32]}.npz"
    if f.exists():
        try:
            with np.load(f, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        except Exception:  # corrupt cache entry — rebuild
            pass
    out = builder()
    try:
        tmp = f.with_suffix(".tmp.npz")
        np.savez_compressed(tmp, **out)
        os.replace(tmp, f)
    except OSError:
        pass
    return out


def cached_pickle(path, kind: str, builder, extra: str = ""):
    """File-keyed cache for structured results (tables dict + info dict)
    that don't fit the pure-array npz format — the measured-BSDF loaders
    (klems/tensortree/djmeasured) return mixed metadata alongside their
    matrices.  Local trusted cache dir; pickle is fine here."""
    import pickle
    if os.environ.get("IGNIS_NO_CACHE"):
        return builder(path)
    path = Path(path)
    try:
        key = _key(path, kind, extra)
    except OSError:
        return builder(path)
    f = cache_dir() / f"{kind}-{key[:32]}.pkl"
    if f.exists():
        try:
            with open(f, "rb") as fh:
                return pickle.load(fh)
        except Exception:
            pass
    out = builder(path)
    try:
        tmp = f.with_suffix(".tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(out, fh, protocol=4)
        os.replace(tmp, f)
    except OSError:
        pass
    return out


def cached_arrays(path, kind: str, builder, extra: str = ""):
    """Return builder(path) as a dict of numpy arrays, cached on disk.

    builder must return a dict[str, np.ndarray]; scalars are stored as
    0-d arrays and returned as such.
    """
    if os.environ.get("IGNIS_NO_CACHE"):
        return builder(path)
    path = Path(path)
    try:
        key = _key(path, kind, extra)
    except OSError:
        return builder(path)
    f = cache_dir() / f"{kind}-{key[:32]}.npz"
    if f.exists():
        try:
            with np.load(f, allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        except Exception:  # corrupt cache entry — rebuild
            pass
    out = builder(path)
    try:
        tmp = f.with_suffix(".tmp.npz")
        np.savez_compressed(tmp, **out)
        os.replace(tmp, f)
    except OSError:
        pass
    return out
