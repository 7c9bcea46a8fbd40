"""Dupuy–Jakob measured isotropic BRDFs (powitacq RGB variant).

Counterpart of src/runtime/measured/{djmeasured.cpp,
powitacq_rgb.inl} and src/artic/bsdf/djmeasured.art.  The reference parses a
"tensor_file" container, wraps the fields in Marginal2D<D> warps (bilinear
density + conditional/marginal CDFs over a unit square, optionally
parameterized by phi_i/theta_i slices), and evaluates

    fr = rgb(warp_inv(u_wm)) * ndf(u_wm) / (4 * sigma(u_wi))

per powitacq_rgb.inl:1113-1154.  Here the tensor file is parsed with numpy,
the CDF tables are precomputed on host exactly like Marginal2D's constructor
(powitacq_rgb.inl:226-325), and eval/pdf/sample/invert are batched jnp
gathers: parameter slices are blended 2x2 (phi x theta corners), CDF
inversion uses a fixed-depth probing binary search (log2(n) gathers per lane
instead of materializing blended CDF rows), which keeps the hot path pure
gather/FMA array work.

Note the reference's Bsdf.eval for djmeasured returns fr WITHOUT the
cosine term and its sample weight is fr/pdf (djmeasured.art:596-662,743-758)
— unlike every other Ignis BSDF, which folds cos(theta) into eval.  We
mirror that behavior exactly for parity.
"""

from __future__ import annotations

import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import FLT_EPS, dot, safe_div, to_local, to_world

_ONE_MINUS_EPS = np.float32(np.nextafter(1.0, 0.0))

# dtype codes of the tensor_file container (powitacq_rgb.inl Tensor::Type)
_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
    5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
    9: np.float16, 10: np.float32, 11: np.float64,
}


def load_tensor_file(path):
    """Parse a Dupuy-Jakob `tensor_file` (powitacq_rgb.inl:800-867)."""
    raw = Path(path).read_bytes()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor_file")
    if raw[12] != 1 or raw[13] != 0:
        raise ValueError(f"{path}: unsupported tensor_file version")
    (n_fields,) = struct.unpack_from("<I", raw, 14)
    fields = {}
    off = 18
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", raw, off)
        off += 2
        name = raw[off:off + name_len].decode("utf-8")
        off += name_len
        ndim, dtype = struct.unpack_from("<HB", raw, off)
        off += 3
        (data_off,) = struct.unpack_from("<Q", raw, off)
        off += 8
        shape = struct.unpack_from("<" + "Q" * ndim, raw, off)
        off += 8 * ndim
        dt = _DTYPES[dtype]
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(raw, dt, count=count, offset=data_off)
        fields[name] = arr.reshape(shape)
    return fields


def write_tensor_file(path, fields):
    """Inverse of load_tensor_file — used by tests and the mts converter."""
    rev = {np.dtype(v): k for k, v in _DTYPES.items()}
    header = bytearray(b"tensor_file\x00" + bytes([1, 0]))
    header += struct.pack("<I", len(fields))
    metas = []
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        metas.append((name.encode(), arr))
    # compute offsets after the field table
    table_size = sum(2 + len(n) + 3 + 8 + 8 * a.ndim for n, a in metas)
    off = len(header) + table_size
    body = bytearray()
    for name, arr in metas:
        header += struct.pack("<H", len(name)) + name
        header += struct.pack("<HB", arr.ndim, rev[arr.dtype])
        header += struct.pack("<Q", off)
        header += struct.pack("<" + "Q" * arr.ndim, *arr.shape)
        body += arr.tobytes()
        off += arr.nbytes
    Path(path).write_bytes(bytes(header) + bytes(body))


def _build_cdf_warp(data):
    """Marginal2D(build_cdf=True) host prep (powitacq_rgb.inl:255-298).

    data: (..., ny, nx) slices.  Returns (norm_data, conditional_cdf,
    marginal_cdf) with the same leading slice dims.
    """
    d = np.asarray(data, np.float64)
    ny, nx = d.shape[-2], d.shape[-1]
    cond = np.zeros_like(d)
    # trapezoid row prefix: cond[..., y, x+1] = sum .5*(d[x]+d[x+1])
    cond[..., 1:] = np.cumsum(0.5 * (d[..., :-1] + d[..., 1:]), axis=-1)
    marg = np.zeros(d.shape[:-2] + (ny,), np.float64)
    row_tot = cond[..., -1]
    marg[..., 1:] = np.cumsum(0.5 * (row_tot[..., :-1] + row_tot[..., 1:]),
                              axis=-1)
    norm = 1.0 / np.maximum(marg[..., -1:], 1e-300)
    return ((d * norm[..., None]).astype(np.float32),
            (cond * norm[..., None]).astype(np.float32),
            (marg * norm).astype(np.float32))


def load_brdf(path, prefix):
    """Load a .bsdf file into (tables, info) for the render tables dict.

    Mirrors djmeasured.cpp:67-118 convert_brdf: ndf/sigma/rgb stay raw
    (normalize=false + eval's inv_patch scaling cancel), vndf/luminance get
    normalized densities + CDFs.
    """
    f = load_tensor_file(path)
    theta_i = np.asarray(f["theta_i"], np.float32)
    phi_i = np.asarray(f["phi_i"], np.float32)
    ndf = np.asarray(f["ndf"], np.float32)
    sigma = np.asarray(f["sigma"], np.float32)
    vndf = np.asarray(f["vndf"], np.float32)        # (nphi, nth, ny, nx)
    lum = np.asarray(f["luminance"], np.float32)    # (nphi, nth, ly, lx)
    rgb = np.asarray(f["rgb"], np.float32)          # (nphi, nth, 3, ry, rx)
    jac = bool(np.asarray(f["jacobian"]).ravel()[0])
    isotropic = phi_i.shape[0] <= 2
    if not isotropic:
        # powitacq_rgb.inl BRDF ctor: anisotropic phi_i knots must span 2*pi
        # (reduction == 1), otherwise the phi parameterization is wrong.
        span = float(phi_i[-1] - phi_i[0])
        reduction = int(np.rint(2.0 * np.pi / span)) if span > 0 else 0
        if reduction != 1:
            raise ValueError(
                f"anisotropic measured BRDF: phi_i span {span:.4f} does not "
                "cover 2*pi (reduction != 1); refusing to load")

    v_d, v_c, v_m = _build_cdf_warp(vndf)
    l_d, l_c, l_m = _build_cdf_warp(lum)

    tables = {
        f"{prefix}_theta_i": theta_i,
        f"{prefix}_phi_i": phi_i,
        f"{prefix}_ndf": ndf,
        f"{prefix}_sigma": sigma,
        f"{prefix}_vndf_data": v_d, f"{prefix}_vndf_cond": v_c,
        f"{prefix}_vndf_marg": v_m,
        f"{prefix}_lum_data": l_d, f"{prefix}_lum_cond": l_c,
        f"{prefix}_lum_marg": l_m,
        f"{prefix}_rgb": rgb,
    }
    info = {
        "isotropic": isotropic,
        "jacobian": jac,
        "n_phi": int(phi_i.shape[0]),
        "n_theta": int(theta_i.shape[0]),
    }
    return tables, info


# --------------------------------------------------------------------------
# warp math (vectorized Marginal2D)
# --------------------------------------------------------------------------

def _elevation(v):
    """Robust acos(z) (powitacq_rgb.inl:1073)."""
    dz = v[..., 2] - 1.0
    return 2.0 * jnp.arcsin(jnp.clip(
        0.5 * jnp.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2 + dz * dz), 0.0, 1.0))


def _theta2u(t):
    return jnp.sqrt(t * (2.0 / jnp.pi))


def _phi2u(p):
    return (p + jnp.pi) / (2.0 * jnp.pi)


def _u2theta(u):
    return u * u * (jnp.pi / 2.0)


def _u2phi(u):
    return (2.0 * u - 1.0) * jnp.pi


def _param_weights(values, x):
    """find_interval over a 1D knot vector -> (i0, w0, w1) per lane."""
    n = values.shape[0]
    if n == 1:
        z = jnp.zeros(jnp.shape(x), jnp.int32)
        return z, jnp.ones(jnp.shape(x), jnp.float32), jnp.zeros(jnp.shape(x), jnp.float32)
    idx = jnp.clip(jnp.searchsorted(values, x, side="right") - 1, 0, n - 2)
    p0 = values[idx]
    p1 = values[idx + 1]
    w1 = jnp.clip((x - p0) / jnp.maximum(p1 - p0, 1e-20), 0.0, 1.0)
    return idx.astype(jnp.int32), 1.0 - w1, w1


class _Slice4:
    """Blends gathers over the 2x2 (phi, theta) param corners."""

    def __init__(self, pi, pw0, pw1, ti, tw0, tw1, nphi):
        self.pi0 = pi
        self.pi1 = jnp.minimum(pi + 1, nphi - 1) if nphi > 1 else pi
        self.ti0 = ti
        self.ti1 = ti + 1
        self.w00 = pw0 * tw0
        self.w01 = pw0 * tw1
        self.w10 = pw1 * tw0
        self.w11 = pw1 * tw1

    def fetch(self, table, *idx):
        """table[(phi, theta, *idx)] blended; idx components broadcast."""
        v00 = table[(self.pi0, self.ti0) + idx]
        v01 = table[(self.pi0, self.ti1) + idx]
        v10 = table[(self.pi1, self.ti0) + idx]
        v11 = table[(self.pi1, self.ti1) + idx]
        return v00 * self.w00 + v01 * self.w01 + v10 * self.w10 + v11 * self.w11


def _make_slice(tables, prefix, info, phi, theta):
    pv = tables[f"{prefix}_phi_i"]
    tv = tables[f"{prefix}_theta_i"]
    nphi, ntheta = info["n_phi"], info["n_theta"]
    pi, pw0, pw1 = _param_weights(pv, phi)
    if nphi == 1:
        pw0, pw1 = jnp.ones_like(phi), jnp.zeros_like(phi)
    ti, tw0, tw1 = _param_weights(tv, theta)
    if ntheta == 1:
        # degenerate theta axis: single slice, ti+1 gathers are clamped by
        # jnp indexing and weighted 0
        tw0, tw1 = jnp.ones_like(theta), jnp.zeros_like(theta)
    return _Slice4(pi, pw0, pw1, ti, tw0, tw1, nphi)


def _eval_warp0(table, pos):
    """Marginal2D<0>.eval with the raw-data shortcut: the constructor's
    1/hprod(inv_patch) scaling cancels eval's trailing *hprod
    (powitacq_rgb.inl:300-325,534-586) so this is a plain bilinear fetch."""
    ny, nx = table.shape[-2], table.shape[-1]
    px = pos[..., 0] * (nx - 1)
    py = pos[..., 1] * (ny - 1)
    ix = jnp.clip(px.astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(py.astype(jnp.int32), 0, ny - 2)
    wx = px - ix
    wy = py - iy
    v00 = table[iy, ix]
    v10 = table[iy, ix + 1]
    v01 = table[iy + 1, ix]
    v11 = table[iy + 1, ix + 1]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v10)
            + wy * ((1 - wx) * v01 + wx * v11))


def _find_interval(fetch, n, target):
    """Vectorized find_interval (powitacq_rgb.inl:147-168): largest index in
    [0, n-2] with fetch(idx) < target, via fixed-depth probing."""
    first = jnp.ones(jnp.shape(target), jnp.int32)
    size = jnp.full(jnp.shape(target), n - 2, jnp.int32)
    steps = max(1, int(np.ceil(np.log2(max(2, n - 1)))) + 1)
    for _ in range(steps):
        active = size > 0
        half = size >> 1
        middle = first + half
        pred = fetch(middle) < target
        first = jnp.where(active & pred, middle + 1, first)
        size = jnp.where(active, jnp.where(pred, size - (half + 1), half), size)
    return jnp.clip(first - 1, 0, n - 2)


def _invert_warp2(sl, data, cond, marg, sample):
    """Marginal2D<2>.invert (powitacq_rgb.inl:442-530): uv -> (cdf sample,
    density*hprod)."""
    ny, nx = data.shape[-2], data.shape[-1]
    sx = sample[..., 0] * (nx - 1)
    sy = sample[..., 1] * (ny - 1)
    ix = jnp.clip(sx.astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(sy.astype(jnp.int32), 0, ny - 2)
    fx = sx - ix
    fy = sy - iy

    v00 = sl.fetch(data, iy, ix)
    v10 = sl.fetch(data, iy, ix + 1)
    v01 = sl.fetch(data, iy + 1, ix)
    v11 = sl.fetch(data, iy + 1, ix + 1)
    c0 = (1 - fy) * v00 + fy * v01
    c1 = (1 - fy) * v10 + fy * v11
    pdf = (1 - fx) * c0 + fx * c1

    ox = fx * (c0 + 0.5 * fx * (c1 - c0))
    cv0 = sl.fetch(cond, iy, ix)
    cv1 = sl.fetch(cond, iy + 1, ix)
    ox = ox + (1 - fy) * cv0 + fy * cv1
    r0 = sl.fetch(cond, iy, nx - 1)
    r1 = sl.fetch(cond, iy + 1, nx - 1)
    ox = ox / jnp.maximum((1 - fy) * r0 + fy * r1, 1e-20)

    oy = fy * (r0 + 0.5 * fy * (r1 - r0))
    oy = oy + sl.fetch(marg, iy)
    out = jnp.stack([ox, oy], axis=-1)
    return out, pdf * (nx - 1) * (ny - 1)


def _sample_warp2(sl, data, cond, marg, sample):
    """Marginal2D<2>.sample (powitacq_rgb.inl:333-440)."""
    ny, nx = data.shape[-2], data.shape[-1]
    sx = jnp.clip(sample[..., 0], 1.0 - _ONE_MINUS_EPS, _ONE_MINUS_EPS)
    sy = jnp.clip(sample[..., 1], 1.0 - _ONE_MINUS_EPS, _ONE_MINUS_EPS)

    row = _find_interval(lambda i: sl.fetch(marg, i), ny, sy)
    sy = sy - sl.fetch(marg, row)

    r0 = sl.fetch(cond, row, nx - 1)
    r1 = sl.fetch(cond, row + 1, nx - 1)
    is_const = jnp.abs(r0 - r1) < 1e-4 * (r0 + r1)
    sy = jnp.where(
        is_const,
        2.0 * sy / jnp.maximum(r0 + r1, 1e-20),
        (r0 - jnp.sqrt(jnp.maximum(r0 * r0 - 2.0 * sy * (r0 - r1), 0.0)))
        / jnp.where(is_const, 1.0, jnp.where(jnp.abs(r0 - r1) < 1e-20, 1e-20,
                                             r0 - r1)))
    sx = sx * ((1 - sy) * r0 + sy * r1)

    def fetch_cond(i):
        v0 = sl.fetch(cond, row, i)
        v1 = sl.fetch(cond, row + 1, i)
        return (1 - sy) * v0 + sy * v1

    col = _find_interval(fetch_cond, nx, sx)
    sx = sx - fetch_cond(col)

    v00 = sl.fetch(data, row, col)
    v10 = sl.fetch(data, row, col + 1)
    v01 = sl.fetch(data, row + 1, col)
    v11 = sl.fetch(data, row + 1, col + 1)
    c0 = (1 - sy) * v00 + sy * v01
    c1 = (1 - sy) * v10 + sy * v11
    is_c = jnp.abs(c0 - c1) < 1e-4 * (c0 + c1)
    sx = jnp.where(
        is_c,
        2.0 * sx / jnp.maximum(c0 + c1, 1e-20),
        (c0 - jnp.sqrt(jnp.maximum(c0 * c0 - 2.0 * sx * (c0 - c1), 0.0)))
        / jnp.where(is_c, 1.0, jnp.where(jnp.abs(c0 - c1) < 1e-20, 1e-20,
                                         c0 - c1)))
    pdf = ((1 - sx) * c0 + sx * c1) * (nx - 1) * (ny - 1)
    uv = jnp.stack([(col + sx) / (nx - 1), (row + sy) / (ny - 1)], axis=-1)
    return uv, pdf


def _eval_warp2(sl, data, pos):
    """Marginal2D<2>.eval for CDF warps: bilinear over normalized density
    times hprod(inv_patch) (powitacq_rgb.inl:534-586)."""
    ny, nx = data.shape[-2], data.shape[-1]
    px = pos[..., 0] * (nx - 1)
    py = pos[..., 1] * (ny - 1)
    ix = jnp.clip(px.astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(py.astype(jnp.int32), 0, ny - 2)
    wx = px - ix
    wy = py - iy
    v00 = sl.fetch(data, iy, ix)
    v10 = sl.fetch(data, iy, ix + 1)
    v01 = sl.fetch(data, iy + 1, ix)
    v11 = sl.fetch(data, iy + 1, ix + 1)
    v = ((1 - wy) * ((1 - wx) * v00 + wx * v10)
         + wy * ((1 - wx) * v01 + wx * v11))
    return v * (nx - 1) * (ny - 1)


def _eval_rgb(sl, rgb, pos):
    """rgb warp eval: raw bilinear per channel (channel param is an exact
    knot so the Warp2D3 blend degenerates to indexing)."""
    ny, nx = rgb.shape[-2], rgb.shape[-1]
    px = pos[..., 0] * (nx - 1)
    py = pos[..., 1] * (ny - 1)
    ix = jnp.clip(px.astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(py.astype(jnp.int32), 0, ny - 2)
    wx = px - ix
    wy = py - iy
    chans = []
    for ch in range(3):
        v00 = sl.fetch(rgb, ch, iy, ix)
        v10 = sl.fetch(rgb, ch, iy, ix + 1)
        v01 = sl.fetch(rgb, ch, iy + 1, ix)
        v11 = sl.fetch(rgb, ch, iy + 1, ix + 1)
        chans.append((1 - wy) * ((1 - wx) * v00 + wx * v10)
                     + wy * ((1 - wx) * v01 + wx * v11))
    return jnp.maximum(jnp.stack(chans, axis=-1), 0.0)  # POWITACQ_CLIP_RGB


# --------------------------------------------------------------------------
# BRDF interface (local +Z hemisphere, powitacq conventions)
# --------------------------------------------------------------------------

def brdf_eval_local(tables, prefix, info, wi, wo):
    """fr(wi, wo) per powitacq_rgb.inl:1113-1154; zero off-hemisphere."""
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    wm = wi + wo
    wm = wm / jnp.maximum(jnp.linalg.norm(wm, axis=-1, keepdims=True), 1e-20)
    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
    theta_m = _elevation(wm)
    phi_m = jnp.arctan2(wm[..., 1], wm[..., 0])

    u_wi = jnp.stack([_theta2u(theta_i), _phi2u(phi_i)], axis=-1)
    uy = _phi2u(phi_m - phi_i if info["isotropic"] else phi_m)
    uy = uy - jnp.floor(uy)
    u_wm = jnp.stack([_theta2u(theta_m), uy], axis=-1)

    sl = _make_slice(tables, prefix, info, phi_i, theta_i)
    sample, _ = _invert_warp2(sl, tables[f"{prefix}_vndf_data"],
                              tables[f"{prefix}_vndf_cond"],
                              tables[f"{prefix}_vndf_marg"], u_wm)
    fr = _eval_rgb(sl, tables[f"{prefix}_rgb"], sample)
    ndf = _eval_warp0(tables[f"{prefix}_ndf"], u_wm)
    sig = _eval_warp0(tables[f"{prefix}_sigma"], u_wi)
    fr = fr * safe_div(ndf, 4.0 * sig)[..., None]
    return jnp.where(valid[..., None], fr, 0.0)


def brdf_pdf_local(tables, prefix, info, wi, wo):
    """pdf(wi, wo) per powitacq_rgb.inl:1075-1108 (luminance sampling on)."""
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    wm = wi + wo
    wm = wm / jnp.maximum(jnp.linalg.norm(wm, axis=-1, keepdims=True), 1e-20)
    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
    theta_m = _elevation(wm)
    phi_m = jnp.arctan2(wm[..., 1], wm[..., 0])
    uy = _phi2u(phi_m - phi_i if info["isotropic"] else phi_m)
    uy = uy - jnp.floor(uy)
    u_wm = jnp.stack([_theta2u(theta_m), uy], axis=-1)

    sl = _make_slice(tables, prefix, info, phi_i, theta_i)
    sample, vndf_pdf = _invert_warp2(sl, tables[f"{prefix}_vndf_data"],
                                     tables[f"{prefix}_vndf_cond"],
                                     tables[f"{prefix}_vndf_marg"], u_wm)
    lum_pdf = _eval_warp2(sl, tables[f"{prefix}_lum_data"], sample)
    sin_tm = jnp.sqrt(wm[..., 0] ** 2 + wm[..., 1] ** 2)
    jac = jnp.maximum(2.0 * jnp.pi ** 2 * u_wm[..., 0] * sin_tm, 1e-6) \
        * 4.0 * dot(wi, wm)
    pdf = vndf_pdf * lum_pdf / jnp.maximum(jac, 1e-20)
    return jnp.where(valid, jnp.maximum(pdf, 0.0), 0.0)


def brdf_sample_local(tables, prefix, info, u1, u2, wi):
    """sample(u, wi) -> (wo, fr, pdf, valid) per powitacq_rgb.inl:1159-1239.
    `wi` here is the fixed (view) direction, matching djmeasured.art:753-758
    where sample_brdf receives the local out_dir."""
    theta_i = _elevation(wi)
    phi_i = jnp.arctan2(wi[..., 1], wi[..., 0])
    u_wi = jnp.stack([_theta2u(theta_i), _phi2u(phi_i)], axis=-1)
    sample = jnp.stack([u2, u1], axis=-1)  # Vector2f(u.y(), u.x())

    sl = _make_slice(tables, prefix, info, phi_i, theta_i)
    sample, lum_pdf = _sample_warp2(sl, tables[f"{prefix}_lum_data"],
                                    tables[f"{prefix}_lum_cond"],
                                    tables[f"{prefix}_lum_marg"], sample)
    u_wm, ndf_pdf = _sample_warp2(sl, tables[f"{prefix}_vndf_data"],
                                  tables[f"{prefix}_vndf_cond"],
                                  tables[f"{prefix}_vndf_marg"], sample)
    phi_m = _u2phi(u_wm[..., 1])
    theta_m = _u2theta(u_wm[..., 0])
    if info["isotropic"]:
        phi_m = phi_m + phi_i
    sin_tm = jnp.sin(theta_m)
    wm = jnp.stack([jnp.cos(phi_m) * sin_tm, jnp.sin(phi_m) * sin_tm,
                    jnp.cos(theta_m)], axis=-1)
    wo = wm * (2.0 * dot(wm, wi))[..., None] - wi
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)

    fr = _eval_rgb(sl, tables[f"{prefix}_rgb"], sample)
    ndf = _eval_warp0(tables[f"{prefix}_ndf"], u_wm)
    sig = _eval_warp0(tables[f"{prefix}_sigma"], u_wi)
    fr = fr * safe_div(ndf, 4.0 * sig)[..., None]
    jac = jnp.maximum(2.0 * jnp.pi ** 2 * u_wm[..., 0] * sin_tm, 1e-6) \
        * 4.0 * dot(wi, wm)
    pdf = ndf_pdf * lum_pdf / jnp.maximum(jac, 1e-20)
    return wo, jnp.where(valid[..., None], fr, 0.0), \
        jnp.where(valid, pdf, 0.0), valid


# --------------------------------------------------------------------------
# Ignis Bsdf closure semantics (djmeasured.art:727-761)
# --------------------------------------------------------------------------

def dj_eval(tables, prefix, info, tint, surf, in_dir, out_dir):
    wi = to_local(in_dir, surf["t"], surf["b"], surf["n"])
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    return tint * brdf_eval_local(tables, prefix, info, wi, wo)


def dj_pdf(tables, prefix, info, surf, in_dir, out_dir):
    wi = to_local(in_dir, surf["t"], surf["b"], surf["n"])
    wo = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    return brdf_pdf_local(tables, prefix, info, wi, wo)


def dj_sample(tables, prefix, info, tint, surf, u1, u2, out_dir):
    """Returns (in_dir, pdf, weight, eta, valid); weight = tint*fr/pdf
    (djmeasured.art:655-658 folds 1/pdf into res, no cosine)."""
    wo_local = to_local(out_dir, surf["t"], surf["b"], surf["n"])
    wi_new, fr, pdf, valid = brdf_sample_local(tables, prefix, info,
                                               u1, u2, wo_local)
    in_dir = to_world(wi_new, surf["t"], surf["b"], surf["n"])
    weight = tint * fr * safe_div(1.0, pdf)[..., None]
    eta = jnp.ones_like(pdf)
    return in_dir, pdf, weight, eta, valid & (pdf > 0)
