"""Heterogeneous volume data: grids, lookups, and the point mapper.

Counterpart of src/artic/medium/volume/ + the host-side grid
prep in src/runtime/medium/HeterogeneousMedium.cpp.

Representation: every heterogeneous medium gets dense JAX arrays
(D, H, W, C) — either raw per-voxel coefficients ("voxel" kind, the
reference's uniform-grid .bin format, scripts/voxelgrid2bin/voxelgrid2bin.py)
or a scalar density (+ optional temperature) field ("density" kind, the
reference's NanoVDB path, src/artic/medium/volume/nanovdb/).  Sparse trees
are densified at load: array code wants regular gathers, not pointer chasing.

Coordinates: the reference maps world points into the *reference entity's*
local space and normalizes by the shape's local bbox
(src/artic/driver/pointmapper.art:28-37 `make_standard_pointmapperset`).
Voxel (i,j,k) spans [i/W,(i+1)/W)×… with index i = x + y*W + z*W*H
(src/artic/medium/volume/voxelgrid/voxelgrid.art:17-41).
"""

from __future__ import annotations

import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import matmul

DENSITY_EPS = 1e-4  # medium/shaders/common.art DENSITY_EPS


def load_voxel_grid_bin(path) -> dict:
    """Reference uniform voxel-grid .bin: u32×4 header (W,H,D,0) then
    W*H*D voxels of 12 f32 (sigma_a.xyz0 | sigma_s.xyz0 | emission.xyz0),
    x-fastest (scripts/voxelgrid2bin/voxelgrid2bin.py:72-77;
    decode voxelgrid.art:17-41).  Returns (D,H,W,3) float32 arrays."""
    raw = Path(path).read_bytes()
    w, h, d, _ = struct.unpack_from("4I", raw, 0)
    n = w * h * d
    data = np.frombuffer(raw, dtype=np.float32, offset=16,
                         count=n * 12).reshape(d, h, w, 12)
    return dict(kind="voxel", width=w, height=h, depth=d,
                sigma_a=np.ascontiguousarray(data[..., 0:3]),
                sigma_s=np.ascontiguousarray(data[..., 4:7]),
                emission=np.ascontiguousarray(data[..., 8:11]))


def grid_lookup(grid, lpos, interpolate=False):
    """Gather grid (D,H,W,C) at normalized local positions (n,3) in [0,1]³.

    Nearest (reference default) clamps voxel indices to the grid
    (voxelgrid.art:24-30); trilinear matches interpolate=true media.
    """
    d, h, w = grid.shape[0], grid.shape[1], grid.shape[2]
    dims = jnp.asarray([w, h, d], jnp.float32)
    if not interpolate:
        idx = jnp.floor(lpos * dims).astype(jnp.int32)
        ix = jnp.clip(idx[..., 0], 0, w - 1)
        iy = jnp.clip(idx[..., 1], 0, h - 1)
        iz = jnp.clip(idx[..., 2], 0, d - 1)
        return grid[iz, iy, ix]
    # trilinear over voxel centers
    p = lpos * dims - 0.5
    i0 = jnp.floor(p).astype(jnp.int32)
    f = p - i0
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = jnp.clip(i0[..., 0] + dx, 0, w - 1)
                iy = jnp.clip(i0[..., 1] + dy, 0, h - 1)
                iz = jnp.clip(i0[..., 2] + dz, 0, d - 1)
                wx = f[..., 0] if dx else 1.0 - f[..., 0]
                wy = f[..., 1] if dy else 1.0 - f[..., 1]
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                out = out + grid[iz, iy, ix] * (wx * wy * wz)[..., None]
    return out


def to_normalized_point(tables, ref_ent, world_p):
    """world → [0,1]³ local volume coords via the reference entity
    (pointmapper.art:4-8 make_normalized_pointmapper)."""
    m = tables["ent_local_mat"][ref_ent]  # (3,4)
    lp = matmul(world_p, m[:, :3].T) + m[:, 3]
    bmin = tables["ent_lbbox_min"][ref_ent]
    ext = tables["ent_lbbox_max"][ref_ent] - bmin
    return (lp - bmin) / jnp.maximum(ext, 1e-20)


def inside_unit(lpos, eps=1e-5):
    """Inside the (slightly expanded) unit cube
    (delta_tracking.art VOLUME_BOUNDS_FLT_MIN checks)."""
    return jnp.all((lpos >= -eps) & (lpos <= 1.0 + eps), axis=-1)


# ---------------------------------------------------------------------------
# Volume shaders (src/artic/medium/shaders/): map stored voxel values to
# (sigma_s, sigma_a, emission).  Shader parameters live in the
# `medium_shader` table so they stay differentiable.
# Row layout (20 floats):
#   0 scalar_density | 1 scalar_emission | 2:5 color_scattering
#   | 5:8 color_absorption | 8:11 color_emission | 11:14 color_blackbody
#   | 14 scalar_blackbody | 15 scalar_temperature | 16 offset_temperature
#   | 17 scalar_absorption | 18 scalar_scattering | 19 pad
# ---------------------------------------------------------------------------

SHADER_ROW = 20


def shader_row_from_props(mobj: dict) -> np.ndarray:
    """Build the shader-parameter row from medium JSON properties
    (HeterogeneousMedium.cpp:92-153 parameter defaults)."""
    def num(k, dv):
        return float(mobj.get(k, dv))

    def col(k, dv):
        v = mobj.get(k, dv)
        if isinstance(v, (int, float)):
            v = [v, v, v]
        return np.asarray(v[:3], np.float32)

    row = np.zeros(SHADER_ROW, np.float32)
    row[0] = num("scalar_density", 1.0)
    row[1] = num("scalar_emission", 0.0)
    shader = mobj.get("shader", "monochromatic")
    if shader == "principled_volume":
        row[2:5] = col("color_scattering", [0.5, 0.5, 0.5])
        row[5:8] = col("color_absorption", [0.8, 0.8, 0.8])
    else:
        row[2:5] = col("color_scattering", [1.0, 1.0, 1.0])
        row[5:8] = col("color_absorption", [1.0, 1.0, 1.0])
    row[8:11] = col("color_emission", [1.0, 1.0, 1.0])
    row[11:14] = col("color_blackbody", [0.0, 0.0, 0.0])
    row[14] = min(max(num("scalar_blackbody", 1.0), 0.0), 1.0)
    row[15] = num("scalar_temperature", 0.0)
    cutoff = num("cutoff_temperature", 0.0)
    row[16] = num("offset_temperature", cutoff)
    row[17] = num("scalar_absorption", 1.0)
    row[18] = num("scalar_scattering", 1.0)
    return row


def _blackbody_rgb(temp):
    """Planckian locus → linear sRGB approximation of math::blackbody
    (src/artic/core/color.art).  temp (n,) in Kelvin, clamped ≥ 1000."""
    t = jnp.maximum(temp, 1000.0)
    # Krystek-style rational fits of the Planckian locus in CIE xy
    u = ((0.860117757 + 1.54118254e-4 * t + 1.28641212e-7 * t * t)
         / (1.0 + 8.42420235e-4 * t + 7.08145163e-7 * t * t))
    v = ((0.317398726 + 4.22806245e-5 * t + 4.20481691e-8 * t * t)
         / (1.0 - 2.89741816e-5 * t + 1.61456053e-7 * t * t))
    x = 3.0 * u / (2.0 * u - 8.0 * v + 4.0)
    y = 2.0 * v / (2.0 * u - 8.0 * v + 4.0)
    z = 1.0 - x - y
    sy = 1.0
    X = sy / jnp.maximum(y, 1e-6) * x
    Z = sy / jnp.maximum(y, 1e-6) * z
    r = 3.2404542 * X - 1.5371385 * sy - 0.4985314 * Z
    g = -0.9692660 * X + 1.8760108 * sy + 0.0415560 * Z
    b = 0.0556434 * X - 0.2040259 * sy + 1.0572252 * Z
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.maximum(rgb, 0.0)


def apply_density_shader(shader_type: str, row, density, temperature=None):
    """Density(-temperature) → (sigma_s, sigma_a, emission), each (n,3).

    monochromatic: medium/shaders/monochromatic.art:16-25
    pbrt_volume:   medium/shaders/pbrt.art
    principled_volume: medium/shaders/principled_volume.art
    """
    dens = jnp.where(density > DENSITY_EPS, density * row[0], 0.0)[..., None]
    if shader_type == "pbrt_volume":
        ss = row[2:5] * dens
        sa = row[5:8] * dens
        if temperature is not None:
            vt = (temperature - row[16]) * row[15]
            em = jnp.where((vt > 100.0)[..., None],
                           _blackbody_rgb(vt) * row[1],
                           0.0)
        else:
            em = jnp.broadcast_to(row[8:11] * row[1], ss.shape)
        em = jnp.where(row[1] > 0.0, em, jnp.zeros_like(em))
        return ss, sa, em
    if shader_type == "principled_volume":
        ss = row[2:5] * dens
        sa = (1.0 - row[2:5]) * (1.0 - row[5:8]) * dens
        em = jnp.broadcast_to(row[8:11] * row[1], ss.shape)
        em = jnp.where(row[1] > 0.0, em, jnp.zeros_like(em))
        if temperature is not None:
            # Stefan-Boltzmann blackbody add (principled_volume.art:33-52)
            lt = row[15] * temperature
            lt4 = (lt * lt) * (lt * lt)
            intensity = (5.670373 / np.pi) * (
                (1.0 + (lt4 - 1.0) * row[14]) / 1e14)
            bb = (_blackbody_rgb(lt) * row[11:14]
                  * intensity[..., None])
            bb = jnp.where((lt >= 1000.0)[..., None], bb, 0.0)
            em = em + jnp.where((row[14] > 0.0) & (row[15] > 0.0),
                                bb, jnp.zeros_like(bb))
        return ss, sa, em
    # monochromatic (gray): density * scalar_{scattering,absorption}
    ss = jnp.broadcast_to(dens * row[18], dens.shape[:-1] + (3,))
    sa = jnp.broadcast_to(dens * row[17], dens.shape[:-1] + (3,))
    return ss, sa, jnp.zeros_like(ss)
