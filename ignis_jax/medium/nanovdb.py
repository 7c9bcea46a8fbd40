"""Minimal NanoVDB (.nvdb) reader → dense density grid.

Counterpart of src/runtime/measured/NanoVDBLoader.{h,cpp} (which
re-packs NanoVDB trees into a flat buffer for the Artic tree-climb in
src/artic/medium/volume/nanovdb/).  Whole-array code wants regular gathers, not
pointer chasing, so instead of preserving the sparse tree we densify at load time:
the leaf-node array (contiguous in the NanoVDB buffer) is scattered into a
dense (D,H,W) float32 array covering the grid's index bounding box.

Supported: uncompressed (codec NONE) float grids, NanoVDB data layout
version 32.x (the "NanoVDB0" magic).  Internal-node value tiles — constant
regions promoted above leaf level — are rare in fog volumes; files using
them are rejected loudly rather than read wrong.

File layout parsed here:
  FileHeader { u64 magic; u32 version; u16 gridCount; u16 codec }
  per grid: FileMetaData (176 B) + grid name + grid blob
  grid blob: GridData (672 B) | TreeData (64 B) | root | internals | leaves
  LeafData<float> (2144 B): CoordT bboxMin (12) | u8 bboxDif[3] | u8 flags
    | 64 B value mask | min/max/avg/stddev (16) | f32 values[512]
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

NANOVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0"
_FILE_HEADER = struct.Struct("<QIHH")
# FileMetaData: gridSize, fileSize, nameKey, voxelCount, gridType, gridClass,
# worldBBox (6d), indexBBox (6i), voxelSize (3d), nameSize, nodeCount[4],
# tileCount[3], codec, padding, version
_FILE_META = struct.Struct("<4Q2I6d6i3dI4I3IHHI")
assert _FILE_META.size == 176

_GRID_TYPE_FLOAT = 1
_LEAF_SIZE = 2144
_LEAF_VALUES_OFF = 96


def _parse_file(raw: bytes):
    magic, version, grid_count, codec = _FILE_HEADER.unpack_from(raw, 0)
    if magic != NANOVDB_MAGIC:
        raise ValueError("Not a NanoVDB file (bad magic)")
    if codec != 0:
        raise ValueError(f"Compressed .nvdb (codec={codec}) not supported; "
                         "re-save uncompressed")
    off = _FILE_HEADER.size
    grids = []
    for _ in range(grid_count):
        m = _FILE_META.unpack_from(raw, off)
        off += _FILE_META.size
        (grid_size, file_size, _name_key, _voxel_count, grid_type,
         grid_class) = m[0:6]
        index_bbox = m[12:18]
        name_size = m[21]
        node_count = m[22:26]
        tile_count = m[26:29]
        name = raw[off:off + name_size].split(b"\0")[0].decode()
        off += name_size
        grids.append(dict(name=name, offset=off, grid_size=grid_size,
                          grid_type=grid_type, grid_class=grid_class,
                          index_bbox=index_bbox, node_count=node_count,
                          tile_count=tile_count))
        off += grid_size
    return grids


def load_nvdb_grid(path, grid_name: str = "density") -> np.ndarray:
    """Read one named float grid from a .nvdb file as a dense (D,H,W)
    float32 array over its index bbox (z-major to match voxel grids)."""
    raw = Path(path).read_bytes()
    grids = _parse_file(raw)
    grid = next((g for g in grids if g["name"] == grid_name), None)
    if grid is None:
        names = [g["name"] for g in grids]
        raise ValueError(f"Grid '{grid_name}' not in {path} "
                         f"(available: {names})")
    if grid["grid_type"] != _GRID_TYPE_FLOAT:
        raise ValueError(f"Grid '{grid_name}' is not a float grid "
                         f"(type={grid['grid_type']})")
    if any(grid["tile_count"]):
        raise ValueError("NanoVDB grids with internal-node value tiles are "
                         "not supported by the dense loader")

    base = grid["offset"]
    # GridData (672 B) then TreeData: u64 nodeOffset[4] (leaf,lower,upper,
    # root, relative to tree start), u32 nodeCount[3], u32 tileCount[3],
    # u64 voxelCount
    tree = base + 672
    node_off = struct.unpack_from("<4Q", raw, tree)
    leaf_count = struct.unpack_from("<3I", raw, tree + 32)[0]
    if leaf_count != grid["node_count"][0]:
        raise ValueError("Leaf count mismatch between file metadata and "
                         "tree header — unsupported NanoVDB version?")

    ib = grid["index_bbox"]
    bmin = np.asarray(ib[0:3], np.int64)
    bmax = np.asarray(ib[3:6], np.int64)
    dims = bmax - bmin + 1  # (x, y, z)
    dense = np.zeros((dims[2], dims[1], dims[0]), np.float32)

    leaves_at = tree + node_off[0]
    if leaf_count:
        buf = np.frombuffer(raw, np.uint8, count=leaf_count * _LEAF_SIZE,
                            offset=leaves_at).reshape(leaf_count, _LEAF_SIZE)
        origins = buf[:, :12].copy().view(np.int32).reshape(leaf_count, 3)
        origins = origins & ~7  # active-bbox min → leaf origin
        masks = np.unpackbits(buf[:, 16:80], axis=1,
                              bitorder="little").astype(bool)
        values = buf[:, _LEAF_VALUES_OFF:_LEAF_VALUES_OFF + 2048].copy() \
            .view(np.float32).reshape(leaf_count, 512)
        values = np.where(masks, values, 0.0)
        # NanoVDB leaf value order: v[((i&7)<<6)|((j&7)<<3)|(k&7)] → (x,y,z)
        vals = values.reshape(leaf_count, 8, 8, 8)  # (x, y, z)
        for li in range(leaf_count):
            ox, oy, oz = origins[li] - bmin
            xs, ys, zs = (slice(max(ox, 0), ox + 8), slice(max(oy, 0), oy + 8),
                          slice(max(oz, 0), oz + 8))
            v = vals[li].transpose(2, 1, 0)  # → (z, y, x)
            v = v[max(-oz, 0):dims[2] - oz, max(-oy, 0):dims[1] - oy,
                  max(-ox, 0):dims[0] - ox]
            dense[zs, ys, xs][: v.shape[0], : v.shape[1], : v.shape[2]] = v
    return dense


# ---------------------------------------------------------------------------
# Writer — used by tests (round-trip) and by tools converting dense grids to
# .nvdb.  Emits a minimal single-root-tile tree in the layout parsed above.
# ---------------------------------------------------------------------------

def write_nvdb_grid(path, dense: np.ndarray, grid_name: str = "density"):
    """Write a dense (D,H,W) float32 array as a minimal uncompressed .nvdb
    float fog-volume grid (single upper/lower internal node chain)."""
    dense = np.asarray(dense, np.float32)
    d, h, w = dense.shape
    if max(d, h, w) > 4096:
        raise ValueError("write_nvdb_grid supports grids up to 4096³")

    # build leaves
    leaves = []
    for oz in range(0, d, 8):
        for oy in range(0, h, 8):
            for ox in range(0, w, 8):
                block = np.zeros((8, 8, 8), np.float32)
                sub = dense[oz:oz + 8, oy:oy + 8, ox:ox + 8]
                block[: sub.shape[0], : sub.shape[1], : sub.shape[2]] = sub
                if not np.any(block):
                    continue
                leaves.append((ox, oy, oz, block))

    leaf_blob = bytearray()
    for ox, oy, oz, block in leaves:
        b = bytearray(_LEAF_SIZE)
        struct.pack_into("<3i", b, 0, ox, oy, oz)
        b[12:15] = bytes([7, 7, 7])
        b[15] = 0
        vals = block.transpose(2, 1, 0).reshape(512)  # (x,y,z) order
        mask = np.packbits((vals != 0.0), bitorder="little")
        b[16:80] = mask.tobytes()
        struct.pack_into("<4f", b, 80, float(vals.min()), float(vals.max()),
                         float(vals.mean()), float(vals.std()))
        b[_LEAF_VALUES_OFF:_LEAF_VALUES_OFF + 2048] = vals.tobytes()
        leaf_blob += b

    # Minimal root/internal blobs: the dense reader never dereferences
    # them, but sizes must be consistent.  Root: 64 B header + 1 tile 32 B.
    root_blob = bytes(64 + 32)
    upper_blob = bytes(24 + 8 + 4096 + 4096 + 16 + 32768 * 8 + 48)
    lower_blob = bytes(24 + 8 + 512 + 512 + 16 + 4096 * 8 + 48)

    tree_hdr = struct.pack(
        "<4Q3I3IQ",
        64 + len(root_blob) + len(upper_blob) + len(lower_blob),  # leaf off
        64 + len(root_blob) + len(upper_blob),                    # lower off
        64 + len(root_blob),                                      # upper off
        64,                                                       # root off
        len(leaves), 1, 1,   # node counts (leaf, lower, upper)
        0, 0, 0,             # tile counts
        int((dense != 0).sum()))
    tree_blob = tree_hdr + bytes(64 - len(tree_hdr))

    grid_data = bytearray(672)
    struct.pack_into("<QQ", grid_data, 0, NANOVDB_MAGIC, 0)
    struct.pack_into("<I", grid_data, 16, (32 << 21) | (3 << 10))  # v32.3
    name_b = grid_name.encode()[:255]
    grid_data[40:40 + len(name_b)] = name_b
    grid_size = (len(grid_data) + len(tree_blob) + len(root_blob)
                 + len(upper_blob) + len(lower_blob) + len(leaf_blob))
    struct.pack_into("<Q", grid_data, 32, grid_size)
    struct.pack_into("<II", grid_data, 632, 1, _GRID_TYPE_FLOAT)  # fog, f32

    name_field = grid_name.encode() + b"\0"
    meta = _FILE_META.pack(
        grid_size, grid_size, 0, int((dense != 0).sum()),
        _GRID_TYPE_FLOAT, 1,
        0.0, 0.0, 0.0, float(w), float(h), float(d),
        0, 0, 0, w - 1, h - 1, d - 1,
        1.0, 1.0, 1.0,
        len(name_field),
        len(leaves), 1, 1, 1,
        0, 0, 0,
        0, 0, (32 << 21) | (3 << 10))

    with open(path, "wb") as f:
        f.write(_FILE_HEADER.pack(NANOVDB_MAGIC, (32 << 21) | (3 << 10),
                                  1, 0))
        f.write(meta)
        f.write(name_field)
        f.write(bytes(grid_data))
        f.write(tree_blob)
        f.write(root_blob)
        f.write(upper_blob)
        f.write(lower_blob)
        f.write(leaf_blob)
