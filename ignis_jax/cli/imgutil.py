"""Image conversion tools (src/tools/: exr2hdr, hdr2exr, exr2png, exr2jpg).

One module, four entry points:
    python -m ignis_jax.cli.imgutil exr2hdr in.exr [out.hdr]
    python -m ignis_jax.cli.imgutil hdr2exr in.hdr [out.exr]
    python -m ignis_jax.cli.imgutil exr2png in.exr [out.png] [--exposure E]
                                    [--tonemap none|reinhard|modified|aces|
                                     uncharted2] [--gamma]
    python -m ignis_jax.cli.imgutil exr2jpg ... (same flags)
LDR conversion matches the reference tools' tonemap+gamma path
(src/tools/exr2png/main.cpp).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _write_hdr(path, img):
    """Radiance RGBE writer (uncompressed scanlines)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        m = img.max(axis=-1)
        exp = np.zeros((h, w), np.int32)
        nz = m > 1e-32
        exp[nz] = np.frexp(m[nz])[1]
        scale = np.zeros((h, w), np.float32)
        scale[nz] = np.ldexp(1.0, -exp[nz]) * 256.0
        rgbe = np.zeros((h, w, 4), np.uint8)
        rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(
            np.uint8)
        rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
        f.write(rgbe.tobytes())


def _tonemap_ldr(img, method, exposure, gamma):
    import jax

    from ignis_jax.render.tonemap import tonemap
    methods = {"none": 0, "reinhard": 1, "modified": 2, "aces": 3,
               "uncharted2": 4}
    out = np.asarray(tonemap(np.asarray(img) * exposure,
                             method=methods[method]))
    out = np.clip(out, 0.0, 1.0)
    if gamma:
        out = np.power(out, 1.0 / 2.2)
    return (out * 255.0 + 0.5).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="igimg")
    ap.add_argument("mode", choices=["exr2hdr", "hdr2exr", "exr2png",
                                     "exr2jpg"])
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--tonemap", default="aces",
                    choices=["none", "reinhard", "modified", "aces",
                             "uncharted2"])
    ap.add_argument("--no-gamma", action="store_true")
    args = ap.parse_args(argv)

    from ignis_jax.texture.loader import _load_hdr
    from ignis_jax.utils.exr import read_exr, write_exr

    inp = Path(args.input)
    ext = {"exr2hdr": ".hdr", "hdr2exr": ".exr", "exr2png": ".png",
           "exr2jpg": ".jpg"}[args.mode]
    out = Path(args.output) if args.output else inp.with_suffix(ext)

    if args.mode == "exr2hdr":
        _write_hdr(out, read_exr(inp))
    elif args.mode == "hdr2exr":
        write_exr(out, _load_hdr(inp))  # _load_hdr returns file row order
    else:
        img = read_exr(inp)
        ldr = _tonemap_ldr(img, args.tonemap, args.exposure,
                           not args.no_gamma)
        from PIL import Image
        Image.fromarray(ldr).save(out)
    print(f"{inp} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
