"""igcli-equivalent batch renderer (src/frontend/cli/main.cpp).

Renders a scene for --spp samples or --timeout seconds, reports min/med/max
Msamples/s per iteration (the reference's benchmark metric,
cli/main.cpp:172-179), and writes an EXR.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="igcli", description=__doc__)
    p.add_argument("scene", help="scene JSON/glTF file")
    p.add_argument("-o", "--output", default="output.exr")
    p.add_argument("--spp", type=int, default=None,
                   help="samples per pixel budget")
    p.add_argument("--spi", type=int, default=1, help="samples per iteration")
    p.add_argument("-t", "--timeout", type=float, default=None,
                   help="time budget in seconds")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="debug-level logging")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--log-file", default=None)
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="resume from FILE if it exists; save state there "
                        "after rendering (progressive across invocations)")
    p.add_argument("--aov", action="store_true",
                   help="also write Normals/Albedo/Depth AOV EXRs "
                        "(infobuffer technique outputs)")
    p.add_argument("--denoise", action="store_true",
                   help="apply the edge-avoiding a-trous denoiser "
                        "(infobuffer-guided) before saving")
    p.add_argument("--stats", action="store_true",
                   help="dump per-stage statistics after rendering")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="set a registry parameter (repeatable; vectors "
                        "comma-separated)")
    p.add_argument("--tonemap", default=None,
                   choices=["none", "reinhard", "modified", "aces",
                            "uncharted2"],
                   help="also write a tonemapped PNG-style EXR")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ignis_jax.utils.log import logger
    if args.verbose:
        logger.set_verbosity("debug")
    logger.set_quiet(args.quiet)
    if args.log_file:
        logger.add_file_listener(args.log_file)
    from ignis_jax.api import Runtime

    rt = Runtime(args.scene, width=args.width, height=args.height,
                 seed=args.seed, use_bvh=not args.no_bvh)
    for pv in args.parameter:
        name, _, val = pv.partition("=")
        vals = [float(x) for x in val.split(",")]
        rt.setParameter(name, vals[0] if len(vals) == 1 else vals)
    if args.checkpoint:
        import os as _os
        if _os.path.exists(args.checkpoint):
            rt.loadCheckpoint(args.checkpoint)
            print(f"Resumed at {rt.currentSampleCount()} spp from "
                  f"{args.checkpoint}")
    spp = args.spp if args.spp is not None else (8 if args.timeout is None else 1 << 30)
    deadline = time.perf_counter() + args.timeout if args.timeout else None

    pixels = rt.width * rt.height
    samples_sec = []
    done = 0
    while done < spp:
        spi = min(args.spi, spp - done)
        t0 = time.perf_counter()
        rt.step(spi=spi)
        dt = time.perf_counter() - t0
        samples_sec.append(pixels * spi / dt)
        done += spi
        if deadline is not None and time.perf_counter() > deadline:
            break

    img = rt.currentFrame()
    if args.checkpoint:
        rt.saveCheckpoint(args.checkpoint)
    if args.aov:
        import jax.numpy as jnp

        from ignis_jax.render.techniques import infobuffer_aovs
        from ignis_jax.utils.exr import write_exr as _wexr
        wpx, hpx = rt.width, rt.height
        idx = np.arange(wpx * hpx, dtype=np.int32)
        aovs = infobuffer_aovs(rt.scene, rt.tables,
                               jnp.asarray(idx % wpx), jnp.asarray(idx // wpx),
                               jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
                               rt.seed)
        stem = args.output.rsplit(".", 1)[0]
        for name, arr in aovs.items():
            a = np.asarray(arr)
            if a.ndim == 1:
                a = np.repeat(a[:, None], 3, axis=1)
            _wexr(f"{stem}_{name.lower()}.exr", a.reshape(hpx, wpx, 3))
    if args.denoise:
        from ignis_jax.render.denoise import denoise_runtime
        img = denoise_runtime(rt)
    from ignis_jax.utils.exr import write_exr
    write_exr(args.output, img)

    if args.tonemap:
        from ignis_jax.render.tonemap import tonemap
        method = {"none": 0, "reinhard": 1, "modified": 2, "aces": 3,
                  "uncharted2": 4}[args.tonemap]
        ldr = np.asarray(tonemap(img, method=method))
        write_exr(args.output.rsplit(".", 1)[0] + "_tonemapped.exr", ldr)

    ss = np.asarray(sorted(samples_sec)) / 1e6
    if len(ss):
        # skip the first (compile) iteration for med like the reference warm-up
        print(f"Samples per second: {ss.min():.3f}/"
              f"{np.median(ss):.3f}/{ss.max():.3f} (min/med/max) Msamples/s")
    print(f"Done: {done} spp -> {args.output}")
    if args.stats:
        print(rt.dumpStats())
    return 0


if __name__ == "__main__":
    sys.exit(main())
