#!/usr/bin/env python3
"""Brute-force sweep vs BVH traversal across soup sizes, on one GPU.

Renders generated scenes through `Runtime.step` both ways (use_bvh False /
True) and prints Msamples/s per scene: the measurement behind the GPU
routing of ops/traverse.py (every soup gets a BVH and the GPU always takes
the CUDA kernel).  Run from the repository root:

    python tools/bvh_crossover.py
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import jax

    from chip_smoke import phase_device, render_timed
    from ignis_jax.api import Runtime
    from ignis_jax.scene.generated import demo_scene, sphere_field

    phase_device()
    scenes = [("demo", demo_scene())] + [
        (f"spheres{n}x{s}", sphere_field(n_spheres=n, subdiv=s))
        for n, s in ((1, 4), (2, 4), (4, 4))]
    for name, sc in scenes:
        row = []
        for use_bvh in (False, True):
            rt = Runtime(sc, width=512, height=512, use_bvh=use_bvh)
            msps = render_timed(rt, 4, 3)[0]
            row.append(msps)
        ntris = int(rt.tables["tri_v0"].shape[0])
        print(f"{name}: {ntris} triangles, brute {row[0]:.3f} Msamples/s, "
              f"BVH {row[1]:.3f} Msamples/s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), jax.devices()[0])


if __name__ == "__main__":
    main()
