#!/usr/bin/env python3
"""Quantitative root-cause runs for the golden-scoreboard outliers
(VERDICT r3 #2).  Each experiment renders a hypothesis variant and
reports the effect on the mean-ratio vs the reference EXR.

Usage: python tools/golden_investigate.py {lights|sun|planes|env}
Writes GOLDEN_INVESTIGATION.json (merging previous runs).
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

EVAL = Path("/root/reference/scenes/evaluation")
REFS = EVAL / "references"
OUT = Path(__file__).resolve().parent.parent / "GOLDEN_INVESTIGATION.json"


def _load_ref(stem):
    from ignis_jax.utils.exr import read_exr
    for suf in ("-4096", "-8192", "-rad"):
        p = REFS / f"ref-{stem}{suf}.exr"
        if p.exists():
            return np.asarray(read_exr(str(p)))[..., :3]
    raise FileNotFoundError(stem)


def _render(scene_path, spp=64, mutate=None):
    import json as _json

    from ignis_jax.api import Runtime
    from ignis_jax.scene.parser import load_scene_dict
    src = _json.loads(Path(scene_path).read_text())
    if mutate:
        mutate(src)
    rt = Runtime(load_scene_dict(src, base_dir=Path(scene_path).parent))
    steps = max(1, spp // 4)
    for _ in range(steps):
        rt.step(spi=min(4, spp))
    return rt.currentFrame()


def _merge(update):
    data = {}
    if OUT.exists():
        data = json.loads(OUT.read_text())
    data.update(update)
    OUT.write_text(json.dumps(data, indent=1))
    print(json.dumps(update, indent=1))


def investigate_lights():
    """cycles-lights is color-separated: B=point(power 1000), G=spot
    (intensity 1000/4pi), R=area(power 1000, 0.1x0.1).  Per-channel mean
    ratios pinpoint which unit conversion diverges from Cycles."""
    ref = _load_ref("cycles-lights")
    img = _render(EVAL / "cycles-lights.json", spp=96)
    rm = ref.reshape(-1, 3).mean(axis=0)
    om = img.reshape(-1, 3).mean(axis=0)
    _merge({"cycles-lights": {
        "ours_mean_rgb": [float(v) for v in om],
        "ref_mean_rgb": [float(v) for v in rm],
        "ratio_rgb (ours/ref)": [float(o / r) for o, r in zip(om, rm)],
        "note": "R=area(power), G=spot(intensity), B=point(power)",
    }})


def investigate_sun():
    ref = _load_ref("cycles-sun")
    img = _render(EVAL / "cycles-sun.json", spp=96)
    rm = ref.reshape(-1, 3).mean(axis=0)
    om = img.reshape(-1, 3).mean(axis=0)
    _merge({"cycles-sun": {
        "ours_mean_rgb": [float(v) for v in om],
        "ref_mean_rgb": [float(v) for v in rm],
        "ratio_rgb (ours/ref)": [float(o / r) for o, r in zip(om, rm)],
    }})


def investigate_planes():
    """three-planes-* vs Radiance: Radiance runs -lr 0 (RR termination,
    NOT depth truncation — scripts/rtrace_default.txt), so the r3
    'Radiance truncates specular depth' hypothesis is moot.  Test the
    live hypotheses: (a) our extra energy comes from the light-sphere
    SOURCE pixels vs the diffuse field, (b) depth sensitivity, (c) the
    tessellated-sphere light with radiance 1e4 over-contributing."""
    out = {}
    for stem in ("three-planes-dielectric", "three-planes-interface",
                 "three-planes-glass"):
        ref = _load_ref(stem)
        img = _render(EVAL / f"{stem}.json", spp=64)
        h = min(ref.shape[0], img.shape[0])
        w = min(ref.shape[1], img.shape[1])
        ref_c = ref[:h, :w]
        img_c = img[:h, :w]
        # source blobs: pixels where EITHER image is > 50x its median
        lum_r = ref_c.mean(axis=-1)
        lum_o = img_c.mean(axis=-1)
        med = max(float(np.median(lum_r)), 1e-6)
        blob = (lum_r > 50 * med) | (lum_o > 50 * med)
        field_ratio = float(img_c[~blob].mean() /
                            max(ref_c[~blob].mean(), 1e-9))
        blob_ours = float(img_c[blob].sum())
        blob_ref = float(ref_c[blob].sum())
        depth2 = _render(EVAL / f"{stem}.json", spp=32, mutate=lambda s: (
            s.setdefault("technique", {}).__setitem__("max_depth", 2)))
        out[stem] = {
            "mean_ratio": float(img_c.mean() / ref_c.mean()),
            "field_ratio (non-source pixels)": field_ratio,
            "blob_pixel_count": int(blob.sum()),
            "blob_energy_ours": blob_ours,
            "blob_energy_ref": blob_ref,
            "mean_ratio_depth2": float(depth2[:h, :w].mean() / ref_c.mean()),
        }
    _merge({"three-planes": out})


def investigate_env():
    """env: our render matches the closed-form single-texel radiometry;
    the Mitsuba ref is claimed 'uniformly 2.17x dimmer'.  Verify the
    uniformity claim pixelwise (ratio histogram over lit pixels)."""
    ref = _load_ref("env")
    img = _render(EVAL / "env.json", spp=64)
    h = min(ref.shape[0], img.shape[0])
    w = min(ref.shape[1], img.shape[1])
    r = ref[:h, :w].mean(axis=-1)
    o = img[:h, :w].mean(axis=-1)
    lit = (r > 0.02 * max(float(r.max()), 1e-9)) & (o > 0)
    ratios = o[lit] / np.maximum(r[lit], 1e-9)
    _merge({"env": {
        "mean_ratio": float(o.mean() / r.mean()),
        "lit_ratio_median": float(np.median(ratios)),
        "lit_ratio_p10": float(np.percentile(ratios, 10)),
        "lit_ratio_p90": float(np.percentile(ratios, 90)),
        "lit_pixels": int(lit.sum()),
    }})


if __name__ == "__main__":
    {"lights": investigate_lights, "sun": investigate_sun,
     "planes": investigate_planes, "env": investigate_env}[sys.argv[1]]()
