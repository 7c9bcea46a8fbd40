"""mts2ig converter (VERDICT r4 #9): Mitsuba XML scenes round-trip into
renderable ignis JSON; the sphere-light evaluation scene must match the
shipped reference EXR after conversion."""

from pathlib import Path

import numpy as np
import pytest

MTS = Path("/root/reference/scenes/evaluation/mitsuba")


def test_convert_all_evaluation_scenes():
    from ignis_jax.cli.mts2ig import convert
    for xml in sorted(MTS.glob("*.xml")):
        sc = convert(xml)
        assert sc["shapes"] or sc["lights"], xml.name
        assert sc["camera"]["type"] == "perspective"


def _fix_meshes(sc):
    # these XMLs' relative paths predate the evaluation/ relocation
    # (evaluation/meshes/Bottom.ply is a DIFFERENT mesh than the
    # scenes/meshes one the XMLs were authored against)
    for sh in sc["shapes"]:
        fn = sh.get("filename", "")
        if fn:
            alt = Path("/root/reference/scenes/meshes") / Path(fn).name
            if alt.exists():
                sh["filename"] = str(alt)


def test_converted_point_scene_renders():
    from ignis_jax.cli.mts2ig import convert
    from ignis_jax.scene.parser import load_scene_dict
    from ignis_jax.api import Runtime
    sc = convert(MTS / "point.xml")
    _fix_meshes(sc)
    rt = Runtime(load_scene_dict(sc, base_dir=MTS), width=48, height=48)
    rt.step(spi=2)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    assert img.mean() > 1e-3


def test_converted_sphere_light_matches_reference():
    """Convert mitsuba/sphere-light.xml and compare against the SAME
    reference EXR the native-JSON golden uses."""
    from ignis_jax.cli.mts2ig import convert
    from ignis_jax.scene.parser import load_scene_dict
    from ignis_jax.api import Runtime
    from ignis_jax.utils.exr import read_exr
    ref = read_exr("/root/reference/scenes/evaluation/references/"
                   "ref-sphere-light-4096.exr")
    sc = convert(MTS / "sphere-light.xml")
    _fix_meshes(sc)
    rt = Runtime(load_scene_dict(sc, base_dir=MTS), width=128, height=128)
    for _ in range(4):
        rt.step(spi=4)
    ours = np.asarray(rt.currentFrame())
    # box-downsample ref to ours
    h, w = ours.shape[:2]
    H, W = ref.shape[:2]
    fy, fx = H // h, W // w
    ref_d = ref[:h * fy, :w * fx].reshape(h, fy, w, fx, 3).mean(axis=(1, 3))
    assert np.isfinite(ours).all()
    rel_mean = abs(ours.mean() - ref_d.mean()) / ref_d.mean()
    assert rel_mean < 0.1, rel_mean
