"""igview inspector helpers (VERDICT r4 #10): AOV display frames and the
luminance histogram pane (view/Inspector.cpp analogs)."""

import numpy as np


def _rt():
    from ignis_jax.api import Runtime
    rt = Runtime("/root/reference/scenes/plane-plane.json",
                 width=32, height=32)
    rt.step(spi=2)
    return rt


def test_aov_frames_finite_and_shaped():
    from ignis_jax.cli.igview import _VIEWS, _aov_frame
    rt = _rt()
    for mode in _VIEWS[1:]:
        f = _aov_frame(rt, mode)
        assert f.shape == (32, 32, 3), mode
        assert np.isfinite(f).all(), mode
        assert 0.0 <= f.min() and f.max() <= 1.0, mode
    # normals of the facing plane point at the camera -> blue-ish encode
    n = _aov_frame(rt, "Normals")
    assert n.mean() > 0.1


def test_histogram_pane_renders():
    from ignis_jax.cli.igview import _histogram_pane
    rt = _rt()
    pane = _histogram_pane(rt, cols=48)
    lines = pane.splitlines()
    assert len(lines) == 7
    assert "lum min=" in lines[-1]
