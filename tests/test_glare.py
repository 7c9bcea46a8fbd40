"""Glare/DGP pipeline tests (counterpart of src/artic/entrypoints/glare.art).

Oracles are analytic: pixel solid angles must sum to the exact frustum solid
angle; with no glare sources DGP collapses to c1*E_v + c3.
"""

import math

import numpy as np
import pytest

from ignis_jax.render.glare import (GlareSettings, WHITE_EFFICIENCY,
                                    evaluate_glare_host, pixel_solid_angles)
from ignis_jax.scene.compile import CameraConfig


def make_cam(fov=60.0, aspect=1.0):
    s = math.tan(math.radians(fov) / 2)
    return CameraConfig(
        type="perspective",
        eye=np.zeros(3, np.float32),
        dir=np.array([0, 0, 1], np.float32),
        up=np.array([0, 1, 0], np.float32),
        scale=np.array([s * aspect, s], np.float32),
        tmin=0.0, tmax=1e30)


def test_solid_angle_sums_to_frustum():
    # exact solid angle of a rectangle [-sw,sw]x[-sh,sh] at unit distance:
    # Omega = 4*atan(sw*sh / sqrt(1 + sw^2 + sh^2))
    cam = make_cam(fov=90.0)
    w = h = 64
    omega = np.asarray(pixel_solid_angles(cam, w, h))
    assert omega.shape == (h, w)
    assert (omega > 0).all()
    sw, sh = cam.scale
    exact = 4 * math.atan(sw * sh / math.sqrt(1 + sw * sw + sh * sh))
    # f32 spherical excess accumulates ~1e-3 relative arccos error
    assert np.sum(omega) == pytest.approx(exact, rel=2e-3)


def test_no_glare_dgp_is_ev_term_only():
    cam = make_cam()
    img = np.full((32, 32, 3), 0.25, np.float32)
    out, heat, mask = evaluate_glare_host(
        cam, img, GlareSettings(max=1.0, avg=0.25, mul=50.0, scale=1.0))
    assert out.num_pixels == 0
    assert not mask.any()
    assert out.dgp == pytest.approx(5.87e-5 * out.vertical_illuminance + 0.16,
                                    abs=1e-6)
    # E_v = lum * projected solid angle; bounded by lum * frustum omega
    sw, sh = cam.scale
    omega_tot = 4 * math.atan(sw * sh / math.sqrt(1 + sw * sw + sh * sh))
    lum = WHITE_EFFICIENCY * 0.25  # grey: Y == channel value
    assert 0 < out.vertical_illuminance < lum * omega_tot


def test_bright_source_raises_dgp():
    cam = make_cam()
    base = np.full((64, 64, 3), 0.05, np.float32)
    out0, _, _ = evaluate_glare_host(
        cam, base, GlareSettings(max=1.0, avg=0.05, mul=6.0))
    img = base.copy()
    img[28:36, 28:36] = 500.0  # small blazing patch at the view center
    out1, heat, mask = evaluate_glare_host(
        cam, img, GlareSettings(max=500.0, avg=0.05, mul=6.0))
    assert out1.num_pixels == 64
    assert mask.sum() == 64
    assert out1.dgp > out0.dgp
    assert 0.0 < out1.dgp <= 1.5
    assert out1.avg_lum > WHITE_EFFICIENCY * 0.05 * 6.0
    # heatmap marks the patch with the bright end of the ramp
    assert heat[32, 32].sum() > heat[0, 0].sum()


def test_fixed_vertical_illuminance_passthrough():
    cam = make_cam()
    img = np.full((16, 16, 3), 0.1, np.float32)
    out, _, _ = evaluate_glare_host(
        cam, img, GlareSettings(max=1.0, avg=0.1, mul=100.0,
                                vertical_illuminance=1234.5))
    assert out.vertical_illuminance == pytest.approx(1234.5)


def test_runtime_evaluate_glare_end_to_end():
    from ignis_jax.api import Runtime
    from ignis_jax.scene.generated import demo_scene
    rt = Runtime(demo_scene(), width=32, height=32)
    rt.step(spi=1)
    out, heat, mask = rt.evaluateGlare(mul=3.0)
    assert np.isfinite(out.dgp)
    assert heat.shape == (32, 32, 3)
    assert mask.shape == (32, 32)
