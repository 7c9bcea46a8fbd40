"""PExpr builtin tail (Transpiler.cpp:419-546 parity additions)."""

import numpy as np
import jax.numpy as jnp
import pytest

from ignis_jax.texture.pexpr import eval_pexpr


class _Scene:
    textures = ()
    parameter_values = {}


def _ev(src, n=4):
    ctx = {"uv": jnp.zeros((n, 2), jnp.float32)}
    return eval_pexpr(_Scene(), {}, src, ctx)


def _rows(v):
    """(..., k) array as 2-D rows (constants fold to a single row)."""
    a = np.asarray(v)
    return a.reshape(-1, a.shape[-1]) if a.ndim else a.reshape(1, 1)


def test_blackbody_is_warm_at_low_temp_and_cool_at_high():
    k, v = _ev("blackbody(2000)")
    assert k == "vec4"
    v = _rows(v)
    assert v[..., 0].mean() > v[..., 2].mean()  # red-dominant
    k, v = _ev("blackbody(15000)")
    v = _rows(v)
    assert v[..., 2].mean() > v[..., 0].mean()  # blue-dominant


def test_hsv_roundtrip():
    k, v = _ev("hsvtorgb(rgbtohsv(color(0.2, 0.5, 0.8)))")
    np.testing.assert_allclose(_rows(v)[0, :3], [0.2, 0.5, 0.8],
                               atol=1e-5)


def test_hsl_roundtrip():
    k, v = _ev("hsltorgb(rgbtohsl(color(0.7, 0.3, 0.1)))")
    np.testing.assert_allclose(_rows(v)[0, :3], [0.7, 0.3, 0.1],
                               atol=1e-5)


def test_xyz_roundtrip():
    k, v = _ev("xyztorgb(rgbtoxyz(color(0.25, 0.5, 0.75)))")
    np.testing.assert_allclose(_rows(v)[0, :3], [0.25, 0.5, 0.75],
                               atol=1e-5)


def test_mix_modes_endpoints():
    # t=0 returns a for every blend mode
    for mode in ("mix_screen", "mix_overlay", "mix_dodge", "mix_burn",
                 "mix_soft", "mix_linear", "mix_hue", "mix_saturation",
                 "mix_value", "mix_color"):
        k, v = _ev(f"{mode}(color(0.3, 0.4, 0.5), color(0.9, 0.1, 0.7), 0)")
        np.testing.assert_allclose(_rows(v)[0, :3], [0.3, 0.4, 0.5],
                                   atol=1e-5, err_msg=mode)
    # screen at t=1: 1-(1-a)(1-b)
    k, v = _ev("mix_screen(color(0.5, 0.5, 0.5), color(0.5, 0.5, 0.5), 1)")
    np.testing.assert_allclose(_rows(v)[0, :3], [0.75] * 3, atol=1e-5)


def test_fresnel_conductor_range():
    k, v = _ev("fresnel_conductor(0.2, 3.9, 0.7)")  # gold-ish at ~45deg
    v = float(np.asarray(v)[()] if np.asarray(v).ndim == 0 else np.asarray(v).flat[0])
    assert 0.8 < v <= 1.0


def test_rotate_euler_inverse_roundtrip():
    k, v = _ev("rotate_euler_inverse(rotate_euler(vec3(1, 2, 3),"
               " vec3(0.3, -0.2, 0.9)), vec3(0.3, -0.2, 0.9))")
    np.testing.assert_allclose(_rows(v)[0], [1, 2, 3], atol=1e-5)


def test_rotate_axis_quarter_turn():
    k, v = _ev("rotate_axis(vec3(1, 0, 0), Pi/2, vec3(0, 0, 1))")
    np.testing.assert_allclose(_rows(v)[0], [0, 1, 0], atol=1e-6)


def test_angle_orthogonal():
    k, v = _ev("angle(vec3(1, 0, 0), vec3(0, 2, 0))")
    np.testing.assert_allclose(np.asarray(v), np.pi / 2, atol=1e-6)


def test_colored_noises_shape_and_range():
    for fn in ("cnoise", "cpnoise", "ccellnoise", "cperlin", "cvoronoi",
               "cfbm"):
        k, v = _ev(f"{fn}(vec2(0.37, 1.21))")
        assert k == "vec4", fn
        v = np.asarray(v)
        assert np.isfinite(v).all(), fn


def test_hash_deterministic_and_uniform():
    k, a = _ev("hash(1.5)")
    k, b = _ev("hash(1.5)")
    k, c = _ev("hash(2.5)")
    assert float(np.ravel(a)[0]) == float(np.ravel(b)[0])
    assert float(np.ravel(a)[0]) != float(np.ravel(c)[0])
    assert 0.0 <= float(np.ravel(a)[0]) < 1.0


def test_check_ray_flag_defaults_to_camera():
    k, v = _ev("check_ray_flag('camera')")
    assert k == "bool" and bool(np.asarray(v)[0])
    k, v = _ev("check_ray_flag('shadow')")
    assert not bool(np.asarray(v)[0])


def test_lookup_linear_and_constant():
    k, v = _ev("lookup('linear', false, 0.5,"
               " vec2(0, 0), vec2(1, 2))")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 1.0, atol=1e-6)
    k, v = _ev("lookup('constant', false, 0.6,"
               " vec2(0, 0), vec2(0.5, 3), vec2(1, 9))")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 3.0, atol=1e-6)
    # clamped outside [0,1] without extrapolation
    k, v = _ev("lookup('linear', false, 1.5, vec2(0, 0), vec2(1, 2))")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 2.0, atol=1e-6)


def test_misc_scalars():
    k, v = _ev("rad(180)")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], np.pi, atol=1e-6)
    k, v = _ev("deg(Pi)")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 180.0, atol=1e-4)
    k, v = _ev("wrap(7.5, 0, 2)")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 1.5, atol=1e-5)
    k, v = _ev("pingpong(1.5, 1)")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 0.5, atol=1e-5)
    k, v = _ev("signbit(-3)")
    assert bool(np.ravel(np.asarray(v))[0])
    k, v = _ev("smin(1, 2, 0)")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 1.0, atol=1e-5)
    k, v = _ev("lerp(1, 3, 0.25)")
    np.testing.assert_allclose(np.ravel(np.asarray(v))[0], 1.5, atol=1e-5)


def test_ensure_valid_reflection_passthrough():
    # A well-behaved normal is returned unchanged
    k, v = _ev("ensure_valid_reflection(vec3(0,0,1), vec3(0,0,1),"
               " vec3(0,0,1))")
    np.testing.assert_allclose(_rows(v)[0], [0, 0, 1], atol=1e-6)
