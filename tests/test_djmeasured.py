"""Dupuy-Jakob measured BRDF tests (powitacq_rgb semantics).

No .bsdf data ships with the reference repo, so these tests build a
synthetic-but-valid tensor_file and check the internal consistency the
Marginal2D warps must satisfy: CDF sample/invert roundtrip, sample-vs-pdf
agreement, eval-vs-sample agreement, and an end-to-end render.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ignis_jax.measured import djmeasured as dj


def _smooth(rng, shape):
    a = rng.random(shape).astype(np.float32) + 0.2
    # box blur to keep bilinear patches well behaved
    for ax in (-1, -2):
        a = (a + np.roll(a, 1, ax) + np.roll(a, -1, ax)) / 3.0
    return a.astype(np.float32)


def make_bsdf_file(path, nphi=1, ntheta=5, res=16, lres=8, seed=7):
    rng = np.random.default_rng(seed)
    theta_i = np.linspace(0.0, 1.5, ntheta).astype(np.float32)
    phi_i = np.zeros(nphi, np.float32)
    fields = {
        "theta_i": theta_i,
        "phi_i": phi_i,
        "ndf": _smooth(rng, (res, res)),
        "sigma": _smooth(rng, (res, res)),
        "vndf": _smooth(rng, (nphi, ntheta, res, res)),
        "luminance": _smooth(rng, (nphi, ntheta, lres, lres)),
        "rgb": _smooth(rng, (nphi, ntheta, 3, lres, lres)),
        "description": np.frombuffer(b"synthetic", np.uint8),
        "jacobian": np.zeros(1, np.uint8),
    }
    dj.write_tensor_file(path, fields)
    return fields


def test_tensor_file_roundtrip(tmp_path):
    p = tmp_path / "synth.bsdf"
    fields = make_bsdf_file(p)
    back = dj.load_tensor_file(p)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.fixture
def brdf(tmp_path):
    p = tmp_path / "synth.bsdf"
    make_bsdf_file(p)
    tables, info = dj.load_brdf(p, "dj0")
    return {k: jnp.asarray(v) for k, v in tables.items()}, info


def test_warp_sample_invert_roundtrip(brdf):
    tables, info = brdf
    n = 512
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.random((n, 2), np.float32) * 0.96 + 0.02)
    phi = jnp.zeros(n, jnp.float32)
    theta = jnp.asarray(rng.random(n, np.float32) * 1.4)
    sl = dj._make_slice(tables, "dj0", info, phi, theta)
    args = (tables["dj0_vndf_data"], tables["dj0_vndf_cond"],
            tables["dj0_vndf_marg"])
    uv, pdf_s = dj._sample_warp2(sl, *args, u)
    back, pdf_i = dj._invert_warp2(sl, *args, uv)
    err = np.abs(np.asarray(back) - np.asarray(u)).max(axis=-1)
    # f32 + is_const branch: the bulk must roundtrip tightly
    assert np.quantile(err, 0.9) < 2e-3
    perr = np.abs(np.asarray(pdf_s) - np.asarray(pdf_i)) / np.asarray(pdf_s)
    assert np.quantile(perr, 0.9) < 2e-3


def test_warp_pdf_integrates_to_one(brdf):
    # the vndf warp's density over the unit square must integrate to 1
    tables, info = brdf
    k = 64
    xs = (np.arange(k) + 0.5) / k
    gx, gy = np.meshgrid(xs, xs)
    pos = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], -1), jnp.float32)
    phi = jnp.zeros(k * k, jnp.float32)
    theta = jnp.full(k * k, 0.7, jnp.float32)
    sl = dj._make_slice(tables, "dj0", info, phi, theta)
    d = dj._eval_warp2(sl, tables["dj0_vndf_data"], pos)
    assert float(jnp.mean(d)) == pytest.approx(1.0, rel=2e-2)


def test_sample_pdf_eval_agree(brdf):
    tables, info = brdf
    n = 512
    rng = np.random.default_rng(11)
    # view directions well inside the upper hemisphere
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2]) + 0.3
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.asarray(v)
    u1 = jnp.asarray(rng.random(n, np.float32) * 0.96 + 0.02)
    u2 = jnp.asarray(rng.random(n, np.float32) * 0.96 + 0.02)

    wo, fr, pdf, valid = dj.brdf_sample_local(tables, "dj0", info, u1, u2, v)
    valid = np.asarray(valid)
    assert valid.mean() > 0.5

    pdf2 = np.asarray(dj.brdf_pdf_local(tables, "dj0", info, v, wo))
    fr2 = np.asarray(dj.brdf_eval_local(tables, "dj0", info, v, wo))
    pdf = np.asarray(pdf)
    fr = np.asarray(fr)
    rel = np.abs(pdf2[valid] - pdf[valid]) / np.maximum(pdf[valid], 1e-6)
    assert np.quantile(rel, 0.85) < 5e-2
    relf = (np.abs(fr2[valid] - fr[valid])
            / np.maximum(np.abs(fr[valid]), 1e-6)).max(axis=-1)
    assert np.quantile(relf, 0.85) < 5e-2


def test_eval_zero_below_horizon(brdf):
    tables, info = brdf
    wi = jnp.asarray([[0.0, 0.0, -1.0], [0.3, 0.0, 0.954]], jnp.float32)
    wo = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], jnp.float32)
    fr = np.asarray(dj.brdf_eval_local(tables, "dj0", info, wi, wo))
    assert (fr[0] == 0).all()
    assert (fr[1] >= 0).all()


def test_render_djmeasured_scene(tmp_path):
    make_bsdf_file(tmp_path / "synth.bsdf")
    scene = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2,
                                 0, 0, 0, 1]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "djmeasured", "name": "mat",
                   "filename": str(tmp_path / "synth.bsdf"),
                   "tint": [1.0, 0.8, 0.6]}],
        "shapes": [{"type": "rectangle", "name": "quad", "width": 2,
                    "height": 2}],
        "entities": [{"name": "quad", "shape": "quad", "bsdf": "mat"}],
        "lights": [{"type": "point", "name": "pl",
                    "position": [0, 0.5, -1], "intensity": [3, 3, 3]}],
    }
    from ignis_jax.api import Runtime
    rt = Runtime(scene)
    rt.step(spi=2)
    img = rt.currentFrame()
    assert np.isfinite(img).all()
    assert img.max() > 0
