#!/usr/bin/env python3
"""BASELINE gate 5: glTF inverse rendering — recover base color and volume
attenuation (sigma_a) by gradient descent.

The gate names the Khronos DragonAttenuation sample (a transmissive dragon
with KHR_materials_volume attenuation); that asset is not bundled with the
reference, so this demo builds the equivalent configuration as an embedded
glTF — a transmissive cube with KHR_materials_transmission +
KHR_materials_volume over a diffuse floor — renders a target with the true
parameters, perturbs (base color, attenuation sigma_a), and recovers both by
Adam on the differentiable render (path-replay scan, trace_wave).  Pass
--gltf <path> to run on the real DragonAttenuation.glb when available.

Outputs: INVERSE.json (param errors per iteration) + target/initial/
recovered EXRs under out/.
"""

import sys
from pathlib import Path as _P

sys.path.insert(0, str(_P(__file__).resolve().parent.parent))

import argparse
import base64
import json
import time
from pathlib import Path

import numpy as np


def _lookat_matrix(eye, target, up):
    """glTF node matrix (column-major) for a camera at eye looking at
    target (camera looks down its local -Z)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.eye(4)
    m[:3, 0] = r
    m[:3, 1] = u
    m[:3, 2] = -f
    m[:3, 3] = eye
    return [float(v) for v in m.T.reshape(-1)]


def make_volume_gltf(path, base_color=(0.9, 0.2, 0.15),
                     attenuation_color=(0.3, 0.6, 0.9), atten_dist=0.5):
    """Embedded-buffer glTF: transmissive cube + diffuse floor + point light
    (the DragonAttenuation material configuration on simple geometry)."""
    cube_pos = np.float32([
        [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]]) * 0.6
    cube_idx = np.uint16([
        0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7,
        0, 1, 5, 0, 5, 4, 2, 3, 7, 2, 7, 6,
        1, 2, 6, 1, 6, 5, 0, 4, 7, 0, 7, 3])
    floor_pos = np.float32([[-4, -0.6, -4], [4, -0.6, -4],
                            [4, -0.6, 4], [-4, -0.6, 4]])
    floor_idx = np.uint16([0, 2, 1, 0, 3, 2])
    buf = (cube_pos.tobytes() + cube_idx.tobytes()
           + floor_pos.tobytes() + floor_idx.tobytes())
    o_ci = len(cube_pos.tobytes())
    o_fp = o_ci + len(cube_idx.tobytes())
    o_fi = o_fp + len(floor_pos.tobytes())
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2, 3]}],
        "nodes": [
            {"mesh": 0, "name": "dragon"},
            {"mesh": 1, "name": "floor"},
            {"name": "light",
             "translation": [1.5, 2.5, 1.5],
             "extensions": {"KHR_lights_punctual": {"light": 0}}},
            {"name": "cam", "camera": 0,
             "matrix": _lookat_matrix([1.6, 1.1, 1.9], [0, -0.1, 0],
                                      [0, 1, 0])},
        ],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "point", "intensity": 120.0, "color": [1, 1, 1]}]}},
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                             "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 2}, "indices": 3,
                             "material": 1}]},
        ],
        "materials": [
            {"name": "glassy",
             "pbrMetallicRoughness": {
                 "baseColorFactor": list(base_color) + [1.0],
                 "metallicFactor": 0.0, "roughnessFactor": 0.15},
             "extensions": {
                 "KHR_materials_transmission": {"transmissionFactor": 0.9},
                 "KHR_materials_ior": {"ior": 1.45},
                 "KHR_materials_volume": {
                     "thicknessFactor": 1.0,
                     "attenuationDistance": atten_dist,
                     "attenuationColor": list(attenuation_color)}}},
            {"name": "floor",
             "pbrMetallicRoughness": {
                 "baseColorFactor": [0.65, 0.65, 0.65, 1.0],
                 "metallicFactor": 0.0, "roughnessFactor": 0.9}},
        ],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": o_ci},
            {"buffer": 0, "byteOffset": o_ci, "byteLength": o_fp - o_ci},
            {"buffer": 0, "byteOffset": o_fp, "byteLength": o_fi - o_fp},
            {"buffer": 0, "byteOffset": o_fi,
             "byteLength": len(buf) - o_fi},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 8,
             "type": "VEC3", "min": (cube_pos.min(0)).tolist(),
             "max": (cube_pos.max(0)).tolist()},
            {"bufferView": 1, "componentType": 5123, "count": 36,
             "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC3", "min": floor_pos.min(0).tolist(),
             "max": floor_pos.max(0).tolist()},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.7, "znear": 0.01}}],
    }
    Path(path).write_text(json.dumps(doc))
    return path


def run(gltf_path, size=48, spp=8, iters=120, lr=0.05, seed=0,
        out_dir="out", quiet=False):
    import jax
    import jax.numpy as jnp

    from ignis_jax.api import load_scene
    from ignis_jax.render.integrator import trace_wave
    from ignis_jax.utils.exr import write_exr

    rt = load_scene(str(gltf_path), width=size, height=size)
    scene = rt.scene
    tables = {k: jnp.asarray(v) for k, v in rt.tables.items()}
    npix = size * size
    idx = np.arange(npix, dtype=np.int32)
    x = jnp.asarray(idx % size)
    y = jnp.asarray(idx // size)

    def render(tabs, spp_, base_seed):
        def body(acc, s):
            c = trace_wave(scene, tabs, x, y, s, jnp.uint32(0),
                           jnp.uint32(0), base_seed, differentiable=True)
            return acc + c, None
        acc, _ = jax.lax.scan(body, jnp.zeros((npix, 3), jnp.float32),
                              jnp.arange(spp_, dtype=jnp.uint32))
        return acc / spp_

    render_j = jax.jit(render, static_argnums=(1,))
    target = render_j(tables, spp, seed)
    # per-sample targets for matched-seed (path-replay) residuals: fresh
    # random seeds per step make E[noisy MSE] = MSE + Var(estimator) and
    # gradient descent then minimizes the VARIANCE too (driving albedos
    # dark); replaying the target's own sample stream cancels that bias
    # and gives zero loss exactly at the true parameters.
    import jax.numpy as _jnp

    def render_sample(tabs, smp):
        return trace_wave(scene, tabs, x, y, smp, _jnp.uint32(0),
                          _jnp.uint32(0), seed, differentiable=True)

    render_sample_j = jax.jit(render_sample)
    target_s = jnp.stack([render_sample_j(tables, jnp.uint32(s))
                          for s in range(spp)])
    true_mc = np.asarray(tables["mat_colors"]).copy()
    true_md = np.asarray(tables["medium_data"]).copy()

    # perturb: gray base color, flat attenuation.  sigma_a optimizes in
    # LOG space (scale-free conditioning: the true channels span 2.4 ..
    # 0.21, a 12x range, and linear Adam with one lr either crawls on the
    # small channel or overshoots the large one).
    mc0 = true_mc.copy()
    mc0[0, 0] = [0.5, 0.5, 0.5]
    md0 = true_md.copy()
    md0[:, 0:3] = 1.0
    params = {"mat_colors": jnp.asarray(mc0),
              "log_sigma": jnp.log(jnp.asarray(md0[:, 0:3]) + 1e-4)}

    base_md = jnp.asarray(md0)

    def _tables_from(params):
        md = base_md.at[:, 0:3].set(jnp.exp(params["log_sigma"]) - 1e-4)
        return {"mat_colors": params["mat_colors"], "medium_data": md}

    init_tabs = dict(tables)
    init_tabs.update(_tables_from(params))
    out = Path(out_dir)
    out.mkdir(exist_ok=True)
    write_exr(out / "inverse_target.exr",
              np.asarray(target).reshape(size, size, 3))
    write_exr(out / "inverse_initial.exr",
              np.asarray(render_j(init_tabs, spp, seed)).reshape(
                  size, size, 3))

    def loss_fn(params, smp):
        # matched-seed residual over ALL target sample streams at once:
        # cycling a single sample per Adam step (the r3 scheme) made the
        # objective itself rotate and reproducibly diverged the large
        # sigma_a channels; the averaged fixed objective converges to
        # <0.2% per channel (r4)
        del smp
        t = dict(tables)
        t.update(_tables_from(params))
        imgs = jnp.stack([render_sample(t, jnp.uint32(s))
                          for s in range(spp)])
        return jnp.mean((imgs - target_s) ** 2)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    # Adam
    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    hist = []
    t0 = time.time()
    for it in range(iters):
        loss, g = vg(params, jnp.uint32(it % spp))
        # grazing/specular lanes can produce isolated non-finite adjoints
        # (GGX denominators); standard differentiable-rendering practice is
        # to zero them rather than poison the whole step
        g = jax.tree.map(lambda a: jnp.nan_to_num(a, nan=0.0, posinf=0.0,
                                                  neginf=0.0), g)
        m = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = jax.tree.map(lambda a, b: 0.999 * a + 0.001 * b * b, v, g)
        mh = jax.tree.map(lambda a: a / (1 - 0.9 ** (it + 1)), m)
        vh = jax.tree.map(lambda a: a / (1 - 0.999 ** (it + 1)), v)
        params = jax.tree.map(
            lambda p, a, b: p - lr * a / (jnp.sqrt(b) + 1e-8),
            params, mh, vh)
        params["mat_colors"] = jnp.clip(params["mat_colors"], 0.0, 1.0)
        params["log_sigma"] = jnp.clip(params["log_sigma"],
                                       jnp.log(1e-3), jnp.log(20.0))
        if it % 10 == 0 or it == iters - 1:
            cur_md = np.asarray(_tables_from(params)["medium_data"])
            mc_err = float(np.abs(
                np.asarray(params["mat_colors"])[0, 0] - true_mc[0, 0]).max())
            md_err = float(np.abs(cur_md[:, 0:3] - true_md[:, 0:3]).max())
            hist.append(dict(iter=it, loss=float(loss),
                             base_color_err=round(mc_err, 4),
                             sigma_a_err=round(md_err, 4)))
            if not quiet:
                print(hist[-1], flush=True)

    final_tabs = dict(tables)
    final_tabs.update(_tables_from(params))
    write_exr(out / "inverse_recovered.exr",
              np.asarray(render_j(final_tabs, spp, seed)).reshape(
                  size, size, 3))
    result = dict(
        gltf=str(gltf_path), size=size, spp=spp, iters=iters,
        secs=round(time.time() - t0, 1),
        true_base_color=true_mc[0, 0].tolist(),
        recovered_base_color=np.asarray(
            params["mat_colors"])[0, 0].round(4).tolist(),
        true_sigma_a=true_md[0, 0:3].round(4).tolist(),
        recovered_sigma_a=np.asarray(
            _tables_from(params)["medium_data"])[0, 0:3].round(4).tolist(),
        history=hist,
    )
    return result, params, (true_mc, true_md)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gltf", default=None,
                    help="path to DragonAttenuation.glb (or any volume glTF)")
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--out", default="INVERSE.json")
    args = ap.parse_args(argv)
    gltf = args.gltf
    if gltf is None:
        gltf = make_volume_gltf("/tmp/dragon_attenuation_standin.gltf")
    result, _, _ = run(gltf, size=args.size, spp=args.spp, iters=args.iters)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in
                      ("true_base_color", "recovered_base_color",
                       "true_sigma_a", "recovered_sigma_a", "secs")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
