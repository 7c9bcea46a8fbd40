"""Camera ray generation (mirrors src/artic/camera/perspective.art and
driver/camera.art pixel-coordinate conventions)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ignis_jax.core.vec import matmul, normalize, vec3
from ignis_jax.scene.compile import CameraConfig


def pixel_coord_from_xy(x, y, w, h, sx, sy):
    """make_pixelcoord_from_xy (driver/camera.art:21-29): nx,ny in [-1,1],
    y flipped."""
    nx = 2.0 * (x.astype(jnp.float32) + sx) / w - 1.0
    ny = 1.0 - 2.0 * (y.astype(jnp.float32) + sy) / h
    return nx, ny


def camera_frame(cam: CameraConfig, dyn=None):
    """view matrix columns (right, up, dir) — perspective.art:30-32.

    dyn: optional traced (eye, dir, up) vectors from the parameter
    registry (__camera_* keys, Runtime.cpp:703-708) so camera pose can
    change between steps without recompiling."""
    if dyn is not None:
        _, d, up = dyn
        right = jnp.cross(d, up)
        right = right / jnp.maximum(
            jnp.sqrt(jnp.sum(right * right)), 1e-20)
        return right, up, d
    d = np.asarray(cam.dir, dtype=np.float64)
    up = np.asarray(cam.up, dtype=np.float64)
    right = np.cross(d, up)
    right = right / max(np.linalg.norm(right), 1e-20)
    return (jnp.asarray(right, jnp.float32), jnp.asarray(cam.up, jnp.float32),
            jnp.asarray(cam.dir, jnp.float32))


def generate_rays(cam: CameraConfig, nx, ny, dyn=None, lens_uv=None):
    """Camera ray generation: perspective (+DoF), orthogonal, fishlens.

    lens_uv: optional (u1, u2) uniform draws for the thin-lens aperture
    (make_perspective_dof_camera, perspective.art:69-83); required when
    cam.aperture_radius > 0."""
    right, up, d = camera_frame(cam, dyn)
    eye = (jnp.asarray(cam.eye, jnp.float32) if dyn is None
           else jnp.asarray(dyn[0], jnp.float32))
    tmin = jnp.full(nx.shape, cam.tmin, jnp.float32)
    tmax = jnp.full(nx.shape, cam.tmax, jnp.float32)

    if cam.type == "orthogonal":
        # orthogonal.art:14-23: pos = view @ (sx*nx, sy*ny, 0) + eye, dir fixed
        sw, sh = float(cam.scale[0]), float(cam.scale[1])
        org = (right[None, :] * (sw * nx)[..., None]
               + up[None, :] * (sh * ny)[..., None]
               + eye[None, :])
        dirs = jnp.broadcast_to(d, org.shape)
        return org, dirs, tmin, tmax

    if cam.type == "fishlens":
        # fishlens.art:8-52: equidistant fisheye with 3 aspect modes
        w, h = float(cam.scale[0]), float(cam.scale[1])  # film w, h stashed
        asp = w / h
        mode = cam.fishlens_mode
        if mode == "cropped":
            xasp = 1.0 / asp if asp < 1 else 1.0
            yasp = 1.0 / asp if asp > 1 else 1.0
        elif mode == "full":
            import math as _m
            diameter = _m.sqrt(asp * asp + 1.0) * h
            f = diameter / min(w, h)
            xasp = f if asp < 1 else f / asp
            yasp = f if asp > 1 else f * asp
        else:  # circular
            xasp = 1.0 if asp < 1 else asp
            yasp = 1.0 if asp > 1 else asp
        fnx = nx * xasp
        fny = ny * yasp
        r = jnp.sqrt(fnx * fnx + fny * fny)
        theta = r * jnp.float32(3.14159265) / 2.0
        st, ct = jnp.sin(theta), jnp.cos(theta)
        small = r < 1.1920929e-07
        sp = jnp.where(small, 0.0, fny / jnp.where(small, 1.0, r))
        cp = jnp.where(small, 0.0, fnx / jnp.where(small, 1.0, r))
        local = jnp.stack([st * cp, st * sp, ct], axis=-1)
        world = (right[None, :] * local[..., 0:1]
                 + up[None, :] * local[..., 1:2] + d[None, :] * local[..., 2:3])
        dirs = normalize(world)
        org = jnp.broadcast_to(eye, dirs.shape)
        return org, dirs, tmin, tmax

    # perspective (perspective.art:29-41)
    sw, sh = float(cam.scale[0]), float(cam.scale[1])
    world = (right[None, :] * (sw * nx)[..., None]
             + up[None, :] * (sh * ny)[..., None]
             + d[None, :])
    dirs = normalize(world)
    if cam.aperture_radius > 0.0 and lens_uv is not None:
        # thin-lens DoF (perspective.art:74-82): focus point along the pinhole
        # dir at focal_length; origin jittered on the concentric-disk aperture
        from ignis_jax.core.warp import square_to_concentric_disk
        ax, ay = square_to_concentric_disk(lens_uv[0], lens_uv[1])
        ar = jnp.float32(cam.aperture_radius)
        ap = (right[None, :] * (ax * ar)[..., None]
              + up[None, :] * (ay * ar)[..., None])
        focus = dirs * jnp.float32(cam.focal_length)
        dirs = normalize(focus - ap)
        org = eye[None, :] + ap
        return org, dirs, tmin, tmax
    org = jnp.broadcast_to(eye, dirs.shape)
    return org, dirs, tmin, tmax


def sample_pixel(cam: CameraConfig, pos):
    """Connect world points to the camera (light-tracer splats).

    Counterpart of Camera.sample_pixel / perspective_pos_to_pixel
    (camera/perspective.art:16-26,43-57): returns dict(valid, nx, ny,
    dir (UNNORMALIZED point→eye vector), weight).  Perspective and
    orthogonal cameras; fishlens connections are not supported (matching
    the reference, whose fishlens camera has no inverse map either).

    Unlike the reference (which sets image_area=1 with a TODO,
    perspective.art:36,47, making its light tracer dimmer than its path
    tracer), `weight` here is the true pinhole importance so that
    splat * weight * cos_i/(cos_o*d2) * bsdf_eval(out,in) integrates to
    the same pixel value the path tracer computes:
      perspective: W = 1 / (4*sw*sh*cos^3 theta)   (film at unit dist)
      orthogonal:  W = depth^2 / (4*sw*sh)         (cancels the 1/d2)
    """
    right, up, d = camera_frame(cam)
    eye = jnp.asarray(cam.eye, jnp.float32)
    n = pos.shape[0]
    if cam.type == "orthogonal":
        sw, sh = float(cam.scale[0]), float(cam.scale[1])
        rel = pos - eye
        nx = matmul(rel, right) / sw
        ny = matmul(rel, up) / sh
        depth = matmul(rel, d)
        valid = ((nx >= -1) & (nx <= 1) & (ny >= -1) & (ny <= 1)
                 & (depth > 0))
        sdir = -d * depth[..., None]
        weight = depth * depth / jnp.float32(4.0 * sw * sh)
        return dict(valid=valid, nx=nx, ny=ny, dir=sdir, weight=weight)
    if cam.type == "fishlens":
        z = jnp.zeros((n,), jnp.float32)
        return dict(valid=jnp.zeros((n,), bool), nx=z, ny=z,
                    dir=jnp.zeros((n, 3), jnp.float32), weight=z)
    sw, sh = float(cam.scale[0]), float(cam.scale[1])
    rel = pos - eye
    un_x = matmul(rel, right)
    un_y = matmul(rel, up)
    un_z = matmul(rel, d)
    safe_z = jnp.where(jnp.abs(un_z) < 1e-12, 1e-12, un_z)
    nx = un_x / (safe_z * sw)
    ny = un_y / (safe_z * sh)
    valid = (nx >= -1) & (nx <= 1) & (ny >= -1) & (ny <= 1) & (un_z > 0)
    sdir = eye - pos
    dist = jnp.sqrt(jnp.maximum(jnp.sum(rel * rel, axis=-1), 1e-20))
    cos_t = jnp.clip(un_z / dist, 1e-6, 1.0)
    weight = 1.0 / (jnp.float32(4.0 * sw * sh) * cos_t * cos_t * cos_t)
    return dict(valid=valid, nx=nx, ny=ny, dir=sdir, weight=weight)
