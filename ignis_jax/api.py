"""Runtime API — the counterpart of IG::Runtime (src/runtime/Runtime.h:19-198).

`Runtime` owns the compiled scene, drives progressive accumulation
(`step()`), and exposes ray-list tracing (`trace()`, the igtrace oracle,
src/frontend/trace/main.cpp semantics).  The framebuffer is an unnormalized
running sum with an iteration count, exactly like the reference
(Device.cpp:94-100): consumers divide by `currentSampleCount()`.
"""

from __future__ import annotations

import os
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from ignis_jax.render.integrator import render_wavefront, trace_wave
from ignis_jax.scene.compile import CompiledScene, load_and_compile

_DEFAULT_TILE = 1 << 16

_CHECKOUT = Path(__file__).resolve().parents[1]


def compile_cache_config(platform, environ=os.environ, checkout=_CHECKOUT):
    """JAX config updates for the persistent compilation cache.

    * JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; set nothing.
    * GPU: a fixed directory in the checkout (build/ is in .gitignore);
      the path is part of the cache key, so it never moves.
    * CPU: disabled.  The CPU backend was seen loading cached executables
      compiled for other machine features and rendering wrong images, and
      CPU compiles are cheap.
    """
    if platform == "cpu":
        return {"jax_enable_compilation_cache": False}
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return {}
    return {"jax_compilation_cache_dir": str(checkout / "build" / "jax_cache")}


def enable_compile_cache():
    """Apply `compile_cache_config` for the default backend (idempotent;
    call before the first compile so the cache sees every program)."""
    for k, v in compile_cache_config(jax.default_backend()).items():
        jax.config.update(k, v)


class Runtime:
    def __init__(self, source, width=None, height=None, seed=0,
                 tile_size=_DEFAULT_TILE, use_bvh=True):
        enable_compile_cache()
        import time as _time
        _t_load = _time.perf_counter()
        self.scene: CompiledScene = load_and_compile(source, width, height)
        _t_load = _time.perf_counter() - _t_load
        from ignis_jax.utils.log import logger
        logger.info("Loaded scene: %dx%d, %d tris, %d materials, %d lights "
                    "(%.2fs)", self.scene.width, self.scene.height,
                    self.scene.tables["tri_v0"].shape[0],
                    len(self.scene.material_names),
                    self.scene.num_lights, _t_load)
        tables = self.scene.tables
        ntris = tables["tri_v0"].shape[0]
        if ntris > 0 and use_bvh:
            # Every soup gets a BVH (use_bvh=False forces the brute-force
            # sweep); ops/traverse.py picks per platform between the two.
            # The build routes through the asset cache keyed on geometry
            # content (CacheManager.h:7-33 caches per-shape BVHs the same
            # way): a second process loading the same scene skips the SAH
            # build + table layout entirely.
            from ignis_jax.ops.bvh import BVH, build_bvh, bvh_tables
            from ignis_jax.utils.cache import cached_arrays_data
            geo = (np.asarray(tables["tri_v0"]),
                   np.asarray(tables["tri_e1"]),
                   np.asarray(tables["tri_e2"]))

            def _build_bvh_arrays():
                b = build_bvh(*geo)
                return dict(node_min=b.node_min, node_max=b.node_max,
                            node_left=b.node_left, node_right=b.node_right,
                            node_count=b.node_count, tri_order=b.tri_order,
                            depth=np.int32(b.depth))

            bvh = cached_arrays_data(geo, "bvh", _build_bvh_arrays,
                                     extra="depth")
            bvh["depth"] = int(bvh["depth"])
            tables = bvh_tables(BVH(**bvh), tables)
        # Instanced-pool tables (ops/bw_tlas.py): unique shapes keep ONE
        # local copy; instances are transform records.
        if getattr(self.scene, "instanced", None):
            from ignis_jax.ops.bw_tlas import build_tlas
            tables = dict(tables)
            tl = build_tlas(self.scene.instanced["shapes"],
                            self.scene.instanced["records"])
            tables.update(tl)
            ia = tl["tl_inst"]
            # static per-instance structure for tlas_traverse_xla
            self.scene.tlas_meta = dict(
                valid=[bool(v > 0) for v in ia[:, 6]],
                mask=[int(v) for v in ia[:, 23]],
                toff=[int(v) for v in ia[:, 9]],
                ccnt=[int(v) for v in ia[:, 8]])
        # Consolidated per-triangle shading table: _surface_at needs 12
        # row gathers per bounce; packing them into ONE (T, 28) row makes
        # it a single gather.
        if tables["tri_v0"].shape[0] > 0:
            tables = dict(tables)
            tables["tri_shade"] = self._pack_tri_shade(tables)
        self.tables = {k: jnp.asarray(v) for k, v in tables.items()}
        self.seed = int(seed)
        self.iteration = 0
        self.frame = 0
        self.tile_size = int(tile_size)
        w, h = self.scene.width, self.scene.height
        # Device-resident accumulation (the reference keeps the framebuffer
        # sum on-device too, Device.cpp:94-100); host only sees it at
        # currentFrame()/save time.
        self._accum = jnp.zeros((h * w, 3), dtype=jnp.float32)
        self._samples = 0
        self._work_cache = {}
        from ignis_jax.utils.stats import Statistics
        self.stats = Statistics()
        self.stats.record("loading", _t_load)
        self._dev_stats = jnp.zeros((9,), jnp.float32)
        self._dev_stats_capacity = 0
        self._first_step_done = False
        self._render_tile = jax.jit(
            partial(trace_wave, self.scene),
            static_argnames=())
        # The regenerating wavefront needs camera and bounce visibility to
        # agree per entity (mixed ray types share one wave); else fall back
        # to the per-sample wave driver.
        ent_flags = np.asarray(self.scene.tables["ent_flags"])
        self._wavefront_ok = bool(
            (((ent_flags & 0x1) != 0) == ((ent_flags & 0x4) != 0)).all())
        if self.scene.technique.type in ("debug", "ao", "wireframe",
                                         "lightvisibility", "camera_check",
                                         "infobuffer"):
            self._wavefront_ok = False
        if self.scene.technique.type in ("lighttracer", "lt"):
            from ignis_jax.render.lighttracer import render_lighttracer
            self._render_lt = jax.jit(
                partial(render_lighttracer, self.scene),
                static_argnames=("n_paths",))
        if self.scene.technique.type in ("photonmapper", "ppm", "sppm"):
            from ignis_jax.render.photonmapper import (
                render_ppm, trace_photons)
            self._trace_photons = jax.jit(
                partial(trace_photons, self.scene),
                static_argnames=("n_photons",))
            self._render_ppm = jax.jit(
                partial(render_ppm, self.scene),
                static_argnames=("max_count",))
        self._render_wavefront = jax.jit(
            partial(render_wavefront, self.scene),
            static_argnames=("capacity", "spi", "work_mode", "work_total"))

    @staticmethod
    def _pack_tri_shade(tables):
        """(T, 28) f32: v0|e1|e2|n0|n1|n2|uv0|uv1|uv2|ent|mat|light|pad."""
        t = np.asarray(tables["tri_v0"]).shape[0]
        out = np.zeros((t, 28), np.float32)
        out[:, 0:3] = np.asarray(tables["tri_v0"], np.float32)
        out[:, 3:6] = np.asarray(tables["tri_e1"], np.float32)
        out[:, 6:9] = np.asarray(tables["tri_e2"], np.float32)
        out[:, 9:12] = np.asarray(tables["tri_n0"], np.float32)
        out[:, 12:15] = np.asarray(tables["tri_n1"], np.float32)
        out[:, 15:18] = np.asarray(tables["tri_n2"], np.float32)
        out[:, 18:20] = np.asarray(tables["tri_uv0"], np.float32)
        out[:, 20:22] = np.asarray(tables["tri_uv1"], np.float32)
        out[:, 22:24] = np.asarray(tables["tri_uv2"], np.float32)
        ent = np.asarray(tables["tri_ent"])
        out[:, 24] = ent.astype(np.float32)
        out[:, 25] = np.asarray(tables["ent_mat"])[ent].astype(np.float32)
        out[:, 26] = np.asarray(tables["ent_light"])[ent].astype(np.float32)
        return out

    # ------------------------------------------------------------------ info
    @property
    def width(self):
        return self.scene.width

    @property
    def height(self):
        return self.scene.height

    def currentSampleCount(self):
        return self._samples

    # ------------------------------------------------------------------ render
    # --------------------------------------------------------- parameters
    def setParameter(self, name, value):
        """Set a registry parameter (Runtime::setParameter,
        Runtime.cpp:668-686).  Values live in the traced `params` table so
        changing them never recompiles; unknown names raise KeyError (scene
        must declare them in its `parameters` section, or use the built-in
        __camera_*/__time keys)."""
        reg = self.scene.param_registry
        if name not in reg:
            raise KeyError(
                f"unknown registry parameter '{name}' (declared: "
                f"{sorted(reg)})")
        _, off, size = reg[name]
        v = np.asarray(value, np.float32).reshape(-1)
        if v.size == 1 and size > 1:
            v = np.full(size, v[0], np.float32)
        if v.size < size:
            v = np.concatenate([v, np.ones(size - v.size, np.float32)])
        self.tables["params"] = self.tables["params"].at[
            off:off + size].set(jnp.asarray(v[:size]))

    def getParameter(self, name):
        reg = self.scene.param_registry
        kind, off, size = reg[name]
        v = np.asarray(self.tables["params"][off:off + size])
        return float(v[0]) if kind in ("num", "int") else v

    def setCameraOrientationParameter(self, eye, dir, up):
        """Runtime::setCameraOrientationParameter (Runtime.cpp:703-708)."""
        self.setParameter("__camera_eye", eye)
        self.setParameter("__camera_dir", dir)
        self.setParameter("__camera_up", up)

    def reset(self):
        self._accum = jnp.zeros_like(self._accum)
        self._samples = 0
        self.iteration = 0

    def step(self, spi=1):
        """Render `spi` samples/pixel for this iteration and accumulate."""
        import time as _time
        t0 = _time.perf_counter()
        self._step_impl(spi)
        dt = _time.perf_counter() - t0
        # the first step includes jit compilation (ScriptCompiler analog)
        name = "step" if self._first_step_done else "compile+first step"
        self._first_step_done = True
        npix = self.scene.width * self.scene.height
        self.stats.record(name, dt, workload=npix * spi)
        self.stats.add("CameraRayCount", npix * spi)
        self.stats.add("Iterations", 1)

    # -------------------------------------------------------- checkpointing
    def saveCheckpoint(self, path):
        """Persist the render state (SURVEY §5.4: the reference's
        progressive accumulation + asset cache generalized to a real
        checkpoint): framebuffer sum, sample/iteration/frame counters and
        seed.  Resuming and stepping produces bitwise-identical images to
        an uninterrupted run (the RNG is keyed on (sample, iteration,
        frame, x, y, seed), so no generator state needs saving)."""
        np.savez_compressed(
            path, accum=np.asarray(self._accum),
            samples=self._samples, iteration=self.iteration,
            frame=self.frame, seed=self.seed,
            width=self.scene.width, height=self.scene.height)

    def loadCheckpoint(self, path):
        with np.load(path) as z:
            if (int(z["width"]) != self.scene.width
                    or int(z["height"]) != self.scene.height):
                raise ValueError(
                    f"checkpoint film {int(z['width'])}x{int(z['height'])} "
                    f"does not match runtime "
                    f"{self.scene.width}x{self.scene.height}")
            self._accum = jnp.asarray(z["accum"])
            self._samples = int(z["samples"])
            self.iteration = int(z["iteration"])
            self.frame = int(z["frame"])
            self.seed = int(z["seed"])

    def dumpStats(self) -> str:
        """Statistics::dump analog (Statistics.cpp:151-228) + wavefront
        occupancy quantities from the device counters."""
        ds = np.asarray(self._dev_stats)
        if ds[0] > 0:
            cap = max(self._dev_stats_capacity, 1)
            self.stats.set("WaveIterations", int(ds[0]))
            self.stats.set("TailIterations", int(ds[2]))
            self.stats.set("BounceLaneVisits", int(ds[1]))
            self.stats.set("WaveOccupancy",
                           float(ds[1] / (ds[0] * cap)))
            # Quantity tree analogs (Statistics.h:9-66): the wavefront
            # carries these as device scalars per bounce
            self.stats.set("CameraRayCount(device)", int(ds[3]))
            # ds[4]/ds[5] sum hit/miss over EVERY bounce of every wave
            # (not just camera rays), so the labels say Ray*, not Primary*
            self.stats.set("RayHitCount", int(ds[4]))
            self.stats.set("RayMissCount", int(ds[5]))
            self.stats.set("ShadowRayCount", int(ds[6]))
            self.stats.set("OccludedShadowRayCount", int(ds[7]))
            self.stats.set("BounceRayCount", int(ds[8]))
            if ds[6] > 0:
                self.stats.set("ShadowOcclusionRatio",
                               float(ds[7] / ds[6]))
        return self.stats.dump()

    def _step_impl(self, spi=1):
        w, h = self.scene.width, self.scene.height
        npix = w * h
        tech = self.scene.technique.type
        if tech in ("lighttracer", "lt"):
            fb = self._render_lt(self.tables, n_paths=npix * spi,
                                 iteration=jnp.uint32(self.iteration),
                                 frame=jnp.uint32(self.frame),
                                 user_seed=self.seed)
            self._accum = self._accum + fb
            self._samples += spi
            self.iteration += 1
            return
        if tech in ("photonmapper", "ppm", "sppm"):
            from ignis_jax.render.photonmapper import (
                build_photon_grid, ppm_compute_radius)
            nph = int(self.scene.technique.photons)
            photons = self._trace_photons(
                self.tables, n_photons=nph,
                iteration=jnp.uint32(self.iteration),
                frame=jnp.uint32(self.frame), user_seed=self.seed)
            grid = build_photon_grid(self.scene, photons)
            radius = ppm_compute_radius(
                self.scene.technique.merge_radius
                * 2.0 * self.scene.scene_radius(), self.iteration)
            for sample in range(spi):
                idx = np.arange(npix, dtype=np.int32)
                fb = self._render_ppm(
                    self.tables, grid, jnp.asarray(idx % w),
                    jnp.asarray(idx // w), jnp.uint32(sample),
                    jnp.uint32(self.iteration), jnp.uint32(self.frame),
                    self.seed, jnp.float32(radius), max_count=nph)
                self._accum = self._accum + fb
            self._samples += spi
            self.iteration += 1
            return
        if self._wavefront_ok:
            total = npix * spi
            capacity = int(min(self.tile_size, max(8192, 1 << int(np.ceil(
                np.log2(max(total, 1)))))))
            fb, wstats = self._render_wavefront(
                self.tables, None, None, None,
                jnp.uint32(self.iteration), jnp.uint32(self.frame),
                self.seed, capacity=capacity, spi=spi,
                work_mode="arith", work_total=total)
            self._accum = self._accum + fb
            self._dev_stats = self._dev_stats + wstats
            self._dev_stats_capacity = capacity
        else:
            tile = min(self.tile_size, npix)
            for sample in range(spi):
                for start in range(0, npix, tile):
                    count = min(tile, npix - start)
                    idx = np.arange(start, start + tile, dtype=np.int32)
                    idx = np.minimum(idx, npix - 1)  # pad tail
                    x = jnp.asarray(idx % w)
                    y = jnp.asarray(idx // w)
                    color = self._render_tile(
                        self.tables, x, y,
                        jnp.uint32(sample), jnp.uint32(self.iteration),
                        jnp.uint32(self.frame), self.seed)
                    self._accum = self._accum.at[start:start + count].add(
                        color[:count])
        self._samples += spi
        self.iteration += 1

    def currentFrame(self) -> np.ndarray:
        """Normalized framebuffer (H, W, 3)."""
        w, h = self.scene.width, self.scene.height
        norm = max(1, self._samples)
        return (np.asarray(self._accum) / norm).reshape(h, w, 3)

    def rawFramebuffer(self) -> np.ndarray:
        w, h = self.scene.width, self.scene.height
        return np.asarray(self._accum).reshape(h, w, 3)

    # ------------------------------------------------------------------ glare
    def tonemap(self, method="aces", scale=1.0, exposure_factor=1.0,
                offset=0.0, gamma=True):
        """Runtime::tonemap (Runtime.cpp:628 → ig_tonemap_shader):
        returns the tonemapped current frame as (H, W, 3) float in [0,1]."""
        from ignis_jax.render.tonemap import tonemap as _tm
        methods = {"none": 0, "reinhard": 1, "modified": 2, "aces": 3,
                   "uncharted2": 4}
        m = methods[method] if isinstance(method, str) else int(method)
        out = np.asarray(_tm(self.currentFrame(), method=m, scale=scale,
                             exposure_factor=exposure_factor,
                             exposure_offset=offset, use_gamma=gamma))
        return np.clip(out, 0.0, 1.0)

    def imageinfo(self, scale=1.0, bins=64, histogram=False,
                  percentile=False):
        """Runtime::imageinfo (Runtime.cpp → ig_imageinfo_shader):
        min/max/avg luminance, NaN/Inf counts (+ optional histogram and
        soft percentiles) of the current frame."""
        from ignis_jax.render.tonemap import image_info
        return image_info(self.currentFrame(), scale=scale, bins=bins,
                          histogram=histogram, percentile=percentile)

    def bake(self, texture, width=256, height=256) -> np.ndarray:
        """Bake a texture or PExpr expression to an (H, W, 3) image over
        the unit uv grid — Runtime::bake / shader/BakeShader.cpp and
        artic/entrypoints/bake.art:1-26 (uvw = (x/(w-1), y/(h-1), 0),
        null shading context).

        `texture` is a scene texture NAME or a raw PExpr string."""
        from ignis_jax.texture.eval import eval_one
        from ignis_jax.texture.loader import TEX_EXPR
        tex = None
        for t in self.scene.textures:
            if t.get("name") == texture:
                tex = t
                break
        if tex is None:
            tex = dict(type=TEX_EXPR, name="__bake", expr=str(texture),
                       obj={})
        us = np.arange(width, dtype=np.float32) / max(width - 1, 1)
        vs = np.arange(height, dtype=np.float32) / max(height - 1, 1)
        uu, vv = np.meshgrid(us, vs)
        uv = jnp.asarray(np.stack([uu.reshape(-1), vv.reshape(-1)],
                                  axis=-1), jnp.float32)
        out = eval_one(self.scene, self.tables, tex, uv)
        return np.asarray(out).reshape(height, width, 3)

    def evaluateGlare(self, settings=None, **kw):
        """DGP glare analysis of the current frame (Runtime.cpp:640-652).

        Returns (GlareOutput, heatmap HxWx3 float, glare-source mask HxW).
        If settings.avg is 0, the image-average luminance is filled in the
        way igview does (UI.cpp:651 passes imageinfo's avg)."""
        import dataclasses

        from ignis_jax.render.glare import (GlareSettings, evaluate_glare_host,
                                            srgb_to_xyY)
        if settings is None:
            settings = GlareSettings(**kw)
        img = self.currentFrame()
        if settings.avg <= 0 or settings.max <= 0:
            # Match evaluate_glare's check_get: non-finite pixels (common in
            # partial renders) must not poison the reductions.
            y = np.asarray(srgb_to_xyY(jnp.asarray(img * settings.scale)))[..., 2]
            y = y[np.isfinite(y)]
            if y.size == 0:
                y = np.zeros(1, np.float32)
            repl = {}
            if settings.avg <= 0:
                repl["avg"] = float(np.mean(y))
            if settings.max <= 0:
                repl["max"] = float(np.max(y))
            settings = dataclasses.replace(settings, **repl)
        return evaluate_glare_host(self.scene.camera, img, settings)

    # ------------------------------------------------------------------ trace
    def trace(self, rays, spp=1) -> np.ndarray:
        """Ray-list tracing: rays = [(org, dir[, tmin, tmax]), ...].

        Matches igtrace (frontend/trace/main.cpp:16-67): film is (n_rays, 1),
        each ray id maps to pixel (i, 0); returns per-ray averaged RGB.
        """
        rays = list(rays)
        n = len(rays)
        # pad to a power of two so recompiles only happen per size bucket
        npad = max(8, 1 << (n - 1).bit_length())
        org = np.zeros((npad, 3), np.float32)
        dirs = np.zeros((npad, 3), np.float32)
        dirs[:, 2] = 1.0
        tmin = np.zeros((npad,), np.float32)
        tmax = np.zeros((npad,), np.float32)  # padded rays: tmax=0 = dead
        tmax[:n] = np.float32(3.4028235e38)
        for i, r in enumerate(rays):
            org[i] = r[0]
            dirs[i] = r[1]
            if len(r) > 2:
                tmin[i] = r[2]
            if len(r) > 3:
                tmax[i] = r[3]

        x = jnp.arange(npad, dtype=jnp.int32)
        y = jnp.zeros((npad,), jnp.int32)
        # ONE dispatch: the spp loop runs inside the jit (a host loop was
        # one dispatch per sample per call — fine for tiny oracles, 100x
        # dispatch overhead for igtrace on big ray lists)
        color = _trace_rays_jit(self.scene, self.tables, x, y,
                                jnp.uint32(self.frame), self.seed,
                                jnp.asarray(org), jnp.asarray(dirs),
                                jnp.asarray(tmin), jnp.asarray(tmax),
                                max(1, spp))
        return np.asarray(color)[:n]


@partial(jax.jit, static_argnums=(0, 10))
def _trace_rays_jit(scene, tables, x, y, frame, seed,
                    org, dirs, tmin, tmax, spp):
    def body(it, acc):
        return acc + trace_wave(scene, tables, x, y, jnp.uint32(0),
                                it.astype(jnp.uint32), frame, seed,
                                org=org, direction=dirs, tmin=tmin,
                                tmax=tmax)
    acc = jax.lax.fori_loop(0, spp, body,
                            jnp.zeros((x.shape[0], 3), jnp.float32))
    return acc / jnp.float32(spp)


def load_scene(source, **kw) -> Runtime:
    return Runtime(source, **kw)
