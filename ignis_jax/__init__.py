"""Ignis-JAX: a differentiable wavefront path tracer in JAX.

A from-scratch reimplementation of the capabilities of the Ignis renderer
(SLebailly/Ignis-MasterThesis): scenes compile to flat JAX arrays instead
of JIT-specialized Artic shaders, the wavefront loop is a `lax.while_loop`
over fixed-capacity SoA ray arrays, BVH traversal on the GPU is a CUDA
kernel called through `jax.ffi`, and rays/pixels shard over a
`jax.sharding.Mesh`.

Reference architecture documented in SURVEY.md; parity targets in BASELINE.md.
"""

__version__ = "0.1.0"

from ignis_jax.api import Runtime, load_scene  # noqa: F401,E402
