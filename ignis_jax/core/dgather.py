"""Differentiation-friendly row gathers for parameter tables.

`table[idx]` transposes to a scatter-add whose indices may collide.
`gather_rows` keeps the forward gather but writes the VJP as a one-hot
matmul: dtable = onehot(idx, M)^T @ g, at HIGHEST precision so a TF32
matmul unit cannot round the gradient.

Intended for the *small* differentiable tables (materials, lights) where
M is at most a few thousand; the one-hot factor is chunked over the lane
dimension so peak memory stays bounded.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# max elements of the (chunk, M) one-hot factor materialized at once
_CHUNK_BUDGET = 1 << 24
_HI = jax.lax.Precision.HIGHEST


@jax.custom_vjp
def gather_rows(table, idx):
    """table[idx] with a one-hot-matmul transpose.  idx rows outside
    [0, M) contribute no gradient (forward clamps like jnp indexing)."""
    return table[idx]


def _fwd(table, idx):
    # the table itself rides in the residuals only for its shape/dtype
    # (dtype objects are not valid pytree leaves)
    return table[idx], (idx, table)


def _bwd(res, g):
    idx, table = res
    tshape, tdtype = table.shape, table.dtype
    m = tshape[0]
    n = idx.shape[0]
    k = 1
    for s in g.shape[1:]:
        k *= s
    gf = g.reshape(n, k).astype(jnp.float32)
    iota = jnp.arange(m, dtype=jnp.int32)

    chunk = max(1, min(n, _CHUNK_BUDGET // max(m, 1)))
    if chunk >= n:
        oh = (idx[:, None].astype(jnp.int32) == iota[None, :])
        dt = jnp.einsum("nm,nk->mk", oh.astype(jnp.float32), gf,
                        precision=_HI)
    else:
        nchunks = -(-n // chunk)
        pad = nchunks * chunk - n
        idx_p = jnp.pad(idx.astype(jnp.int32), (0, pad), constant_values=-1)
        gf_p = jnp.pad(gf, ((0, pad), (0, 0)))

        def body(c, acc):
            i0 = c * chunk
            ic = jax.lax.dynamic_slice_in_dim(idx_p, i0, chunk)
            gc = jax.lax.dynamic_slice_in_dim(gf_p, i0, chunk)
            oh = (ic[:, None] == iota[None, :]).astype(jnp.float32)
            return acc + jnp.einsum("nm,nk->mk", oh, gc, precision=_HI)

        dt = jax.lax.fori_loop(
            0, nchunks, body, jnp.zeros((m, k), jnp.float32))
    return dt.reshape(tshape).astype(tdtype), None


gather_rows.defvjp(_fwd, _bwd)
