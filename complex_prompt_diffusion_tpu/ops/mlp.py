"""GEGLU feed-forward (the SpatialTransformer MLP).

``out = (split_half(x @ W1 + b1) -> v * gelu(g)) @ W2 + b2``, as in the
reference's FeedForward/GEGLU (cpd/models/attention.py). Plain XLA: the two
matmuls go to cuBLAS, and XLA fuses the bias, split and exact-gelu gate into
their epilogues and prologues as it sees fit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["geglu_ff"]


def geglu_ff(x, w1, b1, w2, b2):
    """GEGLU FF: x [..., C], w1 [C, 8C'], b1 [8C'], w2 [4C', C], b2 [C];
    computed in ``x.dtype``."""
    y = jnp.dot(x, w1.astype(x.dtype)) + b1.astype(x.dtype)
    v, g = jnp.split(y, 2, axis=-1)
    y = v * jax.nn.gelu(g, approximate=False)
    return jnp.dot(y, w2.astype(x.dtype)) + b2.astype(x.dtype)
