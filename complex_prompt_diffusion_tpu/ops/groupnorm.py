"""GroupNorm(+SiLU) over NHWC in plain XLA.

The GroupNorm -> SiLU -> Conv pattern is the hot elementwise chain of both
the UNet ResBlock (cpd/models/unet.py:207-238) and the VAE
(cpd/models/autoencoder.py:153-179). On the GPU, XLA fuses the statistics
reduction and the normalise+affine+SiLU pass into a few bandwidth-bound
fusions. Statistics are computed in f32 whatever the storage dtype,
matching the reference's GroupNorm32.

Weights gamma/beta are per-channel [C].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["group_norm", "group_norm_silu"]


def _gn(x, gamma, beta, num_groups, eps, silu):
    """GroupNorm through a [N, HW, G, C/G] reshape (free on the GPU) with
    two-pass (centred) variance in f32."""
    n, h, w, c = x.shape
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    xf = x.astype(jnp.float32).reshape(n, h * w, num_groups, c // num_groups)
    mean = jnp.mean(xf, axis=(1, 3), keepdims=True)
    var = jnp.var(xf, axis=(1, 3), keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    y = y.reshape(n, h, w, c)
    y = y * gamma.astype(jnp.float32) + beta.astype(jnp.float32)
    if silu:
        y = y * jax.nn.sigmoid(y)
    return y.astype(x.dtype)


def group_norm(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> jax.Array:
    """GroupNorm over NHWC (equivalent to torch GroupNorm32, models/util.py:103)."""
    return _gn(x, gamma, beta, num_groups, eps, False)


def group_norm_silu(
    x: jax.Array,
    gamma: jax.Array,
    beta: jax.Array,
    num_groups: int = 32,
    eps: float = 1e-5,
) -> jax.Array:
    """Fused GroupNorm + SiLU (the ResBlock in_layers / out_layers prefix)."""
    return _gn(x, gamma, beta, num_groups, eps, True)
