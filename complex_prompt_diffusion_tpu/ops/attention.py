"""Multi-head attention over the SpatialTransformer's merged [B, S, H*D] layout.

Replaces the reference's memory-metered sliced attention
(cpd/models/attention.py:280-348), which reads ``torch.cuda.mem_get_info``
in the forward pass to choose a slice count. Two routes, chosen per call
site before tracing by :func:`device.attention_route`:

* ``"cudnn"``: cuDNN's fused flash attention, a library kernel reached
  through ``jax.nn.dot_product_attention(implementation="cudnn")``. The
  S x S score matrix never reaches device memory (at SD-1.5's level-0
  self-attention with UNet batch 8 the plain route writes an f32
  [8, 8, 4096, 4096] score tensor, 4.3 GB, per site and step). Its input
  layout [B, S, H, D] is the merged layout reshaped, so no transpose is
  needed. Gradients use the library's own fused backward.
* ``"xla"``: :func:`_xla_attention`, einsum -> f32 softmax -> einsum. It is
  the reference every test and the on-card comparison check against, and
  the route for f32, the CPU, short contexts (CLIP's 77 tokens) and head
  dims cuDNN does not take (the VAE mid-block's single d=512 head).

Shape envelope (Stable Diffusion): self-attention S in {64, 256, 1024, 4096},
head dims 40, 80, 160; cross-attention kv = 77; VAE mid-block d = 512.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu.device import attention_route

__all__ = ["attention"]


def _xla_attention(q, k, v, scale):
    """Reference-semantics attention in plain XLA on [B, H, S, D] (softmax
    in f32, matmuls accumulate in f32)."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    p = jax.nn.softmax(s * scale, axis=-1)
    return jnp.einsum(
        "bhqk,bhkd->bhqd", p.astype(v.dtype), v,
        preferred_element_type=jnp.float32,
    ).astype(q.dtype)


def attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    num_heads: int,
    scale: Optional[float] = None,
) -> jax.Array:
    """Non-causal attention over [B, S, H*D] tensors (q: [B, Sq, H*D];
    k, v: [B, Skv, H*D]). ``scale`` defaults to 1/sqrt(D)."""
    b, sq, inner = q.shape
    kv = k.shape[1]
    d = inner // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if attention_route(jax.default_backend(), q.dtype, d, kv) == "cudnn":
        out = jax.nn.dot_product_attention(
            q.reshape(b, sq, num_heads, d),
            k.reshape(b, kv, num_heads, d),
            v.reshape(b, kv, num_heads, d),
            scale=scale,
            implementation="cudnn",
        )
        return out.reshape(b, sq, inner)

    def split(x):
        return x.reshape(b, x.shape[1], num_heads, d).transpose(0, 2, 1, 3)

    out = _xla_attention(split(q), split(k), split(v), scale)
    return out.transpose(0, 2, 1, 3).reshape(b, sq, inner)
