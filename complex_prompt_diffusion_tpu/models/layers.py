"""Primitive layers: conv / linear / norms / embeddings as pure functions.

Params are plain dicts of arrays. Conv kernels are HWIO; the
torch-checkpoint loader (models/params.py) transposes from OIHW. Norm layers
compute statistics in f32 regardless of activation dtype, matching the
reference's GroupNorm32 behavior (/root/reference/cpd/models/util.py:103-105).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu.ops import group_norm, group_norm_silu


__all__ = [
    "init_conv",
    "conv2d",
    "init_linear",
    "linear",
    "init_group_norm",
    "init_layer_norm",
    "layer_norm",
    "timestep_embedding",
    "silu",
    "gelu",
    "upsample_nearest2x",
    "avg_pool2x",
]


def as_np_rng(key) -> "np.random.Generator":
    """Convert a jax PRNG key / int / Generator into a numpy Generator.

    Init runs host-side in numpy: random weights are only used for tests and
    demos (real weights come from checkpoints), and eager jax dispatch per
    layer costs a compile each on first use.
    """
    import numpy as np

    if isinstance(key, np.random.Generator):
        return key
    if hasattr(key, "dtype"):  # jax typed key or uint32 key array
        import jax.random as jr

        try:
            data = jr.key_data(key)
        except Exception:
            data = key
        entropy = [int(x) for x in np.asarray(data).ravel()]
        return np.random.default_rng(np.random.SeedSequence(entropy))
    return np.random.default_rng(key)


def init_conv(key, in_ch: int, out_ch: int, kernel: int = 3, zero: bool = False):
    """Conv2d params {kernel: [KH,KW,I,O], bias: [O]}; uniform fan-in init
    (torch Conv2d default is kaiming-uniform — only used for random tests).

    Returns HOST numpy leaves: init builds the whole tree host-side and
    the top-level ``init_*`` entry points commit it with ONE
    ``jax.device_put``."""
    import numpy as np

    if zero:
        w = np.zeros((kernel, kernel, in_ch, out_ch), np.float32)
    else:
        rng = as_np_rng(key)
        fan_in = in_ch * kernel * kernel
        bound = 1.0 / math.sqrt(fan_in)
        w = rng.uniform(
            -bound, bound, (kernel, kernel, in_ch, out_ch)
        ).astype(np.float32)
    return {"kernel": w, "bias": np.zeros((out_ch,), np.float32)}


def conv2d(params, x, stride: int = 1, padding=None):
    """Conv with torch-style symmetric padding. Default pad = (k-1)//2, which
    reproduces torch Conv2d(padding=k//2) for odd k at any stride — explicit
    padding, NOT XLA "SAME" (which misaligns at stride 2). NHWC/HWIO, so
    XLA hands it to cuDNN with no layout transpose."""
    dtype = x.dtype
    k = params["kernel"].shape[0]
    if padding is None:
        padding = (k - 1) // 2
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    y = jax.lax.conv_general_dilated(
        x,
        params["kernel"].astype(dtype),
        (stride, stride),
        padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + params["bias"].astype(dtype)


def init_linear(key, in_f: int, out_f: int, bias: bool = True, zero: bool = False):
    # host numpy leaves — see init_conv docstring
    import numpy as np

    if zero:
        w = np.zeros((in_f, out_f), np.float32)
    else:
        rng = as_np_rng(key)
        bound = 1.0 / math.sqrt(in_f)
        w = rng.uniform(-bound, bound, (in_f, out_f)).astype(np.float32)
    p = {"kernel": w}
    if bias:
        p["bias"] = np.zeros((out_f,), np.float32)
    return p


def linear(params, x):
    dtype = x.dtype
    y = jnp.dot(x, params["kernel"].astype(dtype))
    if "bias" in params:
        y = y + params["bias"].astype(dtype)
    return y


def init_group_norm(ch: int):
    import numpy as np

    return {"scale": np.ones((ch,), np.float32), "bias": np.zeros((ch,), np.float32)}


def init_layer_norm(ch: int):
    import numpy as np

    return {"scale": np.ones((ch,), np.float32), "bias": np.zeros((ch,), np.float32)}


def layer_norm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).astype(dtype)


def group_norm_p(params, x, num_groups: int = 32, eps: float = 1e-5):
    return group_norm(x, params["scale"], params["bias"], num_groups, eps)


def group_norm_silu_p(params, x, num_groups: int = 32, eps: float = 1e-5):
    return group_norm_silu(x, params["scale"], params["bias"], num_groups, eps)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, CompVis ordering [cos | sin]
    (/root/reference/cpd/models/util.py:65-85 — note diffusers uses
    [sin | cos]; the order matters for weight parity). f32 output."""
    half = dim // 2
    freqs = jnp.exp(
        -math.log(max_period) * jnp.arange(half, dtype=jnp.float32) / half
    )
    args = timesteps.astype(jnp.float32)[:, None] * freqs[None]
    emb = jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
    if dim % 2:
        emb = jnp.concatenate([emb, jnp.zeros_like(emb[:, :1])], axis=-1)
    return emb


def silu(x):
    return x * jax.nn.sigmoid(x)


def gelu(x):
    return jax.nn.gelu(x, approximate=False)


def upsample_nearest2x(x):
    n, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (n, h, 2, w, 2, c))
    return x.reshape(n, h * 2, w * 2, c)


def avg_pool2x(x):
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, 2, 2, 1), (1, 2, 2, 1), "VALID"
    ) / 4.0
