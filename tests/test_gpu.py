"""Tests that need the GPU: the cuDNN attention route on the card.

They skip elsewhere (the ``gpu`` fixture decides at run time) and run on the
card from ``chip_smoke.py``. CPU tests of the same routing logic are in
``test_ops.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from complex_prompt_diffusion_tpu.ops import attention
from complex_prompt_diffusion_tpu.ops.attention import _xla_attention

pytestmark = pytest.mark.gpu


def _qkv(b, s, h, d, kv, dtype=jnp.bfloat16, seed=0):
    kq, kk, kv_ = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (
        jax.random.normal(kq, (b, s, h * d), dtype),
        jax.random.normal(kk, (b, kv, h * d), dtype),
        jax.random.normal(kv_, (b, kv, h * d), dtype),
    )


def _reference(q, k, v, h):
    b, s, inner = q.shape
    d = inner // h

    def split(x):
        return x.astype(jnp.float32).reshape(b, x.shape[1], h, d).transpose(
            0, 2, 1, 3
        )

    with jax.default_matmul_precision("highest"):
        o = _xla_attention(split(q), split(k), split(v), d**-0.5)
    return o.transpose(0, 2, 1, 3).reshape(b, s, inner)


# Self-attention sites the device policy sends to cuDNN (KV > 256): SD-1.5's
# level 0 (d=40) and level 1 (d=80) at 512x512, and level 2 (d=160) at
# 1024x1024, where its context reaches 1024.
CUDNN_SITES = [(4096, 8, 40), (1024, 8, 80), (1024, 8, 160)]


def _runs_cudnn(fn, *args, backward=False):
    text = jax.jit(fn).lower(*args).as_text()
    name = "__cudnn$fmhaSoftmaxBackward" if backward else "__cudnn$fmhaSoftmax"
    return name in text


@pytest.mark.parametrize("s,h,d", CUDNN_SITES)
def test_cudnn_forward_matches_reference(gpu, s, h, d):
    q, k, v = _qkv(2, s, h, d, s)
    fwd = lambda q, k, v: attention(q, k, v, h)  # noqa: E731
    assert _runs_cudnn(fwd, q, k, v)
    out = jax.jit(fwd)(q, k, v)
    ref = _reference(q, k, v, h)
    err = float(jnp.max(jnp.abs(out.astype(jnp.float32) - ref)))
    assert err <= 2e-2 * float(jnp.max(jnp.abs(ref)))


@pytest.mark.parametrize("s,h,d", CUDNN_SITES)
def test_cudnn_gradient_matches_reference(gpu, s, h, d):
    """The route's own fused backward (a cuDNN backward custom call in the
    compiled gradient) against the f32 reference gradient: CLIP guidance
    and null-text inversion differentiate through these sites."""
    q, k, v = _qkv(2, s, h, d, s, seed=1)
    g = jax.random.normal(jax.random.PRNGKey(2), q.shape, jnp.float32)

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) * g)

    grad = jax.grad(loss(lambda a, b, c: attention(a, b, c, h)),
                    argnums=(0, 1, 2))
    assert _runs_cudnn(grad, q, k, v, backward=True)
    got = jax.jit(grad)(q, k, v)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss(lambda a, b, c: _reference(a, b, c, h)),
                                argnums=(0, 1, 2)))(q, k, v)
    for a, b in zip(got, want):
        a = np.asarray(a.astype(jnp.float32))
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 3e-2 * np.linalg.norm(b)


@pytest.mark.parametrize(
    "dtype,d,kv,want",
    [
        (jnp.bfloat16, 40, 4096, True),
        (jnp.bfloat16, 40, 77, False),
        (jnp.bfloat16, 512, 4096, False),
        (jnp.float32, 40, 4096, False),
    ],
)
def test_cudnn_route_in_compiled_program(gpu, dtype, d, kv, want):
    """The route chosen before tracing is the one the compiled program runs:
    cuDNN's fused attention appears as a cuDNN custom call."""
    h = 1 if d == 512 else 8
    q, k, v = _qkv(1, 4096, h, d, kv, dtype=dtype)
    text = jax.jit(attention, static_argnums=3).lower(q, k, v, h).as_text()
    assert ("__cudnn$fmha" in text) == want
