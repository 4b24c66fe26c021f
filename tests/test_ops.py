"""Op-level tests: attention routes and the device policy, GroupNorm(+SiLU),
GEGLU feed-forward, convolutions, blur.

Each op is checked against an independent numpy reference. The cuDNN
attention route runs only on the GPU; its plumbing (layout, reshapes,
route choice) is tested here through stand-ins, its numerics on the card
in ``test_gpu.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from complex_prompt_diffusion_tpu import device as D
from complex_prompt_diffusion_tpu import ops

A = importlib.import_module("complex_prompt_diffusion_tpu.ops.attention")


def _ref_attention(q, k, v, heads, scale=None):
    """Merged-layout [B, S, H*D] attention in float64 numpy."""
    q, k, v = (np.asarray(jnp.asarray(a, jnp.float32), np.float64) for a in (q, k, v))
    b, sq, inner = q.shape
    d = inner // heads
    scale = d**-0.5 if scale is None else scale

    def split(x):
        return x.reshape(b, x.shape[1], heads, d).transpose(0, 2, 1, 3)

    s = np.einsum("bhqd,bhkd->bhqk", split(q), split(k)) * scale
    s = s - s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p = p / p.sum(axis=-1, keepdims=True)
    o = np.einsum("bhqk,bhkd->bhqd", p, split(v))
    return o.transpose(0, 2, 1, 3).reshape(b, sq, inner)


def _qkv(b, s, heads, d, kv, dtype, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (
        jax.random.normal(ks[0], (b, s, heads * d), jnp.float32).astype(dtype),
        jax.random.normal(ks[1], (b, kv, heads * d), jnp.float32).astype(dtype),
        jax.random.normal(ks[2], (b, kv, heads * d), jnp.float32).astype(dtype),
    )


# tolerance as max |out - ref| / max |ref|: f32 is exact to accumulation
# order; bf16 rounds inputs, probabilities and output to 8 significant bits
_ATTN_TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}


class TestAttention:
    # SD-1.5's head dims per UNet level (40, 80, 160), at CPU-sized S
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize("kind", ["self", "cross"])
    @pytest.mark.parametrize("s,heads,d", [(64, 8, 40), (128, 8, 80), (32, 8, 160)])
    def test_matches_numpy_over_sd_envelope(self, s, heads, d, kind, dtype):
        kv = s if kind == "self" else 77
        q, k, v = _qkv(2, s, heads, d, kv, dtype)
        out = ops.attention(q, k, v, num_heads=heads)
        assert out.shape == q.shape and out.dtype == q.dtype
        ref = _ref_attention(q, k, v, heads)
        err = np.max(np.abs(np.asarray(out, np.float64) - ref))
        assert err <= _ATTN_TOL[dtype] * np.max(np.abs(ref))

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_vae_wide_single_head(self, dtype):
        # the VAE mid-block: one d=512 head, always the XLA route
        q, k, v = _qkv(1, 64, 1, 512, 64, dtype, seed=3)
        out = ops.attention(q, k, v, num_heads=1)
        ref = _ref_attention(q, k, v, 1)
        err = np.max(np.abs(np.asarray(out, np.float64) - ref))
        assert err <= _ATTN_TOL[dtype] * np.max(np.abs(ref))

    def test_explicit_scale(self):
        q, k, v = _qkv(1, 16, 2, 8, 16, jnp.float32, seed=4)
        out = ops.attention(q, k, v, num_heads=2, scale=0.3)
        np.testing.assert_allclose(
            np.asarray(out), _ref_attention(q, k, v, 2, scale=0.3),
            atol=1e-5, rtol=1e-5,
        )

    @pytest.mark.parametrize("kind", ["self", "cross"])
    def test_gradient_matches_numpy_rule(self, kind):
        """d/dq, d/dk, d/dv of <attention, g> against the closed-form
        softmax-attention gradient in float64 numpy."""
        heads, d, s = 2, 8, 16
        kv = s if kind == "self" else 7
        q, k, v = _qkv(1, s, heads, d, kv, jnp.float32, seed=5)
        g = np.asarray(jax.random.normal(jax.random.PRNGKey(6), q.shape))
        got = jax.grad(
            lambda a, b, c: jnp.sum(ops.attention(a, b, c, heads) * g),
            argnums=(0, 1, 2),
        )(q, k, v)

        qn, kn, vn = (np.asarray(a, np.float64) for a in (q, k, v))

        def split(x):
            return x.reshape(1, x.shape[1], heads, d).transpose(0, 2, 1, 3)

        def merge(x):
            return x.transpose(0, 2, 1, 3).reshape(1, x.shape[2], heads * d)

        qh, kh, vh, gh = split(qn), split(kn), split(vn), split(g.astype(np.float64))
        scale = d**-0.5
        sc = np.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        dv = np.einsum("bhqk,bhqd->bhkd", p, gh)
        dp = np.einsum("bhqd,bhkd->bhqk", gh, vh)
        ds = p * (dp - (dp * p).sum(-1, keepdims=True)) * scale
        dq = np.einsum("bhqk,bhkd->bhqd", ds, kh)
        dk = np.einsum("bhqk,bhqd->bhkd", ds, qh)
        for a, b in zip(got, (merge(dq), merge(dk), merge(dv))):
            np.testing.assert_allclose(np.asarray(a), b, atol=1e-5, rtol=1e-4)

    def test_cudnn_branch_layout(self, monkeypatch):
        """The cuDNN branch hands jax.nn.dot_product_attention the merged
        layout reshaped to [B, S, H, D] (no transpose) and merges back.
        Checked on the CPU by standing in its XLA implementation."""
        seen = []
        real = jax.nn.dot_product_attention

        def fake(q, k, v, scale=None, implementation=None):
            seen.append((q.shape, k.shape, implementation, scale))
            return real(q, k, v, scale=scale, implementation="xla")

        monkeypatch.setattr(A, "attention_route", lambda *args: "cudnn")
        monkeypatch.setattr(jax.nn, "dot_product_attention", fake)
        q, k, v = _qkv(2, 32, 4, 16, 48, jnp.float32, seed=7)
        out = A.attention(q, k, v, num_heads=4)
        assert seen == [((2, 32, 4, 16), (2, 48, 4, 16), "cudnn", 0.25)]
        np.testing.assert_allclose(
            np.asarray(out), _ref_attention(q, k, v, 4), atol=1e-5, rtol=1e-5
        )

    def test_route_is_chosen_before_tracing(self, monkeypatch):
        """Each call site asks the device policy once, with the platform,
        dtype, head dim and KV length known at trace time."""
        calls = []

        def route(platform, dtype, head_dim, kv_len):
            calls.append((platform, jnp.dtype(dtype), head_dim, kv_len))
            return "xla"

        monkeypatch.setattr(A, "attention_route", route)
        q, k, v = _qkv(1, 64, 8, 40, 77, jnp.bfloat16)
        jax.jit(lambda a, b, c: A.attention(a, b, c, 8))(q, k, v)
        assert calls == [("cpu", jnp.dtype(jnp.bfloat16), 40, 77)]


class TestDevicePolicy:
    @pytest.mark.parametrize(
        "platform,dtype,head_dim,kv_len,want",
        [
            ("gpu", jnp.bfloat16, 40, 4096, "cudnn"),   # UNet level 0
            ("gpu", jnp.bfloat16, 80, 1024, "cudnn"),   # level 1
            ("gpu", jnp.bfloat16, 160, 256, "xla"),     # level 2: measured
            ("gpu", jnp.bfloat16, 80, 257, "cudnn"),
            ("gpu", jnp.float16, 40, 4096, "cudnn"),
            ("gpu", jnp.bfloat16, 256, 4096, "cudnn"),  # cuDNN's head-dim cap
            ("gpu", jnp.bfloat16, 160, 64, "xla"),      # level 3: short KV
            ("gpu", jnp.bfloat16, 40, 77, "xla"),       # cross-attention
            ("gpu", jnp.bfloat16, 512, 4096, "xla"),    # VAE mid-block head
            ("gpu", jnp.bfloat16, 264, 4096, "xla"),    # above the cap
            ("gpu", jnp.bfloat16, 36, 4096, "xla"),     # not a multiple of 8
            ("gpu", jnp.float32, 40, 4096, "xla"),      # f32: plain route
            ("cpu", jnp.bfloat16, 40, 4096, "xla"),
        ],
    )
    def test_attention_route_table(self, platform, dtype, head_dim, kv_len, want):
        assert D.attention_route(platform, dtype, head_dim, kv_len) == want

    @pytest.mark.parametrize(
        "platform,want", [("gpu", "bfloat16"), ("cpu", "float32")]
    )
    def test_compute_dtype(self, platform, want):
        assert D.compute_dtype(platform) == want

    def test_require_accelerator_refuses_cpu(self):
        with pytest.raises(RuntimeError, match="no accelerator"):
            D.require_accelerator()

    def test_compile_cache_follows_env(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert D.enable_compile_cache() == str(tmp_path)

    def test_compile_cache_defaults_to_checkout(self, monkeypatch):
        from pathlib import Path

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = D.enable_compile_cache()
        assert Path(path) == Path(D.__file__).resolve().parents[1] / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == path


def _ref_group_norm(x, gamma, beta, groups, eps, silu):
    x = np.asarray(jnp.asarray(x, jnp.float32), np.float64)
    n, h, w, c = x.shape
    xr = x.reshape(n, h * w, groups, c // groups)
    mean = xr.mean(axis=(1, 3), keepdims=True)
    var = xr.var(axis=(1, 3), keepdims=True)
    y = ((xr - mean) / np.sqrt(var + eps)).reshape(n, h, w, c)
    y = y * np.asarray(gamma, np.float64) + np.asarray(beta, np.float64)
    if silu:
        y = y / (1.0 + np.exp(-y))
    return y


class TestGroupNorm:
    @pytest.mark.parametrize("silu", [False, True])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize(
        "shape,groups", [((2, 8, 8, 64), 32), ((1, 16, 4, 96), 32), ((2, 4, 4, 48), 16)]
    )
    def test_matches_numpy(self, shape, groups, dtype, silu):
        key = jax.random.PRNGKey(0)
        x = (jax.random.normal(key, shape) * 3.0 + 1.0).astype(dtype)
        c = shape[-1]
        gamma = jnp.linspace(0.5, 1.5, c)
        beta = jnp.linspace(-0.2, 0.2, c)
        fn = ops.group_norm_silu if silu else ops.group_norm
        out = fn(x, gamma, beta, num_groups=groups, eps=1e-5)
        assert out.shape == x.shape and out.dtype == x.dtype
        ref = _ref_group_norm(x, gamma, beta, groups, 1e-5, silu)
        tol = 1e-5 if dtype == jnp.float32 else 1e-2
        err = np.max(np.abs(np.asarray(out, np.float64) - ref))
        assert err <= tol * np.max(np.abs(ref))

    def test_gradient_matches_numerical(self):
        """jax.grad of GroupNorm+SiLU against a float64 central difference
        of the numpy reference."""
        x = jax.random.normal(jax.random.PRNGKey(1), (1, 4, 4, 8))
        gamma = jnp.linspace(0.5, 1.5, 8)
        beta = jnp.zeros((8,))
        g = jax.grad(
            lambda a: jnp.sum(jnp.sin(ops.group_norm_silu(a, gamma, beta, 4)))
        )(x)

        def f(a):
            return np.sum(np.sin(_ref_group_norm(a, gamma, beta, 4, 1e-5, True)))

        xn = np.asarray(x, np.float64)
        for idx in [(0, 1, 2, 3), (0, 0, 0, 0), (0, 3, 1, 6)]:
            e = np.zeros_like(xn)
            e[idx] = 1e-5
            num = (f(xn + e) - f(xn - e)) / 2e-5
            # f32 gradient: the group reductions cancel to ~1e-4 absolute
            np.testing.assert_allclose(float(g[idx]), num, rtol=1e-3, atol=5e-4)

    def test_bad_groups_raises(self):
        x = jnp.zeros((1, 4, 4, 10))
        with pytest.raises(ValueError, match="not divisible"):
            ops.group_norm(x, jnp.ones(10), jnp.zeros(10), num_groups=32)


class TestGegluFF:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_matches_numpy(self, dtype):
        from scipy.special import erf

        from complex_prompt_diffusion_tpu.ops.mlp import geglu_ff

        c, h = 16, 64
        ks = jax.random.split(jax.random.PRNGKey(0), 4)
        x = jax.random.normal(ks[0], (2, 5, c)).astype(dtype)
        w1 = jax.random.normal(ks[1], (c, 2 * h)) * 0.2
        b1 = jax.random.normal(ks[2], (2 * h,)) * 0.1
        w2 = jax.random.normal(ks[3], (h, c)) * 0.2
        b2 = jnp.linspace(-0.1, 0.1, c)
        out = geglu_ff(x, w1, b1, w2, b2)
        assert out.shape == x.shape and out.dtype == x.dtype
        xn = np.asarray(jnp.asarray(x, jnp.float32), np.float64)
        y = xn @ np.asarray(w1, np.float64) + np.asarray(b1, np.float64)
        val, gate = y[..., :h], y[..., h:]
        y = val * 0.5 * gate * (1.0 + erf(gate / np.sqrt(2.0)))
        ref = y @ np.asarray(w2, np.float64) + np.asarray(b2, np.float64)
        tol = 1e-5 if dtype == jnp.float32 else 3e-2
        err = np.max(np.abs(np.asarray(out, np.float64) - ref))
        assert err <= tol * np.max(np.abs(ref))


class TestConv2d:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    @pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (1, 2)])
    def test_matches_numpy(self, k, stride, dtype):
        """torch-style symmetric padding (k-1)//2 at any stride."""
        from complex_prompt_diffusion_tpu.models import layers as L

        key = jax.random.PRNGKey(k * 10 + stride)
        x = jax.random.normal(key, (2, 9, 7, 6)).astype(dtype)
        p = L.init_conv(jax.random.fold_in(key, 1), 6, 5, k)
        p = {"kernel": p["kernel"], "bias": p["bias"] + 0.1}
        out = L.conv2d(p, x, stride=stride)
        xn = np.asarray(jnp.asarray(x, jnp.float32), np.float64)
        pad = (k - 1) // 2
        xp = np.pad(xn, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        ho = (9 + 2 * pad - k) // stride + 1
        wo = (7 + 2 * pad - k) // stride + 1
        w = np.asarray(p["kernel"], np.float64)
        ref = np.zeros((2, ho, wo, 5))
        for i in range(ho):
            for j in range(wo):
                patch = xp[:, i * stride : i * stride + k, j * stride : j * stride + k, :]
                ref[:, i, j, :] = np.einsum("bhwc,hwco->bo", patch, w)
        ref += np.asarray(p["bias"], np.float64)
        assert out.shape == ref.shape and out.dtype == x.dtype
        tol = 1e-5 if dtype == jnp.float32 else 2e-2
        err = np.max(np.abs(np.asarray(out, np.float64) - ref))
        assert err <= tol * np.max(np.abs(ref))


class TestGaussianBlur:
    def test_preserves_mean_and_shape(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (1, 32, 32, 4))
        y = ops.gaussian_blur(x, kernel_size=7)
        assert y.shape == x.shape
        # blur preserves local DC: constant input is unchanged
        const = jnp.ones((1, 16, 16, 2))
        np.testing.assert_allclose(
            np.asarray(ops.gaussian_blur(const, 31)), 1.0, atol=1e-5
        )

    def test_reduces_variance(self):
        x = jax.random.normal(jax.random.PRNGKey(1), (1, 64, 64, 1))
        y = ops.gaussian_blur(x, kernel_size=15)
        assert float(jnp.var(y)) < 0.3 * float(jnp.var(x))
