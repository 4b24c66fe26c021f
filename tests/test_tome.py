"""Token-reduction tests (ops/tome.py): ToMe merge/unmerge math, ToDo K/V
downsampling, the locally-constant lossless property through real softmax
attention, and the UNet wiring for both modes.

The reference has no analog (its only spatial-cost lever is memory slicing,
attention.py:280-348); token reduction is an opt-in device-side FLOP cut.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from complex_prompt_diffusion_tpu.ops import tome


def _rand(b, s, c, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((b, s, c)), jnp.float32)


class TestMergeMath:
    def test_shapes_and_roundtrip_slots(self):
        B, h, w, C, r = 2, 8, 8, 16, 24
        x = _rand(B, h * w, C)
        plan = tome.build_merge(x, h, w, r=r)
        xm = tome.tome_merge(plan, x)
        assert xm.shape == (B, h * w - r, C)
        y = tome.tome_unmerge(plan, xm)
        assert y.shape == x.shape

        n_dst = plan.dst_pos.shape[0]
        idx = np.asarray(plan.idx_src)
        src_pos = np.asarray(plan.src_pos)
        dst_pos = np.asarray(plan.dst_pos)
        yn, xn, xmn = np.asarray(y), np.asarray(x), np.asarray(xm)
        for b in range(B):
            for s_i, p in enumerate(src_pos):
                slot = idx[b, s_i]
                # every src position reads exactly its assigned slot
                np.testing.assert_allclose(yn[b, p], xmn[b, slot])
                if slot >= n_dst:  # kept tokens pass through unchanged
                    np.testing.assert_allclose(xmn[b, slot], xn[b, p])
            for d_i, p in enumerate(dst_pos):
                np.testing.assert_allclose(yn[b, p], xmn[b, d_i])

    def test_pooled_dst_is_mean(self):
        B, h, w, C, r = 1, 8, 8, 8, 30
        x = _rand(B, h * w, C, seed=1)
        plan = tome.build_merge(x, h, w, r=r)
        xm = np.asarray(tome.tome_merge(plan, x))
        n_dst = plan.dst_pos.shape[0]
        idx = np.asarray(plan.idx_src)[0]
        xn = np.asarray(x)[0]
        src_pos = np.asarray(plan.src_pos)
        dst_pos = np.asarray(plan.dst_pos)
        counts = np.zeros(n_dst)
        sums = np.zeros((n_dst, C))
        for s_i, p in enumerate(src_pos):
            if idx[s_i] < n_dst:
                counts[idx[s_i]] += 1
                sums[idx[s_i]] += xn[p]
        want = (xn[dst_pos] + sums) / (1 + counts[:, None])
        np.testing.assert_allclose(xm[0, :n_dst], want, atol=1e-5)

    def test_merged_count_is_exactly_r(self):
        B, h, w, C, r = 3, 8, 8, 8, 17
        plan = tome.build_merge(_rand(B, h * w, C, seed=2), h, w, r=r)
        n_dst = plan.dst_pos.shape[0]
        merged = np.asarray(plan.idx_src) < n_dst
        assert (merged.sum(axis=1) == r).all()

    def test_bad_r_raises(self):
        x = _rand(1, 64, 8)
        with pytest.raises(ValueError):
            tome.build_merge(x, 8, 8, r=0)
        with pytest.raises(ValueError):
            tome.build_merge(x, 8, 8, r=49)  # n_src = 48


class TestAttentionLossless:
    def test_locally_constant_attention_exact(self):
        # tokens constant per 2x2 window + full merge (r = n_src): every src
        # merges into its own window's dst with uniform multiplicity, so
        # softmax attention over the merged sequence unmerges to EXACTLY the
        # full-sequence attention (multiplicity cancels in normalization)
        rng = np.random.default_rng(3)
        B, h, w, C = 2, 8, 8, 16
        base = rng.standard_normal((B, 4, 4, C))
        x = jnp.asarray(
            np.repeat(np.repeat(base, 2, axis=1), 2, axis=2).reshape(
                B, h * w, C
            ),
            jnp.float32,
        )

        def attn(z):
            s = jnp.einsum("bqc,bkc->bqk", z, z) * (C ** -0.5)
            p = jax.nn.softmax(s, axis=-1)
            return jnp.einsum("bqk,bkc->bqc", p, z)

        full = attn(x)
        plan = tome.build_merge(x, h, w, r=48)
        approx = tome.tome_unmerge(plan, attn(tome.tome_merge(plan, x)))
        np.testing.assert_allclose(
            np.asarray(approx), np.asarray(full), atol=1e-5
        )


class TestDownsampleKV:
    def test_pool_is_window_mean(self):
        B, h, w, C = 2, 8, 6, 16
        x = _rand(B, h * w, C, seed=5)
        got = np.asarray(tome.downsample_kv(x, h, w, sx=2, sy=2))
        want = (
            np.asarray(x)
            .reshape(B, h // 2, 2, w // 2, 2, C)
            .mean(axis=(2, 4))
            .reshape(B, (h // 2) * (w // 2), C)
        )
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_bad_grid_raises(self):
        x = _rand(1, 63, 8)
        with pytest.raises(ValueError):
            tome.downsample_kv(x, 8, 8)
        with pytest.raises(ValueError):
            tome.downsample_kv(_rand(1, 56, 8), 8, 7, sx=2, sy=2)

    def test_locally_constant_attention_exact(self):
        # tokens constant per 2x2 window: pooled K/V tokens equal the
        # window value, and softmax over n identical keys renormalizes to
        # softmax over the deduplicated keys — Q-side attention is exact
        rng = np.random.default_rng(6)
        B, h, w, C = 2, 8, 8, 16
        base = rng.standard_normal((B, 4, 4, C))
        x = jnp.asarray(
            np.repeat(np.repeat(base, 2, axis=1), 2, axis=2).reshape(
                B, h * w, C
            ),
            jnp.float32,
        )

        def attn(q, kv):
            s = jnp.einsum("bqc,bkc->bqk", q, kv) * (C ** -0.5)
            p = jax.nn.softmax(s, axis=-1)
            return jnp.einsum("bqk,bkc->bqc", p, kv)

        full = attn(x, x)
        approx = attn(x, tome.downsample_kv(x, h, w))
        np.testing.assert_allclose(
            np.asarray(approx), np.asarray(full), atol=1e-5
        )


class TestUNetWiring:
    def _bundle_out(self, tome_ratio, min_seq=16, mode="merge",
                    mlp=False, crossattn=False):
        from complex_prompt_diffusion_tpu import models as M

        cfg = dataclasses.replace(
            M.UNetConfig.tiny(context_dim=64),
            dtype="float32",
            tome_ratio=tome_ratio,
            tome_min_seq=min_seq,
            tome_mode=mode,
            tome_mlp=mlp,
            tome_crossattn=crossattn,
        )
        key = jax.random.PRNGKey(0)
        params = M.init_unet(key, cfg)
        # random init zero-inits every proj_out / out conv (so attention
        # contributes nothing and ToMe would be invisible) — perturb all
        # params with a fixed-seed offset to make the probe non-degenerate
        rng = np.random.default_rng(7)
        params = jax.tree.map(
            lambda a: a + jnp.asarray(
                rng.standard_normal(a.shape) * 0.02, a.dtype
            ),
            params,
        )
        x = jax.random.normal(jax.random.fold_in(key, 1), (2, 16, 16, 4))
        t = jnp.asarray([500, 500])
        ctx = jax.random.normal(jax.random.fold_in(key, 2), (2, 77, 64))
        # the output conv is zero-init on random weights, so probe the
        # (nonzero) encoder skip activations alongside the output
        out, skips = jax.jit(
            lambda p, a, b, c: M.unet_apply(cfg, p, a, b, c, return_skips=True)
        )(params, x, t, ctx)
        return jnp.concatenate([s.ravel() for s in skips] + [out.ravel()])

    @pytest.mark.parametrize("mode", ["merge", "downsample"])
    def test_jits_and_changes_output_mildly(self, mode):
        exact = self._bundle_out(0.0, mode=mode)
        merged = self._bundle_out(0.4, mode=mode)
        assert merged.shape == exact.shape
        assert np.isfinite(np.asarray(merged)).all()
        # approximate but correlated: the reduced output must stay close in
        # direction to the exact one (cos > 0.95 on random tiny weights)
        a = np.asarray(exact, np.float64).ravel()
        b = np.asarray(merged, np.float64).ravel()
        cos = (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.95, cos
        # and NOT bit-identical (the knob did something)
        assert not np.allclose(a, b)

    def test_unknown_mode_raises(self):
        with pytest.raises(ValueError):
            self._bundle_out(0.4, mode="nope")

    def test_mlp_and_crossattn_merge_flags(self):
        # plan reuse across FF + cross-Q (ToMe-SD merge_mlp/merge_crossattn):
        # still finite, still correlated, and distinct from attn1-only merging
        exact = np.asarray(self._bundle_out(0.0), np.float64).ravel()
        attn_only = np.asarray(self._bundle_out(0.4), np.float64).ravel()
        full = np.asarray(
            self._bundle_out(0.4, mlp=True, crossattn=True), np.float64
        ).ravel()
        assert np.isfinite(full).all()
        cos = (exact @ full) / (np.linalg.norm(exact) * np.linalg.norm(full))
        assert cos > 0.9, cos
        assert not np.allclose(full, attn_only)

    def test_ratio_zero_is_exact_path(self):
        a = self._bundle_out(0.0)
        b = self._bundle_out(0.0)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_render_config_validates_mode_early(self):
        from complex_prompt_diffusion_tpu.pipeline import RenderConfig

        with pytest.raises(ValueError):
            RenderConfig(tome_ratio=0.3, tome_mode="nope")
        RenderConfig(tome_ratio=0.0, tome_mode="nope")  # off => unvalidated

    def test_pipeline_threads_ratio(self):
        from complex_prompt_diffusion_tpu.pipeline import (
            ModelBundle, RenderConfig, txt2img,
        )

        bundle = ModelBundle.random("tiny")
        # tiny level-0 is 8x8=64 tokens; lower the site threshold via the
        # unet cfg so the knob actually engages
        bundle = dataclasses.replace(
            bundle,
            unet_cfg=dataclasses.replace(bundle.unet_cfg, tome_min_seq=16),
        )
        cfg = RenderConfig(steps=2, width=32, height=32, tome_ratio=0.3)
        imgs, _ = txt2img(bundle, "a cat", cfg=cfg)
        assert imgs.dtype == np.uint8
        exact, _ = txt2img(
            bundle, "a cat", cfg=dataclasses.replace(cfg, tome_ratio=0.0)
        )
        assert imgs.shape == exact.shape
