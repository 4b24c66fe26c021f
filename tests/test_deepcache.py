"""DeepCache (opt-in approximate mode; models/unet.py unet_apply docstring).

No reference counterpart — this is a beyond-reference serving feature (like
ops/tome.py): run the FULL UNet every Nth step, and in between only the
shallowest level, reusing the cached deep feature carried through the DDIM
scan. The core correctness property is that the shallow pass is the
IDENTICAL subgraph of the full pass: fed the same step's true deep feature
it must reproduce the full output bitwise.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu.guidance import GuidanceSpec
from complex_prompt_diffusion_tpu.models.unet import (
    UNetConfig,
    deepcache_default_block,
    init_unet,
    precompute_cross_kv,
    unet_apply,
)
from complex_prompt_diffusion_tpu.pipeline import (
    ModelBundle,
    RenderConfig,
    sample_latents,
)


@pytest.fixture(scope="module")
def tiny():
    cfg = UNetConfig.tiny()
    params = init_unet(jax.random.PRNGKey(0), cfg)
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.randn(2, 16, 16, 4), jnp.float32)
    t = jnp.asarray([5.0, 5.0])
    ctx = jnp.asarray(rs.randn(2, 7, 32), jnp.float32)
    return cfg, params, x, t, ctx


class TestUNetSplit:
    def test_default_block_sd15(self):
        # SD-1.5: 12 output blocks, 3 at the shallowest level -> split at 9
        assert deepcache_default_block(UNetConfig.sd15()) == 9

    def test_full_with_return_deep_matches_plain(self, tiny):
        cfg, params, x, t, ctx = tiny
        j0 = deepcache_default_block(cfg)
        out_full, _deep = unet_apply(cfg, params, x, t, ctx, return_deep_at=j0)
        out_ref = unet_apply(cfg, params, x, t, ctx)
        np.testing.assert_array_equal(np.asarray(out_full), np.asarray(out_ref))

    @pytest.mark.parametrize("j0", [0, 1, 2, 3])
    def test_shallow_bitexact_vs_full(self, tiny, j0):
        # the shallow retrieval pass fed the SAME step's true deep feature
        # executes the identical op subgraph -> bitwise equality
        cfg, params, x, t, ctx = tiny
        out_full, deep = unet_apply(cfg, params, x, t, ctx, return_deep_at=j0)
        out_shallow = unet_apply(
            cfg, params, x, t, ctx, deep_feature=deep, deep_at=j0
        )
        np.testing.assert_array_equal(
            np.asarray(out_shallow), np.asarray(out_full)
        )

    def test_shallow_with_hoisted_cross_kv(self, tiny):
        # the shallow pass must pick the right SUBSET of a full cross_kv
        # tuple (executed input prefix + executed output suffix)
        cfg, params, x, t, ctx = tiny
        j0 = deepcache_default_block(cfg)
        kv = precompute_cross_kv(cfg, params, ctx)
        out_full, deep = unet_apply(
            cfg, params, x, t, ctx, cross_kv=kv, return_deep_at=j0
        )
        out_shallow = unet_apply(
            cfg, params, x, t, ctx, cross_kv=kv, deep_feature=deep, deep_at=j0
        )
        np.testing.assert_array_equal(
            np.asarray(out_shallow), np.asarray(out_full)
        )
        # and the kv-fed full pass matches the plain one
        out_ref = unet_apply(cfg, params, x, t, ctx)
        np.testing.assert_array_equal(np.asarray(out_full), np.asarray(out_ref))

    def test_shallow_rejects_aux_interfaces(self, tiny):
        cfg, params, x, t, ctx = tiny
        j0 = deepcache_default_block(cfg)
        _, deep = unet_apply(cfg, params, x, t, ctx, return_deep_at=j0)
        with pytest.raises(ValueError, match="incompatible"):
            unet_apply(
                cfg, params, x, t, ctx,
                deep_feature=deep, deep_at=j0, return_skips=True,
            )
        with pytest.raises(ValueError, match="requires deep_at"):
            unet_apply(cfg, params, x, t, ctx, deep_feature=deep)

    def test_return_deep_out_of_range(self, tiny):
        cfg, params, x, t, ctx = tiny
        with pytest.raises(ValueError, match="out of range"):
            unet_apply(cfg, params, x, t, ctx, return_deep_at=99)


class TestRenderConfigValidation:
    @pytest.mark.parametrize(
        "name", ["DPM Fast", "DPM Adaptive", "UniPC", "dpm_solver", "iPNDM"]
    )
    def test_unsupported_samplers_rejected(self, name):
        with pytest.raises(ValueError, match="not supported"):
            RenderConfig(sampler=name, deepcache_interval=2)

    @pytest.mark.parametrize(
        "name",
        ["DDIM", "PLMS", "Euler", "Euler Ancestral", "Heun", "Huen",
         "DPM2", "DPM2 Ancestral", "DPM++ 2m", "DPM++ 2s Ancestral", "LMS"],
    )
    def test_supported_samplers_accepted(self, name):
        RenderConfig(sampler=name, deepcache_interval=2)

    def test_incompatible_with_tile(self):
        with pytest.raises(ValueError, match="unet_tile"):
            RenderConfig(deepcache_interval=2, unet_tile=32)

    def test_incompatible_with_attn_guide(self):
        from complex_prompt_diffusion_tpu.guidance import GuidanceConfig

        with pytest.raises(ValueError, match="attn_guide"):
            RenderConfig(
                deepcache_interval=2,
                guidance=GuidanceConfig(attn_guide=True),
            )

    def test_off_values_ok(self):
        RenderConfig(deepcache_interval=0)
        RenderConfig(deepcache_interval=1)
        RenderConfig(sampler="Euler", deepcache_interval=1)


class TestPipeline:
    @pytest.fixture(scope="class")
    def bundle(self):
        return ModelBundle.random("tiny")

    def _spec_and_noise(self, bundle):
        rs = np.random.RandomState(0)
        d = bundle.unet_cfg.context_dim
        spec = GuidanceSpec.single(
            jnp.asarray(rs.randn(7, d), jnp.float32),
            jnp.asarray(rs.randn(7, d), jnp.float32),
            1.0,
        )
        noises = jnp.asarray(rs.randn(4, 1, 8, 8, 4), jnp.float32)
        x_T = jnp.asarray(rs.randn(1, 8, 8, 4), jnp.float32)
        return spec, noises, x_T

    def test_interval2_runs_and_differs(self, bundle):
        spec, noises, x_T = self._spec_and_noise(bundle)
        kw = dict(width=64, height=64, batch_size=1, steps=4)
        x_exact = sample_latents(
            bundle, spec, RenderConfig(**kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        x_dc = sample_latents(
            bundle, spec, RenderConfig(deepcache_interval=2, **kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        assert np.isfinite(np.asarray(x_dc)).all()
        # retrieval steps approximate the deep path -> close, not equal
        assert not np.array_equal(np.asarray(x_dc), np.asarray(x_exact))

    def test_single_step_matches_exact(self, bundle):
        # steps=1: only the i=0 cache step runs, which IS the full UNet
        spec, noises, x_T = self._spec_and_noise(bundle)
        kw = dict(width=64, height=64, batch_size=1, steps=1)
        x_exact = sample_latents(
            bundle, spec, RenderConfig(**kw),
            x_init=jnp.array(x_T), noises=noises[:1],
        )
        x_dc = sample_latents(
            bundle, spec, RenderConfig(deepcache_interval=2, **kw),
            x_init=jnp.array(x_T), noises=noises[:1],
        )
        np.testing.assert_allclose(
            np.asarray(x_dc), np.asarray(x_exact), rtol=0, atol=1e-5
        )

    def test_plms_runs_and_differs(self, bundle):
        # PLMS threads the cache through both the AB history evals and the
        # first step's second (t_next) eval
        spec, noises, x_T = self._spec_and_noise(bundle)
        kw = dict(width=64, height=64, batch_size=1, steps=4, sampler="PLMS")
        x_exact = sample_latents(
            bundle, spec, RenderConfig(**kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        x_dc = sample_latents(
            bundle, spec, RenderConfig(deepcache_interval=2, **kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        assert np.isfinite(np.asarray(x_dc)).all()
        assert not np.array_equal(np.asarray(x_dc), np.asarray(x_exact))

    @pytest.mark.parametrize(
        "name",
        ["Euler", "Euler Ancestral", "Heun", "DPM2", "DPM2 Ancestral",
         "DPM++ 2m", "DPM++ 2s Ancestral", "LMS"],
    )
    def test_kdiff_runs_and_differs(self, bundle, name):
        # the den_state threads the k-diffusion scans (incl. the lax.cond
        # second evals in Heun/DPM2/2S)
        spec, noises, x_T = self._spec_and_noise(bundle)
        kw = dict(width=64, height=64, batch_size=1, steps=4, sampler=name)
        x_exact = sample_latents(
            bundle, spec, RenderConfig(**kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        x_dc = sample_latents(
            bundle, spec, RenderConfig(deepcache_interval=2, **kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        assert np.isfinite(np.asarray(x_dc)).all()
        assert not np.array_equal(np.asarray(x_dc), np.asarray(x_exact))

    def test_kdiff_interval1_equivalent_path_full_every_step(self, bundle):
        # steps=2, interval=2: step 0 full, step 1 shallow; Euler's first
        # step with interval covering all evals (steps=1) matches exact
        spec, noises, x_T = self._spec_and_noise(bundle)
        kw = dict(width=64, height=64, batch_size=1, steps=1, sampler="Euler")
        x_exact = sample_latents(
            bundle, spec, RenderConfig(**kw),
            x_init=jnp.array(x_T), noises=noises[:1],
        )
        x_dc = sample_latents(
            bundle, spec, RenderConfig(deepcache_interval=2, **kw),
            x_init=jnp.array(x_T), noises=noises[:1],
        )
        np.testing.assert_allclose(
            np.asarray(x_dc), np.asarray(x_exact), rtol=0, atol=1e-5
        )

    def test_kdiff_vparam(self, bundle):
        # sigma-space v-param conversion composes with the cached branches
        vb = dataclasses.replace(bundle, parameterization="v")
        spec, noises, x_T = self._spec_and_noise(bundle)
        x_dc = sample_latents(
            vb, spec,
            RenderConfig(
                width=64, height=64, batch_size=1, steps=2,
                sampler="DPM++ 2m", deepcache_interval=2,
            ),
            x_init=jnp.array(x_T), noises=noises[:2],
        )
        assert np.isfinite(np.asarray(x_dc)).all()

    def test_custom_block(self, bundle):
        spec, noises, x_T = self._spec_and_noise(bundle)
        x_dc = sample_latents(
            bundle, spec,
            RenderConfig(
                width=64, height=64, batch_size=1, steps=3,
                deepcache_interval=3, deepcache_block=1,
            ),
            x_init=jnp.array(x_T), noises=noises[:3],
        )
        assert np.isfinite(np.asarray(x_dc)).all()

    @pytest.mark.parametrize("name", ["DDIM", "Euler"])
    def test_img2img_composes(self, bundle, name):
        # partial-chain entry (t_start) with the cache: i is the 0-based
        # RUN iteration, so the first executed step is always a full pass
        from complex_prompt_diffusion_tpu.pipeline import img2img

        rs = np.random.RandomState(3)
        img = rs.randint(0, 255, (16, 16, 3), np.uint8)
        _, lat = img2img(
            bundle, img, "x",
            cfg=RenderConfig(
                width=64, height=64, steps=4, denoising_strength=0.6,
                sampler=name, deepcache_interval=2,
            ),
            decode=False,
        )
        assert np.isfinite(np.asarray(lat)).all()

    def test_vparam_bundle(self, bundle):
        # v-parameterization conversion composes with the cached branches
        vb = dataclasses.replace(bundle, parameterization="v")
        spec, noises, x_T = self._spec_and_noise(bundle)
        x_dc = sample_latents(
            vb, spec,
            RenderConfig(
                width=64, height=64, batch_size=1, steps=2,
                deepcache_interval=2,
            ),
            x_init=jnp.array(x_T), noises=noises[:2],
        )
        assert np.isfinite(np.asarray(x_dc)).all()


class TestDeepCacheBatchChunk:
    """Megabatch chunking inside the DeepCache closures (advisor r3): the
    chunked full/shallow pair — x/t/ctx/cross_kv AND the deep feature
    sliced along batch — must be numerically equivalent to the wide call,
    so batch>=8 DeepCache renders keep the B8 scheduling optimum."""

    @pytest.fixture(scope="class")
    def bundle(self):
        return ModelBundle.random("tiny")

    def _batch3(self, bundle, steps):
        rs = np.random.RandomState(1)
        d = bundle.unet_cfg.context_dim
        spec = GuidanceSpec.single(
            jnp.asarray(rs.randn(7, d), jnp.float32),
            jnp.asarray(rs.randn(7, d), jnp.float32),
            1.0,
        )
        noises = jnp.asarray(rs.randn(steps, 3, 8, 8, 4), jnp.float32)
        x_T = jnp.asarray(rs.randn(3, 8, 8, 4), jnp.float32)
        return spec, noises, x_T

    @pytest.mark.parametrize("name", ["DDIM", "Euler"])
    def test_chunked_matches_unchunked(self, bundle, name):
        # batch 3 + CFG -> megabatch 6; chunk 4 -> uneven [4, 2] sub-calls
        # splitting MID-SAMPLE across the uncond/cond factor boundary —
        # exercises deep-feature slicing in both passes
        spec, noises, x_T = self._batch3(bundle, 4)
        kw = dict(
            width=64, height=64, batch_size=3, steps=4, sampler=name,
            deepcache_interval=2,
        )
        ref = sample_latents(
            bundle, spec, RenderConfig(unet_batch_chunk=0, **kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        out = sample_latents(
            bundle, spec, RenderConfig(unet_batch_chunk=4, **kw),
            x_init=jnp.array(x_T), noises=noises,
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), atol=1e-3
        )

    def test_closure_pair_chunked_bitexact(self):
        # closure-level check: make_deepcache_unets(batch_chunk=2) on a
        # megabatch of 5 equals the wide call bit-for-bit per pass
        from complex_prompt_diffusion_tpu.models.unet import (
            make_deepcache_unets,
        )

        cfg = dataclasses.replace(UNetConfig.tiny(), dtype="float32")
        params = init_unet(jax.random.PRNGKey(0), cfg)
        rs = np.random.RandomState(2)
        x = jnp.asarray(rs.randn(5, 16, 16, 4), jnp.float32)
        t = jnp.full((5,), 7.0)
        ctx = jnp.asarray(rs.randn(5, 7, 32), jnp.float32)
        kv = precompute_cross_kv(cfg, params, ctx)

        wide_full, wide_shallow = make_deepcache_unets(
            cfg, params, None, cross_kv=kv
        )
        ch_full, ch_shallow = make_deepcache_unets(
            cfg, params, None, cross_kv=kv, batch_chunk=2
        )
        out_w, deep_w = wide_full(x, t, ctx)
        out_c, deep_c = ch_full(x, t, ctx)
        np.testing.assert_allclose(
            np.asarray(out_c), np.asarray(out_w), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(deep_c), np.asarray(deep_w), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(ch_shallow(x, t, ctx, deep_w)),
            np.asarray(wide_shallow(x, t, ctx, deep_w)),
            atol=1e-5,
        )


def test_make_denoiser_deepcache_requires_model_sigmas():
    # advisor r3: the sigma->t mapping is undefined without the model
    # sigma table; fail at build time, not mid-trace
    from complex_prompt_diffusion_tpu.guidance.cfg import (
        make_denoiser_deepcache,
    )

    spec = GuidanceSpec.single(
        jnp.zeros((7, 32), jnp.float32), jnp.zeros((7, 32), jnp.float32)
    )
    with pytest.raises(ValueError, match="model_sigmas"):
        make_denoiser_deepcache(
            lambda x, t, c: (x, x), lambda x, t, c, d: x, spec, interval=2
        )
