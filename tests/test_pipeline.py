"""End-to-end pipeline tests on tiny random models: txt2img/img2img across
sampler families, manager JSON API, guidance variants, render engine,
null-text inversion, depth conditioning."""

import dataclasses

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu import models as M
from complex_prompt_diffusion_tpu.guidance import GuidanceConfig
from complex_prompt_diffusion_tpu.pipeline import (
    ModelBundle,
    RenderConfig,
    img2img,
    make_guidance_spec,
    sample_latents,
    txt2img,
)


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.random("tiny")


def _cfg(**kw):
    kw.setdefault("steps", 3)
    kw.setdefault("width", 32)
    kw.setdefault("height", 32)
    return RenderConfig(**kw)


class TestTxt2Img:
    def test_ddim(self, bundle):
        imgs, lat = txt2img(bundle, "a cat", "blurry", _cfg())
        assert imgs.dtype == np.uint8
        assert lat.shape == (1, 4, 4, 4)
        assert np.isfinite(np.asarray(lat)).all()

    def test_non_multiple_of_8_rejected(self, bundle):
        # latent_shape floor-divides by 8, so W=33 used to slip past the
        # latent divisibility check and silently render at 32 (found via a
        # verification probe)
        with pytest.raises(ValueError, match="multiples of"):
            txt2img(bundle, "a cat", cfg=_cfg(width=33), decode=False)
        with pytest.raises(ValueError, match="multiples of"):
            txt2img(bundle, "a cat", cfg=_cfg(height=20), decode=False)

    def test_deterministic_per_seed(self, bundle):
        _, a = txt2img(bundle, "a cat", cfg=_cfg(seed=5), decode=False)
        _, b = txt2img(bundle, "a cat", cfg=_cfg(seed=5), decode=False)
        _, c = txt2img(bundle, "a cat", cfg=_cfg(seed=6), decode=False)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert not np.allclose(np.asarray(a), np.asarray(c))

    @pytest.mark.parametrize("sampler", [
        "PLMS", "Euler", "Euler Ancestral", "Huen", "DPM++ 2m", "LMS",
        "DPM2", "DPM Fast", "dpm_solver", "UniPC",
    ])
    def test_sampler_zoo(self, bundle, sampler):
        cfg = _cfg(sampler=sampler, sigma_schedule="karras" if sampler[0].isupper() and sampler not in ("PLMS", "UniPC") else "default")
        if sampler in ("PLMS", "dpm_solver", "UniPC"):
            cfg = _cfg(sampler=sampler)
        _, lat = txt2img(bundle, "a cat", cfg=cfg, decode=False)
        assert np.isfinite(np.asarray(lat)).all(), sampler

    @pytest.mark.parametrize("kw", [
        dict(sampler="UniPC", unipc_variant="vary_coeff"),
        dict(sampler="UniPC", unipc_variant="bh1", solver_order=3),
        dict(sampler="dpm_solver", solver_method="adaptive"),
        dict(sampler="dpm_solver", solver_method="singlestep", solver_order=3),
    ])
    def test_solver_family_knobs(self, bundle, kw):
        _, lat = txt2img(bundle, "a cat", cfg=_cfg(**kw), decode=False)
        assert np.isfinite(np.asarray(lat)).all(), kw

    def test_solver_knob_validation(self):
        with pytest.raises(ValueError, match="unipc_variant"):
            RenderConfig(unipc_variant="bh3")
        with pytest.raises(ValueError, match="solver_method"):
            RenderConfig(solver_method="nope")
        with pytest.raises(ValueError, match="adaptive"):
            RenderConfig(solver_method="adaptive", solver_order=1)
        with pytest.raises(ValueError, match="solver_order"):
            RenderConfig(solver_order=4)

    def test_injected_noise_reproducible(self, bundle):
        cfg = _cfg(eta=1.0)
        from complex_prompt_diffusion_tpu import schedules as S

        it = S.make_inference_tables(bundle.tables, cfg.steps, eta=1.0)
        noises = np.random.default_rng(0).normal(size=(it.num_steps, 1, 4, 4, 4)).astype(np.float32)
        _, a = txt2img(bundle, "x", cfg=cfg, noises=jnp.asarray(noises), decode=False)
        _, b = txt2img(bundle, "x", cfg=cfg, noises=jnp.asarray(noises), decode=False)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_thresholded_sampling(self, bundle):
        cfg = _cfg(clip_sample="dynamic_thresholding", clip_sample_thresh=95.0)
        _, lat = txt2img(bundle, "a cat", cfg=cfg, decode=False)
        assert np.isfinite(np.asarray(lat)).all()

    @pytest.mark.parametrize("cast", ["cast", "cast_vae"])
    def test_cast_bundle_traces_its_own_program(self, cast):
        # a cast copy must not reuse the source bundle's cached sampling
        # program (keyed by RenderConfig, traced for the source dtype)
        b32 = ModelBundle.random("tiny")
        _, ref = txt2img(b32, "a cat", cfg=_cfg(seed=4), decode=False)
        b16 = getattr(b32, cast)("bfloat16")
        assert b16._jit_cache is not b32._jit_cache
        _, lat16 = txt2img(b16, "a cat", cfg=_cfg(seed=4), decode=False)
        _, again = txt2img(b32, "a cat", cfg=_cfg(seed=4), decode=False)
        np.testing.assert_array_equal(np.asarray(again), np.asarray(ref))
        if cast == "cast":
            assert not np.array_equal(np.asarray(lat16), np.asarray(ref))

    def test_guidance_options(self, bundle):
        g = GuidanceConfig(
            guidance_scale=5.0, decay_scale=True, decay_scale_start=1,
            dynamic_scale_clip=True, uc_blur=True, uc_blur_k=3,
            threshold_e="dynamic_thresholding",
        )
        _, lat = txt2img(bundle, "a cat", cfg=_cfg(guidance=g), decode=False)
        assert np.isfinite(np.asarray(lat)).all()


class TestImg2Img:
    def test_roundtrip(self, bundle):
        imgs, _ = txt2img(bundle, "a cat", cfg=_cfg())
        out, lat = img2img(bundle, imgs[0], "a dog", cfg=_cfg(denoising_strength=0.5))
        assert np.isfinite(np.asarray(lat)).all()

    def test_sigma_family_img2img(self, bundle):
        imgs, _ = txt2img(bundle, "a cat", cfg=_cfg())
        out, lat = img2img(
            bundle, imgs[0], "a dog",
            cfg=_cfg(sampler="Euler", denoising_strength=0.5),
        )
        assert np.isfinite(np.asarray(lat)).all()

    def test_strength_monotonic(self, bundle):
        """t-family: higher denoising_strength must move the output FURTHER
        from the input (strength*steps denoise steps, diffusion.py:118 —
        round 1 had this inverted)."""
        from complex_prompt_diffusion_tpu.pipeline import encode_image

        imgs, _ = txt2img(bundle, "a cat", cfg=_cfg(seed=3))
        z0 = np.asarray(encode_image(bundle, imgs[0], key=jax.random.PRNGKey(0)))
        dists = []
        for strength in (0.2, 0.6, 0.95):
            _, lat = img2img(
                bundle, imgs[0], "a dog",
                cfg=_cfg(steps=10, denoising_strength=strength, seed=3),
                decode=False,
            )
            dists.append(float(np.linalg.norm(np.asarray(lat) - z0)))
        assert dists[0] < dists[1] < dists[2], dists


class TestUnetBatchChunk:
    """RenderConfig.unet_batch_chunk splits the CFG megabatch into
    sequential UNet calls. Must be numerically equivalent to the single
    wide call."""

    def test_chunked_matches_unchunked(self, bundle):
        # batch 3 + CFG -> megabatch 6; chunk 4 -> uneven [4, 2] sub-calls
        # (covers the remainder chunk), incl. the hoisted cross-kv slicing
        _, ref = txt2img(
            bundle, "a cat", "blurry",
            cfg=_cfg(batch_size=3, unet_batch_chunk=0), decode=False,
        )
        _, out = txt2img(
            bundle, "a cat", "blurry",
            cfg=_cfg(batch_size=3, unet_batch_chunk=4), decode=False,
        )
        # reassociation noise only (latent scale ~40): a slicing bug
        # would show O(1) differences
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), atol=1e-3
        )

    def test_sigma_family_chunked(self, bundle):
        _, ref = txt2img(
            bundle, "a cat",
            cfg=_cfg(sampler="Euler", batch_size=2, unet_batch_chunk=0),
            decode=False,
        )
        _, out = txt2img(
            bundle, "a cat",
            cfg=_cfg(sampler="Euler", batch_size=2, unet_batch_chunk=2),
            decode=False,
        )
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), atol=1e-3
        )

    def test_validation(self):
        with pytest.raises(ValueError, match="unet_batch_chunk"):
            _cfg(unet_batch_chunk=-1)


class TestInpaintModel:
    """Finetuned inpaint family (LatentInpaintDiffusion, ddpm.py:1802)."""

    def test_inpaint_runs_and_mask_matters(self):
        from complex_prompt_diffusion_tpu.pipeline import inpaint

        b = ModelBundle.random("tiny-inpaint")
        assert b.unet_cfg.in_channels == 9
        # tiny VAE downsamples 2x (not 8x): an 8x8 image gives the 4x4
        # latent grid that _cfg()'s 32x32 render expects
        img = (np.random.default_rng(0).random((8, 8, 3)) * 255).astype(np.uint8)
        mask_a = np.zeros((8, 8), np.float32)
        mask_a[2:6, 2:6] = 1.0
        mask_b = np.zeros((8, 8), np.float32)
        mask_b[0:2, 0:2] = 1.0
        out, lat_a = inpaint(b, img, mask_a, "a cat", cfg=_cfg(seed=4))
        assert out.dtype == np.uint8
        assert np.isfinite(np.asarray(lat_a)).all()
        _, lat_b = inpaint(b, img, mask_b, "a cat", cfg=_cfg(seed=4), decode=False)
        # the mask + masked-image channels condition the UNet
        assert not np.allclose(np.asarray(lat_a), np.asarray(lat_b))

    def test_plain_bundle_rejected(self, bundle):
        from complex_prompt_diffusion_tpu.pipeline import inpaint

        img = np.zeros((32, 32, 3), np.uint8)
        mask = np.ones((32, 32), np.float32)
        with pytest.raises(ValueError, match="not an inpaint model"):
            inpaint(bundle, img, mask, "a cat", cfg=_cfg())

    def test_zero_extend_input_conv(self):
        from complex_prompt_diffusion_tpu.models.params import (
            zero_extend_input_conv,
        )

        rng = np.random.default_rng(1)
        w = rng.normal(size=(32, 4, 3, 3)).astype(np.float32)
        sd = {
            "model.diffusion_model.input_blocks.0.0.weight": w,
            "model_ema.diffusion_modelinput_blocks00weight": w * 0.5,
        }
        out = zero_extend_input_conv(sd, 9)
        nw = out["model.diffusion_model.input_blocks.0.0.weight"]
        assert nw.shape == (32, 9, 3, 3)
        np.testing.assert_array_equal(nw[:, :4], w)
        np.testing.assert_array_equal(nw[:, 4:], 0.0)
        ne = out["model_ema.diffusion_modelinput_blocks00weight"]
        np.testing.assert_array_equal(ne[:, :4], w * 0.5)

    def test_zero_extended_model_ignores_concat(self):
        """Seeding per ddpm.py:1700-1711: with zero-initialized extra input
        channels, the 9-ch model must reproduce the base 4-ch model exactly,
        whatever the concat conditioning contains."""
        cfg4 = dataclasses.replace(M.UNetConfig.tiny(), dtype="float32")
        cfg9 = dataclasses.replace(cfg4, in_channels=9)
        import copy

        p4 = M.init_unet(jax.random.PRNGKey(0), cfg4)
        # graft: all weights shared except the widened, zero-padded input conv
        p9 = copy.deepcopy(p4)
        k4 = p4["input_blocks"][0][0]["kernel"]  # HWIO
        k9 = np.zeros(k4.shape[:2] + (9, k4.shape[3]), np.float32)
        k9[:, :, :4, :] = np.asarray(k4)
        p9["input_blocks"][0][0] = dict(
            p4["input_blocks"][0][0], kernel=jnp.asarray(k9)
        )
        x = jax.random.normal(jax.random.PRNGKey(2), (1, 16, 16, 4))
        extra = jax.random.normal(jax.random.PRNGKey(3), (1, 16, 16, 5))
        t = jnp.array([7])
        ctx = jax.random.normal(jax.random.PRNGKey(4), (1, 7, 32))
        base = M.unet_apply(cfg4, p4, x, t, ctx)
        wide = M.unet_apply(
            cfg9, p9, jnp.concatenate([x, extra], -1), t, ctx
        )
        np.testing.assert_allclose(
            np.asarray(base), np.asarray(wide), atol=1e-5
        )

    def test_manager_dispatch_inpaint_model(self):
        from complex_prompt_diffusion_tpu.manager import DiffusionModelManager

        mgr = DiffusionModelManager(bundle=ModelBundle.random("tiny-inpaint"))
        img = (np.random.default_rng(2).random((8, 8, 3)) * 255).astype(np.uint8)
        mask = np.zeros((8, 8), np.float32)
        mask[2:6, 2:6] = 1.0
        out = mgr.process_img2img(
            img,
            {"sampler": {"name": "DDIM"}, "prompt": "a cat",
             "render": {"steps": 3, "W": 32, "H": 32}},
            mask=mask,
        )
        assert out.dtype == np.uint8 and np.isfinite(out).all()


class TestDepthConditioning:
    def test_depth2img_unet(self):
        # 5-channel tiny UNet + depth mask channel (ddim.py:274-276 semantics)
        unet_cfg = dataclasses.replace(
            M.UNetConfig.tiny(context_dim=64), in_channels=5, dtype="float32"
        )
        b = ModelBundle.random("tiny")
        b = dataclasses.replace(
            b, unet_cfg=unet_cfg,
            unet_params=M.init_unet(jax.random.PRNGKey(1), unet_cfg),
        )
        depth = jnp.ones((4, 4, 1), jnp.float32) * 0.3
        _, lat = txt2img(bundle=b, prompt="a cat", cfg=_cfg(), depth_mask=depth, decode=False)
        assert np.isfinite(np.asarray(lat)).all()


class TestManager:
    def test_json_surface(self, bundle):
        from complex_prompt_diffusion_tpu.manager import DiffusionModelManager

        mgr = DiffusionModelManager(bundle=bundle)
        imgs = mgr.process_txt2img(
            {
                "sampler": {"name": "DDIM", "args": {"eta": 0.0}},
                "prompt": "a cat",
                "render": {"steps": 3, "W": 32, "H": 32, "scale": 5.0},
            }
        )
        assert imgs.shape[0] == 1

    def test_json_solver_knobs(self, bundle):
        """The continuous-time solver knobs flow through the JSON surface
        (manager merges any RenderConfig field from sampler args)."""
        from complex_prompt_diffusion_tpu.manager import DiffusionModelManager

        mgr = DiffusionModelManager(bundle=bundle)
        imgs = mgr.process_txt2img({
            "sampler": {"name": "UniPC", "args": {
                "unipc_variant": "vary_coeff", "solver_order": 2}},
            "prompt": "a cat",
            "render": {"steps": 3, "W": 32, "H": 32},
        })
        assert imgs.shape[0] == 1
        imgs = mgr.process_txt2img({
            "sampler": {"name": "dpm_solver", "args": {
                "solver_method": "adaptive"}},
            "prompt": "a cat",
            "render": {"steps": 3, "W": 32, "H": 32},
        })
        assert imgs.shape[0] == 1

    def test_vae_dtype_cast(self, bundle):
        # opt-in bf16 autoencoder — same latents must decode to nearly the
        # same image as the f32 reference
        import jax.numpy as jnp

        from complex_prompt_diffusion_tpu.manager import DiffusionModelManager
        from complex_prompt_diffusion_tpu.pipeline import decode_latents

        mgr = DiffusionModelManager(bundle=bundle, vae_dtype="bfloat16")
        vb = mgr.bundle
        assert vb.vae_cfg.compute_dtype == jnp.bfloat16
        assert vb.vae_params["decoder"]["conv_in"]["kernel"].dtype == jnp.bfloat16
        lat = jax.random.normal(jax.random.PRNGKey(3), (1, 4, 4, 4), jnp.float32)
        img_b = decode_latents(vb, lat).astype(np.int32)
        img_f = decode_latents(bundle, lat).astype(np.int32)
        assert img_b.shape == img_f.shape and img_b.dtype == img_f.dtype
        # u8 images: bf16 rounding may move pixels by a few levels
        assert np.abs(img_b - img_f).max() <= 8

    def test_prompt_json(self, bundle):
        from complex_prompt_diffusion_tpu.manager import DiffusionModelManager

        mgr = DiffusionModelManager(bundle=bundle)
        imgs = mgr.process_txt2img(
            {
                "sampler": {"name": "DDIM", "args": {}},
                "prompt_json": {
                    "class": "CompositionalPrompt",
                    "prompt": "a forest",
                    "scale": 1.0,
                    "conjunctions": [
                        {"class": "ComplexPrompt", "prompt": "a river", "scale": 0.5}
                    ],
                    "negations": [],
                },
                "render": {"steps": 3, "W": 32, "H": 32},
            }
        )
        assert imgs.shape[0] == 1

    def test_inpaint(self, bundle):
        from complex_prompt_diffusion_tpu.manager import DiffusionModelManager

        mgr = DiffusionModelManager(bundle=bundle)
        img = np.zeros((8, 8, 3), np.uint8)
        mask = np.ones((8, 8), np.float32)
        mask[:, 4:] = 0.0  # inpaint right half
        out = mgr.process_img2img(
            img,
            {"sampler": {"name": "DDIM"}, "prompt": "sky",
             "render": {"steps": 4, "W": 32, "H": 32}},
            mask=mask,
        )
        assert out.shape[-1] == 3


class TestRenderEngine:
    def test_path_render(self, bundle):
        from complex_prompt_diffusion_tpu.prompts import ComplexPrompt
        from complex_prompt_diffusion_tpu.render import RenderEngine

        p = ComplexPrompt("a cat", bundle=bundle)
        p.add_prompt_lerp("a dog", magnitude=1.0, lerp_keys=["magnitude"])
        eng = RenderEngine(bundle, _cfg())
        frames = eng.render_path(p, lerp_steps=2)
        assert len(frames) == 2
        assert frames[0].dtype == np.uint8

    def test_stream_matches_unpipelined(self, bundle):
        # VERDICT r3 item 2: the streamed scan/decode pipeline reorders only
        # the HOST materialization — the images must equal rendering and
        # decoding each frame synchronously with the same per-frame keys
        import jax

        from complex_prompt_diffusion_tpu.prompts import ComplexPrompt
        from complex_prompt_diffusion_tpu.render import RenderEngine
        from complex_prompt_diffusion_tpu.pipeline import (
            decode_latents, sample_latents,
        )

        cfg = _cfg(batch_size=2)
        p = ComplexPrompt("a cat", bundle=bundle)
        p.add_prompt_lerp("a dog", magnitude=1.0, lerp_keys=["magnitude"])
        key = jax.random.PRNGKey(cfg.seed)
        eng = RenderEngine(bundle, cfg)
        frames = eng.render_path(p, lerp_steps=3)
        assert len(frames) == 6  # 3 frames x batch 2

        path = p.embedding_path(steps=3, bundle=bundle)
        uncond = p.uncond_embedding(bundle)
        ref = []
        for i, cond in enumerate(path):
            spec = eng._spec_for(cond, uncond)
            lat = sample_latents(
                bundle, spec, cfg, key=jax.random.fold_in(key, i)
            )
            ref.extend(decode_latents(bundle, lat))
        for got, want in zip(frames, ref):
            np.testing.assert_array_equal(got, want)

    def test_feedback_render(self, bundle):
        from complex_prompt_diffusion_tpu.prompts import ComplexPrompt
        from complex_prompt_diffusion_tpu.render import RenderEngine

        p = ComplexPrompt("a cat", bundle=bundle)
        p.add_prompt_lerp("a dog", magnitude=1.0, lerp_keys=["magnitude"])
        eng = RenderEngine(bundle, _cfg(denoising_strength=0.5))
        frames = eng.render_path(p, lerp_steps=2, feedback=True, coherance=0.9)
        assert len(frames) == 2


class TestNullInversion:
    def test_inversion_and_optimization(self, bundle):
        from complex_prompt_diffusion_tpu import schedules as S
        from complex_prompt_diffusion_tpu.prompts.null_inversion import (
            null_text_inversion,
        )

        it = S.make_inference_tables(bundle.tables, 3)
        cond = jnp.asarray(
            np.random.default_rng(0).normal(size=(1, 77, 64)), jnp.float32
        )
        uncond = jnp.zeros((1, 77, 64))

        def unet(x, t, ctx):
            return M.unet_apply(
                bundle.unet_cfg, bundle.unet_params, x,
                jnp.broadcast_to(t, (x.shape[0],)), ctx,
            )

        def cond_eps(x, t):
            return unet(x, t, cond)

        def cfg_eps(x, t, u):
            return unet(x, t, u), unet(x, t, cond)

        z0 = 0.2 * jnp.asarray(
            np.random.default_rng(1).normal(size=(1, 4, 4, 4)), jnp.float32
        )
        x_T, unconds = null_text_inversion(
            cond_eps, cfg_eps, z0, uncond, it, num_inner_steps=2
        )
        assert unconds.shape[0] == it.num_steps
        assert np.isfinite(np.asarray(x_T)).all()
        assert np.isfinite(np.asarray(unconds)).all()


class TestDAAM:
    def test_heat_maps(self, bundle):
        import jax
        import jax.numpy as jnp

        from complex_prompt_diffusion_tpu.guidance.daam import word_heat_map

        x = jax.random.normal(jax.random.PRNGKey(0), (1, 4, 4, 4))
        ctx = jax.random.normal(jax.random.PRNGKey(1), (1, 7, 64))
        out, maps = M.unet_apply(
            bundle.unet_cfg, bundle.unet_params, x, jnp.asarray([5.0]), ctx,
            collect_attn_maps=True,
        )
        assert len(maps) > 0
        for m in maps:
            assert m.shape[0] == 1 and m.shape[-1] == 7
            # probabilities sum to 1 over tokens
            np.testing.assert_allclose(
                np.asarray(m.sum(axis=-1)), 1.0, atol=1e-3
            )
        hm = word_heat_map(maps, [2, 3], out_size=8)
        assert hm.shape == (8, 8)
        assert 0.0 <= float(hm.min()) and float(hm.max()) <= 1.0


class TestStepCallback:
    """step_callback uses jax.debug.callback; each case runs on the CPU
    backend in a subprocess, like the multichip tests."""

    def _run(self, code):
        import os, subprocess, sys, textwrap

        env = {
            **os.environ,
            "JAX_PLATFORMS": "cpu",
            "HF_HUB_OFFLINE": "1",
        }
        return subprocess.run(
            [sys.executable, "-c", textwrap.dedent(code)],
            env=env, capture_output=True, text=True, timeout=520,
            cwd=Path(__file__).resolve().parents[1],
        )

    def test_txt2img_callback_frames(self):
        r = self._run("""
            import jax, numpy as np
            from complex_prompt_diffusion_tpu.pipeline import (
                ModelBundle, RenderConfig, txt2img)
            from complex_prompt_diffusion_tpu.samplers.callbacks import (
                make_render_callback)
            b = ModelBundle.random("tiny")
            cb = make_render_callback()
            cfg = RenderConfig(steps=4, width=32, height=32)
            txt2img(b, "a cat", cfg=cfg, decode=False, step_callback=cb)
            jax.effects_barrier()
            assert cb.count == 4, cb.count
            assert len(cb.frames) == 4
            assert cb.frames[0].dtype == np.uint8
            assert cb.frames[0].shape == (4, 4, 3), cb.frames[0].shape
            print("OK")
        """)
        assert "OK" in r.stdout, r.stderr[-2000:]

    def test_sigma_family_callback(self):
        r = self._run("""
            import jax
            from complex_prompt_diffusion_tpu.pipeline import (
                ModelBundle, RenderConfig, txt2img)
            seen = []
            b = ModelBundle.random("tiny")
            cfg = RenderConfig(steps=4, width=32, height=32, sampler="Euler")
            txt2img(b, "a cat", cfg=cfg, decode=False,
                    step_callback=lambda s, d: seen.append(float(s)))
            jax.effects_barrier()
            assert len(seen) == 4, seen
            assert seen == sorted(seen, reverse=True), seen
            print("OK")
        """)
        assert "OK" in r.stdout, r.stderr[-2000:]
