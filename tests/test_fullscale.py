"""Full-scale SD-1.5 checkpoint round-trip (VERDICT r1 item 4).

Synthesizes a complete CompVis SD-1.5 checkpoint — the EXACT reference key
set, produced by instantiating the reference's own torch modules at the real
config (860M-param UNet, full VAE, CLIP-L text tower) plus LitEma shadow
buffers — writes it with torch.save, loads it through load_sd_checkpoint,
and activation-parity-checks every tower against the torch reference.

Runs on CPU with random weights (no real checkpoints exist in this
air-gapped environment); spatial sizes are kept small (32x32 latents) to
bound single-core runtime — the weights and key mapping are full-scale.
"""

import os
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu import models as M
from complex_prompt_diffusion_tpu.models import params as P

import _oracle

pytestmark = [
    pytest.mark.skipif(
        _oracle.setup() is None, reason="reference oracle unavailable"
    ),
    # synthesized full-scale SD-1.5 checkpoint round-trips: tens of minutes
    # of CPU compile+run — the heavy tier (see pyproject [tool.pytest])
    pytest.mark.slow,
]


@pytest.fixture(scope="module")
def sd15_checkpoint(tmp_path_factory):
    """Build the full SD-1.5 checkpoint + the live torch modules."""
    import dataclasses

    import torch

    from cpd.models.unet import UNetModel
    from cpd.models.autoencoder import Decoder, Encoder
    from transformers import CLIPTextConfig as HFCLIPTextConfig
    from transformers import CLIPTextModel

    torch.manual_seed(0)
    # reference UNet at the real SD-1.5 config (config-1.49.yaml:28-43)
    unet = UNetModel(
        image_size=32, in_channels=4, out_channels=4, model_channels=320,
        num_res_blocks=2, attention_resolutions=[4, 2, 1],
        channel_mult=[1, 2, 4, 4], num_heads=8, use_spatial_transformer=True,
        transformer_depth=1, context_dim=768, legacy=False,
    ).eval()

    ddconfig = dict(
        double_z=True, z_channels=4, resolution=256, in_channels=3,
        out_ch=3, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
        attn_resolutions=[], dropout=0.0,
    )
    enc = Encoder(**ddconfig).eval()
    dec = Decoder(**ddconfig).eval()
    quant_conv = torch.nn.Conv2d(8, 8, 1)
    post_quant_conv = torch.nn.Conv2d(4, 4, 1)

    # CLIP-L text tower (SD-1.5's cond stage): width 768, 12 layers, 12
    # heads — built from an explicit config, no hub access needed
    clip = CLIPTextModel(
        HFCLIPTextConfig(
            hidden_size=768,
            intermediate_size=3072,
            num_hidden_layers=12,
            num_attention_heads=12,
            vocab_size=49408,
            max_position_embeddings=77,
        )
    ).eval()

    sd = {}
    for k, v in unet.state_dict().items():
        sd[f"model.diffusion_model.{k}"] = v
    for k, v in enc.state_dict().items():
        sd[f"first_stage_model.encoder.{k}"] = v
    for k, v in dec.state_dict().items():
        sd[f"first_stage_model.decoder.{k}"] = v
    for k, v in quant_conv.state_dict().items():
        sd[f"first_stage_model.quant_conv.{k}"] = v
    for k, v in post_quant_conv.state_dict().items():
        sd[f"first_stage_model.post_quant_conv.{k}"] = v
    for k, v in clip.state_dict().items():
        sd[f"cond_stage_model.transformer.{k}"] = v

    # LitEma shadows (ema.py:13-27: param name with dots stripped), values
    # deliberately different from the online weights
    for k, v in unet.state_dict().items():
        if v.dtype.is_floating_point:
            sd["model_ema.diffusion_model" + k.replace(".", "")] = v * 0.5
    sd["model_ema.num_updates"] = torch.tensor(100)
    sd["model_ema.decay"] = torch.tensor(0.9999)

    path = str(tmp_path_factory.mktemp("ckpt") / "sd15_random.ckpt")
    torch.save({"state_dict": sd}, path)
    return {
        "path": path, "unet": unet, "enc": enc, "dec": dec,
        "quant_conv": quant_conv, "post_quant_conv": post_quant_conv,
        "clip": clip,
    }


class TestFullScaleRoundTrip:
    def test_unet_parity_sd15(self, sd15_checkpoint):
        import torch

        bundle = P.load_sd_checkpoint(sd15_checkpoint["path"])
        assert bundle["version"] == "sd1"
        unet_cfg, unet_params = bundle["unet"]
        import dataclasses

        unet_cfg = dataclasses.replace(unet_cfg, dtype="float32")

        torch.manual_seed(1)
        x = torch.randn(1, 4, 32, 32)
        t = torch.tensor([500])
        c = torch.randn(1, 77, 768)
        with torch.no_grad():
            ref = sd15_checkpoint["unet"](x, t, c).numpy()

        out = M.unet_apply(
            unet_cfg, unet_params,
            jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
            jnp.asarray(t.numpy()), jnp.asarray(c.numpy()),
        )
        np.testing.assert_allclose(
            np.asarray(out).transpose(0, 3, 1, 2), ref, atol=1e-3, rtol=1e-2
        )

    def test_unet_ema_weights(self, sd15_checkpoint):
        plain = P.load_sd_checkpoint(sd15_checkpoint["path"], use_ema=False)
        ema = P.load_sd_checkpoint(sd15_checkpoint["path"], use_ema=True)
        a = plain["unet"][1]["time_embed"]["lin1"]["kernel"]
        b = ema["unet"][1]["time_embed"]["lin1"]["kernel"]
        np.testing.assert_allclose(b, a * 0.5, rtol=1e-6)

    def test_vae_parity_sd(self, sd15_checkpoint):
        import torch

        bundle = P.load_sd_checkpoint(sd15_checkpoint["path"])
        vae_cfg, vae_params = bundle["vae"]

        torch.manual_seed(2)
        img = torch.randn(1, 3, 64, 64)
        z = torch.randn(1, 4, 8, 8)
        with torch.no_grad():
            ref_moments = sd15_checkpoint["quant_conv"](
                sd15_checkpoint["enc"](img)
            ).numpy()
            ref_img = sd15_checkpoint["dec"](
                sd15_checkpoint["post_quant_conv"](z)
            ).numpy()

        post = M.vae_encode(
            vae_cfg, vae_params, jnp.asarray(img.numpy().transpose(0, 2, 3, 1))
        )
        got_moments = np.concatenate(
            [np.asarray(post.mean), np.asarray(post.logvar)], axis=-1
        )
        # our DiagonalGaussian clamps logvar to [-30, 20]; apply the same to
        # the reference moments before comparing
        ref_m = ref_moments.copy()
        ref_m[:, 4:] = np.clip(ref_m[:, 4:], -30.0, 20.0)
        np.testing.assert_allclose(
            got_moments.transpose(0, 3, 1, 2), ref_m, atol=1e-3, rtol=1e-2
        )
        got_img = M.vae_decode(
            vae_cfg, vae_params, jnp.asarray(z.numpy().transpose(0, 2, 3, 1))
        )
        np.testing.assert_allclose(
            np.asarray(got_img).transpose(0, 3, 1, 2), ref_img,
            atol=1e-3, rtol=1e-2,
        )

    def test_clip_parity_sd15(self, sd15_checkpoint):
        import torch

        bundle = P.load_sd_checkpoint(sd15_checkpoint["path"])
        clip_cfg, clip_params = bundle["clip"]

        ids = np.array([[49406, 320, 2368, 49407] + [49407] * 73])
        with torch.no_grad():
            ref = sd15_checkpoint["clip"](
                input_ids=torch.tensor(ids)
            ).last_hidden_state.numpy()

        out = M.clip_text_apply(clip_cfg, clip_params, jnp.asarray(ids))
        np.testing.assert_allclose(np.asarray(out), ref, atol=2e-4, rtol=2e-3)


class TestGoldenDrill:
    def test_golden_drill_roundtrip(self, sd15_checkpoint, tmp_path):
        """Real-weights day-1 drill (VERDICT r4 item 7): the one-command
        golden-latent procedure in scripts/demo_txt2img.py, exercised
        end-to-end against the synthesized full-scale checkpoint — record
        goldens, re-check them (PASS), then prove the check actually bites
        by perturbing the stored latents (FAIL)."""
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
        try:
            import demo_txt2img as demo
        finally:
            sys.path.pop(0)

        g = str(tmp_path / "golden.npz")
        common = [
            "--ckpt", sd15_checkpoint["path"], "--steps", "2",
            "--size", "256", "--sampler", "DDIM", "--seed", "3",
        ]
        rc = demo.main(common + ["--save-golden", g])
        assert rc == 0
        rc = demo.main(common + ["--golden", g])
        assert rc == 0, "fresh goldens must PASS against the same build"

        blob = dict(np.load(g, allow_pickle=True))
        blob["latents"] = blob["latents"] + 0.1
        np.savez(g, **blob)
        rc = demo.main(common + ["--golden", g])
        assert rc == 1, "perturbed goldens must FAIL"


class TestFullScaleLoopParity:
    def test_full_ddim_cfg_loop_sd15(self, sd15_checkpoint):
        """The north star at full scale (BASELINE: bit-stable latents vs the
        reference at fixed seed, injected noise): the reference's own
        DDIMSampler loop driving its real 860M-param UNet vs our loaded-
        checkpoint sample_latents — same weights, same x_T, same CFG 7.5.
        (Tiny-scale version: test_samplers.py
        test_full_ddim_cfg_loop_matches_reference; per-module full-scale
        parity: TestFullScaleRoundTrip. This composes both.)"""
        import dataclasses

        import torch

        from cpd.samplers.ddim import DDIMSampler

        from complex_prompt_diffusion_tpu.guidance import GuidanceSpec
        from complex_prompt_diffusion_tpu.pipeline import (
            ModelBundle, RenderConfig, sample_latents,
        )

        rng = np.random.default_rng(11)
        steps, hw = 2, 16  # 128px canvas bounds single-core CPU runtime
        x_T = rng.normal(size=(1, 4, hw, hw)).astype(np.float32)
        cond = rng.normal(size=(1, 77, 768)).astype(np.float32)
        uncond = rng.normal(size=(1, 77, 768)).astype(np.float32)

        class Empty(torch.nn.Module):
            pass

        model = {
            "unet": sd15_checkpoint["unet"],
            "vae": Empty(),
            "tokenizer": None,
            "decode": lambda z: z,
            "clip_new_model": Empty(),
        }
        sampler = DDIMSampler(model, logger=lambda *a: None)
        sampler.device = "cpu"
        with torch.no_grad():
            ref_out, _ = sampler.sample(
                steps, 1, (4, hw, hw),
                conditioning={
                    "and": [(1.0, torch.tensor(cond), None, torch.tensor(1.0))],
                    "not": [],
                },
                x_T=torch.tensor(x_T),
                unconditional_conditioning=torch.tensor(uncond),
                unconditional_guidance_scale=7.5,
                eta=0.0, verbose=False, silent=True,
            )
        ref_out = ref_out.numpy()

        bundle = ModelBundle.from_checkpoint(sd15_checkpoint["path"])
        bundle = dataclasses.replace(
            bundle,
            unet_cfg=dataclasses.replace(bundle.unet_cfg, dtype="float32"),
        )
        spec = GuidanceSpec.single(
            jnp.asarray(cond[0]), jnp.asarray(uncond[0])
        )
        cfg = RenderConfig(steps=steps, width=hw * 8, height=hw * 8)
        lat = sample_latents(
            bundle, spec, cfg,
            x_init=jnp.asarray(x_T.transpose(0, 2, 3, 1)),
        )
        # tolerance: per-module full-scale parity is ~1e-3 (above); the
        # CFG combine multiplies module noise by scale 7.5 and the x0-pred
        # coefficients by up to ~2x per step, so two steps compound to the
        # observed ~1-2% relative divergence between independent f32
        # op orders. Wiring errors (timesteps, CFG signs, update coeffs)
        # diverge at O(1) and still fail loudly at this tolerance.
        np.testing.assert_allclose(
            np.asarray(lat).transpose(0, 3, 1, 2), ref_out,
            atol=0.06, rtol=0.02,
        )
