"""Model tests: shapes with tiny configs + activation parity against the
torch reference (random weights converted through the checkpoint loader)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu import models as M
from complex_prompt_diffusion_tpu.models import params as P

import _oracle


class TestUNetShapes:
    def test_forward_shape(self):
        cfg = dataclasses.replace(M.UNetConfig.tiny(), dtype="float32")
        params = M.init_unet(jax.random.PRNGKey(0), cfg)
        x = jnp.zeros((2, 16, 16, 4))
        t = jnp.array([5, 10])
        ctx = jnp.zeros((2, 7, 32))
        out = M.unet_apply(cfg, params, x, t, ctx)
        assert out.shape == (2, 16, 16, 4)
        assert out.dtype == jnp.float32

    def test_skip_return_and_inject(self):
        cfg = dataclasses.replace(M.UNetConfig.tiny(), dtype="float32")
        params = M.init_unet(jax.random.PRNGKey(0), cfg)
        x = jnp.ones((1, 16, 16, 4))
        t = jnp.array([3])
        ctx = jnp.zeros((1, 7, 32))
        out, skips = M.unet_apply(cfg, params, x, t, ctx, return_skips=True)
        from complex_prompt_diffusion_tpu.models.unet import build_plan
        assert len(skips) == len(build_plan(cfg)[2])  # one per output block
        # re-injecting the same skips reproduces the output exactly
        out2 = M.unet_apply(
            cfg, params, x, t, ctx, inject_skips=skips, inject_skips_stop=99
        )
        np.testing.assert_allclose(np.asarray(out), np.asarray(out2), atol=1e-6)

    def test_precomputed_cross_kv_matches(self):
        """Hoisted cross-attention k/v (the per-render KV cache) must be
        bit-identical to the in-step projections — same _cross_kv math on
        the same context."""
        cfg = dataclasses.replace(M.UNetConfig.tiny(), dtype="float32")
        params = M.init_unet(jax.random.PRNGKey(0), cfg)
        key = jax.random.PRNGKey(7)
        x = jax.random.normal(key, (2, 16, 16, 4))
        t = jnp.array([5, 10])
        ctx = jax.random.normal(jax.random.fold_in(key, 1), (2, 7, 32))
        ref = M.unet_apply(cfg, params, x, t, ctx)
        kv = M.precompute_cross_kv(cfg, params, ctx)
        from complex_prompt_diffusion_tpu.models.unet import build_plan
        n_attn = sum(
            1
            for plan in (lambda i, m, o: list(i) + [m] + list(o))(
                *build_plan(cfg)
            )
            for desc in plan
            if desc[0] == "attn"
        )
        assert len(kv) == n_attn * cfg.transformer_depth
        out = M.unet_apply(cfg, params, x, t, ctx, cross_kv=kv)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


class TestVAEShapes:
    def test_roundtrip_shapes(self):
        cfg = M.VAEConfig.tiny()
        params = M.init_vae(jax.random.PRNGKey(0), cfg)
        x = jnp.zeros((1, 32, 32, 3))
        post = M.vae_encode(cfg, params, x)
        assert post.mean.shape == (1, 16, 16, 4)  # one downsample level
        z = post.mode()
        img = M.vae_decode(cfg, params, z)
        assert img.shape == (1, 32, 32, 3)

    def test_diagonal_gaussian(self):
        moments = jnp.concatenate(
            [jnp.ones((1, 2, 2, 4)), jnp.full((1, 2, 2, 4), -40.0)], axis=-1
        )
        g = M.DiagonalGaussian.from_moments(moments)
        assert float(g.logvar.min()) == -30.0  # clamped
        s = g.sample(jax.random.PRNGKey(0))
        np.testing.assert_allclose(np.asarray(s), np.asarray(g.mean), atol=1e-4)


class TestCLIPShapes:
    def test_layers(self):
        cfg = M.CLIPTextConfig.tiny()
        params = M.init_clip_text(jax.random.PRNGKey(0), cfg)
        tokens = jnp.array([[1, 5, 9, 999] + [0] * 73])
        z = M.clip_text_apply(cfg, params, tokens)
        assert z.shape == (1, 77, 64)
        zp = M.clip_text_apply(cfg, params, tokens, layer="penultimate")
        assert zp.shape == (1, 77, 64)
        assert not np.allclose(np.asarray(z), np.asarray(zp))
        pooled = M.clip_text_apply(cfg, params, tokens, layer="pooled")
        assert pooled.shape == (1, 64)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(pooled), axis=-1), 1.0, rtol=1e-5)

    def test_causality(self):
        # changing a later token must not affect earlier positions
        cfg = M.CLIPTextConfig.tiny()
        params = M.init_clip_text(jax.random.PRNGKey(0), cfg)
        t1 = jnp.array([[1, 5, 9, 12] + [0] * 73])
        t2 = t1.at[0, 3].set(800)
        z1 = M.clip_text_apply(cfg, params, t1)
        z2 = M.clip_text_apply(cfg, params, t2)
        np.testing.assert_allclose(
            np.asarray(z1[:, :3]), np.asarray(z2[:, :3]), atol=1e-5
        )
        assert not np.allclose(np.asarray(z1[:, 3]), np.asarray(z2[:, 3]))


@pytest.mark.skipif(_oracle.setup() is None, reason="reference oracle unavailable")
class TestReferenceParity:
    """Per-module activation parity vs the torch reference (SURVEY.md §4.3)."""

    def test_unet_parity(self):
        import torch

        from cpd.models.unet import UNetModel

        torch.manual_seed(0)
        ref = UNetModel(
            image_size=8, in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=[2, 1], channel_mult=[1, 2],
            num_heads=2, use_spatial_transformer=True, transformer_depth=1,
            context_dim=32, legacy=False,
        ).eval()

        x = torch.randn(2, 4, 16, 16)
        t = torch.tensor([3, 777])
        c = torch.randn(2, 7, 32)
        with torch.no_grad():
            ref_out = ref(x, t, c).numpy()

        cfg = dataclasses.replace(M.UNetConfig.tiny(), dtype="float32")
        sd = {k: v.numpy() for k, v in ref.state_dict().items()}
        params = P.convert_unet(cfg, sd, prefix="")
        out = M.unet_apply(
            cfg, params,
            jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
            jnp.asarray(t.numpy()),
            jnp.asarray(c.numpy()),
        )
        out_nchw = np.asarray(out).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(out_nchw, ref_out, atol=2e-4, rtol=2e-3)

    def test_unet_diffusers_layout_parity(self):
        """Diffusers-layout weights (UNet2DConditionModel, the reference's
        second model path: unet_2d_condition.py:50) loaded through the
        diffusers->CompVis key map must reproduce the reference's
        activations on our single CompVis-plan UNet."""
        import torch

        UNet2DConditionModel = _oracle.setup_diffusers_unet()
        if UNet2DConditionModel is None:
            pytest.skip("diffusers-clone oracle unavailable")

        torch.manual_seed(2)
        ref = UNet2DConditionModel(
            sample_size=16,
            in_channels=4,
            out_channels=4,
            down_block_types=("CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attention_dim=32,
            attention_head_dim=2,
        ).eval()

        x = torch.randn(2, 4, 16, 16)
        t = torch.tensor([3, 777])
        c = torch.randn(2, 7, 32)
        with torch.no_grad():
            ref_out = ref(x, t, c)
        ref_out = getattr(ref_out, "sample", ref_out)
        if isinstance(ref_out, (tuple, list)):
            ref_out = ref_out[0]
        ref_out = ref_out.numpy()

        cfg = dataclasses.replace(M.UNetConfig.tiny(), dtype="float32")
        sd = {k: v.numpy() for k, v in ref.state_dict().items()}
        params = P.convert_unet_diffusers(cfg, sd)
        out = M.unet_apply(
            cfg, params,
            jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
            jnp.asarray(t.numpy()),
            jnp.asarray(c.numpy()),
        )
        out_nchw = np.asarray(out).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(out_nchw, ref_out, atol=2e-4, rtol=2e-3)

    def test_vae_parity(self):
        import torch

        from cpd.models.autoencoder import Decoder, Encoder

        torch.manual_seed(1)
        ddconfig = dict(
            double_z=True, z_channels=4, resolution=32, in_channels=3,
            out_ch=3, ch=32, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=[], dropout=0.0,
        )
        enc = Encoder(**ddconfig).eval()
        dec = Decoder(**ddconfig).eval()

        x = torch.randn(1, 3, 32, 32)
        z = torch.randn(1, 4, 16, 16)
        with torch.no_grad():
            ref_moments = enc(x).numpy()
            ref_img = dec(z).numpy()

        cfg = M.VAEConfig.tiny()
        sd = {f"encoder.{k}": v.numpy() for k, v in enc.state_dict().items()}
        sd.update({f"decoder.{k}": v.numpy() for k, v in dec.state_dict().items()})
        # encoder/decoder only (no quant convs in this oracle) — convert manually
        params = {"encoder": None, "decoder": None}
        full = dict(sd)
        # fabricate identity quant convs so convert_vae can run
        eye8 = np.eye(8, dtype=np.float32).reshape(8, 8, 1, 1)
        eye4 = np.eye(4, dtype=np.float32).reshape(4, 4, 1, 1)
        full["quant_conv.weight"] = eye8
        full["quant_conv.bias"] = np.zeros(8, np.float32)
        full["post_quant_conv.weight"] = eye4
        full["post_quant_conv.bias"] = np.zeros(4, np.float32)
        params = P.convert_vae(cfg, full, prefix="")

        post = M.vae_encode(
            cfg, params, jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
        )
        moments = np.concatenate(
            [np.asarray(post.mean), np.asarray(post.logvar)], axis=-1
        ).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(moments, ref_moments, atol=2e-4, rtol=2e-3)

        img = M.vae_decode(cfg, params, jnp.asarray(z.numpy().transpose(0, 2, 3, 1)))
        np.testing.assert_allclose(
            np.asarray(img).transpose(0, 3, 1, 2), ref_img, atol=2e-4, rtol=2e-3
        )
