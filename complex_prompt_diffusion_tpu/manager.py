"""DiffusionModelManager: the top-level JSON-config API.

Parity target: /root/reference/cpd/manager.py:13-151 — checkpoint load ->
model bundle, ``process_txt2img(config)`` / ``process_img2img(...)`` driven
by a JSON config with ``{"sampler": {"name", "args"}, "prompt_json": {...},
"render": {...}}`` shape.

Differences:
  * no fp16-halving pass and no low-VRAM hook installation
    (manager.py:25-41) — weights live in device memory in bf16 via
    bundle.cast.
  * samplers resolve from the typed registry (no eval fallback).
  * the score corrector becomes the clip_sample / threshold_e options of the
    typed configs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from complex_prompt_diffusion_tpu.guidance import GuidanceConfig
from complex_prompt_diffusion_tpu.pipeline import (
    ModelBundle,
    RenderConfig,
    img2img,
    txt2img,
)
from complex_prompt_diffusion_tpu.prompts.compose import prompt_from_json
from complex_prompt_diffusion_tpu.samplers import get_sampler

__all__ = ["DiffusionModelManager"]


class DiffusionModelManager:
    """Load once, render many. Accepts either a checkpoint path or an
    existing ModelBundle (tests use ModelBundle.random)."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        bundle: Optional[ModelBundle] = None,
        cast_dtype: Optional[str] = None,
        vae_dtype: Optional[str] = None,
        vocab_path: Optional[str] = None,
    ):
        if bundle is None:
            if checkpoint_path is None:
                raise ValueError("need checkpoint_path or bundle")
            bundle = ModelBundle.from_checkpoint(checkpoint_path, vocab_path)
        if cast_dtype:
            bundle = bundle.cast(cast_dtype)
        if vae_dtype:
            bundle = bundle.cast_vae(vae_dtype)
        self.bundle = bundle

    # config assembly ----------------------------------------------------
    def _make_render_config(self, config: Dict[str, Any]) -> RenderConfig:
        sampler_cfg = config.get("sampler", {"name": "DDIM", "args": {}})
        name = sampler_cfg.get("name", "DDIM")
        get_sampler(name)  # validate early
        args = dict(sampler_cfg.get("args", {}))
        render = dict(config.get("render", {}))

        gkwargs = {}
        if "unconditional_guidance_scale" in render:
            gkwargs["guidance_scale"] = render.pop("unconditional_guidance_scale")
        if "scale" in render:
            gkwargs["guidance_scale"] = render.pop("scale")
        # score corrector -> eps thresholding (manager.py:84-93)
        corrector = render.pop("score_corrector", None)
        if corrector:
            gkwargs["threshold_e"] = corrector
            if "score_corrector_e_threshold" in render:
                gkwargs["threshold_e_value"] = render.pop("score_corrector_e_threshold")
        render.pop("score_corrector_x_threshold", None)

        known = {f.name for f in dataclasses.fields(RenderConfig)}
        merged = {**args, **render}
        # accept the reference's names for common options
        aliases = {
            "W": "width", "H": "height", "ddim_eta": "eta",
            "n_samples": "batch_size", "scheduler": "sigma_schedule",
        }
        for src, dst in aliases.items():
            if src in merged:
                merged[dst] = merged.pop(src)
        merged = {k: v for k, v in merged.items() if k in known}
        guidance = GuidanceConfig(**gkwargs) if gkwargs else GuidanceConfig()
        return RenderConfig(sampler=name, guidance=guidance, **merged)

    def _make_embedding(self, config: Dict[str, Any]):
        prompt_json = config.get("prompt_json")
        if prompt_json is not None:
            return prompt_from_json(prompt_json, bundle=self.bundle)
        return config.get("prompt", "")

    # entry points -------------------------------------------------------
    def process_txt2img(self, config: Dict[str, Any]) -> np.ndarray:
        """manager.py:52-66 semantics; returns uint8 images [B, H, W, 3]."""
        cfg = self._make_render_config(config)
        prompt = self._make_embedding(config)
        if isinstance(prompt, str):
            imgs, _ = txt2img(
                self.bundle, prompt, config.get("negative_prompt", ""), cfg
            )
        else:
            spec = prompt.build_spec(cfg.height // 8, cfg.width // 8, self.bundle)
            imgs, _ = txt2img(self.bundle, spec, cfg=cfg)
        return imgs

    def process_img2img(
        self, img: np.ndarray, config: Dict[str, Any],
        mask: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """manager.py:68-78 semantics. With ``mask``, runs RePaint-style
        inpainting over the masked region."""
        cfg = self._make_render_config(config)
        prompt = self._make_embedding(config)
        if mask is not None:
            if self.bundle.unet_cfg.in_channels >= 9:
                # finetuned inpaint model (LatentInpaintDiffusion): mask +
                # masked-image latents as extra UNet input channels
                from complex_prompt_diffusion_tpu.pipeline import inpaint

                spec_or_text = (
                    prompt
                    if isinstance(prompt, str)
                    else prompt.build_spec(
                        cfg.height // 8, cfg.width // 8, self.bundle
                    )
                )
                imgs, _ = inpaint(
                    self.bundle, img, mask, spec_or_text,
                    config.get("negative_prompt", ""), cfg,
                )
                return imgs
            return self._inpaint(img, mask, prompt, cfg, config)
        spec_or_text = (
            prompt
            if isinstance(prompt, str)
            else prompt.build_spec(cfg.height // 8, cfg.width // 8, self.bundle)
        )
        imgs, _ = img2img(
            self.bundle, img, spec_or_text, config.get("negative_prompt", ""), cfg
        )
        return imgs

    def _inpaint(self, img, mask, prompt, cfg: RenderConfig, config):
        import jax
        import jax.numpy as jnp

        from complex_prompt_diffusion_tpu.guidance import make_denoiser
        from complex_prompt_diffusion_tpu.pipeline import (
            decode_latents,
            encode_image,
            make_guidance_spec,
        )
        from complex_prompt_diffusion_tpu.samplers import sample_repaint
        from complex_prompt_diffusion_tpu import models as M

        spec = (
            make_guidance_spec(self.bundle, prompt, config.get("negative_prompt", ""))
            if isinstance(prompt, str)
            else prompt.build_spec(cfg.height // 8, cfg.width // 8, self.bundle)
        )
        z0 = encode_image(self.bundle, img)
        # latent-resolution mask; mask==1 keeps the original (repaint.py:279)
        m = jnp.asarray(mask, jnp.float32)
        if m.ndim == 2:
            m = m[None, :, :, None]
        m = jax.image.resize(m, z0.shape[:3] + (1,), method="nearest")
        m = jnp.broadcast_to(m, z0.shape)

        def unet_eps(x, t, ctx):
            return M.unet_apply(self.bundle.unet_cfg, self.bundle.unet_params, x, t, ctx)

        eps_fn, _ = make_denoiser(unet_eps, spec, gcfg=cfg.guidance)
        lat = sample_repaint(
            eps_fn, z0, m, self.bundle.tables,
            steps=cfg.steps,
            jump_length=config.get("jump_length", 10),
            jump_n_sample=config.get("jump_n_sample", 10),
            eta=cfg.eta if cfg.eta else 1.0,
            key=jax.random.PRNGKey(cfg.seed),
            uc_scale=cfg.guidance.guidance_scale,
        )
        return decode_latents(self.bundle, lat)
