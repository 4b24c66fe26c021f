"""Neural networks: SD UNet, VAE (AutoencoderKL), CLIP text encoders.

Pure-functional JAX: every model is (init_fn -> params pytree,
apply_fn(params, ...) -> outputs). Layout is NHWC; compute dtype
is bf16 with f32 normalization statistics and f32 time/positional embeddings.

Reference parity targets:
  * UNet: /root/reference/cpd/models/unet.py:415 (CompVis UNetModel)
  * VAE: /root/reference/cpd/models/autoencoder.py:780 (AutoencoderKL)
  * CLIP: /root/reference/cpd/models/embedder.py:794/840 (Frozen(Open)CLIPEmbedder)
"""

from complex_prompt_diffusion_tpu.models.unet import (
    UNetConfig, deepcache_default_block, init_unet, make_deepcache_unets,
    precompute_cross_kv, unet_apply,
)
from complex_prompt_diffusion_tpu.models.vae import (
    VAEConfig,
    init_vae,
    vae_encode,
    vae_decode,
    DiagonalGaussian,
)
from complex_prompt_diffusion_tpu.models.clip import (
    CLIPTextConfig,
    init_clip_text,
    clip_text_apply,
    CLIPVisionConfig,
    init_clip_vision,
    clip_vision_apply,
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
)

__all__ = [
    "UNetConfig",
    "init_unet",
    "unet_apply",
    "precompute_cross_kv",
    "deepcache_default_block",
    "make_deepcache_unets",
    "VAEConfig",
    "init_vae",
    "vae_encode",
    "vae_decode",
    "DiagonalGaussian",
    "CLIPTextConfig",
    "init_clip_text",
    "clip_text_apply",
    "CLIPVisionConfig",
    "init_clip_vision",
    "clip_vision_apply",
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
]
