"""CLIP text transformers (SD conditioning encoders), functional JAX.

Covers the reference's embedder zoo (/root/reference/cpd/models/embedder.py):
  * FrozenCLIPEmbedder (:794-837) — HF CLIP ViT-L/14 text tower (SD 1.x):
    12 layers, d=768, quick_gelu, ``layer`` in {last, pooled, hidden}.
  * FrozenOpenCLIPEmbedder (:840-899) — OpenCLIP ViT-H text tower (SD 2.x):
    24 layers, d=1024, gelu, ``layer`` = penultimate (stop 1 layer early).
  * FrozenCLIPTextEmbedder (:920-949) — the "guide" CLIP used for CLIP
    guidance: pooled embedding through text_projection, L2-normalized.

One implementation parameterized by :class:`CLIPTextConfig`. The text
transformer is causal; sequence length is fixed at 77, so attention runs as
a plain XLA matmul chain (a 77x77 score tile is tiny; fused attention buys
nothing here).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu.models import layers as L

__all__ = [
    "CLIPTextConfig",
    "init_clip_text",
    "clip_text_apply",
    "CLIPVisionConfig",
    "init_clip_vision",
    "clip_vision_apply",
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
]

# CLIP preprocessing constants (reference ddim.py:62-66)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    mlp_ratio: int = 4
    activation: str = "quick_gelu"  # "quick_gelu" (CLIP-L) | "gelu" (OpenCLIP-H)
    projection_dim: Optional[int] = None  # text_projection for guide CLIP
    dtype: str = "float32"

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        """CLIP ViT-L/14 text tower (openai/clip-vit-large-patch14)."""
        return CLIPTextConfig()

    @staticmethod
    def sd21() -> "CLIPTextConfig":
        """OpenCLIP ViT-H/14 text tower (laion2b_s32b_b79k)."""
        return CLIPTextConfig(
            hidden_size=1024, num_layers=24, num_heads=16, activation="gelu"
        )

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4
        )

    @property
    def compute_dtype(self):
        return jnp.dtype(self.dtype)


def init_clip_text(key, cfg: CLIPTextConfig, *, commit: bool = True):
    """Random CLIP text params. Built host-side in numpy and committed
    with ONE ``jax.device_put`` unless ``commit=False`` (callers that
    post-process host-side, e.g. ModelBundle.random, commit themselves)."""
    d = cfg.hidden_size
    rng = L.as_np_rng(key)
    nk = lambda: rng  # noqa: E731
    import numpy as _np

    params = {
        "token_embedding": (
            rng.normal(size=(cfg.vocab_size, d)) * 0.02
        ).astype(_np.float32),
        "position_embedding": (
            rng.normal(size=(cfg.max_length, d)) * 0.01
        ).astype(_np.float32),
        "layers": [],
        "final_ln": L.init_layer_norm(d),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "ln1": L.init_layer_norm(d),
                "q": L.init_linear(nk(), d, d),
                "k": L.init_linear(nk(), d, d),
                "v": L.init_linear(nk(), d, d),
                "out": L.init_linear(nk(), d, d),
                "ln2": L.init_layer_norm(d),
                "fc1": L.init_linear(nk(), d, d * cfg.mlp_ratio),
                "fc2": L.init_linear(nk(), d * cfg.mlp_ratio, d),
            }
        )
    if cfg.projection_dim:
        params["text_projection"] = L.init_linear(
            nk(), d, cfg.projection_dim, bias=False
        )
    return jax.device_put(params) if commit else params


def _act(cfg: CLIPTextConfig, x):
    if cfg.activation == "quick_gelu":
        return x * jax.nn.sigmoid(1.702 * x)
    return L.gelu(x)


def _attn(p, x, heads: int, causal_bias):
    n, s, d = x.shape
    dh = d // heads

    def split(y):
        return y.reshape(n, s, heads, dh).transpose(0, 2, 1, 3)

    q = split(L.linear(p["q"], x))
    k = split(L.linear(p["k"], x))
    v = split(L.linear(p["v"], x))
    scores = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * (dh**-0.5)
    scores = scores + causal_bias
    w = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhqk,bhkd->bhqd", w, v)
    out = out.transpose(0, 2, 1, 3).reshape(n, s, d)
    return L.linear(p["out"], out)


def clip_text_apply(
    cfg: CLIPTextConfig,
    params,
    tokens: jax.Array,
    *,
    layer: str = "last",
    layer_idx: Optional[int] = None,
):
    """Encode token ids [N, 77].

    ``layer``:
      * "last"        — final_ln(hidden_last)                  [N, 77, D]
      * "penultimate" — final_ln(hidden_{L-1}) (OpenCLIP SD2:
                        ln_final IS applied, embedder.py:885-892)
      * "hidden"      — raw hidden_{layer_idx}, NO final LN
                        (HF hidden_states semantics, embedder.py:833)
      * "pooled"      — EOT-token embedding, through text_projection if
                        configured, L2-normalized (guide CLIP,
                        embedder.py:940-948)                   [N, P]
    """
    n, s = tokens.shape
    dtype = cfg.compute_dtype
    x = params["token_embedding"][tokens].astype(dtype)
    x = x + params["position_embedding"][None, :s].astype(dtype)

    causal_bias = jnp.triu(
        jnp.full((s, s), -jnp.inf, jnp.float32), k=1
    )[None, None]

    if layer == "penultimate":
        stop = cfg.num_layers - 1
    elif layer == "hidden":
        if layer_idx is None:
            raise ValueError("layer='hidden' requires layer_idx")
        stop = layer_idx
    else:
        stop = cfg.num_layers

    for p in params["layers"][:stop]:
        x = x + _attn(p, L.layer_norm(p["ln1"], x), cfg.num_heads, causal_bias)
        h = L.linear(p["fc1"], L.layer_norm(p["ln2"], x))
        x = x + L.linear(p["fc2"], _act(cfg, h))

    if layer != "hidden":  # HF hidden_states are pre-final-LN
        x = L.layer_norm(params["final_ln"], x)

    if layer == "pooled":
        eot = jnp.argmax(tokens, axis=-1)  # EOT has the highest token id
        pooled = x[jnp.arange(n), eot]
        if "text_projection" in params:
            pooled = L.linear(params["text_projection"], pooled)
        return pooled / jnp.linalg.norm(pooled, axis=-1, keepdims=True)
    return x.astype(jnp.float32)


# --------------------------------------------------------------------------
# Vision tower (guide CLIP image encoder; FrozenClipImageEmbedder,
# embedder.py:952-983, and the CLIP-guidance image path ddim.py:488-502)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 512
    activation: str = "quick_gelu"
    dtype: str = "float32"

    @staticmethod
    def vit_b32() -> "CLIPVisionConfig":
        """openai/clip-vit-base-patch32 — the 512-dim guide CLIP the
        reference uses for gradient guidance (diffusion.py:24-26)."""
        return CLIPVisionConfig()

    @staticmethod
    def vit_l14() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            patch_size=14, hidden_size=1024, num_layers=24, num_heads=16,
            projection_dim=768,
        )

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            image_size=32, patch_size=8, hidden_size=64, num_layers=2,
            num_heads=4, projection_dim=32,
        )

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self):
        return jnp.dtype(self.dtype)


def init_clip_vision(key, cfg: CLIPVisionConfig, *, commit: bool = True):
    import numpy as _np

    d = cfg.hidden_size
    rng = L.as_np_rng(key)
    params = {
        "class_embedding": (rng.normal(size=(d,)) * 0.02).astype(_np.float32),
        "patch_embedding": (
            rng.normal(size=(cfg.patch_size, cfg.patch_size, 3, d)) * 0.02
        ).astype(_np.float32),
        "position_embedding": (
            rng.normal(size=(cfg.num_patches + 1, d)) * 0.01
        ).astype(_np.float32),
        "pre_ln": L.init_layer_norm(d),
        "layers": [],
        "post_ln": L.init_layer_norm(d),
        "visual_projection": L.init_linear(rng, d, cfg.projection_dim, bias=False),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "ln1": L.init_layer_norm(d),
                "q": L.init_linear(rng, d, d),
                "k": L.init_linear(rng, d, d),
                "v": L.init_linear(rng, d, d),
                "out": L.init_linear(rng, d, d),
                "ln2": L.init_layer_norm(d),
                "fc1": L.init_linear(rng, d, d * cfg.mlp_ratio),
                "fc2": L.init_linear(rng, d * cfg.mlp_ratio, d),
            }
        )
    return jax.device_put(params) if commit else params


def clip_vision_apply(
    cfg: CLIPVisionConfig, params, images: jax.Array, *, project: bool = True
):
    """Encode images [N, H, W, 3] (pre-normalized with CLIP_IMAGE_MEAN/STD)
    into pooled embeddings [N, projection_dim] (get_image_features
    semantics). Differentiable — CLIP guidance takes jax.grad through it."""
    n = images.shape[0]
    dtype = cfg.compute_dtype
    x = jax.lax.conv_general_dilated(
        images.astype(dtype),
        params["patch_embedding"].astype(dtype),
        (cfg.patch_size, cfg.patch_size),
        "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    x = x.reshape(n, -1, cfg.hidden_size)
    cls = jnp.broadcast_to(
        params["class_embedding"].astype(dtype), (n, 1, cfg.hidden_size)
    )
    x = jnp.concatenate([cls, x], axis=1)
    x = x + params["position_embedding"][None].astype(dtype)
    x = L.layer_norm(params["pre_ln"], x)

    zero_bias = jnp.zeros((), jnp.float32)
    for p in params["layers"]:
        x = x + _attn(p, L.layer_norm(p["ln1"], x), cfg.num_heads, zero_bias)
        h = L.linear(p["fc1"], L.layer_norm(p["ln2"], x))
        x = x + L.linear(p["fc2"], _act(cfg, h))

    pooled = L.layer_norm(params["post_ln"], x[:, 0])
    if project and "visual_projection" in params:
        pooled = L.linear(params["visual_projection"], pooled)
    return pooled
