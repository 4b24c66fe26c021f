"""AutoencoderKL (the SD first stage), functional JAX implementation.

Parity target: /root/reference/cpd/models/autoencoder.py — ``Encoder`` (:287),
``Decoder`` (:380), ``DiagonalGaussianDistribution`` (:13-51),
``AutoencoderKL`` (:780-845). Structure notes carried over exactly:
  * GroupNorm(32, eps=1e-6) everywhere (autoencoder.py:73-74)
  * Downsample = zero-pad (0,1) on H and W, then 3x3 conv stride 2 pad 0
    (autoencoder.py:93-111 — "no asymmetric padding in torch conv")
  * Upsample = nearest 2x + 3x3 conv
  * mid = ResnetBlock, AttnBlock (single-head full attention), ResnetBlock
  * double_z: encoder emits 2*z_channels moments -> quant_conv 1x1;
    decoder starts with post_quant_conv 1x1

The 0.18215 latent scale factor is applied by callers (as in the reference:
prompts.py:326,345; render.py:27,35), not by the VAE itself.

Replaced mechanisms: the reference's memory-metered sliced VAE attention
(autoencoder.py:233-276) -> ops.attention; its Lightning training
plumbing is out of scope (inference-first, matching the reference's use).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu.models import layers as L
from complex_prompt_diffusion_tpu.ops import attention as mha

__all__ = [
    "VAEConfig",
    "DiagonalGaussian",
    "init_vae",
    "vae_encode",
    "vae_decode",
]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """ddconfig from config-1.49.yaml:47-62 (same for SD 1.x and 2.x)."""

    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    resolution: int = 512
    dtype: str = "float32"

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32)

    @property
    def compute_dtype(self):
        return jnp.dtype(self.dtype)


@dataclasses.dataclass
class DiagonalGaussian:
    """DiagonalGaussianDistribution (autoencoder.py:13-51): moments are
    [mean | logvar] along channels; logvar clamped to [-30, 20]."""

    mean: jax.Array
    logvar: jax.Array

    @staticmethod
    def from_moments(moments: jax.Array) -> "DiagonalGaussian":
        mean, logvar = jnp.split(moments, 2, axis=-1)
        return DiagonalGaussian(mean, jnp.clip(logvar, -30.0, 20.0))

    @property
    def std(self):
        return jnp.exp(0.5 * self.logvar)

    def sample(self, key) -> jax.Array:
        return self.mean + self.std * jax.random.normal(
            key, self.mean.shape, self.mean.dtype
        )

    def mode(self) -> jax.Array:
        return self.mean

    def kl(self) -> jax.Array:
        return 0.5 * jnp.sum(
            self.mean**2 + jnp.exp(self.logvar) - 1.0 - self.logvar,
            axis=(1, 2, 3),
        )

    def nll(self, sample) -> jax.Array:
        logtwopi = jnp.log(2.0 * jnp.pi)
        return 0.5 * jnp.sum(
            logtwopi + self.logvar + (sample - self.mean) ** 2 / jnp.exp(self.logvar),
            axis=(1, 2, 3),
        )


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_resnet(key, cin, cout):
    k1 = k2 = k3 = L.as_np_rng(key)
    p = {
        "norm1": L.init_group_norm(cin),
        "conv1": L.init_conv(k1, cin, cout, 3),
        "norm2": L.init_group_norm(cout),
        "conv2": L.init_conv(k2, cout, cout, 3),
    }
    if cin != cout:
        p["nin_shortcut"] = L.init_conv(k3, cin, cout, 1)
    return p


def _init_attn(key, ch):
    k1 = k2 = k3 = k4 = L.as_np_rng(key)
    return {
        "norm": L.init_group_norm(ch),
        "q": L.init_conv(k1, ch, ch, 1),
        "k": L.init_conv(k2, ch, ch, 1),
        "v": L.init_conv(k3, ch, ch, 1),
        "proj_out": L.init_conv(k4, ch, ch, 1),
    }


def init_vae(key, cfg: VAEConfig, *, commit: bool = True):
    # host numpy leaves, one jax.device_put at the end (see layers.init_conv)
    rng = L.as_np_rng(key)
    nk = lambda: rng  # noqa: E731

    # encoder
    enc = {"conv_in": L.init_conv(nk(), cfg.in_channels, cfg.ch, 3), "down": []}
    ch = cfg.ch
    res = cfg.resolution
    for level, mult in enumerate(cfg.ch_mult):
        blocks, attns = [], []
        cout = cfg.ch * mult
        for _ in range(cfg.num_res_blocks):
            blocks.append(_init_resnet(nk(), ch, cout))
            ch = cout
            if res in cfg.attn_resolutions:
                attns.append(_init_attn(nk(), ch))
        down = {"block": blocks, "attn": attns}
        if level != len(cfg.ch_mult) - 1:
            down["downsample"] = L.init_conv(nk(), ch, ch, 3)
            res //= 2
        enc["down"].append(down)
    enc["mid"] = {
        "block_1": _init_resnet(nk(), ch, ch),
        "attn_1": _init_attn(nk(), ch),
        "block_2": _init_resnet(nk(), ch, ch),
    }
    z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    enc["norm_out"] = L.init_group_norm(ch)
    enc["conv_out"] = L.init_conv(nk(), ch, z_out, 3)

    # decoder
    dec = {"conv_in": L.init_conv(nk(), cfg.z_channels, ch, 3)}
    dec["mid"] = {
        "block_1": _init_resnet(nk(), ch, ch),
        "attn_1": _init_attn(nk(), ch),
        "block_2": _init_resnet(nk(), ch, ch),
    }
    dec["up"] = []
    for level, mult in reversed(list(enumerate(cfg.ch_mult))):
        blocks, attns = [], []
        cout = cfg.ch * mult
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_init_resnet(nk(), ch, cout))
            ch = cout
            if res in cfg.attn_resolutions:
                attns.append(_init_attn(nk(), ch))
        up = {"block": blocks, "attn": attns}
        if level != 0:
            up["upsample"] = L.init_conv(nk(), ch, ch, 3)
            res *= 2
        dec["up"].insert(0, up)  # stored in ascending order like the torch code
    dec["norm_out"] = L.init_group_norm(ch)
    dec["conv_out"] = L.init_conv(nk(), ch, cfg.out_channels, 3)

    moments = 2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim
    params = {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": L.init_conv(nk(), z_out, moments, 1),
        "post_quant_conv": L.init_conv(nk(), cfg.embed_dim, cfg.z_channels, 1),
    }
    return jax.device_put(params) if commit else params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------


def _resnet(p, x):
    h = L.group_norm_silu_p(p["norm1"], x, eps=1e-6)
    h = L.conv2d(p["conv1"], h)
    h = L.group_norm_silu_p(p["norm2"], h, eps=1e-6)
    h = L.conv2d(p["conv2"], h)
    if "nin_shortcut" in p:
        x = L.conv2d(p["nin_shortcut"], x)
    return x + h


def _attn_block(p, x):
    n, h, w, c = x.shape
    y = L.group_norm_p(p["norm"], x, eps=1e-6)
    q = L.conv2d(p["q"], y).reshape(n, h * w, c)
    k = L.conv2d(p["k"], y).reshape(n, h * w, c)
    v = L.conv2d(p["v"], y).reshape(n, h * w, c)
    out = mha(q, k, v, num_heads=1)  # single-head (autoencoder.py:186-231)
    out = L.conv2d(p["proj_out"], out.reshape(n, h, w, c))
    return x + out


def _downsample(p, x):
    x = jnp.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))  # torch pad (0,1,0,1)
    return L.conv2d(p, x, stride=2, padding=0)


def vae_encode(cfg: VAEConfig, params, x) -> DiagonalGaussian:
    """Image [N,H,W,3] in [-1,1] -> posterior over latents [N,H/8,W/8,z]."""
    x = x.astype(cfg.compute_dtype)
    p = params["encoder"]
    h = L.conv2d(p["conv_in"], x)
    for level, down in enumerate(p["down"]):
        for i, blk in enumerate(down["block"]):
            h = _resnet(blk, h)
            if down["attn"]:
                h = _attn_block(down["attn"][i], h)
        if "downsample" in down:
            h = _downsample(down["downsample"], h)
    h = _resnet(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet(p["mid"]["block_2"], h)
    h = L.group_norm_silu_p(p["norm_out"], h, eps=1e-6)
    h = L.conv2d(p["conv_out"], h)
    moments = L.conv2d(params["quant_conv"], h).astype(jnp.float32)
    return DiagonalGaussian.from_moments(moments)


def vae_decode(cfg: VAEConfig, params, z) -> jax.Array:
    """Latents [N,h,w,z] (unscaled) -> image [N,8h,8w,3] in [-1,1]."""
    z = z.astype(cfg.compute_dtype)
    z = L.conv2d(params["post_quant_conv"], z)
    p = params["decoder"]
    h = L.conv2d(p["conv_in"], z)
    h = _resnet(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet(p["mid"]["block_2"], h)
    for level in reversed(range(len(p["up"]))):
        up = p["up"][level]
        for i, blk in enumerate(up["block"]):
            h = _resnet(blk, h)
            if up["attn"]:
                h = _attn_block(up["attn"][i], h)
        if "upsample" in up:
            h = L.conv2d(up["upsample"], L.upsample_nearest2x(h))
    h = L.group_norm_silu_p(p["norm_out"], h, eps=1e-6)
    return L.conv2d(p["conv_out"], h).astype(jnp.float32)


# --------------------------------------------------------------------------
# VQModel (the VQ first stage; autoencoder.py:511-778)
# --------------------------------------------------------------------------


def init_vq_quantizer(key, n_embed: int, embed_dim: int, *, commit: bool = True):
    """Codebook init, uniform(-1/n, 1/n) (taming VectorQuantizer convention,
    referenced at autoencoder.py:9). Like every init_* entry point the
    result commits to device in one transfer (commit=False for callers that
    embed it in a larger tree, e.g. init_vq_model) — direct use from jitted
    fns would otherwise re-transfer the codebook per call."""
    rng = L.as_np_rng(key)
    import numpy as np

    params = {
        "embedding": rng.uniform(
            -1.0 / n_embed, 1.0 / n_embed, (n_embed, embed_dim)
        ).astype(np.float32)
    }
    return jax.device_put(params) if commit else params


def vq_quantize(params, z, beta: float = 0.25):
    """Nearest-codebook quantization with straight-through gradients.

    z: [N, h, w, C]. Returns (z_q, loss, indices) — the VectorQuantizer2
    contract used by VQModel.encode (autoencoder.py:560-570).
    """
    emb = params["embedding"]  # [K, C]
    flat = z.reshape(-1, z.shape[-1])
    d = (
        jnp.sum(flat**2, axis=1, keepdims=True)
        - 2.0 * flat @ emb.T
        + jnp.sum(emb**2, axis=1)[None]
    )
    idx = jnp.argmin(d, axis=1)
    z_q = emb[idx].reshape(z.shape)
    loss = beta * jnp.mean((jax.lax.stop_gradient(z_q) - z) ** 2) + jnp.mean(
        (z_q - jax.lax.stop_gradient(z)) ** 2
    )
    z_q = z + jax.lax.stop_gradient(z_q - z)  # straight-through
    return z_q, loss, idx.reshape(z.shape[:-1])


def init_vq_model(key, cfg: VAEConfig, n_embed: int = 16384):
    """VQModel = Encoder + quant_conv + VectorQuantizer + post_quant_conv +
    Decoder (autoencoder.py:511-555). Uses double_z=False semantics."""
    cfg_vq = dataclasses.replace(cfg, double_z=False)
    params = init_vae(
        jax.random.PRNGKey(0) if key is None else key, cfg_vq, commit=False
    )
    rng = L.as_np_rng(key)
    params["quant_conv"] = L.init_conv(rng, cfg.z_channels, cfg.embed_dim, 1)
    params["post_quant_conv"] = L.init_conv(rng, cfg.embed_dim, cfg.z_channels, 1)
    params["quantize"] = init_vq_quantizer(
        rng, n_embed, cfg.embed_dim, commit=False
    )
    return jax.device_put(params)


def vq_encode(cfg: VAEConfig, params, x, quantize: bool = True):
    """VQModel.encode (autoencoder.py:560-570): encoder -> quant_conv ->
    (optionally) quantize. Returns (z_q, emb_loss, indices) or pre-quant h."""
    cfg_vq = dataclasses.replace(cfg, double_z=False)
    x = x.astype(cfg.compute_dtype)
    p = params["encoder"]
    h = L.conv2d(p["conv_in"], x)
    for level, down in enumerate(p["down"]):
        for i, blk in enumerate(down["block"]):
            h = _resnet(blk, h)
            if down["attn"]:
                h = _attn_block(down["attn"][i], h)
        if "downsample" in down:
            h = _downsample(down["downsample"], h)
    h = _resnet(p["mid"]["block_1"], h)
    h = _attn_block(p["mid"]["attn_1"], h)
    h = _resnet(p["mid"]["block_2"], h)
    h = L.group_norm_silu_p(p["norm_out"], h, eps=1e-6)
    h = L.conv2d(p["conv_out"], h)
    h = L.conv2d(params["quant_conv"], h).astype(jnp.float32)
    if not quantize:
        return h
    return vq_quantize(params["quantize"], h)


def vq_decode(cfg: VAEConfig, params, z_q):
    """VQModel.decode (autoencoder.py:572-580)."""
    return vae_decode(cfg, params, z_q)


# --------------------------------------------------------------------------
# Tiled encode/decode for large canvases
# (the reference's split_input_params fold/unfold path,
#  ddpm.py:799-1077 decode/encode_first_stage — reimplemented as explicit
#  overlapping tiles with smooth blend weights)
# --------------------------------------------------------------------------


def _tile_weights(th: int, tw: int) -> jnp.ndarray:
    """Smooth blending window (the reference's delta_border weighting,
    ddpm.py:828-845): weight falls off toward tile borders."""
    import numpy as np

    def ramp(n):
        x = (np.arange(n) + 0.5) / n
        return np.minimum(x, 1.0 - x) * 2.0  # 0..1..0 triangle

    w = np.clip(np.outer(ramp(th), ramp(tw)), 0.01, 0.5)
    return jnp.asarray(w[None, :, :, None], jnp.float32)


def vae_decode_tiled(
    cfg: VAEConfig,
    params,
    z: jax.Array,
    tile: int = 64,
    overlap: int = 16,
) -> jax.Array:
    """Decode latents tile by tile with overlapping blending — bounds peak
    activation memory for >1k-pixel canvases (the reference's answer is
    fold/unfold, ddpm.py:995-1077; here each tile is one jit'd decode)."""
    n, h, w, c = z.shape
    if h <= tile and w <= tile:
        return vae_decode(cfg, params, z)
    up = 2 ** (len(cfg.ch_mult) - 1)
    stride = tile - overlap
    out = jnp.zeros((n, h * up, w * up, cfg.out_channels), jnp.float32)
    acc = jnp.zeros((n, h * up, w * up, 1), jnp.float32)
    ys = sorted({min(y, max(h - tile, 0)) for y in range(0, h, stride)})
    xs = sorted({min(x, max(w - tile, 0)) for x in range(0, w, stride)})
    for y0 in ys:
        for x0 in xs:
            th = min(tile, h - y0)
            tw = min(tile, w - x0)
            patch = z[:, y0 : y0 + th, x0 : x0 + tw]
            dec = vae_decode(cfg, params, patch)
            wgt = _tile_weights(th * up, tw * up)
            out = out.at[:, y0 * up : (y0 + th) * up, x0 * up : (x0 + tw) * up].add(
                dec * wgt
            )
            acc = acc.at[:, y0 * up : (y0 + th) * up, x0 * up : (x0 + tw) * up].add(
                wgt
            )
    return out / jnp.maximum(acc, 1e-8)


def vae_encode_tiled(
    cfg: VAEConfig,
    params,
    x: jax.Array,
    tile: int = 512,
    overlap: int = 128,
):
    """Tiled encoder counterpart (returns the posterior MEAN — tile blending
    of stochastic draws would decorrelate the noise)."""
    n, h, w, c = x.shape
    if h <= tile and w <= tile:
        return vae_encode(cfg, params, x)
    down = 2 ** (len(cfg.ch_mult) - 1)
    stride = tile - overlap
    zc = cfg.embed_dim
    out = jnp.zeros((n, h // down, w // down, zc), jnp.float32)
    acc = jnp.zeros((n, h // down, w // down, 1), jnp.float32)
    ys = sorted({min(y, max(h - tile, 0)) for y in range(0, h, stride)})
    xs = sorted({min(x0, max(w - tile, 0)) for x0 in range(0, w, stride)})
    for y0 in ys:
        for x0 in xs:
            th = min(tile, h - y0)
            tw = min(tile, w - x0)
            post = vae_encode(cfg, params, x[:, y0 : y0 + th, x0 : x0 + tw])
            mean = post.mean
            ly, lx = y0 // down, x0 // down
            lh, lw = th // down, tw // down
            wgt = _tile_weights(lh, lw)
            out = out.at[:, ly : ly + lh, lx : lx + lw].add(mean * wgt)
            acc = acc.at[:, ly : ly + lh, lx : lx + lw].add(wgt)
    mean = out / jnp.maximum(acc, 1e-8)
    return DiagonalGaussian(mean, jnp.full_like(mean, -30.0))
