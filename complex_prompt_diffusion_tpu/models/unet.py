"""Stable Diffusion UNet, functional JAX implementation.

Semantics match the CompVis ``UNetModel``
(/root/reference/cpd/models/unet.py:415-831): the same block ladder (ResBlock
/ SpatialTransformer / up-down sampling at the same positions for a given
config), scale-shift-norm option, per-level cross-attention, and the
skip-tensor aux interface the reference calls ``return_attn`` /
``inject_attns`` / ``return_feat`` / ``inject_feats`` (unet.py:765-831 —
note the reference's "attn" lists are actually the encoder *skip tensors*,
popped per output block; attention-saliency guidance consumes them).

Differences (deliberate):
  * NHWC layout, bf16 compute / f32 norm statistics.
  * Attention runs through ops.attention (cuDNN's fused attention on the
    GPU) — no memory-metered slicing (reference attention.py:280-348).
  * One implementation: the reference's second diffusers-style UNet clone
    (unet_2d_condition.py) is redundant and intentionally not duplicated.

Architecture is described by a static "plan" (nested tuples of layer
descriptors) computed from :class:`UNetConfig`; ``init_unet`` and
``unet_apply`` walk the same plan, so structure and params cannot drift.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu.models import layers as L
from complex_prompt_diffusion_tpu.ops import attention as mha
from complex_prompt_diffusion_tpu.ops.mlp import geglu_ff

__all__ = [
    "UNetConfig", "build_plan", "init_unet", "unet_apply",
    "precompute_cross_kv", "deepcache_default_block",
]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: Any = 2  # int or per-level tuple
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    num_head_channels: int = -1
    transformer_depth: int = 1
    context_dim: Optional[int] = 768
    use_linear_in_transformer: bool = False
    use_scale_shift_norm: bool = False
    num_classes: Optional[int] = None
    dtype: str = "bfloat16"
    # Token reduction (ops/tome.py) — opt-in approximate speedup for the
    # dominant self-attention sites, applied only where S >= tome_min_seq
    # (default: level-0 S=4096 only). Two modes:
    #   "downsample" (default; ToDo recipe): K/V tokens avg-pooled by
    #     sx*sy, Q stays full — no matching/unmerge overhead; tome_ratio
    #     only gates on/off (> 0 = on).
    #   "merge" (ToMe-SD recipe): bipartite-similarity merge of
    #     ratio*S tokens before attention, unmerge after.
    tome_ratio: float = 0.0
    tome_mode: str = "downsample"
    tome_min_seq: int = 4096
    tome_sx: int = 2
    tome_sy: int = 2
    # merge mode only: reuse the block's merge plan for the FF and the
    # cross-attention Q side too (ToMe-SD merge_mlp / merge_crossattn) —
    # the plan is built once per block, so these amortize its cost
    tome_mlp: bool = False
    tome_crossattn: bool = False

    # SD presets ------------------------------------------------------------
    @staticmethod
    def sd15() -> "UNetConfig":
        """config-1.49.yaml:28-43 (SD 1.4/1.5)."""
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        """v2-inference.yaml:20-37 (SD 2.x)."""
        return UNetConfig(
            num_heads=-1,
            num_head_channels=64,
            context_dim=1024,
            use_linear_in_transformer=True,
        )

    @staticmethod
    def sd_upscaler() -> "UNetConfig":
        """LatentUpscaleDiffusion (ddpm.py:1319 / x4-upscaler config):
        7-channel input (4 latent + 3 downscaled-image concat), noise-level
        conditioning via the class-embedding pathway (num_classes = 1000
        noise-aug levels, conditioning key "adm"/hybrid-adm)."""
        return UNetConfig(
            in_channels=7,
            num_heads=-1,
            num_head_channels=64,
            context_dim=1024,
            use_linear_in_transformer=True,
            num_classes=1000,
        )

    @staticmethod
    def sd2_depth() -> "UNetConfig":
        """v2-midas-inference.yaml: depth2img, 5-channel latent input."""
        return UNetConfig(
            in_channels=5,
            num_heads=-1,
            num_head_channels=64,
            context_dim=1024,
            use_linear_in_transformer=True,
        )

    @staticmethod
    def sd_inpaint() -> "UNetConfig":
        """LatentInpaintDiffusion (ddpm.py:1802): 9-channel input — 4 noisy
        latents + 1 mask + 4 masked-image latents concatenated channel-wise
        (hybrid conditioning, concat_keys=("mask", "masked_image"))."""
        return UNetConfig(in_channels=9)

    @staticmethod
    def tiny(context_dim: int = 32) -> "UNetConfig":
        """Small config for tests."""
        return UNetConfig(
            model_channels=32,
            num_res_blocks=1,
            attention_resolutions=(2, 1),
            channel_mult=(1, 2),
            num_heads=2,
            context_dim=context_dim,
        )

    @property
    def res_blocks_per_level(self) -> Tuple[int, ...]:
        if isinstance(self.num_res_blocks, int):
            return tuple([self.num_res_blocks] * len(self.channel_mult))
        return tuple(self.num_res_blocks)

    def heads_for(self, ch: int) -> Tuple[int, int]:
        """(num_heads, dim_head) per reference unet.py:571-578 (legacy=False)."""
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels

    @property
    def compute_dtype(self):
        return jnp.dtype(self.dtype)


def build_plan(cfg: UNetConfig):
    """Static layer plan mirroring unet.py:545-739 construction.

    Returns (input_blocks, middle_block, output_blocks); each block is a
    tuple of descriptors:
      ("conv_in",) | ("res", cin, cout, "none"|"up"|"down")
      | ("attn", ch, heads, dim_head, depth) | ("down", ch) | ("up", ch)
    """
    nrb = cfg.res_blocks_per_level
    input_blocks = [(("conv_in",),)]
    skip_chans = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(nrb[level]):
            block = [("res", ch, mult * cfg.model_channels, "none")]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                heads, dim_head = cfg.heads_for(ch)
                block.append(("attn", ch, heads, dim_head, cfg.transformer_depth))
            input_blocks.append(tuple(block))
            skip_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append((("down", ch),))
            skip_chans.append(ch)
            ds *= 2

    heads, dim_head = cfg.heads_for(ch)
    middle_block = (
        ("res", ch, ch, "none"),
        ("attn", ch, heads, dim_head, cfg.transformer_depth),
        ("res", ch, ch, "none"),
    )

    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(nrb[level] + 1):
            ich = skip_chans.pop()
            block = [("res", ch + ich, cfg.model_channels * mult, "none")]
            ch = cfg.model_channels * mult
            if ds in cfg.attention_resolutions:
                heads, dim_head = cfg.heads_for(ch)
                block.append(("attn", ch, heads, dim_head, cfg.transformer_depth))
            if level and i == nrb[level]:
                block.append(("up", ch))
                ds //= 2
            output_blocks.append(tuple(block))
    return tuple(input_blocks), middle_block, tuple(output_blocks)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_res(key, cfg: UNetConfig, cin: int, cout: int):
    k1 = k2 = k3 = k4 = L.as_np_rng(key)
    emb_dim = cfg.model_channels * 4
    emb_out = 2 * cout if cfg.use_scale_shift_norm else cout
    p = {
        "in_norm": L.init_group_norm(cin),
        "in_conv": L.init_conv(k1, cin, cout, 3),
        "emb": L.init_linear(k2, emb_dim, emb_out),
        "out_norm": L.init_group_norm(cout),
        "out_conv": L.init_conv(k3, cout, cout, 3, zero=True),
    }
    if cin != cout:
        p["skip"] = L.init_conv(k4, cin, cout, 1)
    return p


def _init_attn(key, cfg: UNetConfig, ch: int, heads: int, dim_head: int, depth: int):
    inner = heads * dim_head
    ctx = cfg.context_dim if cfg.context_dim is not None else inner
    rng = L.as_np_rng(key)
    if cfg.use_linear_in_transformer:
        proj_in = L.init_linear(rng, ch, inner)
        proj_out = L.init_linear(rng, inner, ch, zero=True)
    else:
        proj_in = L.init_conv(rng, ch, inner, 1)
        proj_out = L.init_conv(rng, inner, ch, 1, zero=True)
    blocks = []
    for d in range(depth):
        bk = [rng] * 8
        blocks.append(
            {
                "norm1": L.init_layer_norm(inner),
                "attn1": {
                    "to_q": L.init_linear(bk[0], inner, inner, bias=False),
                    "to_k": L.init_linear(bk[1], inner, inner, bias=False),
                    "to_v": L.init_linear(bk[2], inner, inner, bias=False),
                    "to_out": L.init_linear(bk[3], inner, inner),
                },
                "norm2": L.init_layer_norm(inner),
                "attn2": {
                    "to_q": L.init_linear(bk[4], inner, inner, bias=False),
                    "to_k": L.init_linear(bk[5], ctx, inner, bias=False),
                    "to_v": L.init_linear(bk[6], ctx, inner, bias=False),
                    "to_out": L.init_linear(bk[7], inner, inner),
                },
                "norm3": L.init_layer_norm(inner),
                "ff": {
                    "proj": L.init_linear(bk[0], inner, inner * 4 * 2),
                    "out": L.init_linear(bk[1], inner * 4, inner),
                },
            }
        )
    return {"norm": L.init_group_norm(ch), "proj_in": proj_in,
            "proj_out": proj_out, "blocks": blocks}


def _init_sublayer(key, cfg: UNetConfig, desc):
    kind = desc[0]
    if kind == "conv_in":
        return L.init_conv(key, cfg.in_channels, cfg.model_channels, 3)
    if kind == "res":
        return _init_res(key, cfg, desc[1], desc[2])
    if kind == "attn":
        return _init_attn(key, cfg, desc[1], desc[2], desc[3], desc[4])
    if kind == "down":
        return L.init_conv(key, desc[1], desc[1], 3)
    if kind == "up":
        return L.init_conv(key, desc[1], desc[1], 3)
    raise ValueError(kind)


def init_unet(key, cfg: UNetConfig, *, commit: bool = True):
    # Host numpy leaves throughout; ONE jax.device_put at the end.
    input_plan, middle_plan, output_plan = build_plan(cfg)
    emb_dim = cfg.model_channels * 4
    rng = L.as_np_rng(key)

    class _Keys:
        def __next__(self):
            return rng

    keys = _Keys()
    params = {
        "time_embed": {
            "lin1": L.init_linear(next(keys), cfg.model_channels, emb_dim),
            "lin2": L.init_linear(next(keys), emb_dim, emb_dim),
        },
        "input_blocks": [
            [_init_sublayer(next(keys), cfg, d) for d in block]
            for block in input_plan
        ],
        "middle_block": [_init_sublayer(next(keys), cfg, d) for d in middle_plan],
        "output_blocks": [
            [_init_sublayer(next(keys), cfg, d) for d in block]
            for block in output_plan
        ],
        "out": {
            "norm": L.init_group_norm(cfg.model_channels),
            "conv": L.init_conv(next(keys), cfg.model_channels, cfg.out_channels, 3, zero=True),
        },
    }
    if cfg.num_classes:
        import numpy as _np

        params["label_emb"] = {
            "embedding": rng.normal(
                size=(cfg.num_classes, emb_dim)
            ).astype(_np.float32)
        }
    return jax.device_put(params) if commit else params


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------


def _apply_res(p, cfg: UNetConfig, h, emb, mode: str):
    x = h
    hh = L.group_norm_silu_p(p["in_norm"], h)
    if mode == "up":
        hh = L.upsample_nearest2x(hh)
        x = L.upsample_nearest2x(x)
    elif mode == "down":
        hh = L.avg_pool2x(hh)
        x = L.avg_pool2x(x)
    hh = L.conv2d(p["in_conv"], hh)
    emb_out = L.linear(p["emb"], L.silu(emb))[:, None, None, :]
    if cfg.use_scale_shift_norm:
        scale, shift = jnp.split(emb_out, 2, axis=-1)
        hh = L.group_norm_p(p["out_norm"], hh) * (
            1 + scale
        ) + shift
        hh = L.silu(hh)
    else:
        hh = hh + emb_out
        hh = L.group_norm_silu_p(p["out_norm"], hh)
    hh = L.conv2d(p["out_conv"], hh)
    if "skip" in p:
        x = L.conv2d(p["skip"], x)
    return x + hh


def _hyper(hp, z):
    """HyperLogic residual MLP (reference attention.py:539-547):
    z + linear2(linear1(z)) * multiplier."""
    out = L.linear(hp["linear2"], L.linear(hp["linear1"], z))
    return z + out * hp.get("multiplier", 1.0)


def _cross_kv(p, ctx):
    """Context k/v projections for one cross-attention site, hypernetwork
    transforms included (attention.py:139-144,285-292). Shared by the
    in-step path and :func:`precompute_cross_kv`, so the hoisted cache is
    bit-identical to the recomputed projections."""
    ctx_k = _hyper(p["hyper_k"], ctx) if "hyper_k" in p else ctx
    ctx_v = _hyper(p["hyper_v"], ctx) if "hyper_v" in p else ctx
    if ctx_k is ctx_v:
        # k and v share the context — fuse to one [D, 2C] matmul
        w = jnp.concatenate(
            [p["to_k"]["kernel"], p["to_v"]["kernel"]], axis=1
        )
        kv = L.linear({"kernel": w}, ctx_k)
        k, v = jnp.split(kv, 2, axis=-1)
        return k, v
    return L.linear(p["to_k"], ctx_k), L.linear(p["to_v"], ctx_v)


def precompute_cross_kv(cfg: UNetConfig, params, context):
    """Hoist the cross-attention k/v projections out of the sampling loop.

    In a diffusion render the prompt ``context`` is loop-invariant: every
    one of the 50 scan steps recomputes the same 16 sites x (k, v)
    projections from it. Computing them ONCE per render (outside the
    ``lax.scan``) and threading the results in removes those matmuls and
    their relayouts from the hot step entirely — the analog of a KV
    cache. Returns a tuple of (k, v) pairs in plan order (input -> middle
    -> output, one per transformer depth block); pass it to
    :func:`unet_apply` as ``cross_kv=``.

    The reference recomputes these projections inside every UNet call
    (attention.py:285-292); there is no reference counterpart to match.
    """
    if context is None:
        raise ValueError("precompute_cross_kv requires a context")
    input_plan, middle_plan, output_plan = build_plan(cfg)
    ctx = context.astype(cfg.compute_dtype)
    cache = []

    def walk(block_plan, block_params):
        for desc, p in zip(block_plan, block_params):
            if desc[0] == "attn":
                for blk in p["blocks"]:
                    cache.append(_cross_kv(blk["attn2"], ctx))

    for bp, pp in zip(input_plan, params["input_blocks"]):
        walk(bp, pp)
    walk(middle_plan, params["middle_block"])
    for bp, pp in zip(output_plan, params["output_blocks"]):
        walk(bp, pp)
    return tuple(cache)


def deepcache_default_block(cfg: UNetConfig) -> int:
    """Default DeepCache split: the first output block of the SHALLOWEST
    level (the last ``nrb[0]+1`` output blocks run at full resolution).
    Caching the feature entering that block keeps exactly the level-0
    encoder/decoder blocks (the expensive full-resolution attention+conv)
    live on retrieval steps and skips everything deeper."""
    _, _, output_plan = build_plan(cfg)
    return len(output_plan) - (cfg.res_blocks_per_level[0] + 1)


def make_deepcache_unets(
    cfg: UNetConfig, params, block, *, cross_kv=None, batch_chunk: int = 0
):
    """Build the DeepCache closure pair (one source of truth for the
    full/shallow wiring used by both pipeline sampler families and bench):

      * ``unet_full(x, t, ctx) -> (raw_out, deep)`` — full pass, returns the
        deep feature entering output block ``block``.
      * ``unet_shallow(x, t, ctx, deep) -> raw_out`` — retrieval pass, runs
        only the blocks after the split against the carried feature.

    ``block=None`` resolves to :func:`deepcache_default_block`. Raw model
    output — v-param conversion stays with the caller (eps-level for the
    t-family, denoised-level for the sigma family). Validates the split
    index at build time (clean error instead of a mid-trace shape mismatch).

    ``batch_chunk``: max UNet sub-batch per call (RenderConfig
    .unet_batch_chunk semantics, resolved by the caller; 0 = one wide
    call). CFG megabatches wider than this split into sequential calls —
    x/t/ctx/cross_kv AND the deep feature slice along batch, so the
    chunked pair is bit-equivalent to the wide call.
    """
    n_out = len(build_plan(cfg)[2])
    j0 = deepcache_default_block(cfg) if block is None else int(block)
    if not 0 <= j0 < n_out:
        raise ValueError(
            f"deepcache_block={j0} out of range (0..{n_out - 1})"
        )

    def _kv_slice(sl):
        return (
            None if cross_kv is None
            else jax.tree.map(lambda a: a[sl], cross_kv)
        )

    def unet_full(x, t, ctx):
        b = x.shape[0]
        if batch_chunk > 0 and b > batch_chunk:
            outs, deeps = [], []
            for lo in range(0, b, batch_chunk):
                sl = slice(lo, min(lo + batch_chunk, b))
                o, d = unet_apply(
                    cfg, params, x[sl], t[sl], ctx[sl],
                    cross_kv=_kv_slice(sl), return_deep_at=j0,
                )
                outs.append(o)
                deeps.append(d)
            return jnp.concatenate(outs, axis=0), jnp.concatenate(deeps, axis=0)
        return unet_apply(
            cfg, params, x, t, ctx, cross_kv=cross_kv, return_deep_at=j0
        )

    def unet_shallow(x, t, ctx, deep):
        b = x.shape[0]
        if batch_chunk > 0 and b > batch_chunk:
            outs = []
            for lo in range(0, b, batch_chunk):
                sl = slice(lo, min(lo + batch_chunk, b))
                outs.append(
                    unet_apply(
                        cfg, params, x[sl], t[sl], ctx[sl],
                        cross_kv=_kv_slice(sl),
                        deep_feature=deep[sl], deep_at=j0,
                    )
                )
            return jnp.concatenate(outs, axis=0)
        return unet_apply(
            cfg, params, x, t, ctx,
            cross_kv=cross_kv, deep_feature=deep, deep_at=j0,
        )

    return unet_full, unet_shallow


def _kv_counts(cfg: UNetConfig):
    """Cross-attention k/v cache entries contributed by each plan segment
    (plan order: input blocks, middle, output blocks) — used to align a
    full ``precompute_cross_kv`` tuple with a DeepCache shallow pass."""

    def n(block_plan):
        return sum(d[4] for d in block_plan if d[0] == "attn")

    input_plan, middle_plan, output_plan = build_plan(cfg)
    return (
        [n(b) for b in input_plan],
        n(middle_plan),
        [n(b) for b in output_plan],
    )


def _shallow_cross_kv(cfg: UNetConfig, cross_kv, deep_at: int):
    """Subset of a full cross_kv tuple consumed by the DeepCache shallow
    pass (executed input prefix + executed output suffix)."""
    kv_in, kv_mid, kv_out = _kv_counts(cfg)
    keep_in = len(kv_in) - deep_at
    a = sum(kv_in[:keep_in])
    b = sum(kv_in) + kv_mid + sum(kv_out[:deep_at])
    return tuple(cross_kv[:a]) + tuple(cross_kv[b:])


def _cross_attention(
    p, x, context, heads: int, collector=None, kv=None, self_kv=None,
):
    if kv is not None and context is not None:
        # hoisted path: k/v precomputed once per render (precompute_cross_kv)
        q = L.linear(p["to_q"], x)
        k, v = kv
    elif context is None and self_kv is not None:
        # token-downsampled self-attention (ops/tome.py downsample_kv):
        # Q from the full sequence, K/V from the pooled one
        q = L.linear(p["to_q"], x)
        k, v = _cross_kv(p, self_kv)
    elif context is None and "hyper_k" not in p and "hyper_v" not in p:
        # self-attention: one fused [C, 3C] projection instead of three
        # [C, C] matmuls — one pass over x, wider matmul N-dim (the weight
        # concat is a trivial [C, 3C] copy vs the [B, S, C] activation)
        w = jnp.concatenate(
            [p["to_q"]["kernel"], p["to_k"]["kernel"], p["to_v"]["kernel"]],
            axis=1,
        )
        qkv = L.linear({"kernel": w}, x)
        q, k, v = jnp.split(qkv, 3, axis=-1)
    else:
        q = L.linear(p["to_q"], x)
        k, v = _cross_kv(p, x if context is None else context)
    if collector is not None and context is not None:
        # DAAM-style probability capture (reference attention.py:206-277):
        # explicit softmax path so the per-token maps exist; used on demand,
        # not in the sampling hot loop
        b, sq, inner = q.shape
        d = inner // heads

        def split(z):
            return z.reshape(b, z.shape[1], heads, d).transpose(0, 2, 1, 3)

        qh, kh, vh = split(q), split(k), split(v)
        scores = jnp.einsum(
            "bhqd,bhkd->bhqk", qh, kh, preferred_element_type=jnp.float32
        ) * (d**-0.5)
        probs = jax.nn.softmax(scores, axis=-1)
        collector.append(probs)  # [B, heads, HW, L]
        out = jnp.einsum("bhqk,bhkd->bhqd", probs.astype(vh.dtype), vh)
        out = out.transpose(0, 2, 1, 3).reshape(b, sq, inner)
    else:
        out = mha(q, k, v, num_heads=heads)
    return L.linear(p["to_out"], out)


def _apply_attn(
    p, cfg: UNetConfig, h, context, heads, dim_head, collector=None,
    kv_iter=None,
):
    n, hh_, ww_, c = h.shape
    inner = heads * dim_head
    x = L.group_norm_p(p["norm"], h, eps=1e-6)
    if cfg.use_linear_in_transformer:
        x = x.reshape(n, hh_ * ww_, c)
        x = L.linear(p["proj_in"], x)
    else:
        x = L.conv2d(p["proj_in"], x)
        x = x.reshape(n, hh_ * ww_, inner)
    # Token reduction (opt-in, ops/tome.py): shrink the self-attention
    # K/V (downsample mode) or the whole sequence (merge mode) at the
    # large-S sites. All decisions are trace-time (static shapes).
    tome_on = (
        cfg.tome_ratio > 0.0
        and hh_ * ww_ >= cfg.tome_min_seq
        and hh_ % cfg.tome_sy == 0
        and ww_ % cfg.tome_sx == 0
    )
    if tome_on and cfg.tome_mode not in ("downsample", "merge"):
        raise ValueError(
            f"unknown tome_mode {cfg.tome_mode!r} (downsample|merge)"
        )
    tome_r = 0
    if tome_on and cfg.tome_mode == "merge":
        n_dst = (hh_ // cfg.tome_sy) * (ww_ // cfg.tome_sx)
        tome_r = min(int(cfg.tome_ratio * hh_ * ww_), hh_ * ww_ - n_dst)
    if tome_on:
        from complex_prompt_diffusion_tpu.ops import tome as _tome
    for blk in p["blocks"]:
        xa = L.layer_norm(blk["norm1"], x)
        plan = None
        if tome_on and cfg.tome_mode == "downsample":
            xkv = _tome.downsample_kv(xa, hh_, ww_, cfg.tome_sx, cfg.tome_sy)
            x = x + _cross_attention(
                blk["attn1"], xa, None, heads,
                self_kv=xkv,
            )
        elif tome_r > 0:
            # one plan per block, reused by the FF / cross-Q merges below
            # (ToMe-SD recipe: the metric is the block input)
            plan = _tome.build_merge(
                x, hh_, ww_, tome_r, cfg.tome_sx, cfg.tome_sy
            )
            out = _cross_attention(
                blk["attn1"], _tome.tome_merge(plan, xa), None, heads,
            )
            x = x + _tome.tome_unmerge(plan, out)
        else:
            x = x + _cross_attention(
                blk["attn1"], xa, None, heads,
            )
        kv = next(kv_iter) if (kv_iter is not None and context is not None) else None
        xc = L.layer_norm(blk["norm2"], x)
        if plan is not None and cfg.tome_crossattn and collector is None:
            out = _cross_attention(
                blk["attn2"], _tome.tome_merge(plan, xc), context, heads,
                kv=kv,
            )
            x = x + _tome.tome_unmerge(plan, out)
        else:
            x = x + _cross_attention(
                blk["attn2"], xc, context, heads,
                collector=collector, kv=kv,
            )
        y = L.layer_norm(blk["norm3"], x)
        # GEGLU FF (ops/mlp.py)
        if plan is not None and cfg.tome_mlp:
            x = x + _tome.tome_unmerge(plan, geglu_ff(
                _tome.tome_merge(plan, y),
                blk["ff"]["proj"]["kernel"], blk["ff"]["proj"]["bias"],
                blk["ff"]["out"]["kernel"], blk["ff"]["out"]["bias"],
            ))
        else:
            x = x + geglu_ff(
                y,
                blk["ff"]["proj"]["kernel"], blk["ff"]["proj"]["bias"],
                blk["ff"]["out"]["kernel"], blk["ff"]["out"]["bias"],
            )
    if cfg.use_linear_in_transformer:
        x = L.linear(p["proj_out"], x)
        x = x.reshape(n, hh_, ww_, c)
    else:
        x = x.reshape(n, hh_, ww_, inner)
        x = L.conv2d(p["proj_out"], x)
    return x + h


def _apply_block(
    block_plan, block_params, cfg, h, emb, context, collector=None,
    kv_iter=None,
):
    for desc, p in zip(block_plan, block_params):
        kind = desc[0]
        if kind == "conv_in":
            h = L.conv2d(p, h)
        elif kind == "res":
            h = _apply_res(p, cfg, h, emb, desc[3])
        elif kind == "attn":
            h = _apply_attn(
                p, cfg, h, context, desc[2], desc[3], collector, kv_iter
            )
        elif kind == "down":
            h = L.conv2d(p, h, stride=2)
        elif kind == "up":
            h = L.conv2d(p, L.upsample_nearest2x(h))
        else:
            raise ValueError(kind)
    return h


def unet_apply(
    cfg: UNetConfig,
    params,
    x,
    timesteps,
    context,
    y=None,
    *,
    return_skips: bool = False,
    inject_skips=None,
    inject_skips_stop: int = 10,
    return_feats: bool = False,
    inject_feats=None,
    inject_feats_stop: int = 10,
    collect_attn_maps: bool = False,
    cross_kv=None,
    return_deep_at: Optional[int] = None,
    deep_feature=None,
    deep_at: Optional[int] = None,
):
    """Predict eps (or v) for latents ``x`` [N,H,W,C] at ``timesteps`` [N].

    ``collect_attn_maps=True`` additionally returns the per-layer
    cross-attention probability maps ([B, heads, HW, L] per site, encoder
    -> middle -> decoder order) for DAAM-style word heat maps
    (reference attention.py:30-67,206-277) — this uses the explicit softmax
    path, so reserve it for analysis passes, not the sampling loop.

    ``return_skips`` / ``inject_skips`` mirror the reference's
    return_attn / inject_attns (unet.py:799-815): the popped encoder skip
    tensors per output block, used by saliency guidance and
    prompt-to-prompt-style feature injection. ``return_feats`` /
    ``inject_feats`` mirror return_feat / inject_feats (the decoder hidden
    states). Aux lists are returned as tuples ordered by output block.

    ``cross_kv``: optional output of :func:`precompute_cross_kv` for this
    ``context`` — the cross-attention k/v projections are then read from
    the cache instead of recomputed, which hoists them out of a sampling
    scan (the context is loop-invariant across denoising steps).

    DeepCache (Ma et al. 2023, "DeepCache: Accelerating Diffusion Models
    for Free" — no reference counterpart; an opt-in approximate mode like
    ops/tome.py):
      * ``return_deep_at=j`` — additionally return the hidden state
        ENTERING output block ``j`` (appended last to the extras); this is
        the feature a later retrieval step reuses.
      * ``deep_feature=h, deep_at=j`` — shallow retrieval pass: run only
        the input blocks whose skips feed output blocks ``j..``, skip the
        middle block and output blocks ``< j``, and resume from ``h``.
        The executed ops are the identical subgraph of the full pass, so
        a shallow pass fed the SAME step's true deep feature is
        bit-identical to the full pass. ``cross_kv`` (if given) must be
        the FULL tuple — the shallow subset is selected internally.
    """
    input_plan, middle_plan, output_plan = build_plan(cfg)
    dtype = cfg.compute_dtype
    shallow = deep_feature is not None
    if shallow:
        if deep_at is None:
            raise ValueError("deep_feature requires deep_at")
        if not 0 <= deep_at < len(output_plan):
            raise ValueError(
                f"deep_at={deep_at} out of range "
                f"(0..{len(output_plan) - 1})"
            )
        if (
            return_skips or return_feats or collect_attn_maps
            or inject_skips is not None or inject_feats is not None
            or return_deep_at is not None
        ):
            raise ValueError(
                "DeepCache shallow pass is incompatible with the aux "
                "skip/feature/attn-map interfaces"
            )
        if cross_kv is not None:
            cross_kv = _shallow_cross_kv(cfg, cross_kv, deep_at)

    t_emb = L.timestep_embedding(timesteps, cfg.model_channels)
    emb = L.linear(params["time_embed"]["lin1"], t_emb)
    emb = L.linear(params["time_embed"]["lin2"], L.silu(emb))
    if cfg.num_classes:
        if y is None:
            raise ValueError("class-conditional model requires y")
        emb = emb + params["label_emb"]["embedding"][y]
    emb = emb.astype(dtype)

    h = x.astype(dtype)
    if context is not None:
        context = context.astype(dtype)

    collector = [] if collect_attn_maps else None
    kv_iter = iter(cross_kv) if cross_kv is not None else None
    keep_in = len(input_plan) - deep_at if shallow else len(input_plan)
    hs = []
    for block_plan, block_params in zip(
        input_plan[:keep_in], params["input_blocks"][:keep_in]
    ):
        h = _apply_block(
            block_plan, block_params, cfg, h, emb, context, collector, kv_iter
        )
        hs.append(h)
    if shallow:
        h = deep_feature
        out_start = deep_at
    else:
        h = _apply_block(
            middle_plan, params["middle_block"], cfg, h, emb, context,
            collector, kv_iter,
        )
        out_start = 0

    deep_out = None
    skips_out = []
    feats_out = []
    for i, (block_plan, block_params) in enumerate(
        zip(output_plan[out_start:], params["output_blocks"][out_start:]),
        start=out_start,
    ):
        if return_deep_at is not None and i == return_deep_at:
            deep_out = h
        skip = hs.pop()
        if return_skips:
            skips_out.append(skip)
        if inject_skips is not None and i < inject_skips_stop:
            skip = inject_skips[i]
        if inject_feats is not None and i < inject_feats_stop:
            h = inject_feats[i]
        h = jnp.concatenate([h, skip], axis=-1)
        h = _apply_block(
            block_plan, block_params, cfg, h, emb, context, collector, kv_iter
        )
        if return_feats:
            feats_out.append(h)

    h = L.group_norm_silu_p(params["out"]["norm"], h)
    out = L.conv2d(params["out"]["conv"], h).astype(jnp.float32)

    extras = []
    if return_skips:
        extras.append(tuple(skips_out))
    if return_feats:
        extras.append(tuple(feats_out))
    if collect_attn_maps:
        extras.append(tuple(collector))
    if return_deep_at is not None:
        if deep_out is None:
            raise ValueError(
                f"return_deep_at={return_deep_at} out of range "
                f"(0..{len(output_plan) - 1})"
            )
        extras.append(deep_out)
    if extras:
        return (out, *extras)
    return out
