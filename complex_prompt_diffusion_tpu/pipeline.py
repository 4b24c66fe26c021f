"""End-to-end pipelines: model bundle + txt2img / img2img.

The equivalent of the reference's orchestration layer
(/root/reference/cpd/manager.py — DiffusionModelManager.process_txt2img :52,
process_img2img :68, _make_sampler :94) with a typed config instead of the
kwargs cascade. The whole denoising chain (CFG -> sampler scan) is one jit'd
XLA program with donated latents; CLIP encode and VAE decode are separate
jit'd programs (they run once per render, not per step).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from complex_prompt_diffusion_tpu import models as M
from complex_prompt_diffusion_tpu import samplers as SA
from complex_prompt_diffusion_tpu import schedules as S
from complex_prompt_diffusion_tpu.guidance import (
    GuidanceConfig,
    GuidanceSpec,
    make_denoiser,
)
from complex_prompt_diffusion_tpu.guidance.cfg import (
    _batched_inputs,
    cfg_epsilon_deepcache,
    make_uc_blur_schedule,
    make_uc_scale_schedule,
    stacked_context,
)
from complex_prompt_diffusion_tpu.prompts.tokenizer import get_tokenizer

__all__ = ["ModelBundle", "RenderConfig", "txt2img", "img2img", "decode_latents"]

LATENT_SCALE = 0.18215  # applied by callers in the reference too (prompts.py:326)

# Samplers whose scans thread the DeepCache deep-feature state (ddim.py
# eps_state / kdiff.py den_state). Grouped multi-eval walks (DPM Fast),
# adaptive integrators and the continuous-time solver family are excluded —
# their eval order is not a fixed per-step grid.
DEEPCACHE_SAMPLERS = frozenset({
    "ddim", "plms",
    "euler", "euler ancestral", "heun", "huen",
    "dpm2", "dpm2 ancestral", "dpm++ 2m", "dpm++ 2s ancestral", "lms",
})


@functools.lru_cache(maxsize=None)
def _cast_tree_jit(dtype_str: str, donate: bool = False):
    dt = jnp.dtype(dtype_str)
    return jax.jit(
        lambda t: jax.tree.map(lambda a: a.astype(dt), t),
        donate_argnums=(0,) if donate else (),
    )


def _cast_tree(params, dtype: str, donate: bool = False):
    """Cast a whole param pytree in ONE compiled program.

    Host numpy leaves cast host-side and go to the device in one transfer;
    device leaves go through one jitted tree-cast instead of one eager
    dispatch per leaf.
    donate=False (default) keeps the source tree usable (f32/bf16 A/Bs) at
    the cost of both copies resident in HBM; donate=True frees the source
    buffers — the right choice for the common load-then-cast-once path.
    """
    leaves = jax.tree.leaves(params)
    if all(isinstance(a, np.ndarray) for a in leaves):
        # checkpoint-loaded host trees: cast in numpy (half the transfer
        # bytes for bf16), then ONE batched device_put
        dt = jnp.dtype(dtype)
        return jax.device_put(
            jax.tree.map(lambda a: np.asarray(a).astype(dt), params)
        )
    return _cast_tree_jit(str(jnp.dtype(dtype)), donate)(params)


def _unzero_kernels(key, params, scale: float = 0.02):
    """Replace all-zero kernel leaves (ndim>=2) with small gaussian noise.

    Used only by ModelBundle.random: checkpoint-parity init zeroes the
    residual/projection output layers, which would make a random model's
    output constant-zero and hide conditioning from tests. Biases and norm
    offsets (ndim<2) stay zero.

    Runs host-side in numpy: the leaves are host arrays at this point
    (init_* builds numpy; see models/layers.py init_conv)."""
    rng = M.layers.as_np_rng(key)
    leaves, treedef = jax.tree.flatten(params)
    out = []
    for a in leaves:
        a = np.asarray(a)
        if a.ndim >= 2 and not a.any():
            out.append(
                (scale * rng.standard_normal(a.shape)).astype(a.dtype)
            )
        else:
            out.append(a)
    return jax.tree.unflatten(treedef, out)


@dataclasses.dataclass
class ModelBundle:
    """The model_dict equivalent (manager.py:18-23), as config+params pairs."""

    version: str
    unet_cfg: M.UNetConfig
    unet_params: Any
    vae_cfg: M.VAEConfig
    vae_params: Any
    clip_cfg: M.CLIPTextConfig
    clip_params: Any
    tokenizer: Any
    tables: S.DiffusionTables
    parameterization: str = "eps"
    clip_layer: str = "last"  # "penultimate" for SD2.x
    # the ("data", "model") mesh the bundle was placed on by
    # parallel.tp.shard_bundle; None on one device
    mesh: Any = None
    # jitted sampler cache, keyed by (RenderConfig, t_start, depth, noises)
    _jit_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def from_checkpoint(
        path: str,
        vocab_path: Optional[str] = None,
        dtype: Optional[str] = None,
    ) -> "ModelBundle":
        """Load a torch/safetensors SD checkpoint into a device bundle.

        ``dtype``: optional compute dtype (e.g. "bfloat16") applied to the
        UNet HOST-side before the single device transfer — the cheapest
        load-then-cast path (half the transfer bytes, no transient f32 +
        bf16 double residency in HBM; `.cast(dtype)` after loading keeps
        both copies alive unless donate=True)."""
        from complex_prompt_diffusion_tpu.models.params import load_sd_checkpoint

        ck = load_sd_checkpoint(path)
        version = ck["version"]
        unet_cfg, unet_params = ck["unet"]
        vae_cfg, vae_params = ck["vae"]
        clip_cfg, clip_params = ck["clip"]
        if dtype is not None:
            dt = jnp.dtype(dtype)
            unet_params = jax.tree.map(
                lambda a: np.asarray(a).astype(dt), unet_params
            )
            unet_cfg = dataclasses.replace(unet_cfg, dtype=dtype)
        # one batched transfer: host leaves passed straight into jit would
        # otherwise re-transfer on EVERY call
        unet_params, vae_params, clip_params = jax.device_put(
            (unet_params, vae_params, clip_params)
        )
        return ModelBundle(
            version=version,
            unet_cfg=unet_cfg,
            unet_params=unet_params,
            vae_cfg=vae_cfg,
            vae_params=vae_params,
            clip_cfg=clip_cfg,
            clip_params=clip_params,
            tokenizer=get_tokenizer(
                vocab_path, pad_with_eos=(version == "sd1")
            ),
            tables=S.make_diffusion_tables(),
            clip_layer="last" if version == "sd1" else "penultimate",
        )

    @staticmethod
    def random(scale: str = "tiny", seed: int = 0) -> "ModelBundle":
        """Random-weight bundle for tests/benches ("tiny" or "sd15")."""
        key = jax.random.PRNGKey(seed)
        if scale == "tiny":
            unet_cfg = M.UNetConfig.tiny(context_dim=64)
            unet_cfg = dataclasses.replace(unet_cfg, dtype="float32")
            vae_cfg = M.VAEConfig.tiny()
            clip_cfg = M.CLIPTextConfig.tiny()
        elif scale == "tiny-inpaint":
            # LatentInpaintDiffusion shape: 4 latent + 1 mask + 4 masked
            unet_cfg = dataclasses.replace(
                M.UNetConfig.tiny(context_dim=64),
                dtype="float32", in_channels=9,
            )
            vae_cfg = M.VAEConfig.tiny()
            clip_cfg = M.CLIPTextConfig.tiny()
        elif scale == "sd15":
            unet_cfg = M.UNetConfig.sd15()
            vae_cfg = M.VAEConfig.sd()
            clip_cfg = M.CLIPTextConfig.sd15()
        else:
            raise ValueError(scale)
        # init_unet zero-initializes out_conv / proj_out / the final conv
        # (zero_module parity, reference unet.py zero_module call sites) —
        # correct for checkpoint loading, but a fully-random model would
        # then output identically zero and tests could never observe input
        # conditioning. Fill the zero-init kernels with small noise.
        # init host-side + ONE batched device_put of the whole tree
        unet_params = _unzero_kernels(
            jax.random.fold_in(key, 1), M.init_unet(key, unet_cfg, commit=False)
        )
        vae_params = M.init_vae(key, vae_cfg, commit=False)
        clip_params = M.init_clip_text(key, clip_cfg, commit=False)
        unet_params, vae_params, clip_params = jax.device_put(
            (unet_params, vae_params, clip_params)
        )
        return ModelBundle(
            version="sd1",
            unet_cfg=unet_cfg,
            unet_params=unet_params,
            vae_cfg=vae_cfg,
            vae_params=vae_params,
            clip_cfg=clip_cfg,
            clip_params=clip_params,
            tokenizer=get_tokenizer(vocab_size=clip_cfg.vocab_size),
            tables=S.make_diffusion_tables(),
        )

    def cast(self, dtype: str, donate: bool = False) -> "ModelBundle":
        """Cast UNet weights to a compute dtype (bf16 is the deployed one).

        donate=False keeps this bundle's device tree usable (both copies
        resident — ~3x the bf16 HBM footprint for SD-1.5; fine there, tight
        for larger configs). donate=True frees the source buffers: use it
        for the common load-then-cast-once path and drop the old bundle.
        """
        params = _cast_tree(self.unet_params, dtype, donate=donate)
        # a fresh jit cache: the cached sampling programs are keyed by
        # RenderConfig and were traced for the source bundle's dtype
        return dataclasses.replace(
            self,
            unet_params=params,
            unet_cfg=dataclasses.replace(self.unet_cfg, dtype=dtype),
            _jit_cache={},
        )

    def cast_vae(self, dtype: str, donate: bool = False) -> "ModelBundle":
        """Cast the VAE to a compute dtype. Weights AND activations: the
        encode/decode entry points cast inputs to ``vae_cfg.compute_dtype``,
        so a bf16 cast runs the whole autoencoder at the bf16 matmul rate.
        bf16 shares f32's exponent range, so the fp16 SD-VAE overflow
        problem does not apply; opt-in because decoded pixels shift by up
        to ~1/255 vs the f32 reference."""
        params = _cast_tree(self.vae_params, dtype, donate=donate)
        return dataclasses.replace(
            self,
            vae_params=params,
            vae_cfg=dataclasses.replace(self.vae_cfg, dtype=dtype),
            _jit_cache={},
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Typed render options (the reference's render_args / sampler wrapper
    hyperparams, diffusion.py:31-66 + the CFG flag surface)."""

    steps: int = 50
    sampler: str = "DDIM"
    guidance_scale: float = 7.5
    width: int = 512
    height: int = 512
    batch_size: int = 1
    seed: int = 0
    eta: float = 0.0
    temperature: float = 1.0
    discretize: str = "uniform"  # uniform | quad | jumps
    sigma_schedule: str = "default"  # linear | karras | exp | quad | vp | sig
    sigma_min: Optional[float] = None
    sigma_max: Optional[float] = None
    rho: float = 7.0
    # thresholding on pred_x0 inside the scheduler step
    clip_sample: Optional[str] = None
    clip_sample_thresh: float = 90.0
    # k-family churn
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0
    # img2img
    denoising_strength: float = 0.75
    # tiled/folded UNet inference for large canvases (split_input_params
    # fold/unfold, ddpm.py:995-1077): tile size in LATENT px (0 = untiled),
    # stride (0 -> tile//2), and tiles batched per UNet call
    unet_tile: int = 0
    unet_tile_stride: int = 0
    unet_tile_chunk: int = 1
    # Token reduction (ops/tome.py) at the S>=4096 self-attention sites.
    # 0 = exact (default); > 0 trades a mild approximation for a level-0
    # attention cut. tome_mode: "downsample" (ToDo K/V pooling, cheap) or
    # "merge" (ToMe-SD bipartite merging)
    tome_ratio: float = 0.0
    tome_mode: str = "downsample"
    # DeepCache (models/unet.py unet_apply docstring) — opt-in approximate
    # mode: run the FULL UNet every `deepcache_interval`-th step and only
    # the shallowest level (reusing the cached deep feature) in between.
    # 0/1 = exact (default); requires a DDIM-family sampler.
    # deepcache_block: output-block index of the cache split (None = the
    # first block of the shallowest level, deepcache_default_block)
    deepcache_interval: int = 0
    deepcache_block: Optional[int] = None
    # Max UNet sub-batch per call. CFG megabatches ((1+K)*batch) larger than
    # this are split into SEQUENTIAL UNet calls inside the jit'd step, which
    # bounds activation memory. 0 = never split (the default, until the
    # benchmark measures a reason to); n>=1 = explicit. No reference
    # counterpart (perf dispatch only — bit-exact either way).
    unet_batch_chunk: int = 0
    # continuous-time solver family (sampler="dpm_solver" | "UniPC") knobs:
    # solver order 1-3 (adaptive: 2-3), dpm_solver method
    # multistep|singlestep|adaptive (solver.py:1045 method arg; "adaptive" =
    # DPM-Solver-12/23, solver.py:982), UniPC variant bh1|bh2|vary_coeff
    # (uni_pc.py:190,305)
    solver_order: int = 2
    solver_method: str = "multistep"
    unipc_variant: str = "bh2"
    guidance: GuidanceConfig = GuidanceConfig()

    def __post_init__(self):
        if self.unet_batch_chunk < 0:
            raise ValueError(
                f"unet_batch_chunk must be >= 0, got {self.unet_batch_chunk}"
            )
        if not 1 <= self.solver_order <= 3:
            raise ValueError(
                f"solver_order must be 1-3, got {self.solver_order}"
            )
        if self.solver_method not in ("multistep", "singlestep", "adaptive"):
            raise ValueError(
                f"unknown solver_method {self.solver_method!r} "
                "(multistep|singlestep|adaptive)"
            )
        if self.solver_method == "adaptive" and self.solver_order < 2:
            raise ValueError("adaptive solver_method requires solver_order 2-3")
        if self.unipc_variant not in ("bh1", "bh2", "vary_coeff"):
            raise ValueError(
                f"unknown unipc_variant {self.unipc_variant!r} "
                "(bh1|bh2|vary_coeff)"
            )
        if self.tome_ratio > 0.0 and self.tome_mode not in (
            "downsample", "merge"
        ):
            raise ValueError(
                f"unknown tome_mode {self.tome_mode!r} (downsample|merge)"
            )
        if self.deepcache_interval >= 2:
            if self.sampler.lower() not in DEEPCACHE_SAMPLERS:
                raise ValueError(
                    f"deepcache_interval is not supported with sampler "
                    f"{self.sampler!r} (the feature cache is carried "
                    f"through the sampling scan); supported: "
                    f"{sorted(DEEPCACHE_SAMPLERS)}"
                )
            if self.unet_tile:
                raise ValueError(
                    "deepcache_interval is incompatible with unet_tile"
                )
            if self.guidance.attn_guide:
                raise ValueError(
                    "deepcache_interval is incompatible with attn_guide"
                )
        # convenience: RenderConfig(guidance_scale=9) without an explicit
        # GuidanceConfig propagates into the guidance config
        if (
            self.guidance == GuidanceConfig()
            and self.guidance_scale != GuidanceConfig().guidance_scale
        ):
            object.__setattr__(
                self, "guidance",
                dataclasses.replace(self.guidance, guidance_scale=self.guidance_scale),
            )

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        return (self.height // 8, self.width // 8, 4)


@functools.partial(jax.jit, static_argnames=("cfg", "layer"))
def _clip_encode_jit(cfg, params, tokens, layer):
    return M.clip_text_apply(cfg, params, tokens, layer=layer)


def encode_prompt(bundle: ModelBundle, text: Union[str, list]) -> jax.Array:
    """Text -> CLIP conditioning [N, 77, D] (FrozenCLIPEmbedder.encode
    semantics, embedder.py:824-838). One jit'd program."""
    tokens = jnp.asarray(bundle.tokenizer(text))
    return _clip_encode_jit(
        bundle.clip_cfg, bundle.clip_params, tokens, bundle.clip_layer
    )


def make_guidance_spec(
    bundle: ModelBundle,
    prompt: str,
    negative_prompt: str = "",
    scale: float = 1.0,
) -> GuidanceSpec:
    """Plain single-prompt CFG spec. Complex prompts build richer specs via
    prompts.compose."""
    cond = encode_prompt(bundle, prompt)[0]
    uncond = encode_prompt(bundle, negative_prompt)[0]
    return GuidanceSpec.single(cond, uncond, scale)


def _effective_unet_chunk(cfg: "RenderConfig", bundle: "ModelBundle") -> int:
    """Resolve RenderConfig.unet_batch_chunk to the effective max UNet
    sub-batch (0 = never split). Disabled for tiled
    inference (tiles already batch via unet_tile_chunk) and for bundles on
    a mesh (GSPMD lays the batch over the data axis; slicing the global
    batch would fight the sharding)."""
    if cfg.unet_tile or bundle.mesh is not None:
        return 0
    return cfg.unet_batch_chunk


def _unet_eps_fn(bundle: ModelBundle):
    def unet_eps(x, t, ctx):
        return M.unet_apply(bundle.unet_cfg, bundle.unet_params, x, t, ctx)

    return unet_eps


def _sigma_schedule(bundle: ModelBundle, cfg: RenderConfig) -> np.ndarray:
    kwargs = {}
    if cfg.sigma_min is not None:
        kwargs["sigma_min"] = cfg.sigma_min
    if cfg.sigma_max is not None:
        kwargs["sigma_max"] = cfg.sigma_max
    if cfg.sigma_schedule == "karras":
        kwargs.setdefault("sigma_min", float(bundle.tables.sigmas[0]))
        kwargs.setdefault("sigma_max", float(bundle.tables.sigmas[-1]))
        kwargs["rho"] = cfg.rho
    return S.make_sigma_schedule(
        cfg.sigma_schedule, cfg.steps, model_sigmas=bundle.tables.sigmas, **kwargs
    )


def _build_sampler_fn(
    bundle: ModelBundle, cfg: RenderConfig, t_start, has_depth, has_noises,
    clip_guidance=None, step_callback=None,
):
    """Build and jit the sampling core for a (bundle, cfg) pair.

    CRITICAL compile-time property: ``unet_params`` is threaded through the
    jit as an ARGUMENT. A closure would bake the 860M-param pytree into the
    XLA module as literal constants, blowing compile time from ~90s to >25
    minutes (measured) and doubling HBM. The returned callable is cached on
    the bundle keyed by the static config.

    ``clip_guidance``: optional (vision_cfg, ClipGuidanceConfig) — the
    vision params and text embedding arrive as run() arguments.
    """
    family, sample_fn = SA.get_sampler(cfg.sampler)

    if cfg.unet_tile and cfg.guidance.attn_guide:
        raise ValueError(
            "tiled UNet inference (unet_tile) is incompatible with "
            "attention-saliency guidance (skip tensors span the full canvas)"
        )
    if cfg.deepcache_interval >= 2 and clip_guidance is not None:
        raise ValueError(
            "deepcache_interval is incompatible with CLIP guidance (the "
            "guidance gradient re-runs the UNet outside the cached scan)"
        )

    def _make_unet_eps(unet_params, cross_kv=None):
        """Raw UNet call, optionally wrapped with fold/unfold tiling
        (ddpm.py:995-1077) for large canvases. On a bundle placed on a
        mesh with a data axis and no model axis, the TILES shard over the
        data axis: the multi-device hi-res path (SURVEY §5's spatial
        parallelism). Tile sharding closes over the UNet weights inside
        shard_map, so they must be replicated (TP + tiled hi-res would need
        re-gathered weights; unsupported)."""
        unet_cfg = bundle.unet_cfg
        mesh = bundle.mesh
        tile_mesh = None
        tile_axis = "data"
        if (
            cfg.unet_tile
            and mesh is not None
            and mesh.shape.get("data", 1) > 1
            and mesh.shape.get("model", 1) == 1
        ):
            tile_mesh = mesh

        chunk = _effective_unet_chunk(cfg, bundle)

        def unet_eps(x, t, ctx_):
            b = x.shape[0]
            if chunk > 0 and b > chunk:
                outs = []
                for lo in range(0, b, chunk):
                    sl = slice(lo, min(lo + chunk, b))
                    kv = (
                        None if cross_kv is None
                        else jax.tree.map(lambda a: a[sl], cross_kv)
                    )
                    outs.append(
                        M.unet_apply(
                            unet_cfg, unet_params, x[sl], t[sl], ctx_[sl],
                            cross_kv=kv,
                        )
                    )
                return jnp.concatenate(outs, axis=0)
            return M.unet_apply(
                unet_cfg, unet_params, x, t, ctx_, cross_kv=cross_kv
            )

        if cfg.unet_tile:
            from complex_prompt_diffusion_tpu.models.tiled import make_tiled_unet

            return make_tiled_unet(
                unet_eps,
                cfg.unet_tile,
                cfg.unet_tile_stride or None,
                max(cfg.unet_tile_chunk, 1),
                mesh=tile_mesh,
                axis=tile_axis,
            )
        return unet_eps

    def _hoisted_kv(unet_params, spec, batch: int):
        """Cross-attention k/v are loop-invariant across the sampling scan
        (the prompt context never changes step to step), so compute them
        ONCE per render outside the scan (models.precompute_cross_kv) —
        removes 16 sites x k/v projections + relayouts from every step.
        Disabled for paths that call the UNet with a different context or
        batch mid-step: tiled UNet (tile-stacked batch), attention-saliency
        guidance (uncond-only re-evaluation), CLIP guidance (factor-only
        re-evaluation under grad)."""
        if (
            cfg.unet_tile
            or cfg.guidance.attn_guide
            or clip_guidance is not None
        ):
            return None
        return M.precompute_cross_kv(
            bundle.unet_cfg, unet_params, stacked_context(spec, batch)
        )

    def _deepcache_setup(unet_params, hoisted_kv, x, spec, depth_mask):
        """(raw unet_full, raw unet_shallow, zero deep-feature state) —
        shared between the t- and sigma-family run builders. Megabatch
        chunking applies to both DeepCache passes (the deep feature slices
        along batch like everything else), so batch>=8 DeepCache renders
        keep the B8 scheduling optimum."""
        unet_full, unet_shallow = M.make_deepcache_unets(
            bundle.unet_cfg, unet_params, cfg.deepcache_block,
            cross_kv=hoisted_kv,
            batch_chunk=_effective_unet_chunk(cfg, bundle),
        )
        deep_sd = jax.eval_shape(
            lambda x_, sp, dm: unet_full(
                *_batched_inputs(x_, jnp.zeros((), jnp.float32), sp, dm)
            )[1],
            x, spec, depth_mask,
        )
        return unet_full, unet_shallow, jnp.zeros(deep_sd.shape, deep_sd.dtype)

    if family == "t":
        itables = S.make_inference_tables(
            bundle.tables, cfg.steps, eta=cfg.eta, discretize=cfg.discretize
        )
        s = itables.num_steps
        uc_scales = jnp.asarray(make_uc_scale_schedule(cfg.guidance, s), jnp.float32)
        blur_flags = jnp.asarray(make_uc_blur_schedule(cfg.guidance, s))
        timesteps_j = jnp.asarray(itables.timesteps)
        ac_t_j = jnp.asarray(itables.alphas_cumprod_t, jnp.float32)
        s1m_j = jnp.asarray(itables.sqrt_one_minus_alphas_cumprod_t, jnp.float32)
        gcfg = cfg.guidance

        # v-parameterization (SD 2.1-v): convert the model's v output to eps
        # via eps = sqrt(ac_t) v + sqrt(1-ac_t) x (discrete.py:739-743)
        v_param = bundle.parameterization == "v"
        sqrt_ac = jnp.asarray(bundle.tables.sqrt_alphas_cumprod, jnp.float32)
        sqrt_1m = jnp.asarray(
            bundle.tables.sqrt_one_minus_alphas_cumprod, jnp.float32
        )

        def _to_eps(out, x, t):
            if not v_param:
                return out
            ti = jnp.clip(jnp.asarray(t).astype(jnp.int32), 0, sqrt_ac.shape[0] - 1)
            a = jnp.take(sqrt_ac, ti).reshape(-1, 1, 1, 1)
            b = jnp.take(sqrt_1m, ti).reshape(-1, 1, 1, 1)
            return a * out + b * x[..., : out.shape[-1]]

        def run(unet_params, spec, x_T, key, noises, depth_mask, guide_args):
            hoisted_kv = _hoisted_kv(unet_params, spec, x_T.shape[0])
            raw_unet = _make_unet_eps(unet_params, hoisted_kv)

            def unet_eps(x, t, ctx):
                return _to_eps(raw_unet(x, t, ctx), x, t)

            def unet_eps_skips(x, t, ctx):
                out, skips = M.unet_apply(
                    bundle.unet_cfg, unet_params, x, t, ctx, return_skips=True
                )
                return _to_eps(out, x, t), skips

            base_eps, _ = make_denoiser(
                unet_eps, spec, gcfg=gcfg, depth_mask=depth_mask
            )

            if gcfg.attn_guide or clip_guidance is not None:
                from complex_prompt_diffusion_tpu.guidance.cfg import (
                    cfg_epsilon_attn_guided,
                )

                def eps_fn(x, t, uc_scale, blur_on):
                    idx = jnp.searchsorted(timesteps_j, jnp.asarray(t).reshape(()).astype(timesteps_j.dtype))
                    idx = jnp.clip(idx, 0, s - 1)
                    a_t = jnp.take(ac_t_j, idx)
                    sqrt_1m = jnp.take(s1m_j, idx)

                    if gcfg.attn_guide:
                        attn_on = idx < gcfg.attn_guide_rounds

                        e_t = jax.lax.cond(
                            attn_on,
                            lambda x_: cfg_epsilon_attn_guided(
                                unet_eps, unet_eps_skips, x_, t, spec,
                                uc_scale, (a_t, sqrt_1m),
                                gcfg=gcfg, depth_mask=depth_mask,
                                uc_blur_on=blur_on,
                            ),
                            lambda x_: base_eps(x_, t, uc_scale, blur_on),
                            x,
                        )
                    else:
                        e_t = base_eps(x, t, uc_scale, blur_on)

                    if clip_guidance is not None:
                        from complex_prompt_diffusion_tpu.guidance.clip_guidance import (
                            make_clip_guidance,
                        )

                        vision_cfg, cg_cfg = clip_guidance
                        vision_params, text_emb = guide_args

                        def vae_dec(z):
                            return M.vae_decode(
                                bundle.vae_cfg, bundle.vae_params, z
                            )

                        def factor_eps(x_):
                            """Factor-combined eps recomputed under grad —
                            the reference re-runs the (grad-enabled) UNet on
                            the requires_grad x over the first
                            ``factor_limit`` prompt factors and combines
                            mask*scale*eps (ddim.py:417-466)."""
                            k = min(
                                max(int(cg_cfg.factor_limit), 1),
                                spec.num_factors,
                            )
                            b = x_.shape[0]
                            x_in = jnp.concatenate([x_] * k, axis=0)
                            if depth_mask is not None:
                                x_in = jnp.concatenate(
                                    [
                                        x_in,
                                        jnp.broadcast_to(
                                            depth_mask,
                                            x_in.shape[:3]
                                            + (depth_mask.shape[-1],),
                                        ),
                                    ],
                                    axis=-1,
                                )
                            t_in = jnp.full(
                                (b * k,), jnp.asarray(t).reshape(())
                            )
                            ctx_in = jnp.repeat(spec.factors[:k], b, axis=0)
                            out = unet_eps(x_in, t_in, ctx_in)
                            out = out.reshape((k, b) + out.shape[1:])
                            w = (
                                spec.masks[:k, None]
                                * spec.scales[:k].reshape(k, 1, 1, 1, 1)
                            )
                            return (w * out).sum(axis=0)

                        guide = make_clip_guidance(
                            vae_dec, vision_cfg, vision_params, text_emb,
                            cg_cfg, eps_in_grad_fn=factor_eps,
                        )
                        apply_guide = jnp.logical_and(
                            cg_cfg.freq > 0,
                            jnp.asarray(t).reshape(()).astype(jnp.int32)
                            % max(cg_cfg.freq, 1)
                            == 0,
                        )
                        e_t = jax.lax.cond(
                            apply_guide,
                            lambda args: guide(*args),
                            lambda args: args[1],
                            (x, e_t, a_t),
                        )
                    return e_t

            else:
                eps_fn = base_eps

            # DeepCache (opt-in approximate; models/unet.py docstring):
            # the deep feature rides the scan carry; full UNet every
            # `interval`-th step, shallow retrieval pass in between.
            # RenderConfig validation guarantees a supported sampler + no
            # attn/CLIP guidance, so eps_fn == base_eps here.
            dc_state0 = None
            if cfg.deepcache_interval >= 2:
                interval = cfg.deepcache_interval
                raw_full, raw_shallow, dc_state0 = _deepcache_setup(
                    unet_params, hoisted_kv, x_T, spec, depth_mask
                )

                # v-param conversion at the eps level (t-family contract)
                def unet_full(x_in, t_in, ctx_):
                    out, deep = raw_full(x_in, t_in, ctx_)
                    return _to_eps(out, x_in, t_in), deep

                def unet_shallow(x_in, t_in, ctx_, deep):
                    return _to_eps(
                        raw_shallow(x_in, t_in, ctx_, deep), x_in, t_in
                    )

                def eps_fn(x, t, uc_scale, blur_on, i, deep):
                    return cfg_epsilon_deepcache(
                        unet_full, unet_shallow, x, t, spec, uc_scale,
                        (i % interval) == 0, deep,
                        gcfg=gcfg, depth_mask=depth_mask, uc_blur_on=blur_on,
                    )

            if step_callback is not None:
                # per-step preview hook (extension/callbacks.py): host
                # observes the x0 prediction via jax.debug.callback without
                # breaking the compiled scan
                inner_eps = eps_fn

                def _preview(x, t, e_t):
                    idx = jnp.searchsorted(
                        timesteps_j,
                        jnp.asarray(t).reshape(-1)[0].astype(timesteps_j.dtype),
                    )
                    idx = jnp.clip(idx, 0, s - 1)
                    a_t = jnp.take(ac_t_j, idx)
                    s1m_t = jnp.take(s1m_j, idx)
                    x0_pred = (
                        x[..., : e_t.shape[-1]] - s1m_t * e_t
                    ) / jnp.sqrt(a_t)
                    jax.debug.callback(
                        step_callback, jnp.asarray(t).reshape(-1)[0], x0_pred
                    )

                if dc_state0 is not None:

                    def eps_fn(x, t, uc_scale, blur_on, i, st, _inner=inner_eps):
                        e_t, st = _inner(x, t, uc_scale, blur_on, i, st)
                        _preview(x, t, e_t)
                        return e_t, st

                else:

                    def eps_fn(x, t, uc_scale, blur_on, _inner=inner_eps):
                        e_t = _inner(x, t, uc_scale, blur_on)
                        _preview(x, t, e_t)
                        return e_t

            kwargs = dict(
                key=key,
                noises=noises,
                uc_blur_flags=blur_flags,
                temperature=cfg.temperature,
                clip_sample=cfg.clip_sample,
                clip_sample_thresh=cfg.clip_sample_thresh,
            )
            if sample_fn is SA.sample_ddim and t_start is not None:
                kwargs["t_start"] = t_start
            if dc_state0 is not None:
                kwargs["eps_state"] = dc_state0
            x0, _ = sample_fn(eps_fn, x_T, itables, uc_scales, **kwargs)
            return x0

        return jax.jit(run, donate_argnums=(2,))

    if family == "solver":
        ns = SA.NoiseScheduleVP(
            "discrete", alphas_cumprod=bundle.tables.alphas_cumprod
        )
        uc = jnp.asarray(cfg.guidance.guidance_scale, jnp.float32)

        solver_kw = {"order": cfg.solver_order}
        if sample_fn is SA.sample_unipc:
            solver_kw["variant"] = cfg.unipc_variant
        else:
            solver_kw["method"] = cfg.solver_method

        def run(unet_params, spec, x_T, key, noises, depth_mask, guide_args):
            unet_eps = _make_unet_eps(
                unet_params, _hoisted_kv(unet_params, spec, x_T.shape[0])
            )

            eps_fn, _ = make_denoiser(
                unet_eps, spec, gcfg=cfg.guidance, depth_mask=depth_mask
            )

            def model_fn(x_in, t_cont):
                t_disc = (t_cont - 1.0 / ns.total_N) * 1000.0
                return eps_fn(x_in, t_disc, uc, jnp.asarray(False))

            return sample_fn(model_fn, x_T, ns, steps=cfg.steps, **solver_kw)

        return jax.jit(run, donate_argnums=(2,))

    if family == "blur":
        # inverse-heat blur diffusion (blur.py:52-530), drivable like any
        # registered sampler: eps model = the CFG denoiser on a linear
        # trained-timestep grid, reverse loop in the DCT eigenbasis.
        # (Quality needs blur-trained weights; the plumbing is exact.)
        lh, lw = cfg.latent_shape[0], cfg.latent_shape[1]
        if lh != lw:
            raise ValueError(
                "Blur sampler requires a square canvas (the spectral "
                f"operator diagonalizes on a square grid; got {lh}x{lw})"
            )
        proc = SA.BlurDiffusion(n=cfg.steps, resolution=lh)
        uc_b = jnp.asarray(cfg.guidance.guidance_scale, jnp.float32)
        n_b = cfg.steps

        def run(unet_params, spec, x_T, key, noises, depth_mask, guide_args):
            unet_eps = _make_unet_eps(
                unet_params, _hoisted_kv(unet_params, spec, x_T.shape[0])
            )
            eps_fn, _ = make_denoiser(
                unet_eps, spec, gcfg=cfg.guidance, depth_mask=depth_mask
            )

            def eps_model(x_in, i):
                # blur index i in [1..steps] -> trained timestep grid
                t = (jnp.asarray(i, jnp.float32) / n_b) * 999.0
                return eps_fn(x_in, t, uc_b, jnp.asarray(False))

            return sample_fn(eps_model, proc, x_T.shape, key=key)

        return jax.jit(run, donate_argnums=(2,))

    if family == "trig":  # iPNDM (ipndms.py trig schedule, own t grid)
        uc_tr = jnp.asarray(cfg.guidance.guidance_scale, jnp.float32)

        def run(unet_params, spec, x_T, key, noises, depth_mask, guide_args):
            unet_eps = _make_unet_eps(
                unet_params, _hoisted_kv(unet_params, spec, x_T.shape[0])
            )

            eps_fn, _ = make_denoiser(
                unet_eps, spec, gcfg=cfg.guidance, depth_mask=depth_mask
            )

            def eps3(x_in, t, uc_scale):
                return eps_fn(x_in, t, uc_scale, jnp.asarray(False))

            x0, _ = sample_fn(eps3, x_T, cfg.steps, uc_tr)
            return x0

        return jax.jit(run, donate_argnums=(2,))

    # sigma family: sigma schedules / churn gammas / LMS coeffs are
    # host-side numpy, so they stay closed over (tiny constants)
    sigmas = _sigma_schedule(bundle, cfg)
    if t_start is not None:
        sigmas = sigmas[len(sigmas) - 1 - t_start :]
    n = len(sigmas) - 1
    uc_scales = make_uc_scale_schedule(cfg.guidance, n)
    kw = {}
    if cfg.sampler.lower() in ("euler", "huen", "heun", "dpm2"):
        kw.update(
            s_churn=cfg.s_churn, s_tmin=cfg.s_tmin,
            s_tmax=cfg.s_tmax, s_noise=cfg.s_noise,
        )
    if "ancestral" in cfg.sampler.lower():
        kw["eta"] = cfg.eta if cfg.eta else 1.0

    def run(unet_params, spec, x, key, noises, depth_mask, guide_args):
        hoisted_kv = _hoisted_kv(unet_params, spec, x.shape[0])
        unet_eps = _make_unet_eps(unet_params, hoisted_kv)

        _, den_fn = make_denoiser(
            unet_eps, spec, gcfg=cfg.guidance,
            model_sigmas=jnp.asarray(bundle.tables.sigmas),
            parameterization=bundle.parameterization,
            depth_mask=depth_mask,
        )

        # DeepCache for the k-diffusion scans (opt-in approximate; same
        # carry protocol as the DDIM family — kdiff._den2). The raw UNet
        # output is CFG-combined first and v-param-converted at the
        # denoised level, matching make_denoiser's sigma-space contract.
        dc_state0 = None
        if cfg.deepcache_interval >= 2:
            from complex_prompt_diffusion_tpu.guidance.cfg import (
                make_denoiser_deepcache,
            )

            unet_full, unet_shallow, dc_state0 = _deepcache_setup(
                unet_params, hoisted_kv, x, spec, depth_mask
            )
            den_fn = make_denoiser_deepcache(
                unet_full, unet_shallow, spec,
                interval=cfg.deepcache_interval, gcfg=cfg.guidance,
                model_sigmas=jnp.asarray(bundle.tables.sigmas),
                parameterization=bundle.parameterization,
                depth_mask=depth_mask,
            )

        if step_callback is not None:
            inner_den = den_fn

            def _announce(sigma, denoised):
                jax.debug.callback(
                    step_callback, jnp.asarray(sigma).reshape(-1)[0], denoised
                )

            if dc_state0 is not None:

                def den_fn(x_, sigma, uc_scale, i, st, _inner=inner_den):
                    denoised, st = _inner(x_, sigma, uc_scale, i, st)
                    _announce(sigma, denoised)
                    return denoised, st

            else:

                def den_fn(x_, sigma, uc_scale, _inner=inner_den):
                    denoised = _inner(x_, sigma, uc_scale)
                    _announce(sigma, denoised)
                    return denoised

        kw_run = dict(kw)
        if dc_state0 is not None:
            kw_run["den_state"] = dc_state0
        x0, _ = sample_fn(
            den_fn, x, sigmas, uc_scales, key=key, noises=noises, **kw_run
        )
        return x0

    return jax.jit(run, donate_argnums=(2,))


def sample_latents(
    bundle: ModelBundle,
    spec: GuidanceSpec,
    cfg: RenderConfig,
    *,
    x_init: Optional[jax.Array] = None,
    key: Optional[jax.Array] = None,
    noises: Optional[jax.Array] = None,
    depth_mask: Optional[jax.Array] = None,
    t_start: Optional[int] = None,
    clip_guidance=None,
    step_callback=None,
) -> jax.Array:
    """Run the configured sampler; returns final latents [B, h, w, 4]
    (unscaled model space). The whole chain is one jit'd program, cached on
    the bundle per RenderConfig.

    ``clip_guidance``: optional (vision_cfg, vision_params, text_embedding,
    ClipGuidanceConfig) enabling per-step CLIP gradient guidance
    (t-family samplers only)."""
    family, sample_fn = SA.get_sampler(cfg.sampler)
    if cfg.tome_ratio > 0.0 and (
        bundle.unet_cfg.tome_ratio != cfg.tome_ratio
        or bundle.unet_cfg.tome_mode != cfg.tome_mode
    ):
        # opt-in token reduction: static knobs on the UNet config so the
        # decision happens at trace time (_jit_cache keys include cfg)
        bundle = dataclasses.replace(
            bundle,
            unet_cfg=dataclasses.replace(
                bundle.unet_cfg,
                tome_ratio=cfg.tome_ratio,
                tome_mode=cfg.tome_mode,
            ),
        )
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    key_init, key_steps = jax.random.split(key)
    shape = (cfg.batch_size,) + cfg.latent_shape

    # the UNet ladder needs the latent grid divisible by 2^(levels-1)
    # (otherwise skip-connection shapes mismatch mid-network)
    div = 2 ** (len(bundle.unet_cfg.channel_mult) - 1)
    lh, lw = cfg.latent_shape[0], cfg.latent_shape[1]
    # pixel % 8 must be checked too: latent_shape floor-divides, so e.g.
    # W=33 would silently render at 32 instead of failing loudly
    if lh % div or lw % div or cfg.height % 8 or cfg.width % 8:
        raise ValueError(
            f"width/height must give latents divisible by {div} "
            f"(got latent {lh}x{lw} from {cfg.height}x{cfg.width}); "
            f"use multiples of {8 * div} pixels"
        )

    if clip_guidance is not None:
        vision_cfg, vision_params, text_emb, cg_cfg = clip_guidance
        cg_static = (vision_cfg, cg_cfg)
        guide_args = (vision_params, jnp.asarray(text_emb))
    else:
        cg_static = None
        guide_args = None

    cache_key = (
        cfg, t_start, depth_mask is not None, noises is not None, cg_static,
        step_callback,
    )
    run = bundle._jit_cache.get(cache_key)
    if run is None:
        run = _build_sampler_fn(
            bundle, cfg, t_start, depth_mask is not None, noises is not None,
            clip_guidance=cg_static, step_callback=step_callback,
        )
        bundle._jit_cache[cache_key] = run

    if x_init is not None:
        x_T = x_init
    else:
        x_T = jax.random.normal(key_init, shape, jnp.float32)
        if family == "sigma":
            sigmas = _sigma_schedule(bundle, cfg)
            if t_start is not None:
                sigmas = sigmas[len(sigmas) - 1 - t_start :]
            x_T = x_T * float(sigmas[0])
    return run(
        bundle.unet_params, spec, x_T, key_steps, noises, depth_mask, guide_args
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _decode_latents_u8_jit(cfg, params, latents):
    img = M.vae_decode(cfg, params, latents / LATENT_SCALE)
    img = jnp.clip((img + 1.0) / 2.0, 0.0, 1.0)
    return jnp.round(img * 255).astype(jnp.uint8)


def decode_latents(bundle: ModelBundle, latents: jax.Array) -> np.ndarray:
    """Latents -> uint8 HWC images (render.py:31-36 semantics: /0.18215,
    VAE decode, [-1,1] -> [0,255]). The decode + postprocess is one jit'd
    program returning uint8 (one device->host transfer)."""
    return np.asarray(
        _decode_latents_u8_jit(bundle.vae_cfg, bundle.vae_params, latents)
    )


@functools.partial(jax.jit, static_argnames=("cfg", "sample"))
def _vae_encode_jit(cfg, params, img, key, sample):
    post = M.vae_encode(cfg, params, img)
    z = post.sample(key) if sample else post.mode()
    return z * LATENT_SCALE


def encode_image(
    bundle: ModelBundle, image: np.ndarray, key: Optional[jax.Array] = None
) -> jax.Array:
    """uint8/float HWC image(s) -> scaled latents (prompts.py:324-333)."""
    img = jnp.asarray(image, jnp.float32)
    if img.ndim == 3:
        img = img[None]
    if img.dtype == jnp.uint8 or float(img.max()) > 2.0:
        img = img / 127.5 - 1.0
    return _vae_encode_jit(
        bundle.vae_cfg, bundle.vae_params, img,
        jax.random.PRNGKey(0) if key is None else key, key is not None,
    )


def txt2img(
    bundle: ModelBundle,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    key: Optional[jax.Array] = None,
    noises: Optional[jax.Array] = None,
    x_T: Optional[jax.Array] = None,
    depth_mask: Optional[jax.Array] = None,
    decode: bool = True,
    step_callback=None,
):
    """Text to image (manager.process_txt2img semantics, manager.py:52-66).

    ``step_callback(t, x0_pred)``: optional host-side per-step preview hook
    (see samplers/callbacks.py). Returns (images_uint8 | None, latents)."""
    spec = (
        prompt
        if isinstance(prompt, GuidanceSpec)
        else make_guidance_spec(bundle, prompt, negative_prompt)
    )
    latents = sample_latents(
        bundle, spec, cfg, x_init=x_T, key=key, noises=noises,
        depth_mask=depth_mask, step_callback=step_callback,
    )
    images = decode_latents(bundle, latents) if decode else None
    return images, latents


def img2img_t_enc(strength: float, steps: int, family: str) -> int:
    """Denoise-step count for img2img.

    The reference uses OPPOSITE conventions per family: the DDIM/PLMS
    wrapper runs ``strength * steps`` denoise steps
    (diffusion.py:118: ``t_enc = int(min(strength, 0.999) * steps)``)
    while the k-diffusion wrapper runs ``(1 - strength) * steps``
    (k_diffusion.py:37). Both quirks are preserved verbatim.
    """
    if family == "t":
        return max(1, min(int(min(strength, 0.999) * steps), steps))
    return int((1 - min(strength, 0.999)) * steps)


def img2img(
    bundle: ModelBundle,
    image: np.ndarray,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    key: Optional[jax.Array] = None,
    depth_mask: Optional[jax.Array] = None,
    decode: bool = True,
):
    """Image to image via stochastic encode -> partial reverse chain
    (manager.process_img2img :68 / DiffusionSamplerWrapper.sample_img
    diffusion.py:113-130 / ddim.py:665-737)."""
    spec = (
        prompt
        if isinstance(prompt, GuidanceSpec)
        else make_guidance_spec(bundle, prompt, negative_prompt)
    )
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    k_enc, k_noise, k_steps = jax.random.split(key, 3)

    z0 = encode_image(bundle, image, key=k_enc)

    family, _ = SA.get_sampler(cfg.sampler)
    if family in ("solver", "trig"):
        raise ValueError(
            f"img2img is not supported with the {cfg.sampler!r} sampler "
            "(no partial-noise entry point); use a DDIM/PLMS or k-diffusion "
            "sampler"
        )
    if family == "t":
        itables = S.make_inference_tables(
            bundle.tables, cfg.steps, eta=cfg.eta, discretize=cfg.discretize
        )
        s = itables.num_steps
        t_enc = img2img_t_enc(cfg.denoising_strength, s, "t")
        # stochastic encode to timestep t_enc (discrete.py:655-679, with the
        # mathematically-correct sqrt(a_t) — documented deviation)
        a_t = float(itables.alphas_cumprod_t[t_enc - 1])
        noise = jax.random.normal(k_noise, z0.shape, jnp.float32)
        x_t = np.sqrt(a_t) * z0 + np.sqrt(1 - a_t) * noise
        latents = sample_latents(
            bundle, spec, cfg, x_init=x_t, key=k_steps,
            depth_mask=depth_mask, t_start=t_enc,
        )
    else:
        sigmas = _sigma_schedule(bundle, cfg)
        t_enc = img2img_t_enc(cfg.denoising_strength, cfg.steps, "k")
        # start index into the sigma schedule (k_diffusion.py:38-46)
        idx = max(0, cfg.steps - t_enc - 1)
        noise = jax.random.normal(k_noise, z0.shape, jnp.float32)
        x_t = z0 + noise * float(sigmas[idx])
        latents = sample_latents(
            bundle, spec, cfg, x_init=x_t, key=k_steps,
            depth_mask=depth_mask, t_start=len(sigmas) - 1 - idx,
        )
    images = decode_latents(bundle, latents) if decode else None
    return images, latents


def inpaint(
    bundle: ModelBundle,
    image: np.ndarray,
    mask: np.ndarray,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    key: Optional[jax.Array] = None,
    decode: bool = True,
):
    """Finetuned-inpaint-model path (LatentInpaintDiffusion,
    ddpm.py:1802-1851): the UNet consumes 9 channels — noisy latents plus a
    channel-wise concat of [mask (nearest-resized to the latent grid),
    VAE-encoded masked image], concat_keys=("mask", "masked_image") order.
    Requires an inpaint-shaped bundle (unet_cfg.in_channels == 9); for plain
    SD weights use the RePaint sampler path (the manager's mask dispatch
    picks automatically).

    ``mask``: [H, W] (or [H, W, 1]) array, nonzero = region to regenerate.
    """
    if bundle.unet_cfg.in_channels < 9:
        raise ValueError(
            "bundle is not an inpaint model "
            f"(unet in_channels={bundle.unet_cfg.in_channels}, need 9); "
            "use the RePaint path for plain SD checkpoints"
        )
    spec = (
        prompt
        if isinstance(prompt, GuidanceSpec)
        else make_guidance_spec(bundle, prompt, negative_prompt)
    )
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    k_enc, k_samp = jax.random.split(key)

    m = np.asarray(mask, np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    m = (m > 0.5).astype(np.float32)
    img = np.asarray(image, np.float32)
    masked = img * (1.0 - m)[..., None]  # mask=1 -> hole to regenerate
    masked_z = encode_image(bundle, masked, key=k_enc)
    lh, lw = masked_z.shape[1], masked_z.shape[2]
    mask_lat = jax.image.resize(
        jnp.asarray(m)[None, :, :, None], (1, lh, lw, 1), "nearest"
    )
    concat = jnp.concatenate([mask_lat, masked_z], axis=-1)  # [1,lh,lw,5]
    latents = sample_latents(
        bundle, spec, cfg, key=k_samp, depth_mask=concat
    )
    images = decode_latents(bundle, latents) if decode else None
    return images, latents


def depth2img(
    bundle: ModelBundle,
    image: np.ndarray,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    estimator=None,
    key: Optional[jax.Array] = None,
    decode: bool = True,
):
    """Depth-conditioned img2img (LatentDepth2ImageDiffusion semantics,
    ddpm.py:1852 + the depth-mask concat hook ddim.py:274-276): estimate a
    depth map from the input image, resize to the latent grid, feed it as
    the UNet's 5th input channel, and run img2img."""
    from complex_prompt_diffusion_tpu.depth import DepthManager

    mgr = DepthManager(estimator=estimator, size=(cfg.height // 8, cfg.width // 8))
    depth_mask = mgr.conditioning_channel(image)
    return img2img(
        bundle, image, prompt, negative_prompt, cfg,
        key=key, depth_mask=depth_mask, decode=decode,
    )


def render_config_to_json(cfg: RenderConfig) -> dict:
    """Session-state serialization (the reference round-trips sampler configs
    through JSON, diffusion.py:67-82)."""
    data = dataclasses.asdict(cfg)
    data["guidance"] = dataclasses.asdict(cfg.guidance)
    return data


def render_config_from_json(data: dict) -> RenderConfig:
    data = dict(data)
    g = data.pop("guidance", {})
    known_g = {f.name for f in dataclasses.fields(GuidanceConfig)}
    known = {f.name for f in dataclasses.fields(RenderConfig)} - {"guidance"}
    return RenderConfig(
        guidance=GuidanceConfig(**{k: v for k, v in g.items() if k in known_g}),
        **{k: v for k, v in data.items() if k in known},
    )


def save_bundle(bundle: ModelBundle, path: str):
    """Persist a bundle's params (orbax PyTree checkpoint) + configs (JSON).

    The session-state counterpart of the reference's torch pickles
    (manager.py:18, SURVEY §5 checkpoint/resume)."""
    import json
    import os

    import orbax.checkpoint as ocp

    os.makedirs(path, exist_ok=True)
    ckpt = ocp.PyTreeCheckpointer()
    ckpt.save(
        os.path.join(path, "params"),
        {
            "unet": bundle.unet_params,
            "vae": bundle.vae_params,
            "clip": bundle.clip_params,
        },
        force=True,
    )
    meta = {
        "version": bundle.version,
        "parameterization": bundle.parameterization,
        "clip_layer": bundle.clip_layer,
        "unet_cfg": dataclasses.asdict(bundle.unet_cfg),
        "vae_cfg": dataclasses.asdict(bundle.vae_cfg),
        "clip_cfg": dataclasses.asdict(bundle.clip_cfg),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_bundle(path: str, vocab_path: Optional[str] = None) -> ModelBundle:
    import json
    import os

    import orbax.checkpoint as ocp

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    def _cfg(cls, data):
        fields = {f.name for f in dataclasses.fields(cls)}
        data = {k: (tuple(v) if isinstance(v, list) else v) for k, v in data.items()}
        return cls(**{k: v for k, v in data.items() if k in fields})

    ckpt = ocp.PyTreeCheckpointer()
    params = ckpt.restore(os.path.join(path, "params"))
    return ModelBundle(
        version=meta["version"],
        unet_cfg=_cfg(M.UNetConfig, meta["unet_cfg"]),
        unet_params=params["unet"],
        vae_cfg=_cfg(M.VAEConfig, meta["vae_cfg"]),
        vae_params=params["vae"],
        clip_cfg=_cfg(M.CLIPTextConfig, meta["clip_cfg"]),
        clip_params=params["clip"],
        tokenizer=get_tokenizer(
            vocab_path,
            pad_with_eos=(meta["version"] == "sd1"),
            vocab_size=meta["clip_cfg"].get("vocab_size", 49408),
        ),
        tables=S.make_diffusion_tables(),
        parameterization=meta["parameterization"],
        clip_layer=meta["clip_layer"],
    )


def upscale_latents(
    bundle: ModelBundle,
    low_res_image: np.ndarray,
    prompt: Union[str, GuidanceSpec],
    cfg: RenderConfig = RenderConfig(),
    *,
    noise_level: int = 20,
    key: Optional[jax.Array] = None,
    decode: bool = True,
):
    """Latent upscaler pipeline (LatentUpscaleDiffusion semantics,
    ddpm.py:1319-1658): the low-res image is noise-augmented to
    ``noise_level``, concatenated channel-wise to the latent (hybrid
    conditioning), and the level is fed through the class-embedding path.

    Requires a bundle whose UNet is UNetConfig.sd_upscaler()-shaped. The
    low-res image conditions at latent resolution (H/8 x W/8 of the output).
    """
    spec = (
        prompt
        if isinstance(prompt, GuidanceSpec)
        else make_guidance_spec(bundle, prompt)
    )
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    k_aug, k_s = jax.random.split(key)

    img = jnp.asarray(low_res_image, jnp.float32)
    if img.ndim == 3:
        img = img[None]
    if float(img.max()) > 2.0:
        img = img / 127.5 - 1.0
    lh, lw = cfg.latent_shape[0], cfg.latent_shape[1]
    img = jax.image.resize(img, (img.shape[0], lh, lw, img.shape[-1]), "bilinear")

    # noise augmentation at the given level (q_sample on the concat channels)
    tables = bundle.tables
    a = float(np.sqrt(tables.alphas_cumprod[noise_level]))
    s1m = float(np.sqrt(1 - tables.alphas_cumprod[noise_level]))
    img_aug = a * img + s1m * jax.random.normal(k_aug, img.shape, jnp.float32)

    latents = sample_latents(
        bundle, spec, cfg, key=k_s, depth_mask=img_aug[0],
    )
    images = decode_latents(bundle, latents) if decode else None
    return images, latents
