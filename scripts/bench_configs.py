"""BASELINE.md measurement configs 3-5 (VERDICT r1 item 7).

  3: compositional multi-prompt CFG — K-factor scaling (K=1,2,4) at SD-1.5
     512x512 DDIM-20 (the factor batch rides the CFG UNet call: 1+K factors)
  4: depth2img — SD-2-depth shapes (5-ch UNet input), 512x512 DDIM-20
  5: 64-frame animation walk — single-chip throughput (the data-parallel
     8-chip path is correctness-tested on the CPU mesh in
     tests/test_multichip.py::test_data_parallel_render)

Random bf16 weights (weights don't affect runtime). One JSON line per row.

Usage: python scripts/bench_configs.py [--config 3|4|5] [--steps N]
"""
import argparse
import json
import sys
from pathlib import Path
import time

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from complex_prompt_diffusion_tpu.device import (  # noqa: E402
    enable_compile_cache,
    require_accelerator,
)

require_accelerator()
enable_compile_cache()


def _bundle():
    from complex_prompt_diffusion_tpu.pipeline import ModelBundle

    b = ModelBundle.random("sd15")
    return b.cast("bfloat16")


def bench_config3(steps: int):
    """K-factor CFG sweep: batched 1+K-factor guidance (guidance/cfg.py
    one-UNet-call path) vs K."""
    from complex_prompt_diffusion_tpu.guidance import GuidanceSpec
    from complex_prompt_diffusion_tpu.pipeline import (
        RenderConfig, sample_latents,
    )

    b = _bundle()
    rng = np.random.default_rng(0)
    uncond = jnp.asarray(rng.normal(size=(77, 768)).astype(np.float32))
    rows = []
    for k in (1, 2, 4):
        factors = jnp.asarray(
            rng.normal(size=(k, 77, 768)).astype(np.float32)
        )
        spec = GuidanceSpec(
            uncond=uncond,
            factors=factors,
            scales=jnp.asarray([7.5 / k] * k, jnp.float32),
            masks=jnp.ones((k, 1, 1, 1), jnp.float32),
        )
        cfg = RenderConfig(steps=steps, sampler="DDIM", width=512, height=512)
        lat = sample_latents(b, spec, cfg, key=jax.random.PRNGKey(0))
        jax.block_until_ready(lat)  # compile+warm
        t0 = time.perf_counter()
        lat = sample_latents(b, spec, cfg, key=jax.random.PRNGKey(1))
        jax.block_until_ready(lat)
        dt = time.perf_counter() - t0
        rows.append(
            {
                "metric": f"config3 K={k} multi-factor CFG 512x512 DDIM-{steps}",
                "value": round(1.0 / dt, 4),
                "unit": "images/sec",
                "factors_batched": 1 + k,
                "per_step_ms": round(dt / steps * 1e3, 2),
            }
        )
    return rows


def bench_config4(steps: int):
    """Depth-conditioned img2img (5-channel UNet, sd2_depth config)."""
    import dataclasses

    from complex_prompt_diffusion_tpu import models as M
    from complex_prompt_diffusion_tpu import schedules as S
    from complex_prompt_diffusion_tpu.pipeline import (
        ModelBundle, RenderConfig, img2img,
    )
    from complex_prompt_diffusion_tpu.prompts.tokenizer import get_tokenizer

    key = jax.random.PRNGKey(0)
    unet_cfg = M.UNetConfig.sd2_depth()
    clip_cfg = M.CLIPTextConfig.sd21()
    b = ModelBundle(
        version="sd2",
        unet_cfg=unet_cfg,
        unet_params=M.init_unet(key, unet_cfg),
        vae_cfg=M.VAEConfig.sd(),
        vae_params=M.init_vae(key, M.VAEConfig.sd()),
        clip_cfg=clip_cfg,
        clip_params=M.init_clip_text(key, clip_cfg),
        tokenizer=get_tokenizer(vocab_size=clip_cfg.vocab_size),
        tables=S.make_diffusion_tables(),
        clip_layer="penultimate",
    ).cast("bfloat16")
    rng = np.random.default_rng(1)
    img = (rng.random((512, 512, 3)) * 255).astype(np.uint8)
    depth = jnp.asarray(rng.normal(size=(1, 64, 64, 1)).astype(np.float32))
    cfg = RenderConfig(
        steps=steps, sampler="DDIM", width=512, height=512,
        denoising_strength=0.75,
    )
    _, lat = img2img(b, img, "a room", cfg=cfg, depth_mask=depth, decode=False)
    jax.block_until_ready(lat)
    t0 = time.perf_counter()
    _, lat = img2img(
        b, img, "a bright room", cfg=cfg, depth_mask=depth, decode=False
    )
    jax.block_until_ready(lat)
    dt = time.perf_counter() - t0
    return [
        {
            "metric": f"config4 depth2img 512x512 DDIM-{steps} strength0.75",
            "value": round(1.0 / dt, 4),
            "unit": "images/sec",
        }
    ]


def bench_config5(steps: int, frames: int = 64):
    """Animation walk: render `frames` latents sequentially (single chip),
    batch 4 per call (the data-parallel variant shards this batch axis)."""
    from complex_prompt_diffusion_tpu.pipeline import RenderConfig, txt2img

    b = _bundle()
    cfg = RenderConfig(
        steps=steps, sampler="DDIM", width=512, height=512, batch_size=4,
    )
    _, lat = txt2img(b, "a landscape, frame", cfg=cfg, decode=False)
    jax.block_until_ready(lat)
    n_calls = frames // cfg.batch_size
    t0 = time.perf_counter()
    for i in range(n_calls):
        _, lat = txt2img(
            b, "a landscape, frame", cfg=cfg,
            key=jax.random.PRNGKey(i), decode=False,
        )
        jax.block_until_ready(lat)
    dt = time.perf_counter() - t0
    return [
        {
            "metric": f"config5 animation {frames}f 512x512 DDIM-{steps} b4",
            "value": round(frames / dt, 4),
            "unit": "frames/sec/chip",
            "total_s": round(dt, 1),
        }
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0, help="3|4|5; 0=all")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()
    rows = []
    if args.config in (0, 3):
        rows += bench_config3(args.steps)
    if args.config in (0, 4):
        rows += bench_config4(args.steps)
    if args.config in (0, 5):
        rows += bench_config5(args.steps, args.frames)
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
