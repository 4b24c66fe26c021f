"""Tiled-UNet large-canvas bench (VERDICT r1 item 6's bench row).

1024x1024 (128x128 latent) txt2img on one chip via RenderConfig.unet_tile:
64-px latent tiles, stride 32, chunked tile batching. Untiled 128x128-latent
level-0 attention is S=16384 — 16x the flops of SD's native S=4096 per
tile-row; tiling bounds it back to S=4096 per tile.

Prints one JSON line per variant.
"""
import json
import sys
from pathlib import Path
import time

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from complex_prompt_diffusion_tpu.device import (  # noqa: E402
    enable_compile_cache,
    require_accelerator,
)

require_accelerator()
enable_compile_cache()

from complex_prompt_diffusion_tpu.pipeline import (
    ModelBundle, RenderConfig, txt2img,
)


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    size = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    b = ModelBundle.random("sd15").cast("bfloat16")
    import dataclasses

    variants = (
        (64, 2, 0.0, "", False, "tiled64x2"),
        (0, 1, 0.0, "", False, "untiled"),
        # token reduction (ops/tome.py) — the untiled S=16384/4096 sites
        # are where it should pay most
        (0, 1, 0.75, "downsample", False, "untiled+todo"),
        (0, 1, 0.75, "merge", False, "untiled+tome0.75"),
        # plan reuse across FF + cross-Q (ToMe-SD merge_mlp/crossattn)
        (0, 1, 0.75, "merge", True, "untiled+tome0.75+mlp+xq"),
    )
    only = sys.argv[2].split(",") if len(sys.argv) > 2 else None
    for tile, chunk, tome, mode, mlp, label in variants:
        if only and label not in only:
            continue
        bb = b
        if mlp:
            bb = dataclasses.replace(
                b, unet_cfg=dataclasses.replace(
                    b.unet_cfg, tome_mlp=True, tome_crossattn=True
                )
            )
        cfg = RenderConfig(
            steps=steps, sampler="DDIM", width=size, height=size,
            unet_tile=tile, unet_tile_chunk=chunk,
            tome_ratio=tome, tome_mode=mode or "downsample",
        )
        try:
            _, lat = txt2img(bb, "a vast landscape", cfg=cfg, decode=False)
            jax.block_until_ready(lat)
            t0 = time.perf_counter()
            _, lat = txt2img(
                bb, "a vast landscape", cfg=cfg,
                key=jax.random.PRNGKey(1), decode=False,
            )
            jax.block_until_ready(lat)
            dt = time.perf_counter() - t0
            print(json.dumps({
                "metric": f"{size}x{size} DDIM-{steps} {label}",
                "value": round(1.0 / dt, 4),
                "unit": "images/sec",
                "per_step_ms": round(dt / steps * 1e3, 1),
            }))
        except Exception as e:  # untiled may OOM — that IS the point
            print(json.dumps({
                "metric": f"{size}x{size} DDIM-{steps} {label}",
                "error": f"{type(e).__name__}: {str(e)[:120]}",
            }))


if __name__ == "__main__":
    main()
