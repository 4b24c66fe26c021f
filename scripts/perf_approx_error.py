"""Speed-error quantification for the approximate modes (VERDICT r3 item 3).

For each opt-in approximation at the headline config (SD-1.5 512x512,
DDIM-50, CFG 7.5, batch 4, fixed seed): latent RMSE vs the exact path
(relative to the exact latents' RMS), decoded-pixel mean/max absolute delta
in u8 levels, plus the bf16-VAE-decode delta on the SAME exact latents.

Caveat (documented wherever these numbers are cited): the air-gapped
environment has no real SD weights, so the model is random-weight
(ModelBundle.random("sd15")). The *mechanism* error — how far the cached /
token-reduced path drifts from the exact scan through 50 steps of the same
network — is what this measures; absolute visual quality claims need real
weights.

Usage: python scripts/perf_approx_error.py [--steps 50] [--batch 4] [--small]

Full SD-1.5 size needs the GPU; ``--small`` runs the tiny configuration on
any backend (its times are not device metrics).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from complex_prompt_diffusion_tpu.device import (  # noqa: E402
    compute_dtype,
    enable_compile_cache,
    require_accelerator,
)
from complex_prompt_diffusion_tpu.pipeline import (  # noqa: E402
    ModelBundle, RenderConfig, decode_latents, make_guidance_spec,
    sample_latents,
)
from complex_prompt_diffusion_tpu.utils.metrics import psnr, ssim  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--small", action="store_true",
                    help="tiny configuration on any backend")
    args = ap.parse_args()

    full = not args.small
    if full:
        require_accelerator()
    enable_compile_cache()
    bundle = ModelBundle.random("sd15" if full else "tiny")
    bundle = bundle.cast(compute_dtype(jax.default_backend()))
    size = 512 if full else 32
    steps = args.steps if full else 4

    spec = make_guidance_spec(
        bundle, "a photograph of an astronaut riding a horse",
        "blurry, low quality",
    )
    base = dict(steps=steps, width=size, height=size, batch_size=args.batch)
    lat_shape = (args.batch, size // 8, size // 8, 4)
    key = jax.random.PRNGKey(42)
    x_T0 = jax.random.normal(key, lat_shape, jnp.float32)

    def render(cfg, tag):
        # fresh x_T per call (the scan donates the buffer); timed min-of-2
        lat = sample_latents(bundle, spec, cfg, x_init=jnp.array(x_T0), key=key)
        jax.block_until_ready(lat)
        best = 1e9
        for _ in range(2):
            x = jax.block_until_ready(jnp.array(x_T0))
            t0 = time.perf_counter()
            jax.block_until_ready(
                sample_latents(bundle, spec, cfg, x_init=x, key=key))
            best = min(best, time.perf_counter() - t0)
        return np.asarray(lat), best

    exact_cfg = RenderConfig(**base)
    exact, t_exact = render(exact_cfg, "exact")
    exact_img = decode_latents(bundle, jnp.asarray(exact)).astype(np.int32)
    rms_exact = float(np.sqrt(np.mean(exact.astype(np.float64) ** 2)))

    variants = [
        ("DeepCache N=2", dict(deepcache_interval=2)),
        ("DeepCache N=3", dict(deepcache_interval=3)),
        ("DeepCache N=5", dict(deepcache_interval=5)),
        ("ToDo 0.75", dict(tome_ratio=0.75, tome_mode="downsample")),
        ("ToMe 0.75", dict(tome_ratio=0.75, tome_mode="merge")),
        ("DeepCache3+ToDo", dict(deepcache_interval=3, tome_ratio=0.75,
                                 tome_mode="downsample")),
    ]

    print(f"exact: {args.batch / t_exact:.3f} img/s "
          f"(latent RMS {rms_exact:.3f})")
    print(f"{'variant':18s} {'img/s':>7s} {'speedup':>8s} {'lat relRMSE':>12s} "
          f"{'px mean|d|':>11s} {'px max|d|':>10s} {'PSNR dB':>8s} {'SSIM':>7s}")
    for tag, kw in variants:
        cfg = RenderConfig(**base, **kw)
        lat, t = render(cfg, tag)
        rmse = float(np.sqrt(np.mean((lat - exact).astype(np.float64) ** 2)))
        img = decode_latents(bundle, jnp.asarray(lat)).astype(np.int32)
        d = np.abs(img - exact_img)
        print(f"{tag:18s} {args.batch / t:7.3f} {t_exact / t:7.2f}x "
              f"{rmse / rms_exact:12.4f} {float(d.mean()):11.2f} "
              f"{int(d.max()):10d} {psnr(img, exact_img):8.2f} "
              f"{ssim(img, exact_img):7.4f}")

    # bf16 VAE decode delta on the SAME exact latents (for the default
    # decode dtype decision, VERDICT item 1)
    bf = bundle.cast_vae("bfloat16")
    img_bf = decode_latents(bf, jnp.asarray(exact)).astype(np.int32)
    d = np.abs(img_bf - exact_img)
    print(f"{'bf16 VAE decode':18s} {'-':>7s} {'-':>8s} {'-':>12s} "
          f"{float(d.mean()):11.3f} {int(d.max()):10d} "
          f"{psnr(img_bf, exact_img):8.2f} {ssim(img_bf, exact_img):7.4f}")


if __name__ == "__main__":
    main()
