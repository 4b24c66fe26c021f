"""Benchmark: SD-1.5 512x512, DDIM-50, CFG 7.5 — images/sec on one GPU.

Every mode prints JSON lines that name the device they ran on (platform,
device kind, device count, the card's power limit). Full SD-1.5 shapes run
whenever an accelerator is present; without one the script exits non-zero
unless ``--small`` asks for the tiny CPU-sized smoke configuration
explicitly (whose numbers are not device metrics).

``roofline_share`` is achieved images/s over the images/s the device's
published bf16 peak allows for the exact step FLOPs (1.6065 TFLOP per image
per DDIM step with CFG, enumerated by ``scripts/roofline.py``).

Runs with random bf16 weights (weights do not affect runtime). Usage:
  python bench.py            # streamed end-to-end headline (full size)
  python bench.py --scan     # sampling scan only
  python bench.py --e2e      # scan row, then one-request-at-a-time e2e
  python bench.py --latency  # batch-1 seconds to first image
  python bench.py --small    # tiny config smoke run (CPU-friendly)
"""

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from complex_prompt_diffusion_tpu.device import (
    ACCELERATORS,
    compute_dtype,
    enable_compile_cache,
)

# Published dense peaks per device kind (NVIDIA H100 SXM data sheet: bf16
# tensor cores without sparsity, HBM3 bandwidth). A device not listed is an
# error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet",
    },
}

# Exact FLOPs of one DDIM step per image, CFG (uncond + cond) included:
# scripts/roofline.py's enumeration of the SD-1.5 UNet at 512x512.
FLOPS_PER_IMAGE_STEP = 1.6065e12


def peaks(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "bench.PEAKS with its source"
        )
    return PEAKS[device_kind]


def _power_limit() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip()


class Device:
    """What every result line says about where it ran."""

    def __init__(self, small: bool):
        dev = jax.devices()[0]
        self.full = not small
        if self.full and dev.platform not in ACCELERATORS:
            raise SystemExit(
                f"bench.py: no accelerator (JAX reports {dev.platform!r}); "
                "pass --small for the tiny CPU smoke configuration"
            )
        self.fields = {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "power_limit": _power_limit(),
        }
        self.kind = dev.device_kind

    def roofline_share(self, images_per_sec: float, steps: int):
        if not self.full:
            return None
        sol = peaks(self.kind)["bf16_flops"] / (FLOPS_PER_IMAGE_STEP * steps)
        return round(images_per_sec / sol, 4)

    def emit(self, **row):
        print(json.dumps({**row, **self.fields}), flush=True)


def _bundle(dev: Device, vae_bf16: bool = False):
    from complex_prompt_diffusion_tpu.pipeline import ModelBundle

    bundle = ModelBundle.random("sd15" if dev.full else "tiny")
    bundle = bundle.cast(compute_dtype(jax.default_backend()), donate=True)
    if vae_bf16:
        bundle = bundle.cast_vae("bfloat16")
    return bundle


def _approx_tags(args) -> str:
    tag = ""
    if getattr(args, "tome", 0.0) > 0.0:
        kind = "ToDo" if getattr(args, "tome_mode", "") == "downsample" else "ToMe"
        tag += f" +{kind}{args.tome:g} (approx)"
    if getattr(args, "deepcache", 0) >= 2:
        tag += f" +DeepCache{args.deepcache} (approx)"
    return tag


def bench_e2e(args, dev: Device):
    """End-to-end row: tokenize -> CLIP encode -> sampling scan -> VAE
    decode -> host u8, all inside the timed region, one request at a time."""
    from complex_prompt_diffusion_tpu.pipeline import RenderConfig, txt2img

    bundle = _bundle(dev, getattr(args, "vae_bf16", False))
    size = 512 if dev.full else 32
    steps = args.steps if dev.full else 2
    cfg = RenderConfig(
        steps=steps, width=size, height=size, batch_size=args.batch,
        tome_ratio=getattr(args, "tome", 0.0),
        tome_mode=getattr(args, "tome_mode", "downsample"),
        deepcache_interval=getattr(args, "deepcache", 0),
    )
    prompts = [
        "a photograph of an astronaut riding a horse, seed %d" % i
        for i in range(args.repeats + 1)
    ]
    t0 = time.perf_counter()
    imgs, _ = txt2img(bundle, prompts[0], cfg=cfg)  # compiles every program
    compile_s = time.perf_counter() - t0
    assert imgs is not None and imgs.dtype == np.uint8
    times = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        imgs, _ = txt2img(bundle, prompts[1 + i], cfg=cfg)  # host u8: synced
        assert imgs.shape[0] == args.batch
        times.append(time.perf_counter() - t0)
    dt = min(times)
    images_per_sec = args.batch / dt
    metric = (
        "images/sec e2e(tokenize+CLIP+scan+VAEdecode) "
        "SD1.5 512x512 DDIM-50 CFG7.5"
        if dev.full
        else "images/sec e2e tiny smoke (not a device metric)"
    )
    dev.emit(
        metric=metric + _approx_tags(args),
        value=round(images_per_sec, 4),
        unit="images/sec",
        roofline_share=dev.roofline_share(images_per_sec, steps),
        total_s_per_batch=round(dt, 3),
        first_request_s=round(compile_s, 3),
        steps=steps,
    )


def bench_latency(args, dev: Device):
    """Seconds to first image, end to end at batch 1: the exact path, then
    the labelled approximate operating point (DeepCache 3 + ToDo 0.75)."""
    from complex_prompt_diffusion_tpu.pipeline import RenderConfig, txt2img

    bundle = _bundle(dev, vae_bf16=dev.full)
    size = 512 if dev.full else 32
    steps = args.steps if dev.full else 2
    prompts = [
        "a photograph of an astronaut riding a horse, seed %d" % i
        for i in range(args.repeats + 1)
    ]
    for tag, kw in (
        ("exact", {}),
        ("approx DeepCache3+ToDo0.75", dict(
            deepcache_interval=3, tome_ratio=0.75, tome_mode="downsample")),
    ):
        cfg = RenderConfig(
            steps=steps, width=size, height=size, batch_size=1, **kw
        )
        imgs, _ = txt2img(bundle, prompts[0], cfg=cfg)  # compile
        assert imgs is not None and imgs.dtype == np.uint8
        times = []
        for i in range(args.repeats):
            t0 = time.perf_counter()
            imgs, _ = txt2img(bundle, prompts[1 + i], cfg=cfg)
            times.append(time.perf_counter() - t0)
        metric = (
            f"seconds-to-first-image e2e batch1 {tag} "
            "SD1.5 512x512 DDIM-50 CFG7.5 bf16-decode"
            if dev.full
            else f"seconds-to-first-image tiny smoke {tag} (not a device metric)"
        )
        dev.emit(metric=metric, value=round(min(times), 3), unit="seconds",
                 steps=steps)


def bench_e2e_stream(args, dev: Device):
    """The headline: streamed end-to-end throughput — tokenize + CLIP encode
    + 50-step scan + VAE decode + u8 host transfer for a stream of batches,
    each batch's decode and transfer dispatched asynchronously so that they
    overlap the next batch's scan. The negative prompt is encoded once per
    stream. The exact f32-decode row prints first, the bf16-decode row
    (tagged in the metric string) last."""
    from complex_prompt_diffusion_tpu.guidance import GuidanceSpec
    from complex_prompt_diffusion_tpu.pipeline import (
        RenderConfig, _decode_latents_u8_jit, encode_prompt, sample_latents,
    )

    bundle = _bundle(dev)
    size = 512 if dev.full else 32
    steps = args.steps if dev.full else 2
    cfg = RenderConfig(
        steps=steps, width=size, height=size, batch_size=args.batch,
    )
    n_stream = args.stream
    prompts = [
        "a photograph of an astronaut riding a horse, seed %d" % i
        for i in range(3 * (n_stream + 1))
    ]
    neg = "blurry, low quality"

    def stream(b, prompt_list):
        imgs = []
        pending = []
        uncond = encode_prompt(b, neg)[0]  # once per stream, not per batch
        for i, prompt in enumerate(prompt_list):
            spec = GuidanceSpec.single(encode_prompt(b, prompt)[0], uncond)
            lat = sample_latents(b, spec, cfg, key=jax.random.PRNGKey(31 + i))
            pending.append(
                _decode_latents_u8_jit(b.vae_cfg, b.vae_params, lat)
            )
            if len(pending) > 1:
                imgs.append(np.asarray(pending.pop(0)))
        while pending:
            imgs.append(np.asarray(pending.pop(0)))
        return imgs

    rows = [("exact-f32-decode", bundle)]
    if dev.full:
        rows.append(("bf16-decode", bundle.cast_vae("bfloat16")))
    for tag, b in rows:
        off = 0 if tag == "exact-f32-decode" else (n_stream + 1)
        t0 = time.perf_counter()
        stream(b, prompts[off : off + 1])  # compile warmup
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        imgs = stream(b, prompts[off + 1 : off + 1 + n_stream])
        dt = time.perf_counter() - t0
        assert len(imgs) == n_stream and imgs[0].dtype == np.uint8
        images_per_sec = n_stream * args.batch / dt
        metric = (
            "images/sec e2e streamed (tok+CLIP+scan+VAEdecode+host) "
            f"SD1.5 512x512 DDIM-50 CFG7.5 {tag}"
            if dev.full
            else f"images/sec e2e streamed tiny smoke {tag} (not a device metric)"
        )
        dev.emit(
            metric=metric,
            value=round(images_per_sec, 4),
            unit="images/sec",
            roofline_share=dev.roofline_share(images_per_sec, steps),
            warmup_s=round(compile_s, 3),
            stream_batches=n_stream,
            batch=args.batch,
            steps=steps,
        )


def bench_scan(args, dev: Device):
    """Sampling scan only: the jitted DDIM loop without CLIP, decode or the
    host transfer."""
    from complex_prompt_diffusion_tpu import models as M
    from complex_prompt_diffusion_tpu import samplers as SA
    from complex_prompt_diffusion_tpu import schedules as S
    from complex_prompt_diffusion_tpu.guidance import GuidanceSpec, make_denoiser
    from complex_prompt_diffusion_tpu.guidance.cfg import (
        GuidanceConfig, make_uc_scale_schedule, stacked_context,
    )

    if dev.full:
        unet_cfg = M.UNetConfig.sd15()
        h = w = 64  # 512x512 image
        ctx_dim = 768
        batch = args.batch
    else:
        unet_cfg = M.UNetConfig.tiny(context_dim=64)
        h = w = 16
        ctx_dim = 64
        batch = 1
    if getattr(args, "tome", 0.0) > 0.0:
        import dataclasses

        unet_cfg = dataclasses.replace(
            unet_cfg, tome_ratio=args.tome,
            tome_mode=getattr(args, "tome_mode", "downsample"),
        )

    key = jax.random.PRNGKey(0)
    params = M.init_unet(key, unet_cfg)
    dtype = jnp.dtype(compute_dtype(jax.default_backend()))
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)

    tables = S.make_diffusion_tables()
    itables = S.make_inference_tables(tables, args.steps, eta=0.0)
    s = itables.num_steps

    cond = jax.random.normal(jax.random.fold_in(key, 1), (77, ctx_dim))
    uncond = jax.random.normal(jax.random.fold_in(key, 2), (77, ctx_dim))
    spec = GuidanceSpec.single(cond, uncond)
    gcfg = GuidanceConfig(guidance_scale=7.5)
    uc_scales = jnp.asarray(make_uc_scale_schedule(gcfg, s), jnp.float32)
    # max UNet sub-batch (RenderConfig.unet_batch_chunk semantics; 0 never
    # splits)
    chunk = args.unet_chunk

    # params threaded as a jit ARG — closing over them would embed the
    # weights into the XLA module as constants
    @jax.jit
    def run(p, x_T, k):
        # cross-attention k/v are loop-invariant: hoist them out of the scan
        kv = M.precompute_cross_kv(
            unet_cfg, p, stacked_context(spec, x_T.shape[0])
        )

        dc = getattr(args, "deepcache", 0)
        if dc >= 2:
            from complex_prompt_diffusion_tpu.guidance.cfg import (
                _batched_inputs, cfg_epsilon_deepcache,
            )

            unet_full, unet_shallow = M.make_deepcache_unets(
                unet_cfg, p, None, cross_kv=kv, batch_chunk=chunk
            )
            deep_sd = jax.eval_shape(
                lambda x_: unet_full(
                    *_batched_inputs(x_, jnp.zeros((), jnp.float32), spec, None)
                )[1],
                x_T,
            )

            def eps_fn(x, t, uc, blur, i, st):
                return cfg_epsilon_deepcache(
                    unet_full, unet_shallow, x, t, spec, uc,
                    (i % dc) == 0, st, gcfg=gcfg, uc_blur_on=blur,
                )

            x0, _ = SA.sample_ddim(
                eps_fn, x_T, itables, uc_scales, key=k, unroll=args.unroll,
                eps_state=jnp.zeros(deep_sd.shape, deep_sd.dtype),
            )
            return x0

        def unet_eps(x, t, ctx):
            b = x.shape[0]
            if chunk > 0 and b > chunk:
                outs = []
                for lo in range(0, b, chunk):
                    sl = slice(lo, min(lo + chunk, b))
                    kv_i = jax.tree.map(lambda a: a[sl], kv)
                    outs.append(
                        M.unet_apply(
                            unet_cfg, p, x[sl], t[sl], ctx[sl], cross_kv=kv_i
                        )
                    )
                return jnp.concatenate(outs, axis=0)
            return M.unet_apply(unet_cfg, p, x, t, ctx, cross_kv=kv)

        eps_fn, _ = make_denoiser(unet_eps, spec, gcfg=gcfg)
        x0, _ = SA.sample_ddim(
            eps_fn, x_T, itables, uc_scales, key=k, unroll=args.unroll
        )
        return x0

    shape = (batch, h, w, 4)

    def make_xT(i):  # x_T is donated by the samplers: one per call
        return jax.random.normal(jax.random.fold_in(key, 100 + i), shape, jnp.float32)

    t0 = time.perf_counter()
    jax.block_until_ready(run(params, make_xT(0), jax.random.PRNGKey(1)))
    compile_s = time.perf_counter() - t0

    times = []
    for i in range(args.repeats):
        x_T = make_xT(1 + i)
        jax.block_until_ready(x_T)
        t0 = time.perf_counter()
        jax.block_until_ready(run(params, x_T, jax.random.PRNGKey(2 + i)))
        times.append(time.perf_counter() - t0)
    dt = min(times)
    images_per_sec = batch / dt

    metric = (
        "images/sec scan SD1.5 512x512 DDIM-50 CFG7.5"
        if dev.full
        else "images/sec tiny-unet scan smoke (not a device metric)"
    )
    dev.emit(
        metric=metric + _approx_tags(args),
        value=round(images_per_sec, 4),
        unit="images/sec",
        roofline_share=dev.roofline_share(images_per_sec, s),
        per_step_ms=round(dt / s * 1000.0, 3),
        first_call_s=round(compile_s, 3),
        steps=s,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny CPU-sized configuration; not a device metric")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument(
        "--unroll", type=int, default=1,
        help="lax.scan unroll factor for the sampling loop (A/B knob)",
    )
    ap.add_argument(
        "--unet-chunk", dest="unet_chunk", type=int, default=0,
        help="max UNet sub-batch per call (0 = never split; "
        "pipeline RenderConfig.unet_batch_chunk semantics)",
    )
    ap.add_argument(
        "--e2e", action="store_true",
        help="time tokenize+CLIP encode+scan+VAE decode (honest end-to-end)",
    )
    ap.add_argument(
        "--vae-bf16", dest="vae_bf16", action="store_true",
        help="bf16 autoencoder for the e2e decode",
    )
    ap.add_argument(
        "--tome", type=float, default=0.0,
        help="opt-in token reduction at the S>=4096 self-attention sites "
        "(approximate: the metric is labeled accordingly)",
    )
    ap.add_argument(
        "--tome-mode", default="downsample", choices=["downsample", "merge"],
        help="token-reduction mode: ToDo K/V pooling or ToMe-SD merging",
    )
    ap.add_argument(
        "--deepcache", type=int, default=0,
        help="opt-in DeepCache interval: full UNet every Nth step, shallow "
        "level-0-only retrieval in between (approximate: labeled)",
    )
    ap.add_argument(
        "--latency", action="store_true",
        help="batch-1 e2e seconds-to-first-image rows (exact + labeled "
        "approximate operating point)",
    )
    ap.add_argument(
        "--scan", dest="scan_only", action="store_true",
        help="scan-only row: sampling loop without CLIP/decode/transfer",
    )
    ap.add_argument(
        "--stream", type=int, default=6,
        help="number of batches in the streamed e2e headline (long enough "
        "that the pipeline-fill and tail-transfer edges stop dominating)",
    )
    args = ap.parse_args(argv)

    dev = Device(args.small)
    enable_compile_cache()
    if args.latency:
        bench_latency(args, dev)
    elif args.scan_only:
        bench_scan(args, dev)
    elif args.e2e:
        bench_scan(args, dev)
        bench_e2e(args, dev)
    else:
        bench_e2e_stream(args, dev)


if __name__ == "__main__":
    sys.exit(main())
