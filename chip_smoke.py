"""Smoke run of SD-1.5 txt2img on the GPU, through the entry points a user calls.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: the multi-device paths only

Phases (one card):
  devices   platform, device kind and count, JAX version, XLA_FLAGS, and the
            card's name and power limit from nvidia-smi (a child process that
            stays off JAX).
  txt2img   random SD-1.5 weights cast to bf16: three 512x512 batch-4 DDIM-50
            CFG-7.5 requests, the same request with every attention site on
            the XLA route, one DPM++ 2M Karras-20 request, one
            CompositionalPrompt with two conjunctions and a masked filter, one
            DiffusionModelManager JSON call; f32 and bf16 VAE decode; compile
            seconds, per-request wall seconds and device memory.
  parity    one seeded x_T through the production path (bf16, chosen routes)
            and the plain path (f32 params, XLA references, "highest").
  kernels   every attention route and GroupNorm(+SiLU) form the main path
            runs, at SD-1.5's real shapes in bf16 (and f32 for the VAE),
            compared with the plain f32 reference under "highest" matmul
            precision.
  gpu-tests the repository's tests marked ``gpu``, in this process.

With ``--chips 4``: data-parallel ``sample_latents`` over a data=4 mesh and
``parallel.tp.shard_bundle`` on a 2x2 (data x model) mesh, both in f32 under
"highest", and ``models.tiled`` tiles of the deployed bf16 model sharded over
the data axis at 1024x1024, each compared with the same work on device 0;
planted faults built from device-0 renders show that the bound separates a
one-shard fault from rounding.

This is a smoke run, not a benchmark: its seconds are those of single
requests, compilation included where labelled. Weights are random (seeded);
the checks are shapes, finiteness and agreement with the plain reference.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed. Without a GPU the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from complex_prompt_diffusion_tpu import device as D  # noqa: E402
from complex_prompt_diffusion_tpu.manager import DiffusionModelManager  # noqa: E402
from complex_prompt_diffusion_tpu.ops import attention  # noqa: E402
from complex_prompt_diffusion_tpu.ops import groupnorm as GN  # noqa: E402
from complex_prompt_diffusion_tpu.ops.attention import _xla_attention  # noqa: E402
from complex_prompt_diffusion_tpu.pipeline import (  # noqa: E402
    ModelBundle,
    RenderConfig,
    decode_latents,
    make_guidance_spec,
    sample_latents,
    txt2img,
)
from complex_prompt_diffusion_tpu.prompts import CompositionalPrompt  # noqa: E402

# Attention: bf16 q/k/v, f32 score accumulation, probabilities rounded to
# bf16 before the PV product, bf16 output. Each output element is a convex
# combination of v rows, so the error is bounded by the bf16 rounding of the
# output (2^-8 relative) plus the rounding of the probabilities (2^-9
# relative each, averaging over the KV length), in a different summation
# order per route. Measured as max |out - ref| / max |ref|.
ATTN_TOL = 2e-2
# GroupNorm(+SiLU): two-pass statistics in f32 over up to 2M elements per
# group; bf16 storage rounds the output to 2^-8 relative; f32 storage leaves
# only the order of the sums. Measured as max |out - ref| / max |ref|.
GN_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Parity: bf16 weights and activations against f32 "highest" through
# 5 DDIM steps of the whole UNet (about 100 layers in sequence, each adding
# bf16 rounding of 2^-9 relative that accumulates as a random walk), CLIP and
# VAE: relative L2 of the final latents.
PARITY_LATENT_TOL = 5e-2
# Decoded images: mean |delta| in u8 levels over all pixels.
PARITY_U8_MEAN_TOL = 3.0
# Multi-device runs against the same work on device 0: relative L2 of the
# latents, bound per size (Size.multi_tol). Each run also builds planted
# faults from device-0 renders (one data shard with its CFG halves swapped
# or another prompt's context; one tile with swapped CFG halves) and fails
# unless each lies above the bound, so the bound is shown to separate a
# one-shard fault from the paths' own differences in every run.

PROMPTS = (
    "a red fox in fresh snow, morning light",
    "a lighthouse on a cliff at dusk",
    "a bowl of ramen on a wooden table",
)


@dataclasses.dataclass(frozen=True)
class Size:
    """Model scale and shapes of one smoke run."""

    scale: str  # ModelBundle.random scale
    width: int  # image side in pixels
    batch: int
    steps: int  # DDIM steps of the txt2img requests
    dpm_steps: int
    parity_steps: int
    multi_steps: int
    hires: int  # image side of the tiled multi-device canvas
    tile: int  # tile side in latent pixels
    # attention sites: (batch, S, heads, head_dim, kv_len)
    attn: tuple
    # GroupNorm sites: ((N, H, W, C), dtype)
    gn: tuple
    # bound on the multi-device paths' relative L2 against device 0
    multi_tol: float


FULL = Size(
    scale="sd15", width=512, batch=4, steps=50, dpm_steps=20, parity_steps=5,
    multi_steps=3, hires=1024, tile=64,
    attn=(
        # UNet self-attention at UNet batch 8 (batch 4 with CFG), levels 0-3
        (8, 4096, 8, 40, 4096), (8, 1024, 8, 80, 1024),
        (8, 256, 8, 160, 256), (8, 64, 8, 160, 64),
        # cross-attention against CLIP's 77 tokens
        (8, 4096, 8, 40, 77), (8, 1024, 8, 80, 77),
        (8, 256, 8, 160, 77), (8, 64, 8, 160, 77),
        # VAE decoder mid-block: one d=512 head at 64x64 latents
        (4, 4096, 1, 512, 4096),
    ),
    gn=(
        # UNet ResBlock / transformer sites at UNet batch 8
        ((8, 64, 64, 320), "bfloat16"), ((8, 64, 64, 960), "bfloat16"),
        ((8, 32, 32, 640), "bfloat16"), ((8, 16, 16, 1280), "bfloat16"),
        ((8, 8, 8, 1280), "bfloat16"),
        # VAE decoder sites at batch 4, f32 and bf16
        ((4, 64, 64, 512), "float32"), ((4, 128, 128, 512), "float32"),
        ((4, 256, 256, 256), "float32"), ((4, 512, 512, 128), "float32"),
        ((4, 64, 64, 512), "bfloat16"), ((4, 512, 512, 128), "bfloat16"),
    ),
    # On the H100 a sample's latents depend on the batch it runs in, in f32
    # under "highest" as in bf16: batch 2 against rows of batch 8 on one
    # card reads 0.041 (f32) and 0.045 (bf16) after 3 DDIM steps, 7.8e-4
    # after one. The sharded paths hand each device fewer samples and read
    # 0.043-0.046 against device 0 on four cards; one-shard planted faults
    # read 0.216-0.419. The bound lies between, about 2x from each.
    multi_tol=0.1,
)

TINY = Size(
    scale="tiny", width=32, batch=2, steps=3, dpm_steps=3, parity_steps=2,
    multi_steps=2, hires=256, tile=16,
    attn=((2, 64, 2, 40, 64), (2, 64, 2, 40, 77), (1, 64, 1, 512, 64)),
    gn=(((2, 8, 8, 64), "bfloat16"), ((2, 8, 8, 64), "float32")),
    # the CPU's f32 programs agree across batch sizes to about 1e-6; the
    # tiny model's planted faults read 0.03-0.055
    multi_tol=1e-3,
)


class SmokeFailure(AssertionError):
    """A check of the smoke run did not hold."""


def _check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def _say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return "; ".join(line.strip() for line in r.stdout.splitlines() if line.strip())


def phase_devices() -> dict:
    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    _say("devices", **info, jax=jax.__version__,
         xla_flags=repr(os.environ.get("XLA_FLAGS", "")))
    return info


def _rel_max(out, ref) -> float:
    return float(np.max(np.abs(out - ref)) / max(np.max(np.abs(ref)), 1e-30))


def phase_kernels(size: Size) -> list:
    """Each attention site and GroupNorm site on its production route
    against the plain f32 reference."""
    platform = jax.default_backend()
    key = jax.random.PRNGKey(0)
    rows = []
    for i, (b, s, h, d, kv) in enumerate(size.attn):
        kq, kk, kvv = jax.random.split(jax.random.fold_in(key, i), 3)
        q = jax.random.normal(kq, (b, s, h * d), jnp.bfloat16)
        k = jax.random.normal(kk, (b, kv, h * d), jnp.bfloat16)
        v = jax.random.normal(kvv, (b, kv, h * d), jnp.bfloat16)
        out = jax.jit(attention, static_argnums=3)(q, k, v, h)
        out = np.asarray(out.astype(jnp.float32))

        def ref_fn(q, k, v):
            def split(x):
                return x.reshape(b, x.shape[1], h, d).transpose(0, 2, 1, 3)

            f32 = [split(x.astype(jnp.float32)) for x in (q, k, v)]
            o = _xla_attention(*f32, d ** -0.5)
            return o.transpose(0, 2, 1, 3).reshape(b, s, h * d)

        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax.jit(ref_fn)(q, k, v))
        err = _rel_max(out, ref)
        route = D.attention_route(platform, jnp.bfloat16, d, kv)
        row = dict(op="attention", shape=(b, s, h, d, kv), route=route,
                   max_abs=float(np.max(np.abs(out - ref))), rel=err,
                   tol=ATTN_TOL, ok=err <= ATTN_TOL)
        _say("kernels", **row)
        rows.append(row)
    for i, (shape, dtype) in enumerate(size.gn):
        n, hh, ww, c = shape
        x = jax.random.normal(jax.random.fold_in(key, 100 + i), shape,
                              jnp.float32) * 3.0 + 1.0
        x = x.astype(dtype)
        gamma = jnp.linspace(0.5, 1.5, c, dtype=jnp.float32)
        beta = jnp.linspace(-0.2, 0.2, c, dtype=jnp.float32)
        out = np.asarray(
            jax.jit(GN.group_norm_silu)(x, gamma, beta).astype(jnp.float32)
        )
        xn = np.asarray(x.astype(jnp.float32)).reshape(n, hh * ww, 32, c // 32)
        mean = xn.mean(axis=(1, 3), keepdims=True)
        var = xn.var(axis=(1, 3), keepdims=True)
        y = ((xn - mean) / np.sqrt(var + np.float32(1e-5))).reshape(shape)
        y = y * np.asarray(gamma) + np.asarray(beta)
        ref = y / (1.0 + np.exp(-y))
        err = _rel_max(out, ref)
        row = dict(op="group_norm_silu", shape=shape, dtype=dtype, rel=err,
                   tol=GN_TOL[dtype], ok=err <= GN_TOL[dtype])
        _say("kernels", **row)
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    _check(not bad, f"{len(bad)} kernel comparisons outside tolerance")
    return rows


def _images_ok(imgs, batch: int, side: int, what: str):
    _check(
        isinstance(imgs, np.ndarray) and imgs.dtype == np.uint8
        and imgs.shape == (batch, side, side, 3),
        f"{what}: images {getattr(imgs, 'shape', None)} "
        f"{getattr(imgs, 'dtype', None)}, want ({batch}, {side}, {side}, 3) uint8",
    )


def _latents_ok(lat, what: str):
    _check(bool(np.isfinite(np.asarray(lat)).all()), f"{what}: non-finite latents")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _vae_side(bundle: ModelBundle, width: int) -> int:
    """Decoded image side for a latent of ``width // 8`` (random test-scale
    VAEs upsample less than 8x)."""
    ups = len(bundle.vae_cfg.ch_mult) - 1
    return (width // 8) * 2 ** ups


def phase_txt2img(bundle: ModelBundle, size: Size) -> dict:
    """The main path through txt2img, CompositionalPrompt.render and the
    manager's JSON API. ``bundle`` is the deployed (bf16 UNet) bundle."""
    side = _vae_side(bundle, size.width)
    cfg = RenderConfig(
        steps=size.steps, sampler="DDIM", guidance_scale=7.5,
        width=size.width, height=size.width, batch_size=size.batch,
    )
    walls = []
    lat = None
    for i, prompt in enumerate(PROMPTS):
        # distinct seeds through ``key``: the seed field of RenderConfig is
        # part of the sampler's jit-cache key and would retrace per request
        (imgs, lat), wall = _timed(lambda: txt2img(
            bundle, prompt, "", cfg, key=jax.random.PRNGKey(i)))
        _images_ok(imgs, size.batch, side, f"DDIM request {i}")
        _latents_ok(lat, f"DDIM request {i}")
        walls.append(wall)
        label = "first request, compile included" if i == 0 else "request"
        _say("txt2img", what=f"DDIM-{size.steps} batch {size.batch}",
             label=repr(label), wall_s=wall)
    vae_bf16 = bundle.cast_vae("bfloat16")
    imgs32 = decode_latents(bundle, lat)
    _, dec32 = _timed(lambda: decode_latents(bundle, lat))
    imgs16 = decode_latents(vae_bf16, lat)
    _, dec16 = _timed(lambda: decode_latents(vae_bf16, lat))
    _images_ok(imgs16, size.batch, side, "bf16 VAE decode")
    du8 = np.abs(imgs32.astype(np.int16) - imgs16.astype(np.int16))
    _say("txt2img", what="VAE decode", f32_s=dec32, bf16_s=dec16,
         bf16_vs_f32_u8_mean=float(du8.mean()), bf16_vs_f32_u8_max=int(du8.max()))

    dpm = dataclasses.replace(
        cfg, sampler="DPM++ 2M", sigma_schedule="karras",
        steps=size.dpm_steps, seed=7,
    )
    (imgs, lat_dpm), wall = _timed(lambda: txt2img(bundle, PROMPTS[0], "", dpm))
    _images_ok(imgs, size.batch, side, "DPM++ 2M Karras")
    _latents_ok(lat_dpm, "DPM++ 2M Karras")
    _say("txt2img", what=f"DPM++ 2M Karras-{size.dpm_steps} batch {size.batch}",
         label=repr("compile included"), wall_s=wall)

    comp = CompositionalPrompt("a forest", bundle=bundle)
    comp.add_conjunction("a river", scale=0.8)
    comp.add_masked_filter("the sun", "left_third_valid", strength=0.7)
    _check(len(comp.factors) + 1 == 4, "compositional prompt: want 4 CFG factors")
    (imgs, lat_c), wall = _timed(lambda: comp.render(
        steps=size.steps, sampler="DDIM", width=size.width,
        height=size.width, batch_size=1))
    _images_ok(imgs, 1, side, "CompositionalPrompt")
    _latents_ok(lat_c, "CompositionalPrompt")
    _say("txt2img", what="CompositionalPrompt, 4 CFG factors, batch 1",
         label=repr("compile included"), wall_s=wall)

    mgr = DiffusionModelManager(bundle=bundle)
    imgs, wall = _timed(lambda: mgr.process_txt2img({
        "sampler": {"name": "Euler Ancestral", "args": {"eta": 1.0}},
        "prompt_json": {"class": "WeightedPrompt",
                        "prompt": "a cat:2.0 a dog:1.0"},
        "render": {"steps": size.dpm_steps, "W": size.width,
                   "H": size.width, "scale": 7.5},
    }))
    _images_ok(imgs, 1, side, "manager JSON call")
    _say("txt2img", what="DiffusionModelManager.process_txt2img",
         label=repr("compile included"), wall_s=wall)

    # memory of the headline sampling scan, and of the whole process so far
    run = next(v for k, v in bundle._jit_cache.items() if k[0] == cfg)
    spec = make_guidance_spec(bundle, PROMPTS[0])
    x = jnp.zeros((size.batch,) + cfg.latent_shape, jnp.float32)
    compiled = run.lower(
        bundle.unet_params, spec, x, jax.random.PRNGKey(0), None, None, None
    ).compile()
    ma = compiled.memory_analysis()
    mem = {}
    for name in ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "generated_code_size_in_bytes"):
        mem[name] = getattr(ma, name, None)
    stats = jax.devices()[0].memory_stats() or {}
    mem["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    _say("txt2img", what="memory", **mem)
    # after the memory reading: the XLA route's score tensors would set the peak
    routes = _attention_routes_end_to_end(bundle, cfg, walls[1:])
    return {"compile_and_first_s": walls[0], "request_s": walls[1:],
            "decode_f32_s": dec32, "decode_bf16_s": dec16, **routes, **mem}


def _attention_routes_end_to_end(bundle, cfg, chosen_walls) -> dict:
    """The same request with every attention site on the plain XLA route,
    against the device policy's choice: two XLA requests after a compiling
    one, then one more request on the chosen routes (chosen, XLA, XLA,
    chosen)."""
    import importlib
    from unittest import mock

    A = importlib.import_module("complex_prompt_diffusion_tpu.ops.attention")
    plain = dataclasses.replace(bundle, _jit_cache={})  # retrace
    xla = []
    with mock.patch.object(A, "attention_route", lambda *args: "xla"):
        for i in range(3):
            _, wall = _timed(lambda: txt2img(
                plain, PROMPTS[i], "", cfg, key=jax.random.PRNGKey(10 + i)))
            xla.append(wall)
    _, wall = _timed(lambda: txt2img(
        bundle, PROMPTS[0], "", cfg, key=jax.random.PRNGKey(20)))
    chosen = list(chosen_walls) + [wall]
    _say("txt2img", what="attention routes end to end, request wall s",
         chosen=chosen, all_xla=xla[1:], all_xla_first_with_compile=xla[0])
    return {"routes_chosen_s": chosen, "routes_all_xla_s": xla[1:]}


def phase_parity(bundle_f32: ModelBundle, bundle: ModelBundle, size: Size) -> dict:
    """One seeded x_T through the production path (``bundle``: bf16 UNet,
    chosen routes, default precision) and the plain path (``bundle_f32``:
    f32 params, XLA reference routes, "highest")."""
    cfg = RenderConfig(steps=size.parity_steps, sampler="DDIM",
                       width=size.width, height=size.width, batch_size=1)
    x_np = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1234), (1,) + cfg.latent_shape, jnp.float32))
    # x_T is donated to the sampling program: give each run its own copy
    img_p, lat_p = txt2img(bundle, PROMPTS[1], "", cfg, x_T=jnp.asarray(x_np))
    with jax.default_matmul_precision("highest"):
        img_r, lat_r = txt2img(
            bundle_f32, PROMPTS[1], "", cfg, x_T=jnp.asarray(x_np))
    lat_p, lat_r = np.asarray(lat_p), np.asarray(lat_r)
    _latents_ok(lat_p, "parity production")
    _latents_ok(lat_r, "parity reference")
    rel = float(np.linalg.norm(lat_p - lat_r) / np.linalg.norm(lat_r))
    du8 = np.abs(img_p.astype(np.int16) - img_r.astype(np.int16))
    row = dict(latent_rel_l2=rel, latent_tol=PARITY_LATENT_TOL,
               u8_mean=float(du8.mean()), u8_max=int(du8.max()),
               u8_mean_tol=PARITY_U8_MEAN_TOL)
    _say("parity", what=f"DDIM-{size.parity_steps} batch 1", **row)
    _check(rel <= PARITY_LATENT_TOL, f"parity latents rel L2 {rel}")
    _check(row["u8_mean"] <= PARITY_U8_MEAN_TOL,
           f"parity u8 mean delta {row['u8_mean']}")
    return row


class _PassCount:
    """pytest plugin: counts the tests that passed."""

    def __init__(self):
        self.passed = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1


def phase_gpu_tests() -> int:
    """The tests marked ``gpu``, run in this process (one process per card).
    Fails when any fails or when none ran (they skip off the GPU)."""
    import pytest

    count = _PassCount()
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
        str(REPO / "tests" / "test_gpu.py"),
    ], plugins=[count])
    _say("gpu-tests", exit_code=int(rc), passed=count.passed)
    _check(rc == 0, f"gpu tests exit code {int(rc)}")
    _check(count.passed > 0, "no gpu test ran")
    return count.passed


def _rel_l2(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _multi_compare(what: str, got, ref, tol: float) -> dict:
    _latents_ok(got, what)
    rel = _rel_l2(got, ref)
    _say("multichip", what=what, rel_l2_vs_device0=rel, tol=tol)
    _check(rel <= tol, f"{what}: rel L2 {rel} vs device 0")
    return {"what": what, "rel_l2": rel}


def _planted_fault(what: str, ref, wrong, region, tol: float) -> dict:
    """``ref`` with ``region`` taken from ``wrong``: what a sharding fault
    confined to one shard or tile would return. The check must see it."""
    faulty = np.array(ref)
    faulty[region] = np.asarray(wrong)[region]
    rel = _rel_l2(faulty, ref)
    _say("multichip", planted_fault=what, rel_l2_vs_device0=rel, tol=tol)
    _check(rel > tol, f"planted fault {what!r} passes the check: {rel}")
    return {"planted_fault": what, "rel_l2": rel}


def phase_multichip(bundle_f32: ModelBundle, bundle: ModelBundle, size: Size,
                    devices) -> list:
    """Multi-device paths on four devices, each against device 0: data and
    tensor parallelism with ``bundle_f32`` under "highest", the tiled path
    with the deployed ``bundle``. Every path runs even when another fails;
    the phase fails if any did, or if a planted fault passes."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh
    from complex_prompt_diffusion_tpu.parallel.tp import shard_bundle

    _check(len(devices) == 4, f"want 4 devices, have {len(devices)}")
    tol = size.multi_tol
    cfg = RenderConfig(steps=size.multi_steps, sampler="DDIM",
                       width=size.width, height=size.width, batch_size=8)
    x_np = np.asarray(jax.random.normal(
        jax.random.PRNGKey(5), (8,) + cfg.latent_shape, jnp.float32))
    hi = dataclasses.replace(
        cfg, width=size.hires, height=size.hires, batch_size=1,
        unet_tile=size.tile, unet_tile_stride=size.tile // 2,
    )
    xh = np.asarray(jax.random.normal(
        jax.random.PRNGKey(6), (1,) + hi.latent_shape, jnp.float32))

    def render(b, x, c, prompt=PROMPTS[2], negative=""):
        # x_T is donated to the sampling program: callers pass a fresh array
        spec = make_guidance_spec(b, prompt, negative)
        return np.asarray(sample_latents(b, spec, c, x_init=x))

    def highest(fn):
        def run(*args, **kw):
            with jax.default_matmul_precision("highest"):
                return fn(*args, **kw)
        return run

    @highest
    def data_parallel(ref):
        mesh = make_mesh(devices, data=4)
        x = jax.device_put(x_np, NamedSharding(mesh, P("data")))
        return _multi_compare(
            "data-parallel sample_latents, data=4, batch 8, f32",
            render(shard_bundle(bundle_f32, mesh), x, cfg), ref, tol)

    @highest
    def tensor_parallel(ref):
        mesh = make_mesh(devices, data=2, model=2)
        x = jax.device_put(x_np, NamedSharding(mesh, P("data")))
        return _multi_compare(
            "shard_bundle TP, 2x2 data x model, batch 8, f32",
            render(shard_bundle(bundle_f32, mesh), x, cfg), ref, tol)

    def tiled(ref):
        mesh = Mesh(np.asarray(devices).reshape(4, 1), ("data", "model"))
        return _multi_compare(
            f"tiled_apply_sharded {size.hires}x{size.hires}, tiles over "
            "data=4, bf16",
            render(shard_bundle(bundle, mesh), jnp.asarray(xh), hi), ref, tol)

    rows, failed = [], []
    ref = highest(render)(bundle_f32, jnp.asarray(x_np), cfg)
    ref_h = render(bundle, jnp.asarray(xh), hi)
    one_shard = np.s_[2:4]  # the second of four data shards
    swapped = highest(render)(bundle_f32, jnp.asarray(x_np), cfg,
                              prompt="", negative=PROMPTS[2])
    other = highest(render)(bundle_f32, jnp.asarray(x_np), cfg,
                            prompt=PROMPTS[0])
    swapped_h = render(bundle, jnp.asarray(xh), hi, prompt="",
                       negative=PROMPTS[2])
    t = size.tile
    for what, r, wrong, region in (
        ("CFG halves swapped on one data shard", ref, swapped, one_shard),
        ("another prompt on one data shard", ref, other, one_shard),
        ("CFG halves swapped in one tile", ref_h, swapped_h,
         np.s_[:, :t, :t]),
    ):
        rows.append(_planted_fault(what, r, wrong, region, tol))
    for name, fn, r in (("data-parallel", data_parallel, ref),
                        ("tensor-parallel", tensor_parallel, ref),
                        ("tiled", tiled, ref_h)):
        t0 = time.perf_counter()
        try:
            rows.append(fn(r))
        except Exception:  # report it, run the other paths, fail at the end
            traceback.print_exc()
            failed.append(name)
        _say("multichip", path=name, seconds=time.perf_counter() - t0,
             status="FAILED" if name in failed else "ok")
    _check(not failed, f"multi-device paths failed: {failed}")
    return rows


def _run_phase(name: str, fn, failures: list):
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception:  # report every failed phase, then exit non-zero
        traceback.print_exc()
        _say(name, status="FAILED", seconds=time.perf_counter() - t0)
        failures.append(name)
        return None
    _say(name, status="ok", seconds=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)
    try:
        D.require_accelerator()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    D.enable_compile_cache()
    failures: list = []
    info = _run_phase("devices", phase_devices, failures)
    size = FULL
    bundle_f32 = ModelBundle.random(size.scale, seed=0)
    bundle = bundle_f32.cast(D.compute_dtype(jax.default_backend()))
    if args.chips == 4:
        _run_phase("multichip", lambda: phase_multichip(
            bundle_f32, bundle, size, jax.devices()[:4]), failures)
    else:
        # txt2img first: its peak-memory reading then covers the main path
        # and not the kernels phase's f32 reference scores
        _run_phase("txt2img", lambda: phase_txt2img(bundle, size), failures)
        _run_phase("parity", lambda: phase_parity(bundle_f32, bundle, size),
                   failures)
        _run_phase("kernels", lambda: phase_kernels(size), failures)
        # last: the test session pins "highest" matmul precision process-wide
        _run_phase("gpu-tests", phase_gpu_tests, failures)
    print(f"card: {card_line()}", flush=True)
    if failures or info is None:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
