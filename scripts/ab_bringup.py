"""Op-level A/B of the GPU route choices, at SD-1.5's real shapes.

    python scripts/ab_bringup.py            # needs the GPU
    python scripts/ab_bringup.py --small    # tiny shapes, any backend

Each candidate is jitted, run twice to warm up, then timed as the median
of 10 calls, each ended by ``block_until_ready``. Every line of standard
output is one JSON object:

* ``ref``: a bf16 8192^3 matmul and a bf16 512 MiB read+write, the card's
  attainable rates in the same process;
* ``attn``: attention per SD site (UNet batch 8; VAE mid-block batch 4) on
  the plain XLA route, cuDNN's fused attention
  (``jax.nn.dot_product_attention(implementation="cudnn")``) and the
  Pallas Triton library kernel (``jax.experimental.pallas.ops.gpu.
  attention.mha``), each with its max |error| against the f32 reference;
* ``gn``: GroupNorm+SiLU in the package's reshape form against the
  matmul-statistics form (per-channel sums and a one-hot [C, G] matmul,
  one-pass E[x^2] - E[x]^2), written out below as the alternative;
* ``upconv``: upsample-nearest-2x + conv3x3 (the package's path) against
  the subpixel form, which folds the duplicated taps into 16 small-plane
  contractions (2.25x fewer FLOPs), written out below as the alternative;
* ``ff``: the GEGLU feed-forward (XLA/cuBLAS) at the four UNet levels.
"""

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from complex_prompt_diffusion_tpu.device import (  # noqa: E402
    enable_compile_cache,
    require_accelerator,
)
from complex_prompt_diffusion_tpu.models import layers as L  # noqa: E402
from complex_prompt_diffusion_tpu.ops import groupnorm as GN  # noqa: E402
from complex_prompt_diffusion_tpu.ops.attention import _xla_attention  # noqa: E402
from complex_prompt_diffusion_tpu.ops.mlp import geglu_ff  # noqa: E402

SMALL = "--small" in sys.argv
BF = jnp.bfloat16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, for the bandwidth share

ATTN = [(8, 4096, 8, 40, 4096), (8, 1024, 8, 80, 1024), (8, 256, 8, 160, 256),
        (8, 64, 8, 160, 64), (8, 4096, 8, 40, 77), (8, 1024, 8, 80, 77),
        (8, 256, 8, 160, 77), (8, 64, 8, 160, 77), (4, 4096, 1, 512, 4096)]
GN_SHAPES = [(8, 64, 64, 320), (8, 64, 64, 960), (8, 32, 32, 640),
             (8, 16, 16, 1280), (8, 8, 8, 1280), (4, 64, 64, 512),
             (4, 128, 128, 512), (4, 256, 256, 256), (4, 512, 512, 128)]
UP_SHAPES = [(8, 8, 8, 1280), (8, 16, 16, 1280), (8, 32, 32, 640),
             (4, 64, 64, 512), (4, 128, 128, 512), (4, 256, 256, 256)]
FF_SHAPES = [(8, 4096, 320), (8, 1024, 640), (8, 256, 1280), (8, 64, 1280)]
if SMALL:
    ATTN = [(2, 64, 2, 40, 64), (2, 64, 2, 40, 77)]
    GN_SHAPES = [(2, 8, 8, 64)]
    UP_SHAPES = [(2, 8, 8, 32)]
    FF_SHAPES = [(2, 64, 32)]


def emit(**row):
    print(json.dumps(row, default=str), flush=True)


def med_time(fn, *args, n=10, warm=2):
    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# --- the alternatives the package does not keep -----------------------------

def gn_matmul_stats(x, gamma, beta, num_groups=32, eps=1e-5):
    """GroupNorm+SiLU without the C -> (G, C/G) reshape: per-channel sums,
    a one-hot [C, G] matmul to group statistics, one-pass variance."""
    n, h, w, c = x.shape
    c2g = jnp.asarray(
        np.arange(c)[:, None] // (c // num_groups) == np.arange(num_groups),
        jnp.float32,
    )
    xr = x.reshape(n, h * w, c)
    count = float(h * w * (c // num_groups))
    mean_g = jnp.sum(xr, axis=1, dtype=jnp.float32) @ c2g / count
    ex2_g = jnp.sum(jnp.square(xr.astype(jnp.float32)), axis=1) @ c2g / count
    rstd_g = jax.lax.rsqrt(jnp.maximum(ex2_g - mean_g * mean_g, 0.0) + eps)
    mean_c = (mean_g @ c2g.T)[:, None, None, :]
    rstd_c = (rstd_g @ c2g.T)[:, None, None, :]
    y = (x.astype(jnp.float32) - mean_c) * rstd_c * gamma + beta
    return (y * jax.nn.sigmoid(y)).astype(x.dtype)


def conv3x3_subpixel_up(params, x):
    """``conv2d(params, upsample_nearest2x(x))`` on the small plane: per
    output phase the duplicated 3x3 taps collapse onto 2x2 source pixels."""
    k = params["kernel"].astype(jnp.float32)
    b, h, w, _ = x.shape
    co = k.shape[-1]
    # phase -> {padded offset: taps that read it}
    taps = {0: {0: (0,), 1: (1, 2)}, 1: {1: (0, 1), 2: (2,)}}
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    phases = []
    for ph in (0, 1):
        for pw in (0, 1):
            acc = 0.0
            for oh, dhs in taps[ph].items():
                for ow, dws in taps[pw].items():
                    k2 = sum(k[dh, dw] for dh in dhs for dw in dws)
                    xs = xp[:, oh:oh + h, ow:ow + w, :]
                    acc = acc + jnp.einsum(
                        "bhwc,cd->bhwd", xs, k2.astype(x.dtype),
                        preferred_element_type=jnp.float32)
            phases.append(acc + params["bias"].astype(jnp.float32))
    y = jnp.stack(phases, axis=-2).reshape(b, h, w, 2, 2, co)
    y = y.transpose(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, co)
    return y.astype(x.dtype)


# --- attention routes on the merged [B, S, H*D] layout -----------------------

def _heads(x, h):
    b, s, inner = x.shape
    return x.reshape(b, s, h, inner // h)


def attn_xla(q, k, v, h):
    d = q.shape[-1] // h
    out = _xla_attention(*(_heads(a, h).transpose(0, 2, 1, 3)
                           for a in (q, k, v)), d ** -0.5)
    return out.transpose(0, 2, 1, 3).reshape(q.shape)


def attn_cudnn(q, k, v, h):
    d = q.shape[-1] // h
    return jax.nn.dot_product_attention(
        _heads(q, h), _heads(k, h), _heads(v, h), scale=d ** -0.5,
        implementation="cudnn").reshape(q.shape)


def attn_pallas_triton(q, k, v, h):
    # library kernel: JAX's Pallas Triton flash attention
    from jax.experimental.pallas.ops.gpu import attention as pa

    d = q.shape[-1] // h
    return pa.mha(_heads(q, h), _heads(k, h), _heads(v, h), None,
                  sm_scale=d ** -0.5).reshape(q.shape)


def main():
    if not SMALL:
        require_accelerator()
    enable_compile_cache()
    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi unavailable ({e.__class__.__name__})"
    emit(phase="device", platform=dev.platform, kind=dev.device_kind,
         card=card, jax=jax.__version__)
    key = jax.random.PRNGKey(0)

    if not SMALL:
        a = jax.random.normal(key, (8192, 8192), BF)
        t = med_time(jax.jit(lambda x, y: x @ y), a, a)
        emit(phase="ref", what="bf16 matmul 8192^3", s=t,
             tflops=2 * 8192 ** 3 / t / 1e12)
        big = jax.random.normal(key, (1 << 28,), BF)
        t = med_time(jax.jit(lambda x: x * 2), big)
        emit(phase="ref", what="bf16 512 MiB read+write", s=t,
             gbps=2 * big.nbytes / t / 1e9)

    for b, s, h, d, kv in ATTN:
        ks = jax.random.split(jax.random.fold_in(key, s * 1000 + kv), 3)
        q = jax.random.normal(ks[0], (b, s, h * d), BF)
        k = jax.random.normal(ks[1], (b, kv, h * d), BF)
        v = jax.random.normal(ks[2], (b, kv, h * d), BF)
        f32 = [a.astype(jnp.float32) for a in (q, k, v)]
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax.jit(attn_xla, static_argnums=3)(*f32, h))
        for name, fn in (("xla", attn_xla), ("cudnn", attn_cudnn),
                         ("pallas_triton", attn_pallas_triton)):
            if name != "xla" and (SMALL or d > 256):
                continue
            if name == "pallas_triton" and kv < 128:
                continue
            try:
                f = jax.jit(fn, static_argnums=3)
                out = np.asarray(f(q, k, v, h)).astype(np.float32)
                t = med_time(f, q, k, v, h)
                emit(phase="attn", impl=name, shape=[b, s, h, d, kv], s=t,
                     tflops=4 * b * h * s * kv * d / t / 1e12,
                     max_abs=float(np.max(np.abs(out - ref))))
            except Exception:  # a route that refuses a shape is a result
                emit(phase="attn", impl=name, shape=[b, s, h, d, kv],
                     error=traceback.format_exc()[-1500:])

    for shape in GN_SHAPES:
        for dt in (BF, jnp.float32):
            x = jax.random.normal(key, shape, dt) * 3 + 1
            g = jnp.ones((shape[-1],), jnp.float32)
            z = jnp.zeros((shape[-1],), jnp.float32)
            xr = np.asarray(x, np.float64).reshape(shape[0], -1, 32, shape[-1] // 32)
            y = (xr - xr.mean(axis=(1, 3), keepdims=True)) / np.sqrt(
                xr.var(axis=(1, 3), keepdims=True) + 1e-5)
            y = y.reshape(shape)
            y = y / (1 + np.exp(-y))
            for name, fn in (("reshape", GN.group_norm_silu),
                             ("matmul_stats", gn_matmul_stats)):
                f = jax.jit(fn)
                out = np.asarray(f(x, g, z)).astype(np.float64)
                t = med_time(f, x, g, z)
                emit(phase="gn", impl=name, shape=list(shape),
                     dtype=jnp.dtype(dt).name, s=t,
                     bw_share=2 * x.nbytes / t / HBM_BYTES_PER_S,
                     max_abs=float(np.max(np.abs(out - y))))

    for shape in UP_SHAPES:
        for dt in (BF, jnp.float32):
            if dt == jnp.float32 and shape[0] == 8:  # the UNet runs bf16
                continue
            c = shape[-1]
            x = jax.random.normal(key, shape, dt)
            p = {"kernel": jax.random.normal(key, (3, 3, c, c)) * 0.02,
                 "bias": jnp.zeros((c,), jnp.float32)}
            dense = jax.jit(lambda p, x: L.conv2d(p, L.upsample_nearest2x(x)))
            sub = jax.jit(conv3x3_subpixel_up)
            between = float(np.max(np.abs(
                np.asarray(dense(p, x), np.float32)
                - np.asarray(sub(p, x), np.float32))))
            for name, f in (("upsample_conv", dense), ("subpixel", sub)):
                emit(phase="upconv", impl=name, shape=list(shape),
                     dtype=jnp.dtype(dt).name, s=med_time(f, p, x),
                     max_abs_between=between)

    for b, s, c in FF_SHAPES:
        x = jax.random.normal(key, (b, s, c), BF)
        w1 = (jax.random.normal(key, (c, 8 * c)) * 0.02).astype(BF)
        w2 = (jax.random.normal(key, (4 * c, c)) * 0.02).astype(BF)
        b1, b2 = jnp.zeros((8 * c,), BF), jnp.zeros((c,), BF)
        t = med_time(jax.jit(geglu_ff), x, w1, b1, w2, b2)
        m = b * s
        emit(phase="ff", shape=[b, s, c], s=t,
             tflops=(2 * m * c * 8 * c + 2 * m * 4 * c * c) / t / 1e12,
             hidden_bytes=m * 8 * c * 2)


if __name__ == "__main__":
    main()
