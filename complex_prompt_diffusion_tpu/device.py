"""The one place that decides per device.

Every choice that depends on the machine the program runs on is made here,
before tracing, from what JAX reports (``platform`` and ``device_kind``) and
from static shapes and dtypes. Model code asks this module; it never tests
the backend itself.

``enable_compile_cache`` is the single compile-cache helper for the entry
scripts (``chip_smoke.py``, ``bench.py``, ``scripts/``). It is never called
at package import.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

__all__ = [
    "ACCELERATORS",
    "attention_route",
    "compute_dtype",
    "enable_compile_cache",
    "require_accelerator",
]

# Platforms the program treats as an accelerator; anything else (the CPU) is
# only for tests and rehearsals.
ACCELERATORS = frozenset({"gpu"})

# cuDNN's fused flash attention (reached through
# jax.nn.dot_product_attention(implementation="cudnn")) takes bf16/fp16
# operands and head dims that are multiples of 8 up to 256 on compute
# capability 9.0 (jax/_src/cudnn/fused_attention_stablehlo.py,
# check_is_flash_attention).
_CUDNN_DTYPES = frozenset({jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16)})
_CUDNN_MAX_HEAD_DIM = 256

# Context lengths up to this stay on XLA. Measured on an H100 (400 W limit)
# at UNet batch 8, bf16: cuDNN is 4.3x faster than XLA at S=4096 (d=40) and
# 1.6x at S=1024 (d=80), but 10-17% slower at S=256 and S=64 (d=160) and
# no faster against CLIP's 77 tokens, where the score block is small.
_SHORT_KV = 256


def attention_route(platform: str, dtype, head_dim: int, kv_len: int) -> str:
    """``"cudnn"`` or ``"xla"`` for one attention site.

    A pure function of what is known before tracing, so an unsupported shape
    is a dispatch decision and never a runtime fallback."""
    if (
        platform == "gpu"
        and jnp.dtype(dtype) in _CUDNN_DTYPES
        and head_dim % 8 == 0
        and head_dim <= _CUDNN_MAX_HEAD_DIM
        and kv_len > _SHORT_KV
    ):
        return "cudnn"
    return "xla"


def compute_dtype(platform: str) -> str:
    """Deployed UNet dtype: bf16 on an accelerator, f32 on the CPU (tests,
    rehearsals), where bf16 matmuls are emulated and slow."""
    return "bfloat16" if platform in ACCELERATORS else "float32"


def require_accelerator() -> jax.Device:
    """First device, or ``RuntimeError`` when JAX found no accelerator.

    Measurement and smoke entry points call this so that a run without the
    card fails instead of printing CPU numbers under device-metric names."""
    dev = jax.devices()[0]
    if dev.platform not in ACCELERATORS:
        raise RuntimeError(
            f"no accelerator: JAX reports platform {dev.platform!r} "
            f"({dev.device_kind}); this entry point needs a GPU"
        )
    return dev


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself);
    otherwise the cache lives in ``<checkout>/.jax_cache``, which
    ``.gitignore`` lists."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(Path(__file__).resolve().parent.parent / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
