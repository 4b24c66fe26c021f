"""Per-step render callbacks.

Parity target: /root/reference/cpd/samplers/extension/callbacks.py
(render_callback: latent -> uint8 -> display each step) plus the
``callback(x0, i)`` hooks the reference samplers thread through their Python
step loops (e.g. ddim.py _sampling loop).

JAX redesign: the sampling loop is ONE jit'd ``lax.scan`` — there is no
Python loop to hook. Instead the pipeline wraps the model function with
``jax.debug.callback`` so a host-side Python function observes every step's
x0 prediction without breaking the compiled program. Pass
``step_callback=fn`` to ``txt2img``/``sample_latents``; ``fn(t, x0)``
receives the step's time value (t-family: timestep; sigma-family: sigma)
and the predicted-x0 latents as numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["make_render_callback", "latent_preview"]


def latent_preview(x0: np.ndarray) -> np.ndarray:
    """Cheap latent -> uint8 preview WITHOUT running the VAE: normalize the
    first three latent channels into [0, 255]. Matches the spirit of the
    reference's render_callback (callbacks.py:7-19) — the reference decodes
    with the full first-stage model each step, which would stall the device
    pipeline; this preview is host-side numpy only."""
    x = np.asarray(x0, np.float32)
    if x.ndim == 4:
        x = x[0]
    rgb = x[..., :3] if x.shape[-1] >= 3 else np.repeat(x[..., :1], 3, -1)
    lo, hi = np.percentile(rgb, 1), np.percentile(rgb, 99)
    rgb = (rgb - lo) / max(hi - lo, 1e-6)
    return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)


def make_render_callback(
    display_fn: Optional[Callable] = None, every: int = 1
) -> Callable:
    """Build a ``step_callback`` that converts each step's x0 prediction to a
    uint8 preview and hands it to ``display_fn(t, image)`` (default: no-op
    collector; the images are kept on ``cb.frames``). Exceptions raised by
    ``display_fn`` are recorded on ``cb.errors`` instead of propagating — a
    broken preview must not kill a long render mid-flight."""
    frames = []

    def cb(t, x0):
        cb.count += 1
        if (cb.count - 1) % max(every, 1):
            return
        img = latent_preview(np.asarray(x0))
        if display_fn is not None:
            try:
                display_fn(np.asarray(t), img)
            except Exception as e:  # noqa: BLE001
                cb.errors.append(e)
        else:
            frames.append(img)

    cb.count = 0
    cb.frames = frames
    cb.errors = []
    return cb
