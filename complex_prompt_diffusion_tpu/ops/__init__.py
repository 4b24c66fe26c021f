"""Compute ops shared by the models.

  * :func:`attention` — multi-head attention over the merged [B, S, H*D]
    layout; cuDNN's fused flash attention on the GPU where it applies, plain
    XLA elsewhere (ops/attention.py).
  * :func:`group_norm` / :func:`group_norm_silu` — GroupNorm(+SiLU) with f32
    statistics, the ResBlock/VAE hot pattern
    (cpd/models/unet.py:207-238).
  * :func:`gaussian_blur` — separable depthwise blur for unconditional-blur
    and attention-saliency guidance (cpd/samplers/ddim.py:68).
"""

from complex_prompt_diffusion_tpu.ops.attention import attention
from complex_prompt_diffusion_tpu.ops.groupnorm import group_norm, group_norm_silu
from complex_prompt_diffusion_tpu.ops.blur import gaussian_blur

__all__ = [
    "attention",
    "group_norm",
    "group_norm_silu",
    "gaussian_blur",
]
