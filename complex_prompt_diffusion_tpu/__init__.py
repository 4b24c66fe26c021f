"""complex_prompt_diffusion_tpu — a JAX diffusion sampling framework.

A from-scratch JAX/XLA rebuild of the capabilities of
``milesgray/complex_prompt_diffusion`` (see SURVEY.md): Stable
Diffusion 1.x/2.x txt2img / img2img / inpaint sampling with a composable
prompt algebra, a full sampler zoo, CLIP / attention-saliency guidance,
dynamic thresholding, depth conditioning and animation rendering.

Architecture stance (rebuilt around XLA, not a port):
  * pure functions + pytrees at the core; thin stateful API at the edge
  * schedulers = precomputed coefficient tables + pure ``step`` functions
  * samplers = ``lax.scan`` bodies, jit-compiled end to end
  * classifier-free guidance factors batched through ONE UNet call
  * fused attention (cuDNN on the GPU) and XLA-fused GroupNorm+SiLU
  * parallelism via ``jax.sharding.Mesh`` + ``shard_map`` (no module offload)
"""

__version__ = "0.1.0"

from complex_prompt_diffusion_tpu import schedules  # noqa: F401

# Lazy top-level API: heavy modules import on attribute access.
_API = {
    "ModelBundle": "complex_prompt_diffusion_tpu.pipeline",
    "RenderConfig": "complex_prompt_diffusion_tpu.pipeline",
    "txt2img": "complex_prompt_diffusion_tpu.pipeline",
    "img2img": "complex_prompt_diffusion_tpu.pipeline",
    "DiffusionModelManager": "complex_prompt_diffusion_tpu.manager",
    "RenderEngine": "complex_prompt_diffusion_tpu.render",
    "ComplexPrompt": "complex_prompt_diffusion_tpu.prompts",
    "WeightedPrompt": "complex_prompt_diffusion_tpu.prompts",
    "CompositionalPrompt": "complex_prompt_diffusion_tpu.prompts",
    "GuidanceSpec": "complex_prompt_diffusion_tpu.guidance",
    "GuidanceConfig": "complex_prompt_diffusion_tpu.guidance",
}


def __getattr__(name):
    if name in _API:
        import importlib

        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(name)
