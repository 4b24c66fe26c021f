"""Parallelism: device mesh, shardings, data-parallel rendering.

The reference has no distributed layer at all (SURVEY.md §2: single-process,
single-CUDA-device; its "scaling" is VRAM offload). This design replaces
that with SPMD over a ``jax.sharding.Mesh``:
  * weights replicated (SD-scale fits device memory on every card),
  * batch / animation frames sharded over the ``data`` axis,
  * optional ``model`` axis for tensor-parallel experiments,
with all communication implicit in jit-inserted XLA collectives over ICI.
"""

from complex_prompt_diffusion_tpu.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
    data_parallel_sharding,
)

__all__ = ["make_mesh", "replicate", "shard_batch", "data_parallel_sharding"]
