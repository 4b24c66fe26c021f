"""Precomputed diffusion coefficient tables.

The replacement for the reference's stateful scheduler objects
(/root/reference/cpd/scheduler/discrete.py:370-482): all per-timestep
coefficients are computed once in float64 numpy and frozen into two pytree
dataclasses that jit'd sampling loops index with ``jnp.take``:

  * :class:`DiffusionTables`  — length-T train-time tables (alphas_cumprod,
    posterior coefficients, k-diffusion sigma table, ...).
  * :class:`InferenceTables` — length-S per-run tables selected by
    ``set_timesteps`` semantics (alphas_cumprod_t, prev, eta-sigmas, ...).

Both are registered as JAX pytrees, so they can be closed over or passed as
arguments to jit'd functions with no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from complex_prompt_diffusion_tpu.schedules.beta import make_beta_schedule
from complex_prompt_diffusion_tpu.schedules.timesteps import make_timesteps

__all__ = [
    "DiffusionTables",
    "InferenceTables",
    "make_diffusion_tables",
    "make_inference_tables",
]


def _pytree_dataclass(cls):
    """Register a frozen dataclass whose fields are all arrays as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, f) for f in fields), None

    def unflatten(_, children):
        return cls(**dict(zip(fields, children)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_pytree_dataclass
class DiffusionTables:
    """Length-T (train-time) coefficient tables.

    Mirrors the buffers registered by the reference's DiscreteScheduler
    __init__ (discrete.py:390-454) and DDPM.register_schedule
    (/root/reference/cpd/models/ddpm.py:163-217), recomputed from the DDPM
    closed forms.
    """

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray  # [1.0, ac_0, ..., ac_{T-2}]
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    # k-diffusion model sigma table: sqrt((1-ac)/ac), ascending in noise
    sigmas: np.ndarray
    log_sigmas: np.ndarray

    @property
    def num_train_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def astype(self, dtype) -> "DiffusionTables":
        return jax.tree.map(lambda a: np.asarray(a, dtype=dtype), self)


@_pytree_dataclass
class InferenceTables:
    """Length-S per-sampling-run tables (reference set_timesteps,
    discrete.py:456-481).

    ``timesteps`` ascend; samplers iterate i = S-1 .. 0 (the reference's
    ``index``). ``sigmas_t`` is the DDIM eta-sigma (arXiv:2010.02502 eq. 16).
    """

    timesteps: np.ndarray  # int, ascending
    alphas_cumprod_t: np.ndarray
    alphas_cumprod_prev_t: np.ndarray
    alphas_cumprod_next_t: np.ndarray
    sqrt_one_minus_alphas_cumprod_t: np.ndarray
    sigmas_t: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_diffusion_tables(
    num_train_timesteps: int = 1000,
    beta_schedule: str = "scaled_linear",
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    cosine_s: float = 8e-3,
    max_beta: float = 0.999,
    v_posterior: float = 0.0,
    decimal_precision: Optional[int] = None,
) -> DiffusionTables:
    """Build the train-time tables. Defaults are Stable Diffusion 1.x/2.x
    (scaled_linear 0.00085..0.012 over 1000 steps; config-1.49.yaml /
    v2-inference.yaml in the reference).
    """
    betas = make_beta_schedule(
        beta_schedule,
        num_train_timesteps,
        linear_start=beta_start,
        linear_end=beta_end,
        cosine_s=cosine_s,
        max_beta=max_beta,
        decimal_precision=decimal_precision,
    )
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = (1 - v_posterior) * betas * (
        1.0 - alphas_cumprod_prev
    ) / (1.0 - alphas_cumprod) + v_posterior * betas
    sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)

    return DiffusionTables(
        betas=betas,
        alphas=alphas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1.0),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
        posterior_mean_coef1=betas
        * np.sqrt(alphas_cumprod_prev)
        / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev)
        * np.sqrt(alphas)
        / (1.0 - alphas_cumprod),
        sigmas=sigmas,
        log_sigmas=np.log(sigmas),
    )


def make_inference_tables(
    tables: DiffusionTables,
    num_steps: int,
    eta: float = 0.0,
    discretize: str = "uniform",
    **kwargs,
) -> InferenceTables:
    """Select the per-run subset of the train tables (reference
    set_timesteps, discrete.py:456-481).

    alphas_cumprod_prev_t[0] is alphas_cumprod[0] (NOT 1.0) — matching
    discrete.py:474 exactly, since the DDIM final step uses it.
    """
    timesteps = make_timesteps(
        num_steps,
        method=discretize,
        num_train_timesteps=tables.num_train_timesteps,
        **kwargs,
    )
    ac = tables.alphas_cumprod
    ac_t = ac[timesteps]
    ac_prev_t = np.concatenate([[ac[0]], ac_t[:-1]])
    ac_next_t = np.concatenate([ac_t[1:], [ac[-1]]])

    sigmas_t = eta * np.sqrt(
        (1 - ac_prev_t) / (1 - ac_t) * (1 - ac_t / ac_prev_t)
    )

    return InferenceTables(
        timesteps=timesteps,
        alphas_cumprod_t=ac_t,
        alphas_cumprod_prev_t=ac_prev_t,
        alphas_cumprod_next_t=ac_next_t,
        sqrt_one_minus_alphas_cumprod_t=np.sqrt(1.0 - ac_t),
        sigmas_t=sigmas_t,
    )
