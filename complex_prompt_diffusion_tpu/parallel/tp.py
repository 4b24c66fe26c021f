"""Tensor-parallel inference: Megatron-style UNet weight sharding.

No reference counterpart — the reference is single-GPU by design (SURVEY §2
"Parallelism & distributed communication"). This is the multi-device scaling
path: annotate weight shardings over the mesh's "model" axis and let XLA's
SPMD partitioner insert the collectives (the scaling-book recipe — shardings
in, psum/all-gather out; no hand-written comms).

Sharding rules (the classic attention/MLP pair pattern):
  * attention to_q / to_k / to_v kernels  -> column-parallel  P(None, "model")
  * attention to_out kernel               -> row-parallel     P("model", None)
  * feed-forward proj (GEGLU in) kernel   -> column-parallel
  * feed-forward out kernel               -> row-parallel
  * everything else (convs, norms, time embedding) replicated — conv FLOPs
    are HBM-bound at inference batch sizes and the GroupNorm group stats
    stay local this way.

Attention under the mesh: cuDNN's fused attention carries its own
partitioning rule (batch and heads may be sharded, sequence and head dim
may not), and every other op is plain XLA, so GSPMD partitions the whole
UNet from the weight shardings alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from complex_prompt_diffusion_tpu.parallel.mesh import replicate

__all__ = ["unet_tp_shardings", "shard_bundle"]

# kernel-sharding rule by (parent module, leaf name); biases follow the
# output axis of their kernel
_COLUMN = ("to_q", "to_k", "to_v")


def _spec_for(path, leaf=None, conv_split: bool = False, model_size: int = 1) -> P:
    names = [
        p.key if isinstance(p, jax.tree_util.DictKey) else None for p in path
    ]
    name = names[-1] if names else None
    parent = names[-2] if len(names) >= 2 else None
    is_ff = "ff" in names
    if name == "kernel":
        if parent in _COLUMN or (is_ff and parent == "proj"):
            return P(None, "model")
        if parent == "to_out" or (is_ff and parent == "out"):
            return P("model", None)
        # opt-in conv input-channel split: HWIO kernels contract a Cin
        # shard per device, GSPMD psums the partial outputs
        if (
            conv_split
            and leaf is not None
            and getattr(leaf, "ndim", 0) == 4
            and leaf.shape[2] % model_size == 0
            and leaf.shape[2] >= model_size * 8
        ):
            return P(None, None, "model", None)
    if name == "bias" and (parent in _COLUMN or (is_ff and parent == "proj")):
        return P("model")
    return P()


def unet_tp_shardings(unet_params: Any, mesh: Mesh, *, conv_split: bool = False):
    """NamedSharding pytree for the UNet params (same structure).

    ``conv_split=True`` additionally input-channel-splits the conv kernels
    over the model axis (one psum per conv); not the default."""
    model_size = mesh.shape.get("model", 1)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh,
            _spec_for(path, leaf, conv_split=conv_split, model_size=model_size),
        ),
        unet_params,
    )


def shard_bundle(bundle, mesh: Mesh, *, conv_split: bool = False):
    """Place a ModelBundle on the mesh: UNet weights tensor-parallel over
    "model", VAE/CLIP replicated. Returns a new bundle that records the
    mesh and whose jit cache is fresh (the placement is part of the
    compiled program).

    ``conv_split=True``: conv input-channel split (see unet_tp_shardings)."""
    unet_params = jax.device_put(
        bundle.unet_params,
        unet_tp_shardings(bundle.unet_params, mesh, conv_split=conv_split),
    )
    return dataclasses.replace(
        bundle,
        unet_params=unet_params,
        vae_params=replicate(mesh, bundle.vae_params),
        clip_params=replicate(mesh, bundle.clip_params),
        mesh=mesh,
        _jit_cache={},
    )
