"""Tiled (fold/unfold) UNet inference for large canvases.

Parity target: the reference's ``split_input_params`` path in
``apply_model`` (/root/reference/cpd/models/ddpm.py:995-1077): unfold the
latent into overlapping ``ks``-sized tiles, run the model on each tile
independently, multiply by a border-tapered blending weight, fold the tiles
back, and normalize by the folded weight sum. This bounds the UNet's
attention cost (level-0 self-attention is O(S^2) in latent pixels) and its
activation memory on canvases far above the training resolution.

Deviations from the reference:
  * tile positions are computed statically from the (static) latent shape,
    and the tile loop is a ``lax.scan`` — one compiled program regardless
    of canvas size, tiles processed in ``chunk``-sized batched UNet calls
    (the reference's torch unfold materializes all tiles at once);
  * the reference's clipped-gaussian weighting (ddpm.py get_weighting /
    meshgrid, :939-993) is replaced by a separable linear border taper —
    both are normalized away by the fold denominator, but the linear taper
    is exactly 1.0 in tile interiors, so non-overlap regions reproduce the
    single-tile result bit-exactly;
  * every tile shares the [B] batch dim, so a chunk of k tiles runs as one
    [k*B] UNet call — large batches instead of k sequential small calls.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "tile_positions",
    "tile_window",
    "tiled_apply",
    "tiled_apply_sharded",
    "make_tiled_unet",
]


def tile_positions(size: int, tile: int, stride: int) -> Tuple[int, ...]:
    """Start offsets covering ``size`` with ``tile``-long windows every
    ``stride`` px; the last window is clamped to end exactly at ``size``
    (reference unfold semantics + full coverage)."""
    if tile >= size:
        return (0,)
    pos = list(range(0, size - tile, stride))
    pos.append(size - tile)
    return tuple(pos)


def tile_window(tile: int, overlap: int) -> jnp.ndarray:
    """Separable [tile, tile, 1] blending window: linear ramp over the
    ``overlap`` border px, 1.0 in the interior (stand-in for the
    reference's clipped-gaussian weighting, ddpm.py:939-993 — both
    normalize out under the fold)."""
    if overlap <= 0:
        return jnp.ones((tile, tile, 1), jnp.float32)
    i = jnp.arange(tile, dtype=jnp.float32) + 0.5
    edge = jnp.minimum(i, tile - i)
    w = jnp.clip(edge / overlap, 1e-3, 1.0)
    return (w[:, None] * w[None, :])[..., None]


def tiled_apply(
    apply_fn: Callable[[jax.Array], jax.Array],
    x: jax.Array,
    tile: int,
    stride: Optional[int] = None,
    *,
    chunk: int = 1,
) -> jax.Array:
    """Run ``apply_fn`` ([B, tile, tile, Cin] -> [B, tile, tile, Cout]) over
    overlapping tiles of ``x`` [B, H, W, Cin]; fold back with normalized
    blend weights (ddpm.py:995-1077 fold/unfold semantics).

    ``stride`` defaults to tile/2 (50% overlap, the reference's df=2-ish
    regime). ``chunk`` > 1 stacks that many tiles into one batched UNet
    call per scan step (memory/throughput trade)."""
    b, h, w, cin = x.shape
    stride = stride or max(tile // 2, 1)
    if tile >= h and tile >= w:
        return apply_fn(x)
    ys = tile_positions(h, tile, stride)
    xs = tile_positions(w, tile, stride)
    pos = [(y0, x0) for y0 in ys for x0 in xs]
    overlap = tile - stride
    win = tile_window(tile, overlap)

    cout = jax.eval_shape(
        apply_fn, jax.ShapeDtypeStruct((b, tile, tile, cin), x.dtype)
    ).shape[-1]

    # pad the position list to a chunk multiple. Padding duplicates get a
    # ZERO fold weight: a duplicated tile does NOT normalize out where it
    # overlaps a different tile ((wa*a + k*wb*b)/(wa + k*wb) biases toward
    # b for k > 1), so live-weighting duplicates would skew seam regions.
    n_live = len(pos)
    while len(pos) % chunk:
        pos.append(pos[-1])
    valid = [1.0] * n_live + [0.0] * (len(pos) - n_live)
    pos_arr = jnp.asarray(pos, jnp.int32).reshape(-1, chunk, 2)
    valid_arr = jnp.asarray(valid, jnp.float32).reshape(-1, chunk)
    acc, wsum = _fold_tiles(
        apply_fn, x, pos_arr, valid_arr, tile, win, chunk, cout
    )
    return (acc / wsum).astype(x.dtype)


def _fold_tiles(apply_fn, x, pos_arr, valid_arr, tile, win, chunk, cout):
    """Scan over [n, chunk, 2] tile positions (+ [n, chunk] validity):
    gather chunk tiles, run one batched apply, accumulate taper-weighted
    pieces + weights. Padding positions carry valid=0 so their tiles fold
    with zero weight."""
    b, h, w, cin = x.shape

    def body(carry, pv):
        p, v = pv
        acc, wsum = carry
        # gather chunk tiles -> one [chunk*B] batched call
        tiles = [
            jax.lax.dynamic_slice(
                x, (0, p[j, 0], p[j, 1], 0), (b, tile, tile, cin)
            )
            for j in range(chunk)
        ]
        out = apply_fn(jnp.concatenate(tiles, axis=0))
        out = out.reshape(chunk, b, tile, tile, cout)
        for j in range(chunk):
            wj = win * v[j]
            piece = (out[j].astype(jnp.float32) * wj).astype(acc.dtype)
            cur = jax.lax.dynamic_slice(
                acc, (0, p[j, 0], p[j, 1], 0), (b, tile, tile, cout)
            )
            acc = jax.lax.dynamic_update_slice(
                acc, cur + piece, (0, p[j, 0], p[j, 1], 0)
            )
            wcur = jax.lax.dynamic_slice(
                wsum, (p[j, 0], p[j, 1], 0), (tile, tile, 1)
            )
            wsum = jax.lax.dynamic_update_slice(
                wsum, wcur + wj, (p[j, 0], p[j, 1], 0)
            )
        return (acc, wsum), None

    acc = jnp.zeros((b, h, w, cout), jnp.float32)
    wsum = jnp.zeros((h, w, 1), jnp.float32)
    (acc, wsum), _ = jax.lax.scan(body, (acc, wsum), (pos_arr, valid_arr))
    return acc, wsum


def tiled_apply_sharded(
    apply_fn: Callable[[jax.Array], jax.Array],
    x: jax.Array,
    tile: int,
    stride: Optional[int] = None,
    *,
    mesh,
    axis: str = "data",
    chunk: int = 1,
) -> jax.Array:
    """Multi-device spatial sharding for hi-res canvases (SURVEY §5: the
    analog of sequence parallelism for image models; the reference's
    single-GPU analog is the fold/unfold path, ddpm.py:995-1077).

    The TILES shard over the mesh axis: every device folds its own subset of
    overlapping tiles into a local partial (acc, wsum) canvas pair, then one
    ``psum`` over the axis reconstructs the full canvas. Tiles need no halo
    exchange — the overlap taper + fold normalization already handle tile
    seams, so the only communication is the single canvas-sized psum per
    UNet call (latents are small: a 1024^2 image is a 128^2x4 latent).

    Matches ``tiled_apply`` exactly up to float reassociation of the fold
    sums (same tile set, same taper, same normalization).
    """
    b, h, w, cin = x.shape
    stride = stride or max(tile // 2, 1)
    if tile >= h and tile >= w:
        return apply_fn(x)
    n_shards = mesh.shape[axis]
    ys = tile_positions(h, tile, stride)
    xs = tile_positions(w, tile, stride)
    pos = [(y0, x0) for y0 in ys for x0 in xs]
    overlap = tile - stride
    win = tile_window(tile, overlap)
    cout = jax.eval_shape(
        apply_fn, jax.ShapeDtypeStruct((b, tile, tile, cin), x.dtype)
    ).shape[-1]

    # pad to a (shards * chunk) multiple so every device scans the same
    # trip count; padding duplicates fold with ZERO weight (see
    # ``tiled_apply`` — live duplicates would bias seam regions)
    n_live = len(pos)
    while len(pos) % (n_shards * chunk):
        pos.append(pos[-1])
    valid = [1.0] * n_live + [0.0] * (len(pos) - n_live)
    pos_arr = jnp.asarray(pos, jnp.int32).reshape(n_shards, -1, chunk, 2)
    valid_arr = jnp.asarray(valid, jnp.float32).reshape(n_shards, -1, chunk)

    from jax.sharding import PartitionSpec as P

    def local(x_rep, pos_local, valid_local):
        acc, wsum = _fold_tiles(
            apply_fn, x_rep, pos_local[0], valid_local[0], tile, win, chunk,
            cout,
        )
        acc = jax.lax.psum(acc, axis)
        wsum = jax.lax.psum(wsum, axis)
        return (acc / wsum).astype(x_rep.dtype)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )(x, pos_arr, valid_arr)


def make_tiled_unet(
    unet_apply_fn: Callable,
    tile: int,
    stride: Optional[int] = None,
    chunk: int = 1,
    *,
    mesh=None,
    axis: str = "data",
):
    """Wrap a (x, t, ctx) -> eps UNet call with spatial tiling: t and ctx
    are broadcast to each (possibly chunk-stacked) tile batch.

    With ``mesh`` set, tiles shard over ``axis`` (``tiled_apply_sharded``)
    — the multi-chip hi-res path."""

    def tiled(x, t, ctx):
        b = x.shape[0]

        def fn(xt):
            reps = xt.shape[0] // b
            t_r = jnp.tile(t, reps)
            ctx_r = (
                jnp.tile(ctx, (reps,) + (1,) * (ctx.ndim - 1))
                if ctx is not None
                else None
            )
            return unet_apply_fn(xt, t_r, ctx_r)

        if mesh is not None:
            return tiled_apply_sharded(
                fn, x, tile, stride, mesh=mesh, axis=axis, chunk=chunk
            )
        return tiled_apply(fn, x, tile, stride, chunk=chunk)

    return tiled
