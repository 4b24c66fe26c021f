"""Token merging (ToMe) for the UNet's self-attention — opt-in speedup.

Implements the ToMe-for-SD recipe (Bolya & Hoffman, "Token Merging for Fast
Stable Diffusion", 2023): before each self-attention site, merge the ``r``
most-redundant tokens into their nearest neighbors via bipartite soft
matching, run attention on the reduced sequence, then unmerge (merged
positions copy their destination token's output). The reference framework
has no analog — its only spatial-cost lever is attention slicing
(/root/reference/cpd/models/attention.py:280-348), which saves memory, not
FLOPs. This trades a controlled approximation for a large FLOP cut at the
dominant level-0 sites (S=4096: attention cost scales ~(1-ratio)^2).

Design (everything static-shape, jit/scan-safe, no scatters):

* dst tokens = a fixed strided 2D grid (one per ``sx x sy`` window, offset
  0 — deterministic; the paper's random offset buys ~nothing at SD scale),
  src = the rest. ``n_dst``, ``n_src`` and ``r`` are trace-time constants.
* matching = one [B, n_src, n_dst] cosine-similarity matmul + top-r
  selection done as ONE argsort of the per-src best-match score — src
  ranks < r merge, ranks >= r keep; both index maps fall out of the same
  argsort with no scatter (``rank`` trick below).
* merge = mean-pool each merged src into its best dst via a one-hot
  [B, n_src, n_dst] matmul (no scatter-add; the one-hot contraction is a
  plain matmul).
* unmerge = two gathers (take_along_axis) + one STATIC permutation that
  interleaves dst/src back to raster order.

Exactness property used by the tests: if every token in a window is
identical, softmax attention over the merged sequence returns exactly the
attention of the full sequence (duplicated tokens renormalize away), so
merge->attend->unmerge is lossless on locally-constant features.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "TomePlan", "build_merge", "tome_merge", "tome_unmerge", "downsample_kv",
]


def downsample_kv(x, h: int, w: int, sx: int = 2, sy: int = 2):
    """ToDo-style K/V token downsampling: ``[B, S, C] -> [B, S/(sx*sy), C]``.

    Average-pools the spatial token grid. Used as the K/V source of
    self-attention while Q stays full length (Smith et al., "Token
    Downsampling for Efficient Generation of High-Resolution Images",
    2024) — the output keeps Q's length, so unlike ToMe there is no
    matching, no gathers, and no unmerge; attention cost drops by exactly
    the pool factor. Each pooled K/V token is the window mean, so on
    locally-constant features the attention output is exact (same
    renormalization argument as ToMe's merge).
    """
    b, s, c = x.shape
    if s != h * w:
        raise ValueError(f"x S={s} != h*w={h * w}")
    if h % sy or w % sx:
        raise ValueError(f"grid {h}x{w} not divisible by pool {sy}x{sx}")
    xi = x.astype(jnp.float32).reshape(b, h // sy, sy, w // sx, sx, c)
    pooled = xi.mean(axis=(2, 4))
    return pooled.reshape(b, (h // sy) * (w // sx), c).astype(x.dtype)


class TomePlan(NamedTuple):
    """Static + per-batch data describing one merge assignment.

    ``dst_pos``/``src_pos`` are trace-time constant raster positions.
    ``idx_src`` maps each src token (src-list order) to its slot in the
    merged sequence; ``assign`` is the merged-src -> dst one-hot (zeros on
    kept rows); ``inv_perm`` restores raster order after unmerge.
    """

    dst_pos: jnp.ndarray     # [n_dst] int32, static content
    src_pos: jnp.ndarray     # [n_src] int32, static content
    idx_src: jnp.ndarray     # [B, n_src] int32 — slot of each src token
    assign: jnp.ndarray      # [B, n_src, n_dst] float — one-hot rows for merged src
    kept_order: jnp.ndarray  # [B, n_keep] int32 — kept src-list indices in slot order
    inv_perm: jnp.ndarray    # [S] int32, static content
    r: int


def _grid_partition(h: int, w: int, sx: int, sy: int):
    """Raster positions of the strided-grid dst set and its complement."""
    import numpy as np

    pos = np.arange(h * w).reshape(h, w)
    dst_mask = np.zeros((h, w), bool)
    dst_mask[::sy, ::sx] = True
    dst = pos[dst_mask].ravel()
    src = pos[~dst_mask].ravel()
    return dst.astype(np.int32), src.astype(np.int32)


def build_merge(
    metric, h: int, w: int, r: int, sx: int = 2, sy: int = 2
) -> TomePlan:
    """Bipartite soft matching of ``metric`` [B, S, C] (S = h*w, raster).

    ``r`` src tokens (highest best-match cosine similarity) merge into
    their best dst. ``r`` must be a trace-time int in [0, n_src].
    """
    import numpy as np

    b, s, _ = metric.shape
    if s != h * w:
        raise ValueError(f"metric S={s} != h*w={h * w}")
    dst_np, src_np = _grid_partition(h, w, sx, sy)
    n_src = src_np.shape[0]
    if not (0 < r <= n_src):
        raise ValueError(f"r={r} outside (0, n_src={n_src}]")
    dst_pos = jnp.asarray(dst_np)
    src_pos = jnp.asarray(src_np)

    mn = metric / (
        jnp.linalg.norm(metric.astype(jnp.float32), axis=-1, keepdims=True)
        + 1e-6
    ).astype(metric.dtype)
    m_src = jnp.take(mn, src_pos, axis=1)   # [B, n_src, C]
    m_dst = jnp.take(mn, dst_pos, axis=1)   # [B, n_dst, C]
    scores = jax.lax.dot_general(
        m_src, m_dst,
        (((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )  # [B, n_src, n_dst]
    node_max = jnp.max(scores, axis=-1)          # [B, n_src]
    node_idx = jnp.argmax(scores, axis=-1)       # [B, n_src] best dst per src
    # rank trick: order = argsort(-node_max); rank[s] = position of src s in
    # that order. rank < r  -> merged (slot = its dst's slot),
    # rank >= r -> kept (slot = n_dst + rank - r, i.e. kept tokens appear in
    # similarity order after the dst block). Two argsorts, zero scatters.
    order = jnp.argsort(-node_max, axis=-1)
    rank = jnp.argsort(order, axis=-1)
    merged = rank < r                            # [B, n_src] bool
    n_dst = dst_np.shape[0]
    idx_src = jnp.where(merged, node_idx, n_dst + rank - r)
    assign = (
        jax.nn.one_hot(node_idx, n_dst, dtype=jnp.float32)
        * merged[..., None]
    )
    # kept src tokens occupy slots n_dst..S_m-1; gather them by sorting src
    # tokens by slot id and dropping the merged ones (slots < n_dst). Hoisted
    # into the plan so reusing it across several merge calls (attn/ff/cross,
    # the ToMe-SD recipe) pays the argsort once.
    n_keep = n_src - r
    kept_order = jnp.argsort(
        jnp.where(idx_src >= n_dst, idx_src, jnp.iinfo(jnp.int32).max),
        axis=-1,
    )[:, :n_keep]  # [B, n_keep] src-list indices in slot order
    # static inverse permutation: merged-seq-order -> raster order is only
    # needed for the final output; build raster <- [dst block | src block]
    # and invert it host-side (all static content)
    perm = np.concatenate([dst_np, src_np])      # merged-layout pos -> raster
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return TomePlan(
        dst_pos, src_pos, idx_src, assign, kept_order, jnp.asarray(inv), r
    )


def tome_merge(plan: TomePlan, x):
    """[B, S, C] -> [B, S_m, C] with S_m = S - r.

    Layout: ``[pooled dst tokens | kept src tokens in similarity order]``.
    """
    x_dst = jnp.take(x, plan.dst_pos, axis=1)
    x_src = jnp.take(x, plan.src_pos, axis=1)
    # mean-pool merged src into their dst: one-hot contraction (a matmul)
    sums = jax.lax.dot_general(
        plan.assign.astype(jnp.float32),
        x_src.astype(jnp.float32),
        (((1,), (1,)), ((0,), (0,))),
    )  # [B, n_dst, C]
    counts = jnp.sum(plan.assign, axis=1)[..., None]  # [B, n_dst, 1]
    pooled = (x_dst.astype(jnp.float32) + sums) / (1.0 + counts)
    x_keep = jnp.take_along_axis(x_src, plan.kept_order[..., None], axis=1)
    return jnp.concatenate([pooled.astype(x.dtype), x_keep], axis=1)


def tome_unmerge(plan: TomePlan, y):
    """[B, S_m, C] -> [B, S, C]: merged positions copy their dst's output."""
    n_dst = plan.dst_pos.shape[0]
    y_dst = y[:, :n_dst]
    y_src = jnp.take_along_axis(
        y, plan.idx_src[..., None], axis=1
    )  # [B, n_src, C] — kept tokens read their own slot, merged their dst
    full = jnp.concatenate([y_dst, y_src], axis=1)   # [dst block | src block]
    return jnp.take(full, plan.inv_perm, axis=1)     # static raster reorder
