"""Dense two-level prioritized sampler — a vectorized sum tree.

Drop-in alternative to ops/sum_tree.py for proportional PER (SURVEY.md
§2 "Prioritized replay", arxiv 1511.05952). The classic binary sum
tree is pointer-chasing: sampling descends log2(N) DEPENDENT gather
levels and every priority write rewrites log2(N)+1 ancestor levels
with scatter-adds — all serialized, all tiny, the least friendly
shape there is for a wide vector machine.

This layout keeps ONE flat (N,) priority array and derives a single
level of block partial sums at sample time:

    priorities: (N,)  viewed as (num_blocks, block) with block ≈ √N
    block_sums = priorities.reshape(nb, bs).sum(1)        # one reduce
    pick block  : count(cumsum(block_sums) <= target)     # (B, nb) cmp
    pick in blk : gather B contiguous 4·bs-byte rows, cumsum, count

Everything is a dense vector op (reduce, cumsum, compare, contiguous
row gather); the only "gather" touches B contiguous rows — the same
access pattern as the replay frame gather. Priority updates are ONE
scatter into the flat array instead of a log-depth scatter-add chain.

Zero-leaf proofness falls out of the math: "smallest j with
cumsum[j] > t" can never land on a zero-priority leaf, because a zero
leaf's cumsum equals its predecessor's, so the predecessor wins.
(tools/compare_samplers.py A/Bs this against sum_tree.py at the bench
shapes; on the H100 that A/B is not measured yet.)

API mirrors ops/sum_tree.py: init / total / get / set_priorities /
sample over a flat array ("tree" naming kept so history/replay.py can
dispatch on ReplayConfig.sampler without renaming state fields).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _block_shape(n: int) -> tuple[int, int]:
    """(num_blocks, block) for an already-padded n: block ≈ √n rounded
    up to a lane multiple."""
    bs = 128
    while bs * bs < n:
        bs *= 2
    assert n % bs == 0, "tree not allocated via dense_tree.init"
    return n // bs, bs


def padded_size(num_leaves: int) -> int:
    bs = 128
    while bs * bs < num_leaves:
        bs *= 2
    return ((num_leaves + bs - 1) // bs) * bs


def init(num_leaves: int, dtype=jnp.float32) -> jnp.ndarray:
    """All-zero flat priority array holding `num_leaves` priorities.

    Padded up to a block multiple; padding leaves stay zero forever and
    the zero-leaf-proof sampling math can never return them."""
    return jnp.zeros((padded_size(num_leaves),), dtype=dtype)


def capacity(tree: jnp.ndarray) -> int:
    return tree.shape[0]


def total(tree: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(tree)


def get(tree: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    return tree[idx]


def set_priorities(tree: jnp.ndarray, idx: jnp.ndarray,
                   priorities: jnp.ndarray,
                   unique: bool = False) -> jnp.ndarray:
    """Set leaves `idx` (B,) to `priorities`; duplicate indices resolve
    to the LAST occurrence in input order (same contract as
    sum_tree.set_priorities — scatter order must be deterministic for
    the exact-numerics bar).

    `unique=True` asserts the CALLER guarantees idx has no duplicates
    (replay_insert's index sets are unique by construction) and skips
    the dedup sort — a device argsort costs far more than the scatter
    itself."""
    idx = idx.astype(jnp.int32)
    priorities = priorities.astype(tree.dtype)
    if unique:
        return tree.at[idx].set(priorities, mode="drop")
    order = jnp.argsort(idx, stable=True)
    sidx = idx[order]
    sp = priorities[order]
    keep = jnp.concatenate(
        [sidx[1:] != sidx[:-1], jnp.ones((1,), dtype=bool)])
    # Route dropped duplicates out of range; mode="drop" discards them.
    sidx = jnp.where(keep, sidx, tree.shape[0])
    return tree.at[sidx].set(sp, mode="drop")


@functools.partial(jax.jit, static_argnames=("batch", "stratified"))
def sample(tree: jnp.ndarray, key, batch: int, stratified: bool = True):
    """Draw `batch` leaves ~ priority / total (stratified by default).

    Returns (leaf_idx (B,), leaf_priority (B,)) — identical contract to
    sum_tree.sample; the sampled distribution is the same, the exact
    leaf sequence for a given key differs (different algorithm).
    """
    n = tree.shape[0]
    nb, bs = _block_shape(n)
    rows = tree.reshape(nb, bs)
    block_sums = jnp.sum(rows, axis=1)              # (nb,)
    cumb = jnp.cumsum(block_sums)                   # (nb,) inclusive
    # Scale AND clamp against cumb[-1] (not a separate jnp.sum whose
    # reduction order can differ by ulps): the block search below
    # compares against cumb, so targets must be strictly < cumb[-1]
    # or a target could route past every live block onto padding.
    tot = cumb[-1]

    u = jax.random.uniform(key, (batch,), dtype=tree.dtype)
    if stratified:
        u = (jnp.arange(batch, dtype=tree.dtype) + u) / batch
    targets = jnp.minimum(u * tot, jnp.nextafter(tot, jnp.zeros_like(tot)))

    # smallest block with cumb > target  ==  #{cumb <= target}
    blk = jnp.sum(cumb[None, :] <= targets[:, None], axis=1)
    blk = jnp.minimum(blk, nb - 1).astype(jnp.int32)
    # residual target inside the block (exclusive prefix)
    t_in = targets - (cumb[blk] - block_sums[blk])

    picked = rows[blk]                              # (B, bs) row gather
    cumr = jnp.cumsum(picked, axis=1)               # (B, bs)
    off = jnp.sum(cumr <= t_in[:, None], axis=1)
    off = jnp.minimum(off, bs - 1).astype(jnp.int32)
    leaf = blk * bs + off
    return leaf, tree[leaf]
