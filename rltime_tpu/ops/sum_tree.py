"""On-device segment (sum) tree for prioritized replay.

Device-side replacement for the reference's numpy sum-tree loop
(SURVEY.md §2 "Prioritized replay": proportional PER with sum-tree
sampling / priority updates, per arxiv 1511.05952). The reference
descends the tree one sample at a time in Python; here the whole batch
descends in lockstep as vectorized gathers — O(B·log N) fully on
device, no host round-trips.

Layout: a flat `(2N,)` float32 array for N (power-of-two) leaves.
Node 1 is the root; node `i` has children `2i, 2i+1`; leaves occupy
`[N, 2N)`. Node 0 is unused padding. A batch of B leaf updates
propagates deltas up all `log2(N)+1` levels with `scatter-add`
(duplicate ancestors accumulate correctly by construction).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def tree_size(num_leaves: int) -> int:
    """Smallest power of two >= num_leaves."""
    n = 1
    while n < num_leaves:
        n *= 2
    return n


def init(num_leaves: int, dtype=jnp.float32) -> jnp.ndarray:
    """All-zero tree able to hold `num_leaves` priorities."""
    n = tree_size(num_leaves)
    return jnp.zeros((2 * n,), dtype=dtype)


def capacity(tree: jnp.ndarray) -> int:
    return tree.shape[0] // 2


def total(tree: jnp.ndarray) -> jnp.ndarray:
    """Root value == sum of all priorities."""
    return tree[1]


def get(tree: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Read leaf priorities at `idx` (any shape)."""
    return tree[capacity(tree) + idx]


def set_priorities(tree: jnp.ndarray, idx: jnp.ndarray,
                   priorities: jnp.ndarray,
                   unique: bool = False) -> jnp.ndarray:
    """Set leaves `idx` (shape (B,)) to `priorities`, fixing all ancestors.

    Duplicate indices resolve to the LAST occurrence (sorted stable, so
    the final value for a repeated leaf is the value paired with its
    last occurrence in the input order). `unique=True` asserts the
    caller guarantees no duplicates and skips the dedup sort (a device
    argsort costs far more than the scatters themselves).
    """
    n = capacity(tree)
    depth = n.bit_length() - 1  # log2(n)
    idx = idx.astype(jnp.int32)
    priorities = priorities.astype(tree.dtype)

    if unique:
        sidx, sp = idx, priorities
        delta = sp - tree[n + sidx]
    else:
        # Stable sort so "last occurrence in input order" is well defined.
        order = jnp.argsort(idx, stable=True)
        sidx = idx[order]
        sp = priorities[order]
        # keep[i] iff sidx[i] is the last occurrence of that leaf.
        keep = jnp.concatenate(
            [sidx[1:] != sidx[:-1], jnp.ones((1,), dtype=bool)])
        old = tree[n + sidx]
        delta = jnp.where(keep, sp - old, jnp.zeros_like(sp))

    nodes = n + sidx
    for _ in range(depth + 1):  # leaf level .. root (node 1)
        tree = tree.at[nodes].add(delta, mode="drop")
        nodes = nodes >> 1
    return tree


def _descend(tree: jnp.ndarray, targets: jnp.ndarray) -> jnp.ndarray:
    """Vectorized stochastic descend: prefix-sum targets -> leaf indices.

    Zero-subtree-proof: a float-boundary target (t == left subtree sum
    exactly) must not step into an empty right subtree — and vice
    versa — or the caller would sample a zero-priority leaf and blow
    up its importance weight. Each level therefore checks the child
    masses, not just the target.
    """
    n = capacity(tree)
    depth = n.bit_length() - 1
    idx = jnp.ones_like(targets, dtype=jnp.int32)
    t = targets
    for _ in range(depth):
        left = tree[2 * idx]
        right = tree[2 * idx + 1]
        go_right = (t >= left) & (right > 0)
        go_right = go_right | (left <= 0)
        t = jnp.where(go_right, t - left, t)
        idx = 2 * idx + go_right.astype(jnp.int32)
    return idx - n


@functools.partial(jax.jit, static_argnames=("batch", "stratified"))
def sample(tree: jnp.ndarray, key, batch: int, stratified: bool = True):
    """Draw `batch` leaves ~ priority / total.

    Stratified (reference semantics, SURVEY.md §3.3): target i is
    uniform in segment [i, i+1)/B of the total mass — lower-variance
    than iid and what PER prescribes.

    Returns (leaf_idx (B,), leaf_priority (B,)).
    """
    tot = total(tree)
    u = jax.random.uniform(key, (batch,), dtype=tree.dtype)
    if stratified:
        u = (jnp.arange(batch, dtype=tree.dtype) + u) / batch
    # Scale into mass; nextafter guard keeps targets strictly < total so
    # the descend cannot fall off the right edge.
    targets = jnp.minimum(u * tot, jnp.nextafter(tot, jnp.zeros_like(tot)))
    idx = _descend(tree, targets)
    return idx, get(tree, idx)
