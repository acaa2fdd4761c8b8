"""Dense two-level sampler: same behavioral contract as the sum tree.

ops/dense_tree.py must be a drop-in for ops/sum_tree.py (SURVEY.md §4
item 1's invariants, re-run against the dense layout), plus its
own geometry rules (padding leaves can never be sampled).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rltime_tpu.ops import dense_tree


def test_init_zero_padded():
    tree = dense_tree.init(100)
    assert tree.shape == (128,)  # padded to block multiple
    assert float(dense_tree.total(tree)) == 0.0


def test_set_and_total():
    tree = dense_tree.init(8)
    idx = jnp.array([0, 3, 7])
    p = jnp.array([1.0, 2.0, 3.0])
    tree = dense_tree.set_priorities(tree, idx, p)
    assert float(dense_tree.total(tree)) == pytest.approx(6.0)
    np.testing.assert_allclose(dense_tree.get(tree, idx), [1.0, 2.0, 3.0])


def test_overwrite():
    tree = dense_tree.init(8)
    tree = dense_tree.set_priorities(
        tree, jnp.array([2, 5]), jnp.array([4.0, 1.0]))
    tree = dense_tree.set_priorities(
        tree, jnp.array([2]), jnp.array([0.5]))
    assert float(dense_tree.total(tree)) == pytest.approx(1.5)


def test_duplicate_indices_last_wins():
    tree = dense_tree.init(8)
    tree = dense_tree.set_priorities(
        tree, jnp.array([3, 3, 3]), jnp.array([9.0, 5.0, 2.0]))
    assert float(dense_tree.get(tree, jnp.array(3))) == pytest.approx(2.0)
    assert float(dense_tree.total(tree)) == pytest.approx(2.0)


def test_duplicates_mixed_with_unique():
    tree = dense_tree.init(16)
    idx = jnp.array([1, 4, 1, 9, 4, 4])
    p = jnp.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    tree = dense_tree.set_priorities(tree, idx, p)
    assert float(dense_tree.get(tree, jnp.array(1))) == pytest.approx(3.0)
    assert float(dense_tree.get(tree, jnp.array(4))) == pytest.approx(6.0)
    assert float(dense_tree.get(tree, jnp.array(9))) == pytest.approx(4.0)


def test_zero_priority_never_sampled(key):
    tree = dense_tree.init(16)
    live = jnp.array([2, 7, 11])
    tree = dense_tree.set_priorities(tree, live, jnp.array([1.0, 1.0, 1.0]))
    idx, p = dense_tree.sample(tree, key, 512)
    assert set(np.asarray(idx).tolist()) <= set(np.asarray(live).tolist())
    assert np.all(np.asarray(p) > 0)


def test_padding_leaves_never_sampled(key):
    # 130 live leaves -> padded to 256; leaves >= 130 must stay dead.
    n = 130
    tree = dense_tree.init(n)
    assert tree.shape[0] > n
    tree = dense_tree.set_priorities(
        tree, jnp.arange(n), jnp.ones((n,)))
    idx, _ = dense_tree.sample(tree, key, 1024)
    assert int(np.max(np.asarray(idx))) < n


def test_multiblock_boundaries(key):
    # >1 block: all mass in the LAST block; block search must route
    # every target past the empty blocks.
    n = 128 * 128 * 2  # -> bs=256, nb=128
    tree = dense_tree.init(n)
    nb, bs = dense_tree._block_shape(tree.shape[0])
    assert nb > 1
    last = jnp.arange(tree.shape[0] - bs, tree.shape[0] - bs + 4)
    tree = dense_tree.set_priorities(tree, last, jnp.ones((4,)))
    idx, p = dense_tree.sample(tree, key, 256)
    assert set(np.asarray(idx).tolist()) <= set(np.asarray(last).tolist())
    assert np.all(np.asarray(p) > 0)


def test_sampling_distribution_matches_priorities(key):
    """Chi-squared check: empirical freq ~ priority / total."""
    num = 8
    prios = jnp.array([1.0, 2.0, 4.0, 8.0, 0.5, 0.0, 3.0, 1.5])
    tree = dense_tree.set_priorities(
        dense_tree.init(num), jnp.arange(num), prios)
    draws = 50_000
    idx, _ = dense_tree.sample(tree, key, draws, stratified=False)
    counts = np.bincount(np.asarray(idx), minlength=num)
    probs = np.asarray(prios) / float(np.sum(np.asarray(prios)))
    expected = probs * draws
    live = expected > 0
    chi2 = np.sum((counts[live] - expected[live]) ** 2 / expected[live])
    assert chi2 < 22.5, (counts, expected)
    assert counts[5] == 0


def test_stratified_sampling_lower_variance(key):
    prios = jnp.ones((64,))
    tree = dense_tree.set_priorities(
        dense_tree.init(64), jnp.arange(64), prios)
    idx, _ = dense_tree.sample(tree, key, 64, stratified=True)
    assert sorted(np.asarray(idx).tolist()) == list(range(64))


def test_jit_and_shapes(key):
    tree = dense_tree.set_priorities(
        dense_tree.init(32), jnp.arange(32), jnp.ones((32,)))
    f = jax.jit(lambda t, k: dense_tree.sample(t, k, 16))
    idx, p = f(tree, key)
    assert idx.shape == (16,)


def test_replay_dense_vs_tree_same_distribution(key):
    """End-to-end replay: both backends sample the same distribution
    over (env, col) after identical inserts."""
    from rltime_tpu.history.replay import (
        ReplayConfig, replay_init, replay_insert, replay_sample_indices)
    fields = {"obs": ((4,), jnp.float32),
              "reward": ((), jnp.float32),
              "terminated": ((), jnp.bool_),
              "done": ((), jnp.bool_)}
    rng = np.random.default_rng(3)
    counts = {}
    for sampler in ("dense", "tree"):
        cfg = ReplayConfig(num_envs=4, steps_per_env=64, horizon=2,
                           chunk_len=8, prioritized=True,
                           sampler=sampler)
        st = replay_init(cfg, fields)
        for k in range(4):
            rng2 = np.random.default_rng(100 + k)
            chunk = dict(
                obs=rng2.normal(size=(4, 8, 4)).astype(np.float32),
                reward=rng2.normal(size=(4, 8)).astype(np.float32),
                terminated=np.zeros((4, 8), bool),
                done=np.zeros((4, 8), bool))
            st = replay_insert(cfg, st, chunk)
        idx = replay_sample_indices(cfg, st, key, 4096, 0.4)
        flat = np.asarray(idx["env"]) * 64 + np.asarray(idx["col"])
        counts[sampler] = np.bincount(flat, minlength=4 * 64)
        assert int(np.asarray(idx["num_valid"])) == 4 * (32 - 2)
    # Same support (all-max-priority -> uniform over live entries).
    assert set(np.nonzero(counts["dense"])[0].tolist()) == \
        set(np.nonzero(counts["tree"])[0].tolist())
