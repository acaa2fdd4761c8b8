"""Replay ring + PER activation invariants (see history/replay.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rltime_tpu.history.replay import (
    ReplayConfig, frame_stack_gather, replay_gather_at,
    replay_gather_window, replay_init, replay_insert,
    replay_sample_indices, replay_update_priorities, valid_range,
)
from rltime_tpu.history.replay import _tree_ops


def _leaf_prio(cfg, st, idx):
    """Read leaf priorities via the cfg's sampler backend."""
    return _tree_ops(cfg).get(st.tree, idx)

FIELDS = {
    "obs": ((3,), jnp.float32),
    "action": ((), jnp.int32),
    "reward": ((), jnp.float32),
    "done": ((), jnp.bool_),
}


def _mk(E=2, T=16, horizon=2, L=4, prioritized=True):
    cfg = ReplayConfig(num_envs=E, steps_per_env=T, horizon=horizon,
                       chunk_len=L, prioritized=prioritized)
    return cfg, replay_init(cfg, FIELDS)


def _chunk(cfg, start, L=None):
    """Deterministic chunk: obs[e, t] encodes (e, unwrapped_t)."""
    E, L = cfg.num_envs, L or cfg.chunk_len
    t = start + np.arange(L)
    obs = np.zeros((E, L, 3), np.float32)
    obs[:, :, 0] = np.arange(E)[:, None]
    obs[:, :, 1] = t[None, :]
    return dict(
        obs=jnp.array(obs),
        action=jnp.array(np.tile(t % 5, (E, 1)), jnp.int32),
        reward=jnp.array(np.tile(t.astype(np.float32), (E, 1))),
        done=jnp.zeros((E, L), bool),
    )


def test_insert_roundtrip_and_cursor():
    cfg, st = _mk()
    st = replay_insert(cfg, st, _chunk(cfg, 0))
    assert int(st.t) == 4
    got = replay_gather_at(cfg, st, jnp.array([0, 1]), jnp.array([2, 3]))
    np.testing.assert_allclose(got["obs"][:, 1], [2.0, 3.0])
    np.testing.assert_allclose(got["obs"][:, 0], [0.0, 1.0])


def test_ring_wraparound_overwrites():
    cfg, st = _mk(T=16, L=4)
    for k in range(5):  # 20 columns into a 16-ring
        st = replay_insert(cfg, st, _chunk(cfg, 4 * k))
    # col 0..3 now hold unwrapped t=16..19
    got = replay_gather_at(cfg, st, jnp.array([0]), jnp.array([1]))
    assert float(got["obs"][0, 1]) == 17.0
    lo, hi = valid_range(cfg, st.t)
    assert int(lo) == 4 and int(hi) == 18  # t=20, T=16, horizon=2


def test_per_activation_delay():
    """Leaves go live only when their full horizon is stored."""
    cfg, st = _mk(E=1, T=16, horizon=2, L=4)
    st = replay_insert(cfg, st, _chunk(cfg, 0))
    # t=4: live columns should be [0, 2) (horizon 2 behind cursor).
    live = np.nonzero(np.asarray(
        _leaf_prio(cfg, st, jnp.arange(cfg.capacity))) > 0)[0]
    np.testing.assert_array_equal(live, [0, 1])
    st = replay_insert(cfg, st, _chunk(cfg, 4))
    live = np.nonzero(np.asarray(
        _leaf_prio(cfg, st, jnp.arange(cfg.capacity))) > 0)[0]
    np.testing.assert_array_equal(live, [0, 1, 2, 3, 4, 5])


def test_per_overwrite_zeroes_dead_columns():
    cfg, st = _mk(E=1, T=16, horizon=2, L=4)
    for k in range(8):
        st = replay_insert(cfg, st, _chunk(cfg, 4 * k))
    # steady state (t=32): live columns = [t-T, t-horizon) = 14 leaves
    prio = np.asarray(_leaf_prio(cfg, st, jnp.arange(cfg.capacity)))
    assert (prio > 0).sum() == cfg.steps_per_env - cfg.horizon
    lo, hi = valid_range(cfg, st.t)
    live_cols = sorted(np.nonzero(prio > 0)[0] % cfg.steps_per_env)
    expect = sorted(int(u) % cfg.steps_per_env
                    for u in range(int(lo), int(hi)))
    assert live_cols == expect


def test_sampled_indices_always_valid(key):
    cfg, st = _mk(E=2, T=16, horizon=3, L=4)
    for k in range(6):
        st = replay_insert(cfg, st, _chunk(cfg, 4 * k))
        if int(st.t) > cfg.horizon:
            k1, key = jax.random.split(key)
            idx = replay_sample_indices(cfg, st, k1, 64)
            lo, hi = valid_range(cfg, st.t)
            # every sampled column decodes to an unwrapped t in [lo, hi)
            col = np.asarray(idx["col"])
            t = int(st.t)
            T = cfg.steps_per_env
            unwrapped = col + (t - 1 - col) // T * T  # latest u == col mod T, u < t
            assert np.all(unwrapped >= int(lo)), (col, lo, hi, t)
            assert np.all(unwrapped < int(hi))


def test_uniform_sampling_valid(key):
    cfg, st = _mk(E=2, T=16, horizon=3, L=4, prioritized=False)
    st = replay_insert(cfg, st, _chunk(cfg, 0))
    idx = replay_sample_indices(cfg, st, key, 128)
    assert np.all(np.asarray(idx["col"]) < 1)  # only col 0 valid (t=4, hor=3)
    np.testing.assert_allclose(np.asarray(idx["weight"]), 1.0)


def test_priority_update_and_is_weights(key):
    cfg, st = _mk(E=1, T=16, horizon=1, L=4)
    st = replay_insert(cfg, st, _chunk(cfg, 0))
    st = replay_insert(cfg, st, _chunk(cfg, 4))
    k1, k2 = jax.random.split(key)
    idx = replay_sample_indices(cfg, st, k1, 8, beta=1.0)
    st2 = replay_update_priorities(cfg, st, idx["leaf"],
                                   jnp.full((8,), 3.0))
    expect_p = (3.0 + cfg.min_priority) ** cfg.alpha
    got = _leaf_prio(cfg, st2, idx["leaf"])
    np.testing.assert_allclose(np.asarray(got), expect_p, rtol=1e-5)
    # max priority tracked
    assert float(st2.max_priority) == pytest.approx(
        max(1.0, expect_p), rel=1e-6)


def test_priority_update_dropped_for_overwritten(key):
    cfg, st = _mk(E=1, T=16, horizon=1, L=4)
    for k in range(4):  # fill the ring (t=16)
        st = replay_insert(cfg, st, _chunk(cfg, 4 * k))
    k1, _ = jax.random.split(key)
    idx = replay_sample_indices(cfg, st, k1, 16)
    # Overwrite columns 0..3 (their leaves zero out).
    st = replay_insert(cfg, st, _chunk(cfg, 16))
    dead_mask = np.asarray(_leaf_prio(cfg, st, idx["leaf"])) == 0
    assert dead_mask.any()  # stratified over 15 live leaves hits 0..3
    st2 = replay_update_priorities(cfg, st, idx["leaf"],
                                   jnp.full((16,), 9.0))
    after = np.asarray(_leaf_prio(cfg, st2, idx["leaf"]))
    assert np.all(after[dead_mask] == 0.0)  # no resurrection
    assert np.all(after[~dead_mask] > 1.0)  # live ones updated


def test_gather_window_wraps():
    cfg, st = _mk(E=1, T=16, horizon=2, L=4)
    for k in range(5):
        st = replay_insert(cfg, st, _chunk(cfg, 4 * k))
    win = replay_gather_window(cfg, st, jnp.array([0]),
                               jnp.array([14]), 3, fields=["reward"])
    # cols 14,15,0(mod) hold t=14,15,16
    np.testing.assert_allclose(np.asarray(win["reward"][0]),
                               [14., 15., 16.])


def test_frame_stack_gather_masks_previous_episode():
    cfg = ReplayConfig(num_envs=1, steps_per_env=32, horizon=1,
                       chunk_len=8, lookback=3, prioritized=False)
    fields = {"obs": ((2, 2), jnp.float32), "done": ((), jnp.bool_)}
    st = replay_init(cfg, fields)
    obs = np.arange(1, 9, dtype=np.float32)[None, :, None, None] * \
        np.ones((1, 8, 2, 2), np.float32)
    done = np.zeros((1, 8), bool)
    done[0, 3] = True  # episode boundary after col 3
    st = replay_insert(cfg, st, dict(obs=jnp.array(obs),
                                     done=jnp.array(done)))
    stk = frame_stack_gather(cfg, st, jnp.array([0]), jnp.array([5]), 4)
    # window cols 2,3,4,5 -> done at col3 invalidates cols 2,3
    vals = np.asarray(stk)[0, :, 0, 0]
    np.testing.assert_allclose(vals, [0.0, 0.0, 5.0, 6.0])
    # no boundary in window:
    stk2 = frame_stack_gather(cfg, st, jnp.array([0]), jnp.array([7]), 4)
    np.testing.assert_allclose(np.asarray(stk2)[0, :, 0, 0],
                               [5.0, 6.0, 7.0, 8.0])


def test_config_validation():
    with pytest.raises(ValueError):  # T not a multiple of L
        ReplayConfig(num_envs=1, steps_per_env=10, horizon=1, chunk_len=3)
    with pytest.raises(ValueError):  # T too small vs windows
        ReplayConfig(num_envs=1, steps_per_env=8, horizon=8, chunk_len=8)
    with pytest.raises(ValueError):  # lookback makes T too small
        ReplayConfig(num_envs=1, steps_per_env=16, horizon=4,
                     chunk_len=2, lookback=3)


def test_inserted_priorities_activation():
    """Ape-X actor-side initial priorities: activation uses the raw
    |TD| carried in the chunk, not max-priority."""
    cfg = ReplayConfig(num_envs=1, steps_per_env=16, horizon=2,
                       chunk_len=4, prioritized=True,
                       use_inserted_priorities=True, alpha=1.0,
                       min_priority=0.0)
    fields = dict(FIELDS)
    fields["priority"] = ((), jnp.float32)
    st = replay_init(cfg, fields)
    ck = _chunk(cfg, 0)
    ck["priority"] = jnp.array([[5.0, 3.0, 2.0, 7.0]])
    st = replay_insert(cfg, st, ck)
    # t=4, horizon=2 -> cols 0,1 active with their OWN priorities
    prio = np.asarray(_leaf_prio(cfg, st, jnp.arange(4)))
    np.testing.assert_allclose(prio, [5.0, 3.0, 0.0, 0.0])
    assert float(st.max_priority) == 5.0  # tracks inserted max
    ck2 = _chunk(cfg, 4)
    ck2["priority"] = jnp.array([[1.0, 1.0, 1.0, 1.0]])
    st = replay_insert(cfg, st, ck2)
    prio = np.asarray(_leaf_prio(cfg, st, jnp.arange(8)))
    np.testing.assert_allclose(prio, [5., 3., 2., 7., 1., 1., 0., 0.])
    assert float(st.max_priority) == 7.0


def test_union_gather_matches_two_stacks():
    """frame_stack_union_gather == two frame_stack_gather calls,
    bit-exact, including episode-boundary masking and ring seams."""
    import numpy as np
    from rltime_tpu.history.replay import (
        ReplayConfig, frame_stack_gather, frame_stack_union_gather,
        replay_init, replay_insert,
    )
    E, T, L, F, n = 4, 64, 8, 4, 3
    cfg = ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                       chunk_len=L, lookback=F - 1, prioritized=False)
    fields = {"obs": ((5, 5), jnp.uint8), "action": ((), jnp.int32),
              "reward": ((), jnp.float32),
              "terminated": ((), jnp.bool_), "done": ((), jnp.bool_)}
    state = replay_init(cfg, fields)
    rng = np.random.default_rng(3)
    for k in range(12):              # > T/L: exercises the ring seam
        state = replay_insert(cfg, state, dict(
            obs=rng.integers(0, 255, (E, L, 5, 5), dtype=np.uint8),
            action=rng.integers(0, 3, (E, L)).astype(np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=(rng.random((E, L)) < 0.15),
            done=(rng.random((E, L)) < 0.2)))
    B = 128
    env = jnp.asarray(rng.integers(0, E, (B,)).astype(np.int32))
    col = jnp.asarray(rng.integers(0, T, (B,)).astype(np.int32))
    a = frame_stack_gather(cfg, state, env, col, F)
    b = frame_stack_gather(cfg, state, env, col + n, F)
    u_a, u_b = frame_stack_union_gather(cfg, state, env, col, F, n)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(u_a))
    np.testing.assert_array_equal(np.asarray(b), np.asarray(u_b))


def _seam_ring(window):
    """A wrapped uint8 image ring with random episode ends, and sampled
    columns on both sides of the ring seam (col 0 / col T-1)."""
    E, T, L = 3, 64, 8
    cfg = ReplayConfig(num_envs=E, steps_per_env=T, horizon=window,
                       chunk_len=L, lookback=window - 1)
    fields = {"obs": ((4, 5), jnp.uint8), "done": ((), jnp.bool_)}
    st = replay_init(cfg, fields)
    rng = np.random.default_rng(window)
    for _ in range(10):         # 80 columns into a 64-ring
        st = replay_insert(cfg, st, dict(
            obs=rng.integers(0, 255, (E, L, 4, 5), np.uint8),
            done=rng.random((E, L)) < 0.2))
    env = np.array([0, 1, 2, 0, 1, 2, 1], np.int32)
    col = np.array([0, 1, 2, T - 1, T - 2, 5, T - 3], np.int32)
    return (cfg, st, env, col, np.asarray(st.storage["obs"]),
            np.asarray(st.storage["done"]))


@pytest.mark.parametrize("window", [1, 4, 7])
def test_frame_stack_gather_across_seam_matches_numpy(window):
    cfg, st, env, col, obs, done = _seam_ring(window)
    T = cfg.steps_per_env
    ref = []
    for e, c in zip(env, col):
        frames = []
        for i in range(window):         # slot i: column c-(window-1)+i
            s = c - (window - 1) + i
            stale = any(done[e, k % T] for k in range(s, c))
            frames.append(np.zeros_like(obs[e, 0]) if stale
                          else obs[e, s % T])
        ref.append(np.stack(frames))
    got = frame_stack_gather(cfg, st, jnp.asarray(env), jnp.asarray(col),
                             window)
    np.testing.assert_array_equal(np.asarray(got), np.stack(ref))


@pytest.mark.parametrize("window", [1, 4, 7])
def test_gather_window_across_seam_matches_numpy(window):
    cfg, st, env, col, obs, _ = _seam_ring(window)
    T = cfg.steps_per_env
    ref = np.stack([obs[e, (c + np.arange(window)) % T]
                    for e, c in zip(env, col)])
    got = replay_gather_window(cfg, st, jnp.asarray(env),
                               jnp.asarray(col), window, fields=["obs"])
    np.testing.assert_array_equal(np.asarray(got["obs"]), ref)
