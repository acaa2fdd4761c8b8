"""LR decay (algo.lr_end / lr_decay_updates) unit tests."""
import jax
import jax.numpy as jnp
import numpy as np

from rltime_tpu.training.learner import AlgoConfig, make_optimizer


def _step_sizes(cfg, n):
    """|param delta| per update for a constant unit gradient."""
    tx = make_optimizer(cfg)
    p = {"w": jnp.zeros((3,))}
    g = {"w": jnp.ones((3,))}
    st = tx.init(p)
    out = []
    for _ in range(n):
        upd, st = tx.update(g, st, p)
        out.append(float(jnp.abs(upd["w"][0])))
    return out


def test_constant_lr_by_default():
    s = _step_sizes(AlgoConfig(lr=1e-3, grad_clip=0.0), 5)
    # adam with constant grad: step magnitude settles at ~lr
    assert all(abs(x - s[0]) < 1e-6 for x in s[1:])


def test_linear_decay_reaches_lr_end():
    cfg = AlgoConfig(lr=1e-3, lr_end=0.0, lr_decay_updates=10,
                     grad_clip=0.0)
    s = _step_sizes(cfg, 12)
    assert s[1] < s[0]                      # decaying
    assert s[11] < 1e-9                     # clamped at lr_end=0
    # halfway point scales linearly (adam's unit-grad step ~= lr)
    assert abs(s[5] / s[0] - 0.5) < 0.05


def test_decay_count_survives_checkpoint_roundtrip():
    """The schedule count lives in opt_state; saving/restoring it must
    resume the decay where it left off (deterministic-resume bar)."""
    cfg = AlgoConfig(lr=1e-3, lr_end=0.0, lr_decay_updates=8,
                     grad_clip=0.0)
    tx = make_optimizer(cfg)
    p = {"w": jnp.zeros((3,))}
    g = {"w": jnp.ones((3,))}
    st = tx.init(p)
    for _ in range(4):
        _, st = tx.update(g, st, p)
    # round-trip through host numpy (what checkpoints serialize)
    st2 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), st)
    u_a, _ = tx.update(g, st, p)
    u_b, _ = tx.update(g, st2, p)
    np.testing.assert_allclose(np.asarray(u_a["w"]),
                               np.asarray(u_b["w"]))
