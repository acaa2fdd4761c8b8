"""State records and checkpoints: the PyTreeNode base under jit and
donation, and the npz checkpoint round trip (typed PRNG keys, the
dataclass structure with an example, plain dicts without one)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rltime_tpu.models.policy import ModelConfig
from rltime_tpu.training import checkpoint as ckpt_lib
from rltime_tpu.training.learner import AlgoConfig, make_train_state
from rltime_tpu.utils.pytree import PyTreeNode


class _State(PyTreeNode):
    x: jnp.ndarray
    rnn: tuple
    key: jnp.ndarray


def test_pytree_node_jit_donation_and_replace():
    s = _State(x=jnp.arange(4.0), rnn=(jnp.zeros(2), jnp.ones(2)),
               key=jax.random.key(1))
    leaves, treedef = jax.tree.flatten(s)
    assert len(leaves) == 4
    assert isinstance(jax.tree.unflatten(treedef, leaves), _State)
    step = jax.jit(lambda st: st.replace(x=st.x * 2,
                                         key=jax.random.split(st.key)[0]),
                   donate_argnums=(0,))
    out = step(s)
    assert isinstance(out, _State)
    np.testing.assert_array_equal(np.asarray(out.x), [0, 2, 4, 6])
    np.testing.assert_array_equal(np.asarray(out.rnn[1]), [1, 1])
    # replace returns a new record; frozen fields cannot be assigned
    r = out.replace(rnn=())
    assert r.rnn == () and len(out.rnn) == 2
    with pytest.raises(dataclasses.FrozenInstanceError):
        out.x = 0
    m = jax.tree.map(lambda a: a, out)
    assert isinstance(m, _State)


def _train_state():
    mcfg = ModelConfig(num_actions=3, torso="mlp", mlp_hidden=(8,),
                       head="dueling", dueling_hidden=4, lstm_size=4)
    acfg = AlgoConfig(batch_size=4, lr=1e-3)
    return make_train_state(mcfg, acfg, jax.random.key(5),
                            jnp.zeros((1, 6)))


def test_checkpoint_round_trip_typed_keys(tmp_path):
    d = str(tmp_path)
    ts = _train_state()
    extra = {"actor": _State(x=jnp.arange(3), rnn=(),
                             key=jax.random.key(9))}
    path = ckpt_lib.save(d, 120, ts, dict(env_steps=120, updates=7),
                         extra=extra)
    assert sorted(os.listdir(path)) == ["arrays.npz", "tree.json"]
    assert ckpt_lib.latest_step(d) == 120
    # no temporary directory is left beside the step
    assert os.listdir(os.path.dirname(path)) == ["120"]

    example = {"train_state": ts, "host_state": dict(env_steps=0,
                                                     updates=0),
               "actor": extra["actor"]}
    r = ckpt_lib.restore(d, 120, example)
    assert r["step"] == 120
    assert type(r["train_state"]) is type(ts)
    assert jax.dtypes.issubdtype(r["train_state"].key.dtype,
                                 jax.dtypes.prng_key)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(r["train_state"].key)),
        np.asarray(jax.random.key_data(ts.key)))
    for a, b in zip(jax.tree.leaves(r["train_state"]),
                    jax.tree.leaves(ts)):
        if jax.dtypes.issubdtype(b.dtype, jax.dtypes.prng_key):
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(r["host_state"]["updates"]) == 7
    assert isinstance(r["actor"], _State)

    # without an example: plain nested dicts (what eval reads)
    plain = ckpt_lib.restore(d)
    tree = plain["train_state"]["params"]["params"]
    np.testing.assert_array_equal(
        tree["lstm"]["h_kernel"],
        np.asarray(ts.params["params"]["lstm"]["h_kernel"]))
    assert isinstance(plain["train_state"]["opt_state"], list)
    with open(os.path.join(path, "tree.json")) as f:
        assert len(json.load(f)) == len(jax.tree.leaves(
            ckpt_lib._strip_keys({"train_state": ts,
                                  "host_state": dict(a=0, b=0),
                                  **extra})))

    # overwriting a step replaces it whole
    ckpt_lib.save(d, 120, ts, dict(env_steps=120, updates=8))
    assert int(ckpt_lib.restore(d, 120)["host_state"]["updates"]) == 8
