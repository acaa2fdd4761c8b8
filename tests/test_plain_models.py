"""The plain-JAX model layers against independent references: the LSTM
cell against a numpy step, the Nature and MinAtar CNN torsos against a
lax/numpy forward, and the param trees' shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rltime_tpu.models.policy import (
    ModelConfig, init_params, initial_rnn_state, lstm_cell, make_model,
    unroll,
)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np_lstm_step(p, c, h, x):
    """Gates i, f, g, o; c' = f*c + i*g; h' = o*tanh(c')."""
    z = x @ p["i_kernel"] + h @ p["h_kernel"] + p["bias"]
    i, f, g, o = np.split(z, 4, axis=-1)
    c = _sigmoid(f) * c + _sigmoid(i) * np.tanh(g)
    return c, _sigmoid(o) * np.tanh(c)


def test_lstm_cell_matches_numpy_step_with_reset():
    cfg = ModelConfig(num_actions=3, torso="mlp", mlp_hidden=(6,),
                      head="linear", lstm_size=5)
    B, T = 3, 4
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(B, T, 7)).astype(np.float32)
    done_prev = np.zeros((B, T), bool)
    done_prev[1, 2] = True          # lane 1 resets before step 2
    params = init_params(cfg, jax.random.key(0), jnp.asarray(obs[:, 0]))
    p = jax.tree.map(np.asarray, params["params"])

    # orthogonal recurrent kernel, one (H, H) block per gate
    for k in range(4):
        blk = p["lstm"]["h_kernel"][:, 5 * k:5 * (k + 1)]
        np.testing.assert_allclose(blk.T @ blk, np.eye(5), atol=1e-5)
    np.testing.assert_array_equal(p["lstm"]["bias"], np.zeros(20))

    def torso(x):
        d = p["torso_mod"]["Dense_0"]
        return np.maximum(x @ d["kernel"] + d["bias"], 0.0)

    c = np.zeros((B, 5), np.float32)
    h = np.zeros((B, 5), np.float32)
    ref = []
    for t in range(T):
        keep = (1.0 - done_prev[:, t])[:, None]
        c, h = _np_lstm_step(p["lstm"], c * keep, h * keep,
                             torso(obs[:, t]))
        d = p["head_mod"]["Dense_0"]
        ref.append(h @ d["kernel"] + d["bias"])
    qs, (c_f, h_f) = unroll(make_model(cfg), params, jnp.asarray(obs),
                            jnp.asarray(done_prev),
                            initial_rnn_state(cfg, B))
    np.testing.assert_allclose(np.asarray(qs), np.stack(ref, 1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(c_f), c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(h_f), h, rtol=1e-5, atol=1e-5)
    # the cell alone returns h' as both the output and the carry's h
    (c1, h1), out = lstm_cell(params["params"]["lstm"],
                              (jnp.zeros((B, 5)), jnp.zeros((B, 5))),
                              jnp.asarray(torso(obs[:, 0])))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(h1))


def _lax_conv(x, w, b, s):
    y = jax.lax.conv_general_dilated(
        x, w, (s, s), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    return np.maximum(np.asarray(y) + b, 0.0)


def test_nature_cnn_forward_matches_lax_reference():
    cfg = ModelConfig(num_actions=4, torso="nature_cnn", head="dueling",
                      compute_dtype="float32", dueling_hidden=16)
    obs = np.random.default_rng(1).integers(0, 255, (2, 4, 84, 84),
                                            np.uint8)
    params = init_params(cfg, jax.random.key(3), jnp.asarray(obs[:1]))
    p = jax.tree.map(np.asarray, params["params"])
    x = np.transpose(obs, (0, 2, 3, 1)).astype(np.float32) / 255.0
    for i, s in enumerate((4, 2, 1)):
        cv = p["torso_mod"][f"Conv_{i}"]
        x = _lax_conv(x, cv["kernel"], cv["bias"], s)
    fc = p["torso_mod"]["Dense_0"]
    feat = np.maximum(x.reshape(2, -1) @ fc["kernel"] + fc["bias"], 0.0)
    h = p["head_mod"]

    def lin(name, v):
        return v @ h[name]["kernel"] + h[name]["bias"]
    v = lin("Dense_1", np.maximum(lin("Dense_0", feat), 0.0))
    a = lin("Dense_3", np.maximum(lin("Dense_2", feat), 0.0))
    ref = v + a - a.mean(-1, keepdims=True)
    q, state = make_model(cfg).apply(params, jnp.asarray(obs), ())
    assert state == ()
    np.testing.assert_allclose(np.asarray(q), ref, rtol=1e-4, atol=1e-5)


def test_minatar_cnn_forward_matches_lax_reference():
    cfg = ModelConfig(num_actions=3, torso="minatar_cnn",
                      cnn_channels=(16,), cnn_fc=32, head="linear")
    obs = (np.random.default_rng(2).random((3, 1, 10, 10, 4)) < 0.3
           ).astype(np.uint8)       # (B, F, H, W, C) window gather form
    params = init_params(cfg, jax.random.key(4), jnp.asarray(obs[:1]))
    p = jax.tree.map(np.asarray, params["params"])
    x = np.moveaxis(obs, 1, -2).reshape(3, 10, 10, 4).astype(np.float32)
    cv = p["torso_mod"]["Conv_0"]
    x = _lax_conv(x, cv["kernel"], cv["bias"], 1)
    fc = p["torso_mod"]["Dense_0"]
    feat = np.maximum(x.reshape(3, -1) @ fc["kernel"] + fc["bias"], 0.0)
    d = p["head_mod"]["Dense_0"]
    q, _ = make_model(cfg).apply(params, jnp.asarray(obs), ())
    np.testing.assert_allclose(np.asarray(q), feat @ d["kernel"] + d["bias"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("head,lstm", [("dueling", 0), ("iqn", 0),
                                       ("linear", 512)])
def test_param_tree_shapes(head, lstm):
    cfg = ModelConfig(num_actions=6, torso="nature_cnn", head=head,
                      lstm_size=lstm)
    params = init_params(cfg, jax.random.key(0),
                         jnp.zeros((1, 4, 84, 84), jnp.uint8))
    shapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                          params["params"])
    f32 = "float32"
    assert shapes["torso_mod"] == {
        "Conv_0": {"kernel": ((8, 8, 4, 32), f32), "bias": ((32,), f32)},
        "Conv_1": {"kernel": ((4, 4, 32, 64), f32), "bias": ((64,), f32)},
        "Conv_2": {"kernel": ((3, 3, 64, 64), f32), "bias": ((64,), f32)},
        "Dense_0": {"kernel": ((3136, 512), f32), "bias": ((512,), f32)}}
    head_in = 512
    if lstm:
        assert shapes["lstm"] == {"i_kernel": ((512, 2048), f32),
                                  "h_kernel": ((512, 2048), f32),
                                  "bias": ((2048,), f32)}
    if head == "linear":
        assert shapes["head_mod"] == {
            "Dense_0": {"kernel": ((head_in, 6), f32), "bias": ((6,), f32)}}
    elif head == "dueling":
        assert shapes["head_mod"]["Dense_1"]["kernel"] == ((256, 1), f32)
        assert shapes["head_mod"]["Dense_3"]["kernel"] == ((256, 6), f32)
    else:
        assert shapes["head_mod"]["tau_embed"]["kernel"] == ((64, 512), f32)
        assert shapes["head_mod"]["Dense_1"]["kernel"] == ((256, 6), f32)
    # LeCun-normal conv fan-in: std ~ 1/sqrt(8*8*4)
    w = np.asarray(params["params"]["torso_mod"]["Conv_0"]["kernel"])
    assert 0.7 < w.std() * np.sqrt(8 * 8 * 4) < 1.1
