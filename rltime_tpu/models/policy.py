"""QPolicy: torso + optional LSTM + Q head, with sequence unroll.

Re-design of the reference's model/policy layer (SURVEY.md §1 L5:
`forward(obs, state) -> (q/quantiles, state)` with recurrent state
bookkeeping), in plain jax.numpy. One model serves both the acting
side and the learner side — no separate "actor_policy" mirror; weight
publication is just handing the same param pytree to the acting step.

Sequence processing (R2D2) is a `lax.scan` over time on one device
(SURVEY.md §5.7: sequences are short and fixed; no sequence
parallelism by design — parity with the reference, which has none).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from rltime_tpu.models.torso import (
    MLPTorso, MinAtarCNNTorso, NatureCNNTorso,
)
from rltime_tpu.models.heads import LinearQHead, DuelingQHead, IQNHead


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (hashable; safe as jit static arg)."""
    num_actions: int
    torso: str = "mlp"                  # "mlp" | "nature_cnn" | "minatar_cnn"
    mlp_hidden: Tuple[int, ...] = (64, 64)
    cnn_channels: Tuple[int, ...] = (32, 64, 64)
    cnn_fc: int = 512
    lstm_size: int = 0                  # 0 => feed-forward
    head: str = "linear"                # "linear" | "dueling" | "iqn"
    dueling_hidden: int = 256
    iqn_embed_dim: int = 64
    iqn_dueling: bool = False
    num_tau: int = 64                   # training prediction taus
    num_tau_prime: int = 64             # training target taus
    num_tau_policy: int = 32            # acting taus (risk-neutral mean)
    compute_dtype: str = "float32"      # "float32" | "bfloat16"
    # Nature-CNN perf options (see torso.NatureCNNTorso): NHWC obs
    # contract (4D model input is (B, H, W, F); the learner emits its
    # union gather channel-last, the actor transposes its tiny
    # per-step stack) and the exact conv_0 space-to-depth rewrite.
    channels_last: bool = False
    space_to_depth: bool = False

    @property
    def dtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else jnp.float32

    @property
    def is_iqn(self) -> bool:
        return self.head == "iqn"

    @property
    def recurrent(self) -> bool:
        return self.lstm_size > 0


def lstm_params(key, d_in: int, size: int):
    """LSTM cell params, gates fused in the order i, f, g, o: a
    LeCun-normal input kernel (d_in, 4H), an orthogonal recurrent
    kernel per gate (H, 4H) and a zero bias (4H,)."""
    k_in, k_rec = jax.random.split(key)
    orth = jax.nn.initializers.orthogonal()
    return {"i_kernel": jax.nn.initializers.lecun_normal()(
                k_in, (d_in, 4 * size), jnp.float32),
            "h_kernel": jnp.concatenate(
                [orth(k, (size, size), jnp.float32)
                 for k in jax.random.split(k_rec, 4)], axis=1),
            "bias": jnp.zeros((4 * size,), jnp.float32)}


def lstm_cell(params, carry, x):
    """One float32 LSTM step: c' = f*c + i*g, h' = o*tanh(c').
    carry (c, h) each (B, H); x (B, D). Returns ((c', h'), h')."""
    c, h = carry
    z = (jnp.dot(x, params["i_kernel"]) + jnp.dot(h, params["h_kernel"])
         + params["bias"])
    i, f, g, o = jnp.split(z, 4, axis=-1)
    c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
    h = jax.nn.sigmoid(o) * jnp.tanh(c)
    return (c, h), h


class QPolicy:
    """Torso -> optional LSTM -> Q head, as two pure functions of a
    param tree {"params": {"torso_mod", ["lstm"], "head_mod"}}."""

    def __init__(self, cfg: ModelConfig):
        c = cfg
        self.cfg = c
        if ((c.channels_last or c.space_to_depth)
                and c.torso != "nature_cnn"):
            raise ValueError(
                "channels_last/space_to_depth are Nature-CNN options "
                f"(torso={c.torso!r})")
        if c.torso == "mlp":
            self.torso = MLPTorso(hidden=c.mlp_hidden, compute_dtype=c.dtype)
        elif c.torso == "nature_cnn":
            self.torso = NatureCNNTorso(
                channels=c.cnn_channels, fc=c.cnn_fc,
                compute_dtype=c.dtype,
                channels_last=c.channels_last,
                space_to_depth=c.space_to_depth)
        elif c.torso == "minatar_cnn":
            self.torso = MinAtarCNNTorso(channels=c.cnn_channels,
                                         fc=c.cnn_fc,
                                         compute_dtype=c.dtype)
        else:
            raise ValueError(f"unknown torso {c.torso!r}")
        if c.head == "linear":
            self.head = LinearQHead(c.num_actions)
        elif c.head == "dueling":
            self.head = DuelingQHead(c.num_actions, hidden=c.dueling_hidden,
                                     compute_dtype=c.dtype)
        elif c.head == "iqn":
            self.head = IQNHead(c.num_actions, embed_dim=c.iqn_embed_dim,
                                dueling=c.iqn_dueling,
                                hidden=c.dueling_hidden,
                                compute_dtype=c.dtype)
        else:
            raise ValueError(f"unknown head {c.head!r}")

    def init(self, key, obs):
        """Fresh params for inputs shaped like `obs` (only its shape
        and dtype are read)."""
        k_torso, k_lstm, k_head = jax.random.split(key, 3)
        torso = self.torso.init(k_torso, obs)
        d = jax.eval_shape(self.torso, torso, obs).shape[-1]
        params = {"torso_mod": torso}
        if self.cfg.recurrent:
            params["lstm"] = lstm_params(k_lstm, d, self.cfg.lstm_size)
            d = self.cfg.lstm_size
        params["head_mod"] = self.head.init(k_head, d)
        return {"params": params}

    def apply(self, params, obs, rnn_state=(),
              taus: Optional[jnp.ndarray] = None):
        """One step. obs (B, ...); rnn_state () or (c, h) each (B, H).

        Returns (q, new_rnn_state): q is (B, A), or (B, N, A) quantile
        values when the head is IQN (taus required, shape (B, N)).
        """
        p = params["params"]
        feat = self.torso(p["torso_mod"], obs)
        if self.cfg.recurrent:
            rnn_state, feat = lstm_cell(p["lstm"], rnn_state, feat)
        if self.cfg.is_iqn:
            if taus is None:
                raise ValueError("IQN head requires taus")
            q = self.head(p["head_mod"], feat, taus)
        else:
            q = self.head(p["head_mod"], feat)
        return q, rnn_state


def make_model(cfg: ModelConfig) -> QPolicy:
    return QPolicy(cfg)


def initial_rnn_state(cfg: ModelConfig, batch: int):
    """Zero LSTM carry (c, h), or () for feed-forward policies."""
    if not cfg.recurrent:
        return ()
    # Distinct buffers: (z, z) would alias c and h, which breaks
    # donation (same buffer donated twice).
    return (jnp.zeros((batch, cfg.lstm_size), jnp.float32),
            jnp.zeros((batch, cfg.lstm_size), jnp.float32))


def init_params(cfg: ModelConfig, key, example_obs):
    return make_model(cfg).init(key, example_obs)


def q_values(cfg: ModelConfig, quantiles_or_q: jnp.ndarray) -> jnp.ndarray:
    """Risk-neutral action values: mean over the tau axis for IQN."""
    if cfg.is_iqn:
        return jnp.mean(quantiles_or_q, axis=1)
    return quantiles_or_q


def unroll(model: QPolicy, params, obs_seq, done_prev_seq, rnn_state,
           taus_seq=None):
    """Unroll over time with per-step recurrent reset (SURVEY.md §3.2).

    Args:
      obs_seq: (B, T, ...) observations.
      done_prev_seq: (B, T) True where the PREVIOUS step ended an
        episode — the carry is zeroed before consuming that step,
        mirroring the acting side's reset bookkeeping.
      rnn_state: carry at t=0 ((c, h) or ()).
      taus_seq: (B, T, N) for IQN unrolls.

    Returns (q_seq (B, T, ...), final_state).
    """
    def step(carry, xs):
        if taus_seq is not None:
            obs, done_prev, taus = xs
        else:
            (obs, done_prev), taus = xs, None
        if isinstance(carry, tuple) and len(carry) > 0:
            mask = (1.0 - done_prev.astype(jnp.float32))[:, None]
            carry = jax.tree.map(lambda s: s * mask, carry)
        q, carry = model.apply(params, obs, carry, taus)
        return carry, q

    xs = (jnp.moveaxis(obs_seq, 0, 1), jnp.moveaxis(done_prev_seq, 0, 1))
    if taus_seq is not None:
        xs = xs + (jnp.moveaxis(taus_seq, 0, 1),)
    final_state, q_seq = jax.lax.scan(step, rnn_state, xs)
    return jnp.moveaxis(q_seq, 0, 1), final_state
