"""Q-value heads: linear, dueling, IQN (SURVEY.md §2 "Models").

Dueling: Q = V + A - mean_a A (the reference's aggregation identity —
tested in tests/test_models.py). IQN: cosine tau embedding (64 basis),
elementwise product with the torso features, shared head over taus.
Same conventions as models/torso.py: `init(key, feat_dim) -> params`,
`__call__(params, feat[, taus])`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from rltime_tpu.models.torso import dense, dense_params


def _dueling_params(key, d_in: int, hidden: int, num_actions: int):
    k = jax.random.split(key, 4)
    return {"Dense_0": dense_params(k[0], d_in, hidden),
            "Dense_1": dense_params(k[1], hidden, 1),
            "Dense_2": dense_params(k[2], d_in, hidden),
            "Dense_3": dense_params(k[3], hidden, num_actions)}


def _dueling(params, h, dtype):
    f32 = jnp.float32
    v = jax.nn.relu(dense(params["Dense_0"], h, dtype))
    v = dense(params["Dense_1"], v.astype(f32), f32)
    a = jax.nn.relu(dense(params["Dense_2"], h, dtype))
    a = dense(params["Dense_3"], a.astype(f32), f32)
    return v + a - jnp.mean(a, axis=-1, keepdims=True)


@dataclasses.dataclass(frozen=True)
class LinearQHead:
    num_actions: int
    compute_dtype: Any = jnp.float32

    def init(self, key, d_in: int):
        return {"Dense_0": dense_params(key, d_in, self.num_actions)}

    def __call__(self, params, feat):
        return dense(params["Dense_0"], feat, jnp.float32)


@dataclasses.dataclass(frozen=True)
class DuelingQHead:
    num_actions: int
    hidden: int = 256
    compute_dtype: Any = jnp.float32

    def init(self, key, d_in: int):
        return _dueling_params(key, d_in, self.hidden, self.num_actions)

    def __call__(self, params, feat):
        return _dueling(params, feat, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class IQNHead:
    """Implicit-quantile head (SURVEY.md §3.3 IQN path).

    phi(tau) = relu(Dense(cos(pi * i * tau), i = 0..embed_dim-1));
    quantile features = feat * phi(tau); head maps to per-action
    quantile values. Dueling aggregation optionally applied per tau.
    """
    num_actions: int
    embed_dim: int = 64
    dueling: bool = False
    hidden: int = 256
    compute_dtype: Any = jnp.float32

    def init(self, key, d_in: int):
        k_embed, k_head = jax.random.split(key)
        params = {"tau_embed": dense_params(k_embed, self.embed_dim, d_in)}
        if self.dueling:
            params.update(_dueling_params(k_head, d_in, self.hidden,
                                          self.num_actions))
        else:
            k0, k1 = jax.random.split(k_head)
            params["Dense_0"] = dense_params(k0, d_in, self.hidden)
            params["Dense_1"] = dense_params(k1, self.hidden,
                                             self.num_actions)
        return params

    def __call__(self, params, feat, taus):
        """feat (B, D); taus (B, N) -> quantile values (B, N, A)."""
        cd = self.compute_dtype
        i = jnp.arange(self.embed_dim, dtype=jnp.float32)
        cos = jnp.cos(jnp.pi * taus[..., None] * i)        # (B, N, E)
        phi = jax.nn.relu(dense(params["tau_embed"], cos, cd))  # (B, N, D)
        h = feat[:, None, :].astype(cd) * phi
        if self.dueling:
            return _dueling(params, h, cd)
        q = jax.nn.relu(dense(params["Dense_0"], h, cd))
        return dense(params["Dense_1"], q.astype(jnp.float32),
                     jnp.float32)                           # (B, N, A)
