"""Fused on-device acting: policy + env dynamics + recording in ONE
jitted lax.scan — zero per-step host I/O.

For device-resident envs (envs/device.py) the whole acting chunk runs
as a single device launch: L steps of {recurrent-reset -> policy ->
eps-greedy -> env.step -> record}, emitting the (E, L, ...) transition
chunk directly in device memory where the replay insert consumes it.
The only host traffic per chunk is the epsilon vector (E,) down and
the episode-stat scalars back — acting throughput becomes
compute-bound (SURVEY.md §0 item 1 at its device-resident extreme).

Episode bookkeeping stays on device too: completed returns land in a
fixed-size ring via a cumsum-offset scatter (out-of-range indices
dropped for non-done lanes), popped to host at log time.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rltime_tpu.models.policy import (
    ModelConfig, initial_rnn_state, make_model, q_values,
)
from rltime_tpu.utils.pytree import PyTreeNode

STATS_RING = 256  # last-K completed episode returns kept on device


class DeviceActorState(PyTreeNode):
    env_state: Any           # obs derives from it via env.observe()
    done_prev: jnp.ndarray   # (E,) bool
    rnn: tuple
    key: jnp.ndarray
    ep_ret: jnp.ndarray      # (E,) running returns
    ep_len: jnp.ndarray      # (E,) running lengths
    ret_ring: jnp.ndarray    # (STATS_RING,) completed returns
    len_ring: jnp.ndarray    # (STATS_RING,) completed lengths
    ring_cursor: jnp.ndarray  # int32 total completions ever


def make_rollout_core(env, cfg: ModelConfig, chunk_len: int,
                      compute_priorities: bool = False,
                      gamma: float = 0.99):
    """Build the UNJITTED fused rollout for a device env — the ONE
    act-phase definition shared by DeviceActor (jitted directly below)
    and the fused SPMD superstep (parallel/fused.py, which adapts its
    per-shard state view around it). Bit-identity between those two
    paths is load-bearing (test_parallel::test_fused_matches_trainer_
    path), which is why there is exactly one copy of this logic.

    With `compute_priorities`, the chunk carries a "priority" field:
    the Ape-X actor-side 1-step TD estimate |r_t + g*(1-done_t)*
    max_a Q(s_{t+1}) - Q(s_t, a_t)| (SURVEY.md §0 item 5), computed
    in-register during the scan; only the final column needs one
    extra forward on the post-chunk obs. Keys for that forward are
    DERIVED (fold_in), not consumed, so the actor PRNG stream is
    identical with or without priorities.
    """
    model = make_model(cfg)
    L = chunk_len

    def body(params, state: DeviceActorState, eps):
        key, ekey, akey, tkey = jax.random.split(state.key, 4)
        obs = env.observe(state.env_state)
        rnn = state.rnn
        if cfg.recurrent:
            m = (1.0 - state.done_prev.astype(jnp.float32))[:, None]
            rnn = jax.tree.map(lambda s: s * m, rnn)
        stored_rnn = rnn
        taus = None
        if cfg.is_iqn:
            taus = jax.random.uniform(
                tkey, (obs.shape[0], cfg.num_tau_policy))
        q, rnn = model.apply(params, obs, rnn, taus)
        qv = q_values(cfg, q)
        greedy = jnp.argmax(qv, axis=-1).astype(jnp.int32)
        E = obs.shape[0]
        explore = jax.random.uniform(ekey, (E,)) < eps
        rand_a = jax.random.randint(akey, (E,), 0, cfg.num_actions,
                                    dtype=jnp.int32)
        actions = jnp.where(explore, rand_a, greedy)

        env_state, rew, term, trunc = env.step(state.env_state,
                                               actions)
        done = term | trunc

        ep_ret = state.ep_ret + rew
        ep_len = state.ep_len + 1
        # completed episodes -> stat rings (scatter via cumsum offsets;
        # non-done lanes write index STATS_RING -> dropped).
        offs = jnp.cumsum(done.astype(jnp.int32))
        idx = jnp.where(done,
                        (state.ring_cursor + offs - 1) % STATS_RING,
                        STATS_RING)
        ret_ring = state.ret_ring.at[idx].set(ep_ret, mode="drop")
        len_ring = state.len_ring.at[idx].set(
            ep_len.astype(jnp.float32), mode="drop")
        cursor = state.ring_cursor + offs[-1] if E > 0 else \
            state.ring_cursor
        ep_ret = jnp.where(done, 0.0, ep_ret)
        ep_len = jnp.where(done, 0, ep_len)

        rec = dict(obs=obs, action=actions, reward=rew,
                   terminated=term, done=done)
        if compute_priorities:
            rec["q_sa"] = jnp.take_along_axis(
                qv, actions[:, None], axis=-1)[:, 0]
            rec["q_best"] = jnp.max(qv, axis=-1)
        if cfg.recurrent:
            rec["rnn_c"] = stored_rnn[0]
            rec["rnn_h"] = stored_rnn[1]
        new_state = DeviceActorState(
            env_state=env_state, done_prev=done,
            rnn=rnn, key=key, ep_ret=ep_ret, ep_len=ep_len,
            ret_ring=ret_ring, len_ring=len_ring, ring_cursor=cursor)
        return new_state, rec

    def final_qbest(params, state: DeviceActorState):
        obs = env.observe(state.env_state)
        rnn = state.rnn
        if cfg.recurrent:
            m = (1.0 - state.done_prev.astype(jnp.float32))[:, None]
            rnn = jax.tree.map(lambda s: s * m, rnn)
        taus = None
        if cfg.is_iqn:
            taus = jax.random.uniform(
                jax.random.fold_in(state.key, 0x9E37),
                (obs.shape[0], cfg.num_tau_policy))
        q, _ = model.apply(params, obs, rnn, taus)
        return jnp.max(q_values(cfg, q), axis=-1)

    def rollout(params, state: DeviceActorState, eps):
        state, recs = jax.lax.scan(
            lambda s, e: body(params, s, e), state, eps, length=L)
        if compute_priorities:
            q_sa = recs.pop("q_sa")          # (L, E)
            q_best = recs.pop("q_best")      # (L, E)
            q_last = final_qbest(params, state)
            q_next = jnp.concatenate([q_best[1:], q_last[None]],
                                     axis=0)
            # bootstrap masked by done (terminated OR truncated): at a
            # done step q_next is Q of the NEXT episode's auto-reset
            # obs — an unrelated state — and the learner's own targets
            # never bootstrap through a done boundary either
            nondone = 1.0 - recs["done"].astype(jnp.float32)
            recs["priority"] = jnp.abs(
                recs["reward"] + gamma * nondone * q_next - q_sa)
        # (L, E, ...) -> (E, L, ...)
        chunk = {k: jnp.swapaxes(v, 0, 1) for k, v in recs.items()}
        return state, chunk

    return rollout


def make_device_rollout(env, cfg: ModelConfig, chunk_len: int,
                        compute_priorities: bool = False,
                        gamma: float = 0.99):
    """Jitted (donating) wrapper over make_rollout_core."""
    core = make_rollout_core(env, cfg, chunk_len,
                             compute_priorities=compute_priorities,
                             gamma=gamma)
    return jax.jit(core, donate_argnums=(1,))


class DeviceActor:
    """Actor-interface adapter over the fused device rollout."""

    def __init__(self, env, num_envs: int, cfg: ModelConfig,
                 exploration, key, chunk_len: int,
                 compute_priorities: bool = False,
                 gamma: float = 0.99):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.exploration = exploration
        self.chunk_len = chunk_len
        self.compute_priorities = compute_priorities
        k_env, k_act = jax.random.split(key)
        env_state = env.reset(k_env, num_envs)
        self.state = DeviceActorState(
            env_state=env_state,
            done_prev=jnp.ones((num_envs,), bool),
            rnn=initial_rnn_state(cfg, num_envs),
            key=k_act,
            # distinct buffers (identical jnp.zeros may alias one
            # constant, which breaks donation)
            ep_ret=jnp.array(np.zeros((num_envs,), np.float32)),
            ep_len=jnp.array(np.zeros((num_envs,), np.int32)),
            ret_ring=jnp.array(np.zeros((STATS_RING,), np.float32)),
            len_ring=jnp.array(np.zeros((STATS_RING,), np.float32)),
            ring_cursor=jnp.zeros((), jnp.int32))
        self._rollout = make_device_rollout(
            env, cfg, chunk_len, compute_priorities=compute_priorities,
            gamma=gamma)
        self.env_steps = 0
        self._stats_popped = 0

    def rollout(self, params, num_steps: Optional[int] = None):
        L = num_steps or self.chunk_len
        assert L == self.chunk_len, "device rollout length is static"
        eps = jnp.asarray(np.stack([
            self.exploration.epsilons(self.num_envs,
                                      self.env_steps + t * self.num_envs)
            for t in range(L)]))
        self.state, chunk = self._rollout(params, self.state, eps)
        self.env_steps += L * self.num_envs
        return chunk, dict(env_steps=self.env_steps)

    def episode_stats(self, clear: bool = True):
        """Fresh completed (returns, lengths), OLDEST FIRST (same
        chronological order as the host Actor's append-order lists —
        eval.py counts on it)."""
        cursor = int(self.state.ring_cursor)
        fresh = min(cursor - self._stats_popped, STATS_RING)
        if fresh <= 0:
            return [], []
        ring_r = np.asarray(self.state.ret_ring)
        ring_l = np.asarray(self.state.len_ring)
        idxs = [(cursor - fresh + i) % STATS_RING
                for i in range(fresh)]
        rets = [float(ring_r[i]) for i in idxs]
        lens = [float(ring_l[i]) for i in idxs]
        if clear:
            self._stats_popped = cursor
        return rets, lens
