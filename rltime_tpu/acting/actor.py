"""Acting subsystem: jitted policy step + host rollout driver.

Re-design of the reference's actor/actor-pool (SURVEY.md §1 L3, §3.2).
The reference runs policy forward on CPU torch inside actor
subprocesses; here the policy step is a single jitted device function
over ALL env lanes at once:

  raw obs (host, uint8/f32) --device_put--> act_step (frame-stack
  update + LSTM step + eps-greedy, all on device) --> actions (host)

Per-step host<->device traffic is one small H2D (raw obs) and one tiny
D2H (actions). Chunks of L steps are accumulated host-side and
inserted into the device replay with ONE transfer per field
(SURVEY.md §3.5 "host->device stream").

Recurrent bookkeeping (SURVEY.md §3.2): the device state carries the
LSTM carry and the frame stack; `done` lanes are zero-reset INSIDE the
jitted step. The state stored into replay for R2D2 is the post-reset
carry used to compute that step's Q — exactly what burn-in resumes
from.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rltime_tpu.models.policy import (
    ModelConfig, initial_rnn_state, make_model, q_values,
)
from rltime_tpu.utils.pytree import PyTreeNode


class ActorDeviceState(PyTreeNode):
    """On-device acting state for E lockstep env lanes."""
    frames: jnp.ndarray      # (E, F, ...) rolling frame stack (F>=1)
    rnn: tuple               # LSTM carry ((c, h) or ())
    key: jnp.ndarray         # PRNG key for exploration + IQN taus
    obs_chunk: jnp.ndarray   # (E, L, ...) device-side chunk obs
                             # accumulator ((E, 0) dummy if unused) —
                             # raw frames transfer H2D ONCE and are
                             # inserted into replay straight from here


def init_actor_state(cfg: ModelConfig, num_envs: int, frame_stack: int,
                     obs_shape, obs_dtype, key,
                     chunk_len: int = 0) -> ActorDeviceState:
    frames = jnp.zeros((num_envs, frame_stack) + tuple(obs_shape),
                       dtype=obs_dtype)
    obs_chunk = jnp.zeros((num_envs, chunk_len) + tuple(obs_shape),
                          dtype=obs_dtype)
    return ActorDeviceState(
        frames=frames,
        rnn=initial_rnn_state(cfg, num_envs),
        key=key,
        obs_chunk=obs_chunk,
    )


def make_act_step(cfg: ModelConfig, frame_stack: int,
                  flatten_stack: bool):
    """Build the jitted act step for a model config.

    flatten_stack: for vector obs with frame_stack == 1 the stack axis
    is squeezed before the model (CartPole-style (E, D) input); image
    obs keep (E, F, H, W) — the CNN torso consumes F as channels.
    """
    model = make_model(cfg)

    @functools.partial(jax.jit, donate_argnums=(1,))
    def act_step(params, state: ActorDeviceState, obs: jnp.ndarray,
                 done_prev: jnp.ndarray, eps: jnp.ndarray,
                 t_in_chunk: jnp.ndarray):
        """One lockstep policy step.

        Args:
          obs: (E, ...) raw obs AFTER the previous env step (auto-reset:
            first obs of a new episode where done_prev).
          done_prev: (E,) bool — previous step ended the episode.
          eps: (E,) per-lane exploration epsilon.
          t_in_chunk: scalar — column of the chunk accumulator to fill.
        Returns (actions (E,) int32, new_state, info dict).
        """
        E = obs.shape[0]
        # Frame stack update: zero pre-reset frames, append new obs.
        mask_shape = (E,) + (1,) * (state.frames.ndim - 1)
        keep = (1 - done_prev.astype(jnp.int32)).reshape(mask_shape)
        frames = state.frames * keep.astype(state.frames.dtype)
        frames = jnp.concatenate(
            [frames[:, 1:], obs[:, None].astype(frames.dtype)], axis=1)

        obs_chunk = state.obs_chunk
        if obs_chunk.shape[1] > 0:
            obs_chunk = jax.lax.dynamic_update_slice(
                obs_chunk, obs[:, None].astype(obs_chunk.dtype),
                (0, t_in_chunk) + (0,) * (obs.ndim - 1))

        # Recurrent reset on episode boundary.
        rnn = state.rnn
        if cfg.recurrent:
            rmask = (1.0 - done_prev.astype(jnp.float32))[:, None]
            rnn = jax.tree.map(lambda s: s * rmask, rnn)
        stored_rnn = rnn  # state consumed by THIS step (R2D2 storage)

        net_in = frames[:, 0] if (flatten_stack and frame_stack == 1) \
            else frames
        if flatten_stack and frame_stack > 1:
            net_in = frames.reshape(E, -1)
        if cfg.channels_last and net_in.ndim == 4:
            # NHWC model contract: the rolling stack stays (E, F, H, W)
            # (cheap append on axis 1); only this tiny per-step view
            # is transposed.
            net_in = jnp.moveaxis(net_in, 1, -1)

        key, tau_key, ekey, akey = jax.random.split(state.key, 4)
        taus = None
        if cfg.is_iqn:
            taus = jax.random.uniform(tau_key, (E, cfg.num_tau_policy))
        q, rnn = model.apply(params, net_in, rnn, taus)
        qv = q_values(cfg, q)
        greedy = jnp.argmax(qv, axis=-1).astype(jnp.int32)
        explore = jax.random.uniform(ekey, (E,)) < eps
        random_a = jax.random.randint(akey, (E,), 0, cfg.num_actions,
                                      dtype=jnp.int32)
        actions = jnp.where(explore, random_a, greedy)
        q_sa = jnp.take_along_axis(qv, actions[:, None], axis=-1)[:, 0]
        q_best = jnp.max(qv, axis=-1)
        info = dict(q_mean=jnp.mean(qv), q_max=jnp.mean(q_best))
        new_state = ActorDeviceState(frames=frames, rnn=rnn, key=key,
                                     obs_chunk=obs_chunk)
        return actions, new_state, info, stored_rnn, q_sa, q_best

    return act_step


class Actor:
    """Host-side rollout driver over one VecEnv (SURVEY.md §3.2).

    Produces fixed-shape transition chunks:
      obs (E, L, ...) raw single frames, action/reward (E, L),
      terminated/done (E, L), and for recurrent policies the stored
      per-step LSTM carry (E, L, H) x2.
    Tracks per-env episode returns/lengths host-side.
    """

    def __init__(self, env, cfg: ModelConfig, frame_stack: int,
                 exploration, key, chunk_len: int,
                 compute_priorities: bool = False, gamma: float = 0.99):
        self.env = env
        self.cfg = cfg
        self.frame_stack = frame_stack
        self.exploration = exploration
        self.chunk_len = chunk_len
        # Ape-X actor-side initial priorities (arxiv 1803.00933 §B):
        # emit each transition one step late so its 1-step TD estimate
        # |r + gamma*(1-done)*max_a Q(s') - Q(s,a)| can ride along
        # (done, not terminated: at a done step s' is the next
        # episode's reset obs, which no target ever bootstraps from).
        self.compute_priorities = compute_priorities
        self.gamma = gamma
        self._pending = None
        # Device-side obs chunk accumulation (one H2D per frame instead
        # of two): on unless priorities delay emission by one step.
        self.device_obs_chunk = not compute_priorities
        flatten = len(env.spec.obs_shape) == 1
        self.flatten_stack = flatten
        self._act_step = make_act_step(cfg, frame_stack, flatten)
        self.state = init_actor_state(
            cfg, env.num_envs, frame_stack, env.spec.obs_shape,
            jnp.uint8 if env.spec.obs_dtype == np.uint8 else jnp.float32,
            key, chunk_len=chunk_len if self.device_obs_chunk else 0)
        self.obs = env.reset()
        self.done_prev = np.ones((env.num_envs,), bool)  # stack starts empty
        self.env_steps = 0
        # episode bookkeeping
        self._ep_ret = np.zeros((env.num_envs,), np.float64)
        self._ep_len = np.zeros((env.num_envs,), np.int64)
        self.completed_returns: list = []
        self.completed_lengths: list = []

    def rollout(self, params, num_steps: Optional[int] = None):
        """Collect a chunk of num_steps lockstep transitions.

        Returns (chunk dict of numpy/device arrays each (E, L, ...),
        info dict). The LSTM fields stay on device. With
        compute_priorities, the chunk also carries "priority" (raw
        1-step |TD|) and transitions are emitted one policy step late.
        """
        L = num_steps or self.chunk_len
        E = self.env.num_envs
        spec = self.env.spec
        use_dev_obs = self.device_obs_chunk and L == self.chunk_len
        obs_buf = (None if use_dev_obs else
                   np.empty((E, L) + spec.obs_shape, spec.obs_dtype))
        act_buf = np.empty((E, L), np.int32)
        rew_buf = np.empty((E, L), np.float32)
        term_buf = np.empty((E, L), bool)
        done_buf = np.empty((E, L), bool)
        prio_buf = (np.empty((E, L), np.float32)
                    if self.compute_priorities else None)
        rnn_steps = []
        q_mean = 0.0
        emitted = 0

        def emit(tr, prio=None):
            nonlocal emitted
            i = emitted
            if obs_buf is not None:
                obs_buf[:, i] = tr["obs"]
            act_buf[:, i] = tr["action"]
            rew_buf[:, i] = tr["reward"]
            term_buf[:, i] = tr["terminated"]
            done_buf[:, i] = tr["done"]
            if prio_buf is not None:
                prio_buf[:, i] = prio
            if self.cfg.recurrent:
                rnn_steps.append(tr["rnn"])
            emitted += 1

        while emitted < L:
            eps = self.exploration.epsilons(E, self.env_steps)
            (actions, self.state, info, stored_rnn, q_sa,
             q_best) = self._act_step(params, self.state, self.obs,
                                      self.done_prev, jnp.asarray(eps),
                                      jnp.int32(emitted if use_dev_obs
                                                else 0))
            if self.compute_priorities and self._pending is not None:
                p = self._pending
                td = np.abs(p["reward"]
                            + self.gamma
                            * (1.0 - p["done"].astype(np.float32))
                            * np.asarray(q_best) - p["q_sa"])
                emit(p, td)
            actions_np = np.asarray(actions)
            obs_cur = self.obs
            next_obs, rew, term, trunc = self.env.step(actions_np)
            done = term | trunc
            tr = dict(obs=obs_cur, action=actions_np, reward=rew,
                      terminated=term, done=done, rnn=stored_rnn,
                      q_sa=np.asarray(q_sa))
            if self.compute_priorities:
                self._pending = tr
            else:
                emit(tr)
            # episode bookkeeping
            self._ep_ret += rew
            self._ep_len += 1
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_ret[i]))
                self.completed_lengths.append(int(self._ep_len[i]))
            self._ep_ret[done] = 0.0
            self._ep_len[done] = 0
            self.obs = next_obs
            self.done_prev = done
            self.env_steps += E
            q_mean = info["q_mean"]

        if use_dev_obs:
            # Copy out of the (donated) accumulator so the next chunk's
            # in-place updates cannot race a pending async insert.
            chunk_obs = jnp.copy(self.state.obs_chunk)
        else:
            chunk_obs = obs_buf
        chunk = dict(obs=chunk_obs, action=act_buf, reward=rew_buf,
                     terminated=term_buf, done=done_buf)
        if prio_buf is not None:
            chunk["priority"] = prio_buf
        if self.cfg.recurrent:
            # (L, (c,h) of (E,H)) -> two (E, L, H) device arrays.
            c = jnp.stack([s[0] for s in rnn_steps], axis=1)
            h = jnp.stack([s[1] for s in rnn_steps], axis=1)
            chunk["rnn_c"] = c
            chunk["rnn_h"] = h
        info = dict(env_steps=self.env_steps, q_mean=float(q_mean))
        return chunk, info

    def episode_stats(self, clear: bool = True):
        rets, lens = self.completed_returns, self.completed_lengths
        if clear:
            self.completed_returns, self.completed_lengths = [], []
        return rets, lens
