"""Trainer: the host driver gluing acting, replay, and the learner.

SURVEY.md §3.1 control flow, re-drawn for an accelerator (§3.5): the loop
alternates {device acting over all lanes, single-transfer chunk
insert, K jitted update steps} — the update path never touches host.

Built entirely from a JSON config dict (SURVEY.md §1 L1):

  {"env": {"type": "cartpole", "num_envs": 32},
   "model": {...}, "frame_stack": 1,
   "replay": {...}, "algo": {...},
   "exploration": {"type": "epsilon_greedy", ...},
   "train": {...}, "seed": 0}
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

import rltime_tpu.envs  # noqa: F401  (registers env types)
import rltime_tpu.exploration  # noqa: F401  (registers exploration types)
from rltime_tpu.acting.actor import Actor
from rltime_tpu.config.config import build
from rltime_tpu.history.replay import (
    ReplayConfig, replay_init, replay_insert,
)
from rltime_tpu.models.policy import ModelConfig
from rltime_tpu.training.learner import (
    AlgoConfig, make_train_state, make_update_step,
)
from rltime_tpu.training import checkpoint as ckpt_lib
from rltime_tpu.utils.loggers import RunLogger
from rltime_tpu.utils.prng import fold_in_str


@dataclasses.dataclass
class TrainLoopConfig:
    total_env_steps: int = 100_000
    warmup_env_steps: int = 1_000
    chunk_len: int = 16
    updates_per_chunk: int = 1
    log_interval: int = 2_000        # env steps
    checkpoint_interval: int = 50_000
    checkpoint_replay: bool = False
    resume: bool = False
    # Best-checkpoint tracking: snapshot whenever the log-interval
    # episode return mean (>= best_min_episodes episodes) makes a new
    # high; `eval --best` loads it. checkpoints/best.json marks it.
    track_best: bool = True
    best_min_episodes: int = 5
    # exact-numerics transcript (utils/transcript.py): record actions,
    # sampled leaves, and |TD| digests every chunk.
    record_transcript: bool = False
    # jax.profiler trace dir ("" = off); phase timers are always on.
    profile_dir: str = ""
    profile_port: int = 0            # >0: start jax.profiler server
    # async acting (acting/pool.py): background rollout thread; trades
    # exact-seed reproducibility for host/device overlap.
    async_acting: bool = False
    publish_interval: int = 1        # chunks between weight publishes
    # Trainer implementation: "default" (this class: host-driven
    # chunk loop, any env), "fused" (parallel/fused.py
    # FusedApexTrainer: one-dispatch SPMD superstep, device envs
    # only), "apex" (parallel/apex.py ApexTrainer: multi-host actor
    # shards). train.py dispatches on this.
    trainer: str = "default"
    # FusedApexTrainer only: whole supersteps scanned per dispatch
    # (parallel/fused.py make_superstep docstring). 1 = one dispatch
    # per superstep. Each scanned superstep consumes its own annealed
    # PER beta, so S > 1 is bit-identical to S single dispatches.
    supersteps_per_dispatch: int = 1
    # FusedApexTrainer only: interleave updates INSIDE the acting scan
    # ({1 env step + 1-col insert + updates_per_chunk/chunk_len
    # updates} x chunk_len per superstep) — per-step cadence at
    # one-scan amortization; see fused.make_superstep.
    interleave_updates: bool = False


def _mk_model_cfg(model: Dict[str, Any], num_actions: int) -> ModelConfig:
    m = dict(model)
    for k in ("mlp_hidden", "cnn_channels"):
        if k in m:
            m[k] = tuple(m[k])
    return ModelConfig(num_actions=num_actions, **m)


class Trainer:
    def __init__(self, config: Dict[str, Any], result_dir: str,
                 logger: Optional[RunLogger] = None):
        self.config = config
        self.result_dir = result_dir
        seed = int(config.get("seed", 0))
        root = jax.random.key(seed)

        self.env = build(config["env"], seed=seed)
        spec = self.env.spec
        self.frame_stack = int(config.get("frame_stack", 1))
        self.model_cfg = _mk_model_cfg(config.get("model", {}),
                                       spec.num_actions)
        self.algo_cfg = AlgoConfig(**config.get("algo", {}))
        self.loop_cfg = TrainLoopConfig(**config.get("train", {}))
        self.transcript = None
        if self.loop_cfg.record_transcript:
            from rltime_tpu.utils.transcript import Transcript
            self.algo_cfg = dataclasses.replace(self.algo_cfg,
                                                debug_outputs=True)
            self.transcript = Transcript()

        if self.algo_cfg.algo == "r2d2":
            from rltime_tpu.training.r2d2 import r2d2_horizon
            horizon = r2d2_horizon(self.algo_cfg)
        else:
            horizon = self.algo_cfg.n_step
        self.replay_cfg = ReplayConfig(
            num_envs=self.env.num_envs,
            horizon=horizon,
            chunk_len=self.loop_cfg.chunk_len,
            lookback=self.frame_stack - 1,
            **config.get("replay", {}))

        obs_jdt = (jnp.uint8 if spec.obs_dtype == np.uint8
                   else jnp.float32)
        fields = {
            "obs": (spec.obs_shape, obs_jdt),
            "action": ((), jnp.int32),
            "reward": ((), jnp.float32),
            "terminated": ((), jnp.bool_),
            "done": ((), jnp.bool_),
        }
        if self.model_cfg.recurrent:
            H = self.model_cfg.lstm_size
            fields["rnn_c"] = ((H,), jnp.float32)
            fields["rnn_h"] = ((H,), jnp.float32)
        if self.replay_cfg.use_inserted_priorities:
            fields["priority"] = ((), jnp.float32)
        self.replay_state = replay_init(self.replay_cfg, fields)

        exploration = build(config.get(
            "exploration", {"type": "epsilon_greedy"}))
        if getattr(self.env, "is_device", False):
            from rltime_tpu.acting.device_actor import DeviceActor
            if self.frame_stack != 1:
                raise ValueError("device envs feed raw obs straight to "
                                 "the model; frame_stack must be 1")
            self.actor = DeviceActor(
                self.env.inner, self.env.num_envs, self.model_cfg,
                exploration, fold_in_str(root, "actor"),
                self.loop_cfg.chunk_len,
                compute_priorities=self.replay_cfg.use_inserted_priorities,
                gamma=self.algo_cfg.gamma)
        else:
            self.actor = Actor(
                self.env, self.model_cfg, self.frame_stack,
                exploration, fold_in_str(root, "actor"),
                self.loop_cfg.chunk_len,
                compute_priorities=self.replay_cfg.use_inserted_priorities,
                gamma=self.algo_cfg.gamma)
        self.flatten = len(spec.obs_shape) == 1

        # learner state + jitted update
        B = self.env.num_envs
        if self.flatten:
            ex_obs = jnp.zeros(
                (1, int(np.prod(spec.obs_shape)) * self.frame_stack),
                jnp.float32)
        elif self.model_cfg.channels_last:
            # NHWC model contract: frames land on the LAST axis
            # (matches the learner's NHWC union gather and the
            # actor's per-step transpose)
            ex_obs = jnp.zeros(
                (1,) + spec.obs_shape + (self.frame_stack,), obs_jdt)
        else:
            ex_obs = jnp.zeros((1, self.frame_stack) + spec.obs_shape,
                               obs_jdt)
        self.train_state = make_train_state(
            self.model_cfg, self.algo_cfg, fold_in_str(root, "learner"),
            ex_obs)
        algo = self.algo_cfg.algo
        if algo in ("dqn", "iqn"):
            upd = make_update_step(self.model_cfg, self.algo_cfg,
                                   self.replay_cfg, self.frame_stack,
                                   self.flatten)
        elif algo == "r2d2":
            from rltime_tpu.training.r2d2 import make_r2d2_update_step
            upd = make_r2d2_update_step(self.model_cfg, self.algo_cfg,
                                        self.replay_cfg,
                                        self.frame_stack, self.flatten)
        else:
            raise ValueError(f"unknown algo {algo!r}")
        k = self.loop_cfg.updates_per_chunk
        # Steady-state path: {chunk insert + K updates} as ONE
        # dispatch (make_insert_and_update_step scans the K updates
        # itself). The chunk arg is NOT donated — the async pool /
        # actor may still alias its buffers (CLAUDE.md donation
        # conventions).
        from rltime_tpu.training.learner import make_insert_and_update_step
        self._insert_update = jax.jit(
            make_insert_and_update_step(self.replay_cfg, upd, k),
            donate_argnums=(0, 1))

        self.pool = None
        if self.loop_cfg.async_acting:
            from rltime_tpu.acting.pool import AsyncActorPool
            self.pool = AsyncActorPool(self.actor,
                                       self.train_state.params)

        from rltime_tpu.utils.profiling import PhaseTimers, start_server
        self.timers = PhaseTimers()
        if self.loop_cfg.profile_port > 0:
            start_server(self.loop_cfg.profile_port)

        self.logger = logger or RunLogger(result_dir, config)
        self.metrics_acc: Dict[str, float] = {}
        self.updates_done = 0
        self._t_start = time.time()
        self._steps_at_last_log = 0
        self._time_at_last_log = self._t_start
        self._best_score = float("-inf")
        self._protected_steps: set = set()

        if self.loop_cfg.resume:
            self._try_resume()

    # ----- checkpointing -----
    def _host_state(self):
        return dict(env_steps=self.actor.env_steps,
                    updates=self.updates_done)

    def save_checkpoint(self, protect: bool = True):
        """`protect=True` (interval/final saves) marks the step as
        never garbage-collectable by best-checkpoint cleanup."""
        rp = (self.replay_state if self.loop_cfg.checkpoint_replay
              else None)
        path = ckpt_lib.save(self.result_dir, self.actor.env_steps,
                             self.train_state, self._host_state(), rp)
        if protect:
            self._protected_steps.add(self.actor.env_steps)
        return path

    def _maybe_save_best(self, mean_return: float, n_episodes: int):
        """Best-checkpoint tracking (train.track_best): snapshot the
        params whenever the log-interval episode mean makes a new high
        (DQN's end-of-run policy can oscillate off its optimum; eval
        --best loads this instead of the final checkpoint). Shared
        rule + old-best cleanup: checkpoint.maybe_record_best."""
        if not self.loop_cfg.track_best:
            return
        self._best_score = ckpt_lib.maybe_record_best(
            self.result_dir, self._best_score, mean_return, n_episodes,
            self.loop_cfg.best_min_episodes, self.actor.env_steps,
            lambda: self.save_checkpoint(protect=False),
            self._protected_steps)

    def _try_resume(self):
        step = ckpt_lib.latest_step(self.result_dir)
        if step is None:
            return
        # Seed best-score tracking from the recorded best so a resumed
        # run can't overwrite best.json with a worse post-restart mean.
        best = ckpt_lib.best_step(self.result_dir)
        if best is not None:
            self._best_score = float(best["score"])
        example = {"train_state": self.train_state,
                   "host_state": self._host_state()}
        if self.loop_cfg.checkpoint_replay:
            example["replay_state"] = self.replay_state
        restored = ckpt_lib.restore(self.result_dir, step, example)
        self.train_state = restored["train_state"]
        self.actor.env_steps = int(restored["host_state"]["env_steps"])
        self.updates_done = int(restored["host_state"]["updates"])
        if self.loop_cfg.checkpoint_replay and "replay_state" in restored:
            self.replay_state = restored["replay_state"]
        print(f"resumed from checkpoint at env step {step}")

    # ----- training -----
    def _beta(self) -> float:
        a = self.algo_cfg
        frac = min(self.actor.env_steps
                   / max(self.loop_cfg.total_env_steps, 1), 1.0)
        return a.per_beta_start + frac * (a.per_beta_end
                                          - a.per_beta_start)

    def train_chunk(self):
        """One acting chunk + its learner updates. Returns metrics."""
        with self.timers.phase("act"):
            if self.pool is not None:
                chunk, act_info = self.pool.get_chunk()
            else:
                chunk, act_info = self.actor.rollout(
                    self.train_state.params)
        metrics = {}
        if self.actor.env_steps >= self.loop_cfg.warmup_env_steps:
            beta = jnp.float32(self._beta())
            # Post-warmup, the chunk insert is fused into the update
            # dispatch, so this phase covers insert+update; the
            # standalone "insert" phase only ticks during warmup.
            with self.timers.phase("insert+update"):
                self.train_state, self.replay_state, metrics = \
                    self._insert_update(self.train_state,
                                        self.replay_state, chunk, beta)
            self.updates_done += self.loop_cfg.updates_per_chunk
            if self.pool is not None:
                self._pub_count = getattr(self, "_pub_count", 0) + 1
                if self._pub_count % self.loop_cfg.publish_interval == 0:
                    self.pool.set_params(self.train_state.params)
        else:  # warmup: fill replay without updating
            with self.timers.phase("insert"):
                self.replay_state = replay_insert(
                    self.replay_cfg, self.replay_state, chunk)
        if self.transcript is not None:
            self.transcript.record_chunk(self.actor.env_steps,
                                         chunk["action"], metrics)
        return metrics, act_info

    def train(self):
        import contextlib
        cfg = self.loop_cfg
        profile_ctx = contextlib.nullcontext()
        if cfg.profile_dir:
            from rltime_tpu.utils.profiling import trace
            profile_ctx = trace(cfg.profile_dir)
        next_log = self.actor.env_steps + cfg.log_interval
        next_ckpt = self.actor.env_steps + cfg.checkpoint_interval
        with profile_ctx:
            while self.actor.env_steps < cfg.total_env_steps:
                metrics, _ = self.train_chunk()
                if self.actor.env_steps >= next_log:
                    next_log = self.actor.env_steps + cfg.log_interval
                    self._log(metrics)
                if self.actor.env_steps >= next_ckpt:
                    next_ckpt = (self.actor.env_steps
                                 + cfg.checkpoint_interval)
                    self.save_checkpoint()
        if self.pool is not None:
            self.pool.close()
        self.save_checkpoint()
        if self.transcript is not None:
            import os
            self.transcript.dump(os.path.join(self.result_dir,
                                              "transcript.jsonl"))
        self.logger.close()
        return self

    def _log(self, metrics):
        rets, lens = self.actor.episode_stats()
        now = time.time()
        steps = self.actor.env_steps
        sps = ((steps - self._steps_at_last_log)
               / max(now - self._time_at_last_log, 1e-9))
        self._steps_at_last_log = steps
        self._time_at_last_log = now
        scalars = dict(env_steps=steps, updates=self.updates_done,
                       steps_per_s=sps)
        if rets:
            scalars["episode_return_mean"] = float(np.mean(rets))
            scalars["episode_return_median"] = float(np.median(rets))
            scalars["episode_len_mean"] = float(np.mean(lens))
            self._maybe_save_best(scalars["episode_return_mean"],
                                  len(rets))
        if hasattr(self.env, "pop_completed_scores"):
            scores = self.env.pop_completed_scores()
            if scores:
                scalars["episode_score_mean"] = float(np.mean(scores))
                scalars["episode_score_median"] = float(
                    np.median(scores))
        for name, secs in self.timers.pop().items():
            scalars[f"time/{name}_s"] = secs
        for k, v in metrics.items():
            if not k.startswith("debug_"):
                scalars[f"train/{k}"] = float(v)
        self.logger.log_scalars(steps, scalars)
        self.logger.summary(steps, {k: v for k, v in scalars.items()
                                    if k != "env_steps"})
