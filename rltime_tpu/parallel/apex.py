"""Ape-X topology: host-sharded actors -> sharded replay -> DP learner.

The [BJ] config #5 / SURVEY.md §7 M5 subsystem. Mapping of the
reference's actor-pool/learner processes (SURVEY.md §2c) onto a
multi-host GPU cluster:

  * every HOST runs one python process (`jax.distributed.initialize`)
    driving E_per_device * local_device_count lockstep env lanes — the
    per-host actor shard;
  * acting uses a HOST-LOCAL copy of the params, refreshed every
    `publish_interval` chunks (the reference's "publish weights to
    actors" boundary, SURVEY.md §3.1 — here a device_get/device_put
    pull instead of a pipe);
  * transition chunks enter the GLOBAL replay via
    `jax.make_array_from_process_local_data`: each process contributes
    exactly its local devices' env lanes — the host->device stream of
    SURVEY.md §3.5; no cross-host data movement on insert;
  * the learner update is the shard_map step from parallel/mesh.py:
    per-device PER sampling + grad pmean over the interconnect;
    target-net sync is
    free (replicated);
  * per-actor epsilon ladder spans the GLOBAL env lanes (Ape-X
    semantics: lane i of E_global gets eps^(1+alpha*i/(E-1))).

Single-process multi-device is the degenerate case (tested on the
8-device CPU mesh); multi-host runs launch rltime_tpu.train_distributed
on every host.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import rltime_tpu.envs  # noqa: F401
import rltime_tpu.exploration  # noqa: F401
from rltime_tpu.acting.actor import Actor
from rltime_tpu.config.config import build
from rltime_tpu.exploration.epsilon import epsilon_ladder
from rltime_tpu.history.replay import ReplayConfig

from rltime_tpu.parallel.mesh import (
    make_mesh, make_sharded_insert, make_sharded_update_step,
    replay_partition_specs, sharded_replay_init,
)
from rltime_tpu.training.learner import AlgoConfig, make_train_state
from rltime_tpu.training.trainer import TrainLoopConfig, _mk_model_cfg
from rltime_tpu.utils.loggers import RunLogger
from rltime_tpu.utils.prng import fold_in_str


class _GlobalLadder:
    """Ape-X ladder over the global lane index space for this host."""

    def __init__(self, e_global: int, offset: int, e_host: int,
                 base_eps: float = 0.4, alpha: float = 7.0):
        full = epsilon_ladder(e_global, base_eps, alpha)
        self._eps = full[offset:offset + e_host]

    def epsilons(self, num_envs: int, env_step: int):
        return self._eps


class ApexTrainer:
    def __init__(self, config: Dict[str, Any], result_dir: str,
                 mesh=None):
        self.config = config
        seed = int(config.get("seed", 0))
        root = jax.random.key(seed)
        self.mesh = mesh if mesh is not None else make_mesh()
        d = self.mesh.shape["data"]
        self.num_shards = d

        proc = jax.process_index()
        n_local = jax.local_device_count()
        self.is_lead = proc == 0

        env_cfg = dict(config["env"])
        e_per_device = int(env_cfg.pop("num_envs"))
        e_host = e_per_device * n_local
        e_global = e_per_device * d
        self.env = build({**env_cfg, "num_envs": e_host},
                         seed=seed + proc * 7919)
        spec = self.env.spec
        self.frame_stack = int(config.get("frame_stack", 1))
        self.model_cfg = _mk_model_cfg(config.get("model", {}),
                                       spec.num_actions)
        self.algo_cfg = AlgoConfig(**config.get("algo", {}))
        self.loop_cfg = TrainLoopConfig(**config.get("train", {}))
        # single address for this knob: train.publish_interval (the
        # same field Trainer's async pool reads)
        self.publish_interval = int(self.loop_cfg.publish_interval)

        if self.algo_cfg.algo == "r2d2":
            from rltime_tpu.training.r2d2 import r2d2_horizon
            horizon = r2d2_horizon(self.algo_cfg)
        else:
            horizon = self.algo_cfg.n_step
        self.replay_cfg = ReplayConfig(
            num_envs=e_per_device,
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
        self.replay_state = sharded_replay_init(
            self.replay_cfg, d, fields, self.mesh)
        self._chunk_sharding = NamedSharding(self.mesh, P("data"))

        exp_cfg = dict(config.get("exploration",
                                  {"type": "epsilon_greedy"}))
        if exp_cfg.get("mode") == "ladder":
            exploration = _GlobalLadder(
                e_global, proc * e_host, e_host,
                exp_cfg.get("base_eps", 0.4), exp_cfg.get("alpha", 7.0))
        else:
            exploration = build(exp_cfg)
        self.actor = Actor(
            self.env, self.model_cfg, self.frame_stack, exploration,
            jax.random.fold_in(fold_in_str(root, "actor"), proc),
            self.loop_cfg.chunk_len,
            compute_priorities=self.replay_cfg.use_inserted_priorities,
            gamma=self.algo_cfg.gamma)
        if jax.process_count() > 1:
            # multi-host insertion goes through
            # make_array_from_process_local_data, which takes HOST
            # arrays; keep the actor's obs chunk host-side there.
            self.actor.device_obs_chunk = False
            from rltime_tpu.acting.actor import init_actor_state
            self.actor.state = init_actor_state(
                self.model_cfg, self.env.num_envs, self.frame_stack,
                spec.obs_shape,
                obs_jdt, self.actor.state.key, chunk_len=0)
        self.flatten = len(spec.obs_shape) == 1

        if self.flatten:
            ex_obs = jnp.zeros(
                (1, int(np.prod(spec.obs_shape)) * self.frame_stack),
                jnp.float32)
        else:
            ex_obs = jnp.zeros((1, self.frame_stack) + spec.obs_shape,
                               obs_jdt)
        self.train_state = make_train_state(
            self.model_cfg, self.algo_cfg, fold_in_str(root, "learner"),
            ex_obs)
        # replicate explicitly over the global mesh (every process
        # builds the identical state from the same seed, so the
        # callback-based replication is consistent cross-process)
        from rltime_tpu.parallel.mesh import replicate_global
        self.train_state = replicate_global(self.train_state,
                                            self.mesh)

        self._insert = make_sharded_insert(
            self.replay_cfg, self.mesh, self.replay_state)
        self._update = make_sharded_update_step(
            self.model_cfg, self.algo_cfg, self.replay_cfg,
            self.frame_stack, self.flatten, self.mesh,
            self.replay_state,
            num_updates=self.loop_cfg.updates_per_chunk)

        # host-local actor params (SURVEY.md §7 M5 "explicit host pull")
        self._actor_params = jax.device_get(self.train_state.params)
        self.updates_done = 0
        self._chunks = 0
        self.result_dir = result_dir
        self.logger = (RunLogger(result_dir, config)
                       if self.is_lead else None)
        from rltime_tpu.utils.profiling import PhaseTimers
        self.timers = PhaseTimers()
        self._steps_at_last_log = 0
        self._time_at_last_log = time.time()
        self._best_score = float("-inf")
        self._protected_steps: set = set()
        self.episodes_seen = 0   # local episodes popped by train()
        if self.loop_cfg.resume:
            self.try_resume()

    @property
    def global_env_steps(self) -> int:
        # every process steps E_host lanes in lockstep; global lanes
        # per step = E_host * process_count.
        return self.actor.env_steps * jax.process_count()

    def _beta(self) -> float:
        # Annealed on the PRE-update step counter (the chunk just
        # inserted is counted by actor.env_steps already) — same point
        # Trainer samples it. The fused trainer instead anneals each
        # scanned superstep's beta on its POST-chunk counter so
        # S-deep scans stay bit-identical to S sequential dispatches
        # (fused._beta_at call sites); the one-chunk-of-anneal offset
        # between the paths is deliberate and numerically negligible
        # (beta moves ~1e-5 per chunk on real budgets).
        a = self.algo_cfg
        frac = min(self.global_env_steps
                   / max(self.loop_cfg.total_env_steps, 1), 1.0)
        return a.per_beta_start + frac * (a.per_beta_end
                                          - a.per_beta_start)

    def _make_global_chunk(self, chunk):
        """Per-process local lanes -> globally sharded arrays."""
        out = {}
        for k, v in chunk.items():
            if isinstance(v, jax.Array) and jax.process_count() == 1:
                # device-resident chunk (actor obs accumulator / LSTM
                # states): reshard device-to-device, no host bounce.
                out[k] = jax.device_put(v, self._chunk_sharding)
            else:
                out[k] = jax.make_array_from_process_local_data(
                    self._chunk_sharding, np.asarray(v))
        return out

    def train_chunk(self):
        with self.timers.phase("act"):
            chunk, _ = self.actor.rollout(self._actor_params)
        with self.timers.phase("insert"):
            self.replay_state = self._insert(
                self.replay_state, self._make_global_chunk(chunk))
        self._chunks += 1
        metrics = {}
        if self.global_env_steps >= self.loop_cfg.warmup_env_steps:
            # host scalar: valid on every process of a multi-host run
            # (a committed jnp scalar would be single-device only)
            beta = np.float32(self._beta())
            with self.timers.phase("update"):
                self.train_state, self.replay_state, metrics = \
                    self._update(self.train_state, self.replay_state,
                                 beta)
            self.updates_done += self.loop_cfg.updates_per_chunk
            if self._chunks % self.publish_interval == 0:
                self._actor_params = jax.device_get(
                    self.train_state.params)
        return metrics

    def _aux_dir(self, step: int) -> str:
        import os
        return os.path.join(self.result_dir, "checkpoints_aux",
                            str(step))

    @staticmethod
    def _local_block(x) -> np.ndarray:
        """This process's rows of a 'data'-sharded global array
        (shared implementation: parallel/mesh.local_shard_rows)."""
        from rltime_tpu.parallel.mesh import local_shard_rows
        return local_shard_rows(x)

    def save_checkpoint(self, protect: bool = True):
        """Lead process saves the replicated learner state;
        EVERY process additionally writes a per-process sidecar
        (checkpoints_aux/<step>/proc<i>.npz) holding its actor PRNG
        stream and — with `checkpoint_replay` — its local replay
        shards, so resume restores the full distributed state without
        any cross-process data movement (SURVEY.md §5.4 'replay
        (optional)' on the multi-host path)."""
        import os
        from rltime_tpu.training import checkpoint as ckpt_lib
        step = self.global_env_steps
        if protect:
            self._protected_steps.add(step)
            if self.is_lead:
                # an interval save at an already-best step clears its
                # best_only flag so post-resume GC can't reclaim it
                ckpt_lib.unmark_best_only(self.result_dir, step)
        path = None
        if self.is_lead:
            host = dict(env_steps=self.actor.env_steps,
                        updates=self.updates_done)
            path = ckpt_lib.save(self.result_dir, step,
                                 jax.device_get(self.train_state),
                                 host)
        aux = {
            "actor_key": np.asarray(
                jax.random.key_data(self.actor.state.key)),
            "chunks": np.int64(self._chunks),
        }
        if self.loop_cfg.checkpoint_replay:
            for k, v in self.replay_state.storage.items():
                aux[f"storage_{k}"] = self._local_block(v)
            aux["tree"] = self._local_block(self.replay_state.tree)
            aux["t"] = np.asarray(jax.device_get(self.replay_state.t))
            aux["max_priority"] = np.asarray(
                jax.device_get(self.replay_state.max_priority))
        d = self._aux_dir(step)
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, f"proc{jax.process_index()}.npz"),
                 **aux)
        return path

    def try_resume(self):
        """Resume from the shared result dir. EVERY process restores
        the same learner checkpoint (multi-host runs assume a shared
        filesystem, the usual cluster setup) then re-replicates — lead-only
        restore would silently desync the replicated state. Each
        process then restores ITS OWN sidecar: actor PRNG stream +
        (optional) local replay shards. Env instances restart fresh
        (host env internals are not serializable; the reference's
        actor subprocesses restart the same way)."""
        import os
        import jax.numpy as jnp
        from rltime_tpu.history.replay import ReplayState
        from rltime_tpu.parallel.mesh import (
            make_global_array, replicate_global)
        from rltime_tpu.training import checkpoint as ckpt_lib
        step = ckpt_lib.latest_step(self.result_dir)
        if step is None:
            return False
        example = {"train_state": jax.device_get(self.train_state),
                   "host_state": dict(env_steps=0, updates=0)}
        restored = ckpt_lib.restore(self.result_dir, step, example)
        self.train_state = replicate_global(restored["train_state"],
                                            self.mesh)
        self.actor.env_steps = int(
            restored["host_state"]["env_steps"])
        self.updates_done = int(restored["host_state"]["updates"])
        self._actor_params = jax.device_get(self.train_state.params)

        aux_path = os.path.join(
            self._aux_dir(step), f"proc{jax.process_index()}.npz")
        if os.path.exists(aux_path):
            aux = np.load(aux_path)
            impl = jax.random.key_impl(self.actor.state.key)
            self.actor.state = self.actor.state.replace(
                key=jax.random.wrap_key_data(
                    jnp.asarray(aux["actor_key"]), impl=impl))
            self._chunks = int(aux["chunks"])
            if self.loop_cfg.checkpoint_replay and "tree" in aux.files:
                storage = {
                    k: jax.make_array_from_process_local_data(
                        self._chunk_sharding, aux[f"storage_{k}"])
                    for k in self.replay_state.storage}
                self.replay_state = ReplayState(
                    storage=storage,
                    t=make_global_array(aux["t"], self.mesh, P()),
                    tree=jax.make_array_from_process_local_data(
                        self._chunk_sharding, aux["tree"]),
                    max_priority=make_global_array(
                        aux["max_priority"], self.mesh, P()))
        best = ckpt_lib.best_step(self.result_dir)
        if best is not None:
            # resumed runs must not mark a worse mean as 'best'
            self._best_score = float(best["score"])
        self._protected_steps = ckpt_lib.derive_protected_steps(
            self.result_dir)
        print(f"apex: resumed from checkpoint at step {step}")
        return True

    def train(self):
        cfg = self.loop_cfg
        next_log = self.global_env_steps + cfg.log_interval
        next_ckpt = self.global_env_steps + cfg.checkpoint_interval
        while self.global_env_steps < cfg.total_env_steps:
            metrics = self.train_chunk()
            if self.global_env_steps >= next_log:
                next_log = self.global_env_steps + cfg.log_interval
                # EVERY process pops + pools stats at the same
                # deterministic chunk (the allgather is a rendezvous);
                # the best decision and collective sidecar save then
                # run everywhere, best.json/GC lead-only.
                rets, lens = self.actor.episode_stats()
                self.episodes_seen += len(rets)
                from rltime_tpu.parallel.mesh import (
                    pool_process_stats)
                g_rets, g_sum, g_n = pool_process_stats(rets,
                                                        cap=4096)
                if cfg.track_best and g_n > 0:
                    from rltime_tpu.training import (
                        checkpoint as ckpt_lib)
                    # decision uses the EXACT global mean/count (the
                    # pooled multiset may truncate past `cap`/process)
                    self._best_score = ckpt_lib.maybe_record_best(
                        self.result_dir, self._best_score,
                        g_sum / g_n, g_n,
                        cfg.best_min_episodes, self.global_env_steps,
                        lambda: self.save_checkpoint(protect=False),
                        self._protected_steps, lead=self.is_lead)
                if self.is_lead:
                    self._log(metrics, g_rets, lens)
            if self.global_env_steps >= next_ckpt:
                next_ckpt = (self.global_env_steps
                             + cfg.checkpoint_interval)
                self.save_checkpoint()
        self.save_checkpoint()
        if self.logger is not None:
            self.logger.close()
        return self

    def _log(self, metrics, rets, lens):
        """Same scalar set as Trainer._log (the multi-host path is the
        one whose curves get compared): clipped returns (pooled over
        all processes), TRUE game scores, episode lengths, phase
        timers, throughput."""
        now = time.time()
        steps = self.global_env_steps
        sps = ((steps - self._steps_at_last_log)
               / max(now - self._time_at_last_log, 1e-9))
        self._steps_at_last_log = steps
        self._time_at_last_log = now
        scalars = dict(env_steps=steps, updates=self.updates_done,
                       steps_per_s=sps)
        if rets:
            scalars["episode_return_mean"] = float(np.mean(rets))
            scalars["episode_return_median"] = float(np.median(rets))
        if lens:
            # lens are the LEAD's local episodes (returns are pooled
            # globally); guard separately — other hosts may have
            # finished episodes in an interval where the lead did not
            scalars["episode_len_mean"] = float(np.mean(lens))
        if hasattr(self.env, "pop_completed_scores"):
            scores = self.env.pop_completed_scores()
            if scores:
                scalars["episode_score_mean"] = float(np.mean(scores))
                scalars["episode_score_median"] = float(
                    np.median(scores))
        for name, secs in self.timers.pop().items():
            scalars[f"time/{name}_s"] = secs
        for k, v in metrics.items():
            scalars[f"train/{k}"] = float(v)
        self.logger.log_scalars(steps, scalars)
        self.logger.summary(steps, {k: v for k, v in scalars.items()
                                    if k != "env_steps"})
