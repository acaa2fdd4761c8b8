"""Fused SPMD superstep: the whole Ape-X iteration as ONE XLA program.

For device-resident envs (envs/device.py, envs/minatar*.py), nothing
in the train loop needs the host at all — so the device-resident end-state
is a single shard_map'd computation over the ('data','model') mesh in
which every device, per superstep:

  1. scans `chunk_len` env+policy steps over its OWN env lanes
     (per-shard PRNG streams; Ape-X eps ladder sliced per lane),
  2. inserts the chunk into its LOCAL replay shard (per-shard sum
     tree), optionally with actor-side initial priorities (1-step
     |TD| computed in-register during acting — SURVEY.md §0 item 5),
  3. runs K learner updates (DQN/IQN feed-forward or R2D2 sequence),
     `pmean`ing gradients over the interconnect — params stay
     replicated, target
     sync is free.

Host involvement per superstep: ONE dispatch + the logged scalars.
This composes the unchanged building blocks: envs/device.py dynamics,
history/replay.py insert/sample, training/learner.py +
training/r2d2.py updates — under a single shard_map; SURVEY.md §3.5's
boundary diagram collapses to one box.

This is the FLAGSHIP training path for device envs: reachable from the
CLI via {"train": {"trainer": "fused"}} (train.py), with warmup,
checkpoint/resume, and image observations (uint8 rings) supported.
Bit-identity with the 2-dispatch Trainer+DeviceActor path at d=1 is
proven in tests/test_parallel.py::test_fused_matches_trainer_path.

Sharding layout (leading-axis 'data' everywhere, like parallel/mesh):
  env lanes (d*E_local, ...), stat rings (d*RING,), per-shard scalars
  shaped (d,) so each shard owns a (1,) slice; params/opt replicated.
"""
from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rltime_tpu.history.replay import (
    ReplayConfig, ReplayState, replay_insert,
)
from rltime_tpu.acting.device_actor import STATS_RING  # per shard
from rltime_tpu.models.policy import (
    ModelConfig, initial_rnn_state,
)
from rltime_tpu.parallel.mesh import replay_partition_specs
from rltime_tpu.training.learner import AlgoConfig
from rltime_tpu.utils.pytree import PyTreeNode


class FusedActorState(PyTreeNode):
    env_state: Any            # leaves (E, ...) — sharded on axis 0
    done_prev: jnp.ndarray    # (E,)
    rnn: tuple
    key: jnp.ndarray          # (S,) key array — one stream per shard
    ep_ret: jnp.ndarray       # (E,)
    ep_len: jnp.ndarray       # (E,)
    ret_ring: jnp.ndarray     # (S*RING,)
    len_ring: jnp.ndarray     # (S*RING,)
    ring_cursor: jnp.ndarray  # (S,) int32


def _is_key(x):
    return jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)


def _shard_global(tree, mesh: Mesh):
    """Process-identical host/local pytree -> GLOBAL arrays sharded on
    their leading axis over 'data'. Works when the mesh spans devices
    this process cannot address (multi-host fused runs): the callback
    materializes only the local blocks; typed PRNG key leaves ride
    through key_data/wrap_key_data like parallel/mesh.replicate_global.
    """
    import functools
    sh = NamedSharding(mesh, P("data"))

    def f(x):
        if _is_key(x):
            data = np.asarray(jax.random.key_data(x))
            impl = jax.random.key_impl(x)
            arr = jax.make_array_from_callback(
                data.shape, sh, lambda idx, d=data: d[idx])
            wrap = functools.partial(jax.random.wrap_key_data,
                                     impl=impl)
            return jax.jit(wrap, out_shardings=sh)(arr)
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx, d=x: d[idx])

    return jax.tree.map(f, tree)


def init_fused_actor_state(env, cfg: ModelConfig, e_local: int,
                           num_shards: int, key,
                           mesh: Mesh) -> FusedActorState:
    d = num_shards
    E = d * e_local
    keys = jax.random.split(key, 2 * d)
    # Per-shard env states: array leaves concatenate on the lane axis,
    # PRNG-key leaves stack to (S,) so each shard owns its own stream.
    # Key order (env keys first, actor streams second) matches
    # DeviceActor's `k_env, k_act = split(key)` so the d=1 mesh is
    # bit-identical to the Trainer+DeviceActor path. Every process
    # builds the identical full state (deterministic from the seed);
    # _shard_global serves each process only its local blocks.
    shards = [env.reset(keys[i], e_local) for i in range(d)]
    env_state = jax.tree.map(
        lambda *xs: (jnp.stack(xs) if _is_key(xs[0])
                     else jnp.concatenate(xs, axis=0)), *shards)
    state = FusedActorState(
        env_state=env_state,
        done_prev=jnp.ones((E,), bool),
        rnn=initial_rnn_state(cfg, E),
        key=keys[d:],
        ep_ret=jnp.array(np.zeros((E,), np.float32)),
        ep_len=jnp.array(np.zeros((E,), np.int32)),
        ret_ring=jnp.array(np.zeros((d * STATS_RING,), np.float32)),
        len_ring=jnp.array(np.zeros((d * STATS_RING,), np.float32)),
        ring_cursor=jnp.array(np.zeros((d,), np.int32)))
    return _shard_global(state, mesh)


def fused_actor_specs(state: FusedActorState) -> FusedActorState:
    return jax.tree.map(lambda _: P("data"), state)


def make_act_phase(env, model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                   chunk_len: int, compute_priorities: bool = False):
    """Build act(params, astate, eps (L, E)) -> (astate, chunk).

    The per-shard acting scan shared by the full superstep and the
    warmup (act+insert only) program. The acting logic itself (policy,
    eps-greedy, env step, stat rings, actor-side initial priorities)
    is the ONE shared definition in acting/device_actor.py's
    make_rollout_core; this wrapper only adapts the per-shard
    FusedActorState view (env/actor PRNG keys stacked to (1,), stat
    cursor shaped (1,)) to the plain DeviceActorState the core scans
    over — so the proven bit-identity between the fused and
    Trainer+DeviceActor paths cannot drift apart by divergent copies.
    """
    from rltime_tpu.acting.device_actor import (
        DeviceActorState, make_rollout_core)
    core = make_rollout_core(env, model_cfg, chunk_len,
                             compute_priorities=compute_priorities,
                             gamma=algo_cfg.gamma)

    def act(params, astate: FusedActorState, eps):
        view = DeviceActorState(
            env_state=jax.tree.map(
                lambda x: x[0] if _is_key(x) else x, astate.env_state),
            done_prev=astate.done_prev, rnn=astate.rnn,
            key=astate.key[0], ep_ret=astate.ep_ret,
            ep_len=astate.ep_len, ret_ring=astate.ret_ring,
            len_ring=astate.len_ring,
            ring_cursor=astate.ring_cursor[0])
        view, chunk = core(params, view, eps)
        astate = FusedActorState(
            env_state=jax.tree.map(
                lambda x: x[None] if _is_key(x) else x,
                view.env_state),
            done_prev=view.done_prev, rnn=view.rnn,
            key=view.key[None], ep_ret=view.ep_ret,
            ep_len=view.ep_len, ret_ring=view.ret_ring,
            len_ring=view.len_ring,
            ring_cursor=view.ring_cursor[None])
        return astate, chunk

    return act


def make_superstep(env, model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                   local_replay_cfg: ReplayConfig, mesh: Mesh,
                   chunk_len: int, num_updates: int,
                   example_rstate: ReplayState,
                   example_astate: FusedActorState,
                   supersteps: int = 1,
                   frame_stack: int = 1,
                   flatten: bool = True,
                   compute_priorities: bool = False,
                   interleave: bool = False):
    """Build the jitted fused superstep over the mesh.

    `supersteps` > 1 scans S whole supersteps inside ONE dispatch (eps
    then shaped (S, L, E), beta shaped (S,) — one annealed value per
    superstep, so numerics are bit-identical to S sequential
    dispatches). The replay ring rides the scan carry and XLA keeps
    its dynamic_update_slice IN PLACE across iterations, so the
    entry/exit relayout pair that XLA's default layout for big image
    rings costs (the committed layout of a (E, T, H, W) array
    disagrees with the row-major layout every internal op wants) is
    paid once per dispatch instead of once per superstep — and host
    dispatch latency amortizes S-fold.

    `interleave` (train.interleave_updates; VERDICT r4 Next #2): ONE
    scan of chunk_len iterations, each = {1 env step over the local
    lanes + 1-column insert + num_updates/chunk_len learner updates}.
    Same work per superstep as the act-then-update shape, but (a) the
    cadence is per-STEP — updates sample data ≤1 step old, priorities
    and acting params refresh every step, i.e. STRICTLY fresher than
    any chunked recipe (coarse L=128 chunking cost score on
    cadence-sensitive configs), and (b) the per-chunk
    boundaries that limited throughput amortize over the whole scan,
    and the 1-column insert frees chunk_len from the ring-safety
    bound steps_per_env >= 2*(chunk_len+horizon).
    """
    if algo_cfg.algo == "r2d2":
        from rltime_tpu.training.r2d2 import make_r2d2_update_step
        local_update = make_r2d2_update_step(
            model_cfg, algo_cfg, local_replay_cfg, frame_stack,
            flatten, axis_name="data")
    else:
        from rltime_tpu.training.learner import make_update_step
        local_update = make_update_step(
            model_cfg, algo_cfg, local_replay_cfg, frame_stack,
            flatten, axis_name="data")
    act = make_act_phase(env, model_cfg, algo_cfg,
                         1 if interleave else chunk_len,
                         compute_priorities)
    if interleave:
        import dataclasses as _dc
        if num_updates % chunk_len != 0:
            raise ValueError(
                "interleave_updates needs updates_per_chunk to be a "
                f"multiple of chunk_len (got {num_updates} per "
                f"{chunk_len})")
        if algo_cfg.debug_outputs:
            raise ValueError("debug_outputs/transcripts are not "
                             "supported with interleave_updates")
        upd_per_step = num_updates // chunk_len
        insert_cfg = _dc.replace(local_replay_cfg, chunk_len=1)
    else:
        insert_cfg = local_replay_cfg

    def _run_updates(tstate, rstate, beta, n):
        # K learner updates with a gradient pmean. Storage stays OUT of
        # the scan carry (read-only in updates; carrying it costs
        # full-ring boundary copies — see learner._scan_updates).
        storage = rstate.storage

        def upd_body(carry, _):
            t, tree, cur, max_p = carry
            r = rstate.replace(storage=storage, tree=tree, t=cur,
                               max_priority=max_p)
            shard = jax.lax.axis_index("data")
            lt = t.replace(key=jax.random.fold_in(t.key, shard))
            nt, nr, m = local_update(lt, r, beta)
            nt = nt.replace(key=jax.random.split(t.key, 3)[0])
            # scalar metrics pmean; debug_* leaves (the transcript
            # harness's per-sample leaf/TD vectors) stay PER-SHARD and
            # concatenate through out_specs P('data') instead
            m = {k: (v if k.startswith("debug_")
                     else jax.lax.pmean(v, "data"))
                 for k, v in m.items()}
            max_p = jax.lax.pmax(nr.max_priority, "data")
            return (nt, nr.tree, nr.t, max_p), m
        carry0 = (tstate, rstate.tree, rstate.t, rstate.max_priority)
        (tstate, tree, cur, max_p), ms = jax.lax.scan(
            upd_body, carry0, None, length=n)
        rstate = rstate.replace(tree=tree, t=cur, max_priority=max_p)
        return tstate, rstate, jax.tree.map(lambda m: m[-1], ms)

    def _super(tstate, astate, rstate, eps, beta):
        # 1) act L steps over the local lanes
        astate, chunk = act(tstate.params, astate, eps)
        # 2) local replay insert
        rstate = replay_insert(local_replay_cfg, rstate, chunk)
        rstate = rstate.replace(
            t=jax.lax.pmax(rstate.t, "data"),
            max_priority=jax.lax.pmax(rstate.max_priority, "data"))
        # 3) K learner updates
        tstate, rstate, metrics = _run_updates(tstate, rstate, beta,
                                               num_updates)
        if algo_cfg.debug_outputs:
            # the chunk's actions ride out per-shard for the
            # transcript's actions digest (Trainer records the same)
            metrics["debug_chunk_action"] = chunk["action"]
        return tstate, astate, rstate, metrics

    def _super_interleaved(tstate, astate, rstate, eps, beta):
        """{1 env step + 1-column insert + u/L updates} x L in ONE
        scan — per-step cadence at one-scan amortization."""
        def body(carry, eps_t):
            ts, a, r = carry
            a, chunk = act(ts.params, a, eps_t[None])
            r = replay_insert(insert_cfg, r, chunk)
            r = r.replace(
                t=jax.lax.pmax(r.t, "data"),
                max_priority=jax.lax.pmax(r.max_priority, "data"))
            ts, r, m = _run_updates(ts, r, beta, upd_per_step)
            return (ts, a, r), m

        (tstate, astate, rstate), ms = jax.lax.scan(
            body, (tstate, astate, rstate), eps)
        metrics = jax.tree.map(lambda x: x[-1], ms)
        return tstate, astate, rstate, metrics

    if interleave:
        _super = _super_interleaved  # noqa: F811 — selected shape

    def _multi(tstate, astate, rstate, eps, betas):
        """Scan S supersteps; eps (S, L, E_local), betas (S,)."""
        def body(carry, xs):
            eps_t, beta_t = xs
            ts, a, r = carry
            ts, a, r, m = _super(ts, a, r, eps_t, beta_t)
            return (ts, a, r), m

        (tstate, astate, rstate), ms = jax.lax.scan(
            body, (tstate, astate, rstate), (eps, betas))
        metrics = jax.tree.map(lambda x: x[-1], ms)
        return tstate, astate, rstate, metrics

    rspecs = replay_partition_specs(example_rstate)
    aspecs = fused_actor_specs(example_astate)
    inner = _super if supersteps == 1 else _multi
    eps_spec = (P(None, "data") if supersteps == 1
                else P(None, None, "data"))

    def wrapped(tstate, astate, rstate, eps, beta):
        ts_specs = jax.tree.map(lambda _: P(), tstate)
        metric_specs = jax.tree.map(
            lambda _: P(), dict(loss=0, q=0, td_abs=0, grad_norm=0,
                                mean_weight=0))
        if algo_cfg.debug_outputs:
            if supersteps != 1:
                raise ValueError(
                    "debug_outputs/record_transcript on the fused "
                    "path needs supersteps_per_dispatch=1 (the "
                    "transcript records every chunk; an S-scan only "
                    "surfaces the last)")
            # per-shard vectors, concatenated over 'data': at d=1
            # these equal the Trainer path's debug leaves bit-for-bit
            metric_specs.update(
                debug_leaf=P("data"), debug_td=P("data"),
                debug_q=P("data"), debug_chunk_action=P("data"))
            if algo_cfg.algo != "r2d2":   # r2d2 has no per-sample action
                metric_specs["debug_action"] = P("data")
        f = shard_map(inner, mesh=mesh,
                      in_specs=(ts_specs, aspecs, rspecs,
                                eps_spec, P()),
                      out_specs=(ts_specs, aspecs, rspecs,
                                 metric_specs),
                      check_vma=False)
        return f(tstate, astate, rstate, eps, beta)

    return jax.jit(wrapped, donate_argnums=(0, 1, 2))


def make_warm_superstep(env, model_cfg: ModelConfig,
                        algo_cfg: AlgoConfig,
                        local_replay_cfg: ReplayConfig, mesh: Mesh,
                        chunk_len: int,
                        example_rstate: ReplayState,
                        example_astate: FusedActorState,
                        compute_priorities: bool = False):
    """Warmup program: act + insert, NO learner updates.

    Mirrors Trainer's warmup semantics (fill replay before the first
    update; the learner PRNG stream is untouched) so the fused path
    honors `warmup_env_steps` and stays bit-compatible with the
    2-dispatch path across the warmup boundary.
    """
    act = make_act_phase(env, model_cfg, algo_cfg, chunk_len,
                         compute_priorities)
    # interleave_updates runs with a chunk_len=1 replay geometry (the
    # point: 1-col inserts escape the ring-safety chunk bound). The
    # warm program still ACTS L steps per dispatch; it inserts the
    # chunk column-by-column through the same 1-col view instead of
    # re-validating an L-shaped config (which would re-impose the
    # bound warmup cannot violate — it only inserts, never samples).
    per_col = local_replay_cfg.chunk_len == 1 and chunk_len > 1

    def _warm(params, astate, rstate, eps):
        astate, chunk = act(params, astate, eps)
        if per_col:
            cols = jax.tree.map(
                lambda x: jnp.moveaxis(x[:, :, None], 1, 0), chunk)

            def body(r, col):
                return replay_insert(local_replay_cfg, r, col), None
            rstate, _ = jax.lax.scan(body, rstate, cols)
        else:
            rstate = replay_insert(local_replay_cfg, rstate, chunk)
        rstate = rstate.replace(
            t=jax.lax.pmax(rstate.t, "data"),
            max_priority=jax.lax.pmax(rstate.max_priority, "data"))
        return astate, rstate

    rspecs = replay_partition_specs(example_rstate)
    aspecs = fused_actor_specs(example_astate)

    def wrapped(params, astate, rstate, eps):
        p_specs = jax.tree.map(lambda _: P(), params)
        f = shard_map(_warm, mesh=mesh,
                      in_specs=(p_specs, aspecs, rspecs,
                                P(None, "data")),
                      out_specs=(aspecs, rspecs),
                      check_vma=False)
        return f(params, astate, rstate, eps)

    return jax.jit(wrapped, donate_argnums=(1, 2))


class FusedApexTrainer:
    """Driver for the fused SPMD superstep (device envs only).

    The flagship path for on-chip envs: config shape matches Trainer
    ("env": {"type": "minatar_breakout"|"cartpole_device"|...,
    "num_envs": PER-DEVICE lanes}); select it with
    {"train": {"trainer": "fused"}} from the CLI. Supports warmup,
    image observations (uint8 replay rings), DQN/IQN/R2D2 updates,
    actor-side initial priorities, checkpoints, and resume.
    """

    def __init__(self, config, result_dir: str, mesh=None):
        from rltime_tpu.parallel.mesh import (
            make_mesh, sharded_replay_init)
        from rltime_tpu.training.learner import make_train_state
        from rltime_tpu.training.trainer import (
            TrainLoopConfig, _mk_model_cfg)
        from rltime_tpu.config.config import build
        from rltime_tpu.utils.loggers import RunLogger
        from rltime_tpu.utils.prng import fold_in_str
        import rltime_tpu.envs  # noqa: F401  (registers env types)

        self.config = config
        self.result_dir = result_dir
        seed = int(config.get("seed", 0))
        root = jax.random.key(seed)
        self.mesh = mesh if mesh is not None else make_mesh()
        d = self.mesh.shape["data"]
        self.num_shards = d
        # Multi-process (multi-host) operation: the mesh may span
        # devices this process cannot address. All global state is
        # built via callbacks/process-local data (never device_put),
        # checkpoints split into a lead save (replicated
        # learner) + per-process sidecars (sharded actor/replay rows).
        self.proc = jax.process_index()
        self.is_lead = self.proc == 0

        handle = build(config["env"], seed=seed)
        if not getattr(handle, "is_device", False):
            raise ValueError(
                "FusedApexTrainer requires a device-resident env "
                f"(got {config['env']['type']!r}); use the default "
                "Trainer for host envs")
        self.env = handle.inner
        spec = handle.spec
        e_local = int(config["env"]["num_envs"])
        self.e_global = e_local * d
        self.model_cfg = _mk_model_cfg(
            config.get("model", {}), spec.num_actions)
        self.algo_cfg = AlgoConfig(**config.get("algo", {}))
        self.loop_cfg = TrainLoopConfig(**config.get("train", {}))
        self.transcript = None
        if self.loop_cfg.record_transcript:
            import dataclasses as _dc
            from rltime_tpu.utils.transcript import Transcript
            self.algo_cfg = _dc.replace(self.algo_cfg,
                                        debug_outputs=True)
            self.transcript = Transcript()
        if self.algo_cfg.debug_outputs \
                and self.loop_cfg.warmup_env_steps > 0:
            raise ValueError(
                "fused transcripts record post-warmup chunks only — "
                "set train.warmup_env_steps=0 for the exact-numerics "
                "harness (Trainer records warmup chunks too, so the "
                "transcripts would differ)")
        if self.algo_cfg.debug_outputs and jax.process_count() > 1:
            # the P('data') debug leaves span non-addressable devices
            # on a process-spanning mesh; the exactness harness is a
            # single-process (any d) workflow
            raise ValueError(
                "record_transcript/debug_outputs on the fused path "
                "requires a single-process run")
        if self.algo_cfg.algo == "r2d2":
            from rltime_tpu.training.r2d2 import r2d2_horizon
            horizon = r2d2_horizon(self.algo_cfg)
        else:
            horizon = self.algo_cfg.n_step
        # interleave_updates inserts ONE column at a time, so the
        # replay geometry validates against chunk_len=1 — this is what
        # frees chunk_len from the ring-safety bound (the warm program
        # still inserts L-chunks through an L-shaped view below)
        self.replay_cfg = ReplayConfig(
            num_envs=e_local, horizon=horizon,
            chunk_len=(1 if self.loop_cfg.interleave_updates
                       else self.loop_cfg.chunk_len),
            **config.get("replay", {}))
        self.flatten = len(spec.obs_shape) == 1

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
        self.actor_state = init_fused_actor_state(
            self.env, self.model_cfg, e_local, d,
            fold_in_str(root, "actor"), self.mesh)
        if self.flatten:
            ex_obs = jnp.zeros(
                (1, int(np.prod(spec.obs_shape))), jnp.float32)
        else:
            ex_obs = jnp.zeros((1, 1) + tuple(spec.obs_shape),
                               obs_jdt)
        # replicate over the global mesh via callbacks (every process
        # builds the identical state from the same seed) — device_put
        # would be illegal on a process-spanning mesh
        from rltime_tpu.parallel.mesh import replicate_global
        self.train_state = replicate_global(
            make_train_state(self.model_cfg, self.algo_cfg,
                             fold_in_str(root, "learner"), ex_obs),
            self.mesh)
        self.supersteps = max(
            1, int(self.loop_cfg.supersteps_per_dispatch))
        prio = self.replay_cfg.use_inserted_priorities
        self._super = make_superstep(
            self.env, self.model_cfg, self.algo_cfg, self.replay_cfg,
            self.mesh, self.loop_cfg.chunk_len,
            self.loop_cfg.updates_per_chunk, self.replay_state,
            self.actor_state, supersteps=self.supersteps,
            frame_stack=1, flatten=self.flatten,
            compute_priorities=prio,
            interleave=self.loop_cfg.interleave_updates)
        self._warm_super = None
        if self.loop_cfg.warmup_env_steps > 0:
            self._warm_super = make_warm_superstep(
                self.env, self.model_cfg, self.algo_cfg,
                self.replay_cfg, self.mesh, self.loop_cfg.chunk_len,
                self.replay_state, self.actor_state,
                compute_priorities=prio)
        self.exploration = build(config.get(
            "exploration", {"type": "epsilon_greedy"}))
        self.logger = (RunLogger(result_dir, config)
                       if self.is_lead else None)
        self.env_steps = 0
        self.updates_done = 0
        # per-GLOBAL-shard pop cursors for the shards THIS process can
        # address (episode_stats reads only addressable ring shards)
        self._stats_popped: dict = {}
        self._best_score = float("-inf")
        self._protected_steps: set = set()
        if self.loop_cfg.resume:
            self._try_resume()

    def _beta_at(self, env_steps: int) -> float:
        a = self.algo_cfg
        frac = min(env_steps
                   / max(self.loop_cfg.total_env_steps, 1), 1.0)
        return a.per_beta_start + frac * (a.per_beta_end
                                          - a.per_beta_start)

    def _eps(self, num_steps: int):
        """Host-side eps schedule for the next `num_steps` act steps."""
        return np.stack([
            self.exploration.epsilons(self.e_global,
                                      self.env_steps
                                      + t * self.e_global)
            for t in range(num_steps)])

    def superstep(self):
        """One dispatch: S full supersteps, or one warmup act+insert.

        Warmup semantics mirror Trainer.train_chunk: a chunk trains
        iff the post-chunk env_steps counter has reached
        `warmup_env_steps`.
        """
        from rltime_tpu.parallel.mesh import make_global_array
        L, S = self.loop_cfg.chunk_len, self.supersteps
        per_chunk = L * self.e_global
        if (self._warm_super is not None
                and self.env_steps + per_chunk
                < self.loop_cfg.warmup_env_steps):
            # eps schedules are deterministic host math, identical on
            # every process; globalize via callback (process-safe)
            eps = make_global_array(self._eps(L), self.mesh,
                                    P(None, "data"))
            self.actor_state, self.replay_state = self._warm_super(
                self.train_state.params, self.actor_state,
                self.replay_state, eps)
            self.env_steps += per_chunk
            return {}
        eps = self._eps(S * L)
        # Per-superstep beta, annealed on the POST-chunk step counter
        # (same point Trainer samples it) so S-scanned dispatches are
        # bit-identical to S sequential ones even while beta anneals.
        betas = np.array(
            [self._beta_at(self.env_steps + (i + 1) * per_chunk)
             for i in range(S)], np.float32)
        if S > 1:
            eps = make_global_array(
                eps.reshape(S, L, self.e_global), self.mesh,
                P(None, None, "data"))
            beta_arg = make_global_array(betas, self.mesh, P())
        else:
            eps = make_global_array(eps, self.mesh, P(None, "data"))
            beta_arg = make_global_array(betas[0], self.mesh, P())
        self.train_state, self.actor_state, self.replay_state, m = \
            self._super(self.train_state, self.actor_state,
                        self.replay_state, eps, beta_arg)
        self.env_steps += S * per_chunk
        self.updates_done += S * self.loop_cfg.updates_per_chunk
        if self.transcript is not None:
            m = dict(m)
            actions = m.pop("debug_chunk_action")
            self.transcript.record_chunk(self.env_steps, actions, m)
        return m

    def episode_stats(self):
        """Fresh completed returns pooled over THIS process's shards,
        per-shard oldest first (chronological, like DeviceActor).
        Reads only addressable ring shards, so it works when the mesh
        spans processes (each process reports its own lanes; the lead
        logs its share, like the reference's per-process episode
        accounting)."""
        cursors = {}
        for s in self.actor_state.ring_cursor.addressable_shards:
            start = s.index[0].start or 0
            vals = np.asarray(s.data)
            for j in range(vals.shape[0]):
                cursors[start + j] = int(vals[j])
        rings = {}
        for s in self.actor_state.ret_ring.addressable_shards:
            start = (s.index[0].start or 0) // STATS_RING
            vals = np.asarray(s.data).reshape(-1, STATS_RING)
            for j in range(vals.shape[0]):
                rings[start + j] = vals[j]
        rets = []
        for g in sorted(cursors):
            cur = cursors[g]
            fresh = min(cur - self._stats_popped.get(g, 0), STATS_RING)
            ring = rings[g]
            for i in range(fresh):
                rets.append(float(ring[(cur - fresh + i) % STATS_RING]))
            self._stats_popped[g] = cur
        return rets

    def global_episode_stats(self):
        """Fresh completed returns pooled over ALL processes.

        Single-process: identical to episode_stats(). Multi-process:
        each process pops its own shards, then a fixed-size NaN-padded
        process_allgather pools them — every process gets the SAME
        multiset, so mean/median and the best-checkpoint decision are
        process-identical (VERDICT r4 Next #5). Fresh returns per
        shard are bounded by STATS_RING, so the gather payload is
        static ((nproc, local_shards*STATS_RING) f32)."""
        from rltime_tpu.parallel.mesh import pool_process_stats
        rets = self.episode_stats()
        if jax.process_count() == 1:
            return rets
        # cap is EXACT here: fresh returns per shard are bounded by
        # STATS_RING, so nothing can be truncated
        pooled, _, _ = pool_process_stats(
            rets, cap=STATS_RING * jax.local_device_count())
        return pooled

    # ----- checkpointing (SURVEY.md §5.4 on the fused path) -----
    def _host_state(self):
        return dict(env_steps=self.env_steps,
                    updates=self.updates_done)

    def _aux_dir(self, step: int) -> str:
        import os
        return os.path.join(self.result_dir, "checkpoints_aux",
                            str(step), f"proc{self.proc}")

    def save_checkpoint(self, protect: bool = True):
        """Lead process: checkpoint of the replicated learner state.
        EVERY process: a sidecar dir of per-leaf .npy files holding its
        LOCAL rows of the 'data'-sharded actor state (+ replay shards
        with `checkpoint_replay`) — written one leaf at a time so peak
        host memory is one field's local block, never the whole ring
        through a single pytree save (round-3 verdict Weak #5); no
        cross-process data movement."""
        import os
        from rltime_tpu.parallel.mesh import local_shard_rows
        from rltime_tpu.training import checkpoint as ckpt_lib
        step = self.env_steps
        path = None
        if self.is_lead:
            path = ckpt_lib.save(self.result_dir, step,
                                 jax.device_get(self.train_state),
                                 self._host_state())
        d = self._aux_dir(step)
        os.makedirs(d, exist_ok=True)
        leaves = jax.tree.leaves(self.actor_state)
        for i, leaf in enumerate(leaves):
            np.save(os.path.join(d, f"actor_{i}.npy"),
                    local_shard_rows(leaf))
        shards = sorted(self._stats_popped)
        np.save(os.path.join(d, "stats_shards.npy"),
                np.array(shards, np.int64))
        np.save(os.path.join(d, "stats_popped.npy"),
                np.array([self._stats_popped[g] for g in shards],
                         np.int64))
        if self.loop_cfg.checkpoint_replay:
            for k, v in self.replay_state.storage.items():
                np.save(os.path.join(d, f"storage_{k}.npy"),
                        local_shard_rows(v))
            np.save(os.path.join(d, "tree.npy"),
                    local_shard_rows(self.replay_state.tree))
            np.save(os.path.join(d, "t.npy"),
                    np.asarray(jax.device_get(self.replay_state.t)))
            np.save(os.path.join(d, "max_priority.npy"),
                    np.asarray(jax.device_get(
                        self.replay_state.max_priority)))
        if protect:
            self._protected_steps.add(step)
            if self.is_lead:
                # an interval save at an already-best step clears its
                # best_only flag so post-resume GC can't reclaim it
                ckpt_lib.unmark_best_only(self.result_dir, step)
        return path

    def _try_resume(self):
        import os
        from rltime_tpu.parallel.mesh import (
            make_global_array, replicate_global, tree_from_local_rows)
        from rltime_tpu.training import checkpoint as ckpt_lib
        step = ckpt_lib.latest_step(self.result_dir)
        if step is None:
            return
        best = ckpt_lib.best_step(self.result_dir)
        if best is not None:
            # a resumed run must not mark a worse mean as 'best'
            self._best_score = float(best["score"])
        # every process restores the SAME learner checkpoint (shared
        # filesystem, the usual cluster setup) and re-replicates — lead-only
        # restore would silently desync the replicated state
        example = {"train_state": jax.device_get(self.train_state),
                   "host_state": self._host_state()}
        restored = ckpt_lib.restore(self.result_dir, step, example)
        self.train_state = replicate_global(restored["train_state"],
                                            self.mesh)
        hs = restored["host_state"]
        self.env_steps = int(hs["env_steps"])
        self.updates_done = int(hs["updates"])
        # Protected (interval/final) steps don't survive the process,
        # so re-derive them (shared rule; advisor r4: a post-resume
        # new best must not reclaim a pre-crash interval checkpoint).
        self._protected_steps = ckpt_lib.derive_protected_steps(
            self.result_dir)
        # this process's own sidecar: local actor rows (+ replay)
        d = self._aux_dir(step)
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"fused resume: checkpoint {step} has no sidecar dir "
                f"{d} — it was written by an incompatible layout "
                "(pre-round-4 format, or a different process count/"
                "rank mapping). Delete the checkpoint or start "
                "without train.resume.")
        leaves, treedef = jax.tree.flatten(self.actor_state)
        local = [np.load(os.path.join(d, f"actor_{i}.npy"))
                 for i in range(len(leaves))]
        self.actor_state = tree_from_local_rows(
            self.actor_state, jax.tree.unflatten(treedef, local),
            self.mesh)
        shards = np.load(os.path.join(d, "stats_shards.npy"))
        popped = np.load(os.path.join(d, "stats_popped.npy"))
        self._stats_popped = {int(g): int(p)
                              for g, p in zip(shards, popped)}
        if (self.loop_cfg.checkpoint_replay
                and os.path.exists(os.path.join(d, "tree.npy"))):
            storage = {
                k: tree_from_local_rows(
                    v, np.load(os.path.join(d, f"storage_{k}.npy")),
                    self.mesh)
                for k, v in self.replay_state.storage.items()}
            self.replay_state = ReplayState(
                storage=storage,
                t=make_global_array(
                    np.load(os.path.join(d, "t.npy")), self.mesh, P()),
                tree=tree_from_local_rows(
                    self.replay_state.tree,
                    np.load(os.path.join(d, "tree.npy")), self.mesh),
                max_priority=make_global_array(
                    np.load(os.path.join(d, "max_priority.npy")),
                    self.mesh, P()))
        print(f"fused: resumed from checkpoint at env step {step}")

    def train(self):
        import time as _time
        cfg = self.loop_cfg
        next_log = self.env_steps + cfg.log_interval
        next_ckpt = self.env_steps + cfg.checkpoint_interval
        t_last, s_last = _time.time(), self.env_steps
        # Best-checkpoint tracking is GLOBAL: every process pools the
        # same episode stats (global_episode_stats allgather) at the
        # same deterministic superstep, reaches the identical decision,
        # and joins the collective sidecar save; best.json + GC are
        # lead-only. (Closes the r4 single-process-only gap.)
        track_best = cfg.track_best
        while self.env_steps < cfg.total_env_steps:
            m = self.superstep()
            if self.env_steps >= next_log:
                next_log = self.env_steps + cfg.log_interval
                rets = self.global_episode_stats()
                if rets and track_best:
                    from rltime_tpu.training import (
                        checkpoint as ckpt_lib)
                    self._best_score = ckpt_lib.maybe_record_best(
                        self.result_dir, self._best_score,
                        float(np.mean(rets)), len(rets),
                        cfg.best_min_episodes, self.env_steps,
                        lambda: self.save_checkpoint(protect=False),
                        self._protected_steps, lead=self.is_lead)
                if self.logger is not None:
                    now = _time.time()
                    scalars = dict(
                        env_steps=self.env_steps,
                        updates=self.updates_done,
                        steps_per_s=(self.env_steps - s_last)
                        / max(now - t_last, 1e-9))
                    t_last, s_last = now, self.env_steps
                    if rets:
                        scalars["episode_return_mean"] = float(
                            np.mean(rets))
                        scalars["episode_return_median"] = float(
                            np.median(rets))
                    for k, v in m.items():
                        if not k.startswith("debug_"):
                            scalars[f"train/{k}"] = float(v)
                    self.logger.log_scalars(self.env_steps, scalars)
                    self.logger.summary(self.env_steps, scalars)
            if self.env_steps >= next_ckpt:
                next_ckpt = self.env_steps + cfg.checkpoint_interval
                self.save_checkpoint()
        self.save_checkpoint()
        if self.transcript is not None and self.is_lead:
            import os
            self.transcript.dump(os.path.join(self.result_dir,
                                              "transcript.jsonl"))
        if self.logger is not None:
            self.logger.close()
        return self
