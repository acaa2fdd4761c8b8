"""Learner: one jitted update step, zero host round-trips.

Re-design of the reference's trainer/loss layer (SURVEY.md §1 L2,
§3.3). The reference's per-update cycle crosses the host/device
boundary four times (numpy batch -> cuda, loss, backward, priorities
back to numpy). Here the ENTIRE cycle — PER sum-tree sampling, window
gather, n-step target, forward/backward, Adam, priority write-back,
periodic target sync — is one jitted function over device-resident
state ([BJ] "run entirely on-device ... no host round-trips").

Algorithms (SURVEY.md §0 item 4): 1-step/n-step DQN, double-Q,
dueling (in the model head), IQN quantile regression. R2D2 sequence
updates live in training/r2d2.py.
"""
from __future__ import annotations

import dataclasses

from typing import Any

import jax
import jax.numpy as jnp
import optax

from rltime_tpu.history.replay import (
    ReplayConfig, ReplayState, frame_stack_gather,
    frame_stack_union_gather, frame_stack_union_gather_nhwc,
    replay_gather_at, replay_gather_window,
    replay_sample_indices, replay_update_priorities,
)
from rltime_tpu.models.policy import ModelConfig, make_model
from rltime_tpu.ops import losses, returns
from rltime_tpu.utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """Static training hyperparameters (hashable jit static arg)."""
    algo: str = "dqn"              # "dqn" | "iqn"  (r2d2: training/r2d2.py)
    batch_size: int = 32
    gamma: float = 0.99
    n_step: int = 1
    double_q: bool = True
    huber_kappa: float = 1.0
    lr: float = 1e-4
    # Optional linear LR decay over `lr_decay_updates` learner updates
    # (0 = constant LR). Late-training Q oscillation on small tasks
    # (CartPole) moves the final greedy policy off its learned
    # optimum; annealing LR to lr_end pins it.
    lr_end: float = 0.0
    lr_decay_updates: int = 0
    adam_eps: float = 1e-8
    optimizer: str = "adam"        # "adam" | "rmsprop" (centered, the
                                   # Ape-X/Nature-DQN choice)
    rmsprop_decay: float = 0.95
    grad_clip: float = 10.0
    target_update_freq: int = 500  # in learner updates
    # PER importance-sampling beta anneal (host passes beta per call)
    per_beta_start: float = 0.4
    per_beta_end: float = 1.0
    # Exact truncation handling: windows whose first boundary is a
    # time-limit truncation are excluded from the loss and drained
    # from PER (ops/returns.truncation_mask). False reverts to the
    # truncation-as-termination approximation (the reference's
    # pre-gym-0.26 behavior — it never distinguishes the two).
    exact_truncation: bool = True
    # DQN: fuse the two gradient-free next-obs forwards (online s' for
    # double-Q argmax + target s') into ONE stacked-params vmap apply
    # — same FLOPs, one grouped conv instead of two. Per-workload
    # flag pending a GPU A/B (ROADMAP design debt 3); math is
    # identical, reduction tiling may differ in last ulps.
    batched_next_forward: bool = False
    # Force the PER obs gather into its own kernel (an
    # optimization_barrier between gather and conv). Measurement knob
    # for a gather fused into the scanned update running slower than
    # the same gather alone; pending a GPU A/B (ROADMAP design
    # debt 2).
    gather_barrier: bool = False
    # IQN
    num_tau: int = 64
    num_tau_prime: int = 64
    # R2D2 (training/r2d2.py)
    burn_in: int = 40
    seq_len: int = 80
    eta: float = 0.9            # sequence priority max/mean mix
    value_rescale: bool = True
    # lambda-return targets (SURVEY.md §0 item 3 "n-step (and
    # lambda-style) return computation"): Peng's Q(lambda). On r2d2,
    # over the training window instead of per-step n-step targets; on
    # the FF dqn path, over the n-step window with per-step double-Q
    # bootstraps (costs n target forwards instead of 1).
    use_lambda: bool = False
    lambda_: float = 0.7
    # debug: return sampled leaves, per-sample |TD| and Q(s, a) in
    # metrics (the exact-numerics transcript harness and the
    # cross-backend comparison read these; costs one small D2H per
    # update, so off by default)
    debug_outputs: bool = False


class TrainState(PyTreeNode):
    params: Any
    target_params: Any
    opt_state: Any
    key: jnp.ndarray
    updates: jnp.ndarray          # int32 learner update counter


def make_optimizer(cfg: AlgoConfig):
    lr = cfg.lr
    if cfg.lr_decay_updates > 0:
        lr = optax.linear_schedule(cfg.lr, cfg.lr_end,
                                   cfg.lr_decay_updates)
    if cfg.optimizer == "adam":
        tx = optax.adam(lr, eps=cfg.adam_eps)
    elif cfg.optimizer == "rmsprop":
        tx = optax.rmsprop(lr, decay=cfg.rmsprop_decay,
                           eps=cfg.adam_eps, centered=True)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.grad_clip > 0:
        tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), tx)
    return tx


def make_train_state(model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                     key, example_obs) -> TrainState:
    from rltime_tpu.models.policy import init_params
    ikey, skey = jax.random.split(key)
    params = init_params(model_cfg, ikey, example_obs)
    tx = make_optimizer(algo_cfg)
    return TrainState(
        params=params,
        target_params=jax.tree.map(jnp.copy, params),
        opt_state=tx.init(params),
        key=skey,
        updates=jnp.zeros((), jnp.int32),
    )


def build_net_input(frames: jnp.ndarray, flatten: bool) -> jnp.ndarray:
    """Mirror the actor's net input: (B, F, ...) stack -> model input."""
    if flatten:
        return frames.reshape(frames.shape[0], -1)
    return frames


def _gather_batch(replay_cfg: ReplayConfig, rstate: ReplayState,
                  env, col, frame_stack: int, n_step: int,
                  flatten: bool, lambda_mode: bool = False,
                  channels_last: bool = False,
                  barrier: bool = False):
    """Gather everything one FF update needs from the ring storage.

    `lambda_mode` (algo.use_lambda on the FF path, SURVEY.md §0 item 3
    "and lambda-style"): instead of ONE bootstrap stack at col+n, the
    per-step bootstrap stacks at col+1..col+n are gathered (flattened
    to (B*n, ...) for one batched forward), and exactness masking uses
    the per-step suffix rule (a sample is biased iff the segment
    containing step 0 ends in a truncation inside the window)."""
    if lambda_mode:
        B = env.shape[0]
        offs = jnp.arange(1, n_step + 1, dtype=jnp.int32)
        envs_flat = jnp.repeat(env, n_step)
        cols_flat = (col[:, None] + offs[None, :]).reshape(-1)
        obs_tn = frame_stack_gather(replay_cfg, rstate, envs_flat,
                                    cols_flat, frame_stack)
        obs_t = frame_stack_gather(replay_cfg, rstate, env, col,
                                   frame_stack)
        if channels_last:
            obs_t = jnp.moveaxis(obs_t, 1, -1)
            obs_tn = jnp.moveaxis(obs_tn, 1, -1)
    elif frame_stack > 1:
        if channels_last:
            # NHWC straight out of the gather — no whole-batch
            # relayout between gather and conv (replay.py docstring)
            obs_t, obs_tn = frame_stack_union_gather_nhwc(
                replay_cfg, rstate, env, col, frame_stack, n_step)
        else:
            # one union-window gather for both stacks (F+n rows vs 2F;
            # bit-identical to the two-call path — replay.py docstring)
            obs_t, obs_tn = frame_stack_union_gather(
                replay_cfg, rstate, env, col, frame_stack, n_step)
    else:
        obs_t = frame_stack_gather(replay_cfg, rstate, env, col,
                                   frame_stack)
        obs_tn = frame_stack_gather(replay_cfg, rstate, env,
                                    col + n_step, frame_stack)
        if channels_last:
            obs_t = jnp.moveaxis(obs_t, 1, -1)
            obs_tn = jnp.moveaxis(obs_tn, 1, -1)
    if barrier:
        obs_t, obs_tn = jax.lax.optimization_barrier((obs_t, obs_tn))
    win = replay_gather_window(replay_cfg, rstate, env, col, n_step,
                               fields=["reward", "done", "terminated"])
    at = replay_gather_at(replay_cfg, rstate, env, col, fields=["action"])
    if lambda_mode:
        trunc_ok = returns.truncation_suffix_mask(
            win["terminated"], win["done"])[..., 0]
    else:
        # `done` (terminated|truncated) bounds both the reward sum and
        # the bootstrap. Windows whose first boundary is a TRUNCATION
        # have no stored bootstrap obs (auto-reset discards it); they
        # are excluded exactly via `trunc_ok` — zero loss weight + zero
        # priority write-back (see ops/returns.truncation_mask).
        trunc_ok = returns.truncation_mask(win["terminated"],
                                           win["done"])
    return dict(
        obs=build_net_input(obs_t, flatten),
        next_obs=build_net_input(obs_tn, flatten),
        action=at["action"],
        rewards=win["reward"],
        boundary=win["done"],
        trunc_ok=trunc_ok,
    )


def make_update_step(model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                     replay_cfg: ReplayConfig, frame_stack: int,
                     flatten: bool, axis_name: str | None = None):
    """Build the (jit-able) learner update.

    Returns fn(train_state, replay_state, beta) ->
      (train_state, replay_state, metrics).
    `axis_name`: set by the shard_map wrapper for multi-device psum
    (SURVEY.md §5.8 gradient allreduce); None = single device.
    """
    model = make_model(model_cfg)
    tx = make_optimizer(algo_cfg)
    B = algo_cfg.batch_size
    if algo_cfg.use_lambda and algo_cfg.algo == "iqn":
        raise ValueError(
            "use_lambda is supported for algo='dqn' (FF Q-lambda) and "
            "'r2d2' (sequence Q-lambda), not 'iqn' — matching the "
            "reference's Q-learning-flavored lambda usage")

    def loss_fn(params, target_params, batch, taus_key):
        if algo_cfg.algo == "dqn":
            q_t, _ = model.apply(params, batch["obs"], ())
            if algo_cfg.batched_next_forward and algo_cfg.double_q:
                sp = jax.tree.map(lambda a, b: jnp.stack([a, b]),
                                  params, target_params)
                q_next, _ = jax.vmap(
                    model.apply, in_axes=(0, None, None))(
                        sp, batch["next_obs"], ())
                q_next = jax.lax.stop_gradient(q_next)
                q_tn_online, q_tn_target = q_next[0], q_next[1]
            else:
                q_tn_target, _ = model.apply(target_params,
                                             batch["next_obs"], ())
                if algo_cfg.double_q:
                    q_tn_online, _ = model.apply(params,
                                                 batch["next_obs"], ())
                    q_tn_online = jax.lax.stop_gradient(q_tn_online)
                else:
                    q_tn_online = q_tn_target
            if algo_cfg.use_lambda:
                # Peng's Q(lambda) target over the n-window (SURVEY.md
                # §0 item 3 on the FF path): next_obs holds the B*n
                # per-step bootstrap stacks (_gather_batch
                # lambda_mode); per-step double-Q V estimates feed the
                # backward lambda recursion, G[:, 0] is the target.
                # n_step=1 (any lambda) and lambda=1.0 both reduce
                # exactly to the n-step path (tests/test_losses.py).
                n = algo_cfg.n_step
                A = q_t.shape[-1]
                q_on_n = q_tn_online.reshape(-1, n, A)
                q_tg_n = q_tn_target.reshape(-1, n, A)
                a_star = jnp.argmax(
                    q_on_n if algo_cfg.double_q else q_tg_n, axis=-1)
                v_next = jnp.take_along_axis(
                    q_tg_n, a_star[..., None], axis=-1)[..., 0]
                g = returns.lambda_returns(
                    batch["rewards"], batch["boundary"], v_next,
                    algo_cfg.gamma, algo_cfg.lambda_)
                target = g[..., 0]
            else:
                rew, disc = returns.nstep_return(
                    batch["rewards"],
                    batch["boundary"], algo_cfg.gamma)
                target = losses.double_q_target(
                    q_tn_online, q_tn_target, rew, disc)
            target = jax.lax.stop_gradient(target)
            loss, td_abs = losses.q_learning_loss(
                q_t, batch["action"], target, weights=batch["weight"],
                kappa=algo_cfg.huber_kappa)
            q_sa = jnp.take_along_axis(
                q_t, batch["action"][:, None], axis=-1)[:, 0]
            return loss, (td_abs, jnp.mean(jnp.max(q_t, -1)), q_sa)

        elif algo_cfg.algo == "iqn":
            k1, k2, k3 = jax.random.split(taus_key, 3)
            taus = jax.random.uniform(k1, (B, algo_cfg.num_tau))
            taus_p = jax.random.uniform(k2, (B, algo_cfg.num_tau_prime))
            quant_t, _ = model.apply(params, batch["obs"], (), taus)
            q_sa = jnp.take_along_axis(
                quant_t, batch["action"][:, None, None], axis=2)[..., 0]
            # a* from online net mean over policy taus (double-IQN).
            taus_pol = jax.random.uniform(
                k3, (B, model_cfg.num_tau_policy))
            src = params if algo_cfg.double_q else target_params
            quant_pol, _ = model.apply(src, batch["next_obs"], (), taus_pol)
            a_star = jnp.argmax(jnp.mean(quant_pol, axis=1), axis=-1)
            quant_tn, _ = model.apply(
                target_params, batch["next_obs"], (), taus_p)
            q_next = jnp.take_along_axis(
                quant_tn, a_star[:, None, None], axis=2)[..., 0]
            rew, disc = returns.nstep_return(
                batch["rewards"], batch["boundary"], algo_cfg.gamma)
            target_quant = rew[:, None] + disc[:, None] * q_next
            loss, td_abs = losses.quantile_huber_loss(
                q_sa, taus, target_quant, weights=batch["weight"],
                kappa=algo_cfg.huber_kappa)
            return loss, (td_abs, jnp.mean(q_sa), jnp.mean(q_sa, -1))
        else:
            raise ValueError(f"unknown algo {algo_cfg.algo!r}")

    def sample_phase(skey, rstate: ReplayState, beta: jnp.ndarray):
        """PER sample + window gather: everything that only READS the
        replay state. Split out so a pipelined caller can overlap the
        next update's gather with the current update's compute
        (make_pipelined_insert_update)."""
        idx = replay_sample_indices(replay_cfg, rstate, skey, B, beta)
        batch = _gather_batch(replay_cfg, rstate, idx["env"], idx["col"],
                              frame_stack, algo_cfg.n_step, flatten,
                              lambda_mode=(algo_cfg.use_lambda
                                           and algo_cfg.algo == "dqn"),
                              channels_last=model_cfg.channels_last,
                              barrier=algo_cfg.gather_barrier)
        trunc_ok = batch.pop("trunc_ok")
        if not algo_cfg.exact_truncation:
            trunc_ok = jnp.ones_like(trunc_ok)
        batch["weight"] = idx["weight"] * trunc_ok
        batch["trunc_ok"] = trunc_ok
        return idx, batch

    def apply_phase(state: TrainState, rstate: ReplayState, tkey,
                    idx, batch):
        """Fwd/bwd + optimizer + target sync + priority write-back on
        an already-gathered batch (state.key must already be
        advanced)."""
        batch = dict(batch)
        trunc_ok = batch.pop("trunc_ok")
        (loss, (td_abs, qmetric, q_sa)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.target_params,
                                   batch, tkey)
        if axis_name is not None:
            grads = jax.lax.pmean(grads, axis_name)
            loss = jax.lax.pmean(loss, axis_name)
        updates, opt_state = tx.update(grads, state.opt_state,
                                       state.params)
        params = optax.apply_updates(state.params, updates)

        upd = state.updates + 1
        sync = (upd % algo_cfg.target_update_freq) == 0
        target_params = jax.tree.map(
            lambda t, p: jnp.where(sync, p, t), state.target_params,
            params)

        rstate = replay_update_priorities(replay_cfg, rstate,
                                          idx["leaf"], td_abs,
                                          keep=trunc_ok)
        metrics = dict(loss=loss, q=qmetric,
                       td_abs=jnp.mean(td_abs * trunc_ok),
                       grad_norm=optax.global_norm(grads),
                       mean_weight=jnp.mean(idx["weight"]))
        if algo_cfg.debug_outputs:
            metrics["debug_leaf"] = idx["leaf"]
            metrics["debug_td"] = td_abs
            metrics["debug_action"] = batch["action"]
            metrics["debug_q"] = q_sa
        return TrainState(params=params, target_params=target_params,
                          opt_state=opt_state, key=state.key,
                          updates=upd), rstate, metrics

    def update_step(state: TrainState, rstate: ReplayState,
                    beta: jnp.ndarray):
        key, skey, tkey = jax.random.split(state.key, 3)
        idx, batch = sample_phase(skey, rstate, beta)
        return apply_phase(state.replace(key=key), rstate, tkey, idx,
                           batch)

    update_step.sample_phase = sample_phase
    update_step.apply_phase = apply_phase
    return update_step


def _scan_updates(update_step, state, rstate, beta, num_updates: int):
    """Scan K update steps with replay STORAGE kept out of the carry.

    Update steps read storage but never write it (priorities live in
    the tree, not storage), so storage is closed over as a
    loop-invariant. Carrying it instead can cost full-ring copies at
    the while-loop boundary (two ~460 MB obs-ring copies per dispatch
    for the Atari-shaped config).
    """
    storage = rstate.storage

    def body(carry, _):
        s, tree, t, max_p = carry
        r = rstate.replace(storage=storage, tree=tree, t=t,
                           max_priority=max_p)
        s, r, m = update_step(s, r, beta)
        return (s, r.tree, r.t, r.max_priority), m

    carry0 = (state, rstate.tree, rstate.t, rstate.max_priority)
    (state, tree, t, max_p), ms = jax.lax.scan(
        body, carry0, None, length=num_updates)
    rstate = rstate.replace(tree=tree, t=t, max_priority=max_p)
    metrics = jax.tree.map(lambda m: m[-1], ms)
    return state, rstate, metrics


def make_insert_and_update_step(replay_cfg: ReplayConfig, update_step,
                                num_updates: int):
    """Fuse {chunk insert + K update steps} into ONE XLA program.

    One host dispatch per training chunk instead of two, so dispatch
    latency is paid once per chunk. The ops
    are the building blocks unchanged: history/replay.replay_insert
    (outside the scan, so its dynamic_update_slice stays in-place)
    followed by `num_updates` update_step iterations via _scan_updates.
    """
    from rltime_tpu.history import replay as replay_lib

    def fused(state, rstate, chunk, beta):
        rstate = replay_lib.replay_insert(replay_cfg, rstate, chunk)
        return _scan_updates(update_step, state, rstate, beta,
                             num_updates)
    return fused


def make_pipelined_insert_and_update_step(replay_cfg: ReplayConfig,
                                          update_step,
                                          num_updates: int):
    """{chunk insert + K updates} with SOFTWARE-PIPELINED sampling:
    each update consumes the batch sampled+gathered during the
    previous update's compute window (VERDICT r4 Next #1 candidate c).

    Update k's PER sample+gather reads the tree BEFORE update k-1's
    priority write-back and is data-independent of update k-1's
    fwd/bwd — XLA can run the gather (memory plane) concurrently with
    the convs (compute plane) instead of serializing them. The semantic
    shift vs make_insert_and_update_step: sampling priorities are ONE
    UPDATE stale (the standard async-PER relaxation — Ape-X actors
    sample against stale priorities by design, arxiv 1803.00933), and
    the pending batch crossing a chunk boundary was sampled before
    that chunk's insert (its gathered values are a valid snapshot;
    dead-leaf priority write-backs are dropped by the replay
    invariant).

    Returns (prime, fused):
      prime(state, rstate, beta) -> (state, pending)
      fused(state, rstate, pending, chunk, beta)
          -> (state, rstate, pending, metrics)
    """
    from rltime_tpu.history import replay as replay_lib
    sample = update_step.sample_phase
    apply = update_step.apply_phase

    def prime(state, rstate, beta):
        key, skey, tkey = jax.random.split(state.key, 3)
        idx, batch = sample(skey, rstate, beta)
        return state.replace(key=key), (idx, batch, tkey)

    def fused(state, rstate, pending, chunk, beta):
        rstate = replay_lib.replay_insert(replay_cfg, rstate, chunk)
        storage = rstate.storage

        def body(carry, _):
            s, tree, t, max_p, pend = carry
            r = rstate.replace(storage=storage, tree=tree, t=t,
                               max_priority=max_p)
            idx_p, batch_p, tkey_p = pend
            key, skey, tkey_next = jax.random.split(s.key, 3)
            # next batch: independent of apply() below given the
            # post-insert state — the overlap the pipeline exists for
            idx2, batch2 = sample(skey, r, beta)
            s2, r2, m = apply(s.replace(key=key), r, tkey_p, idx_p,
                              batch_p)
            return (s2, r2.tree, r2.t, r2.max_priority,
                    (idx2, batch2, tkey_next)), m

        carry0 = (state, rstate.tree, rstate.t, rstate.max_priority,
                  pending)
        (state, tree, t, max_p, pending), ms = jax.lax.scan(
            body, carry0, None, length=num_updates)
        rstate = rstate.replace(tree=tree, t=t, max_priority=max_p)
        return state, rstate, pending, \
            jax.tree.map(lambda m: m[-1], ms)

    return prime, fused


def make_multi_update_step(update_step, num_updates: int):
    """Fuse K update steps into ONE jit dispatch via lax.scan.

    Cuts per-update dispatch/launch overhead K-fold. Returns the
    metrics of the LAST step (same contract as a single update).
    Production paths use make_insert_and_update_step (insert fused
    in); this update-only shape is what the measurement tools isolate
    (tools/compare_samplers.py).
    """
    def multi(state, rstate, beta):
        return _scan_updates(update_step, state, rstate, beta,
                             num_updates)
    return multi
