"""R2D2: recurrent sequence replay with burn-in + stored LSTM state.

Re-design of the reference's R2D2 support (SURVEY.md §2 "R2D2
support", §3.3 R2D2 path): sequence-of-length-m replay entries with
stored initial recurrent state, burn-in prefix unrolled without
gradient to warm the state, per-sequence priority = eta-mix of
max/mean |TD| (arxiv 1803.00933 lineage).

Device mapping: a sampled column `s` is the start of the burn-in window;
the replay ring serves the whole [s, s+burn+len+n) window as one
gather (no separate sequence storage — SURVEY.md §7 M4 executed on
the same time-major ring as everything else). The unroll is a single
`lax.scan` over time with per-step episode-boundary state resets
(identical math to the acting side). Burn-in is excluded from
gradients by `stop_gradient` on the warmed carry AND on the burn-in
params path (the burn unroll runs under stop_gradient entirely).

Value rescaling h/h^-1 (ops/returns.py) applied to targets when
`value_rescale=True` (R2D2 paper default).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from rltime_tpu.history.replay import (
    ReplayConfig, ReplayState, frame_stack_gather, replay_gather_at,
    replay_gather_window, replay_sample_indices, replay_update_priorities,
)
from rltime_tpu.models.policy import ModelConfig, make_model
from rltime_tpu.ops import losses, returns
from rltime_tpu.training.learner import (
    AlgoConfig, TrainState, build_net_input, make_optimizer,
)


def r2d2_horizon(algo_cfg: AlgoConfig) -> int:
    return algo_cfg.burn_in + algo_cfg.seq_len + algo_cfg.n_step


def _gather_seq_frames(replay_cfg, rstate, env, col, length,
                       frame_stack):
    """Per-step frame stacks over a window: (B, length, F, ...)."""
    B = env.shape[0]
    offs = jnp.arange(length, dtype=jnp.int32)
    envs_flat = jnp.repeat(env, length)
    cols_flat = (col[:, None] + offs[None, :]).reshape(-1)
    frames = frame_stack_gather(replay_cfg, rstate, envs_flat,
                                cols_flat, frame_stack)
    return frames.reshape((B, length) + frames.shape[1:])


def make_r2d2_update_step(model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                          replay_cfg: ReplayConfig, frame_stack: int,
                          flatten: bool, axis_name=None):
    """Build the jitted R2D2 update (same signature as the FF one)."""
    assert model_cfg.recurrent, "r2d2 requires lstm_size > 0"
    if model_cfg.channels_last:
        raise ValueError(
            "channels_last is an FF-learner option (the r2d2 sequence "
            "unroll feeds (B, F, H, W) per step)")
    model = make_model(model_cfg)
    tx = make_optimizer(algo_cfg)
    B = algo_cfg.batch_size
    burn, L, n = algo_cfg.burn_in, algo_cfg.seq_len, algo_cfg.n_step
    total = burn + L + n
    gamma = algo_cfg.gamma

    def h(x):
        return returns.value_rescale(x) if algo_cfg.value_rescale else x

    def h_inv(x):
        return (returns.value_rescale_inv(x)
                if algo_cfg.value_rescale else x)

    def unroll_from(params, obs_seq, done_prev_seq, state0):
        """scan over (B, total, ...) -> q (B, total, A), resets on done."""
        def step(carry, xs):
            obs, done_prev = xs
            mask = (1.0 - done_prev.astype(jnp.float32))[:, None]
            carry = jax.tree.map(lambda s: s * mask, carry)
            q, carry = model.apply(params, obs, carry)
            return carry, q
        xs = (jnp.moveaxis(obs_seq, 0, 1),
              jnp.moveaxis(done_prev_seq, 0, 1))
        _, qs = jax.lax.scan(step, state0, xs)
        return jnp.moveaxis(qs, 0, 1)

    def loss_fn(params, target_params, batch):
        obs = batch["obs"]                   # (B, total, ...)
        done_prev = batch["done_prev"]       # (B, total)
        state0 = batch["state0"]             # stored carry at col s

        # Burn-in: warm the carry with the ONLINE net, no gradient.
        if burn > 0:
            warm = jax.lax.stop_gradient(_warm_state(
                params, obs[:, :burn], done_prev[:, :burn], state0))
        else:
            warm = state0
        # Online unroll over train+target region.
        q_on = unroll_from(params, obs[:, burn:], done_prev[:, burn:],
                           warm)              # (B, L+n, A)
        # Target net: warm from the SAME stored state, full unroll.
        if burn > 0:
            warm_t = _warm_state(target_params, obs[:, :burn],
                                 done_prev[:, :burn], state0)
        else:
            warm_t = state0
        q_tg = unroll_from(target_params, obs[:, burn:],
                           done_prev[:, burn:], warm_t)
        q_tg = jax.lax.stop_gradient(q_tg)

        actions = batch["action"][:, burn:burn + L]      # (B, L)
        q_sa = jnp.take_along_axis(
            q_on[:, :L], actions[..., None], axis=-1)[..., 0]

        r_full = batch["reward"][:, burn:]               # (B, L+n)
        b_full = batch["boundary"][:, burn:]             # (B, L+n)
        t_full = batch["terminated"][:, burn:]           # (B, L+n)
        if algo_cfg.use_lambda:
            # Peng's Q(lambda) over the training window (SURVEY.md §0
            # item 3): G_t = r_t + gamma(1-term)[(1-lam) V_{t+1}
            # + lam G_{t+1}], V from the (double-Q) target net.
            q_on_nx = jax.lax.stop_gradient(q_on[:, 1:1 + L])
            q_tg_nx = q_tg[:, 1:1 + L]
            a_star = jnp.argmax(q_on_nx if algo_cfg.double_q else
                                q_tg_nx, axis=-1)
            v_next = h_inv(jnp.take_along_axis(
                q_tg_nx, a_star[..., None], axis=-1)[..., 0])
            target = h(returns.lambda_returns(
                r_full[:, :L], b_full[:, :L], v_next, gamma,
                algo_cfg.lambda_))
            # steps whose segment ends in a truncation inside the
            # window have biased lambda returns — mask them out.
            tmask = returns.truncation_suffix_mask(
                t_full[:, :L], b_full[:, :L])
        else:
            # Per-step n-step targets inside the sequence:
            # windows (B, L, n) built from the (B, L+n) strips.
            idx = (jnp.arange(L)[:, None] + jnp.arange(n)[None, :])
            rew_n, disc_n = returns.nstep_return(
                r_full[:, idx], b_full[:, idx], gamma)
            q_on_next = jax.lax.stop_gradient(q_on[:, n:n + L])
            q_tg_next = q_tg[:, n:n + L]
            a_star = jnp.argmax(q_on_next if algo_cfg.double_q else
                                q_tg_next, axis=-1)
            boot = jnp.take_along_axis(
                q_tg_next, a_star[..., None], axis=-1)[..., 0]
            target = h(rew_n + disc_n * h_inv(boot))
            # per-step n-step windows whose first boundary is a
            # truncation are biased — mask them out.
            tmask = returns.truncation_mask(t_full[:, idx],
                                            b_full[:, idx])
        target = jax.lax.stop_gradient(target)

        td = target - q_sa                                # (B, L)
        per_step = losses.huber(td, algo_cfg.huber_kappa)
        mask = (tmask if algo_cfg.exact_truncation
                else jnp.ones_like(td))
        loss = jnp.mean(jnp.sum(per_step * mask, axis=-1)
                        / jnp.maximum(jnp.sum(mask, axis=-1), 1.0)
                        * batch["weight"])
        prio = losses.sequence_priority(jnp.abs(td), mask,
                                        algo_cfg.eta)
        return loss, (prio, q_sa)

    def _warm_state(params, obs_seq, done_prev_seq, state0):
        def step(carry, xs):
            obs, done_prev = xs
            mask = (1.0 - done_prev.astype(jnp.float32))[:, None]
            carry = jax.tree.map(lambda s: s * mask, carry)
            _, carry = model.apply(params, obs, carry)
            return carry, ()
        xs = (jnp.moveaxis(obs_seq, 0, 1),
              jnp.moveaxis(done_prev_seq, 0, 1))
        carry, _ = jax.lax.scan(step, state0, xs)
        return carry

    def update_step(state: TrainState, rstate: ReplayState, beta):
        # 3-way split matches the FF learner's key discipline exactly
        # (key, sample key, [taus key unused here]) so the mesh/fused
        # wrapper's replicated-key rule — carried key :=
        # split(key, 3)[0] (mesh.py _one) — is algorithm-independent
        # and d=1 sharding is bit-identical to this local step for
        # r2d2 too (tests/test_parallel.py fused-vs-trainer params).
        key, skey, _ = jax.random.split(state.key, 3)
        idx = replay_sample_indices(replay_cfg, rstate, skey, B, beta)
        env, col = idx["env"], idx["col"]

        if flatten:
            frames = _gather_seq_frames(replay_cfg, rstate, env, col,
                                        total, frame_stack)
            obs = frames.reshape(frames.shape[:2] + (-1,)) \
                if frame_stack > 1 else frames[:, :, 0]
        else:
            obs = _gather_seq_frames(replay_cfg, rstate, env, col,
                                     total, frame_stack)
        win = replay_gather_window(
            replay_cfg, rstate, env, col, total,
            fields=["action", "reward", "done", "terminated"])
        # done_prev[t] = done at col+t-1 (episode ended before step t).
        prev = replay_gather_window(
            replay_cfg, rstate, env, col - 1, 1, fields=["done"])
        done_prev = jnp.concatenate(
            [prev["done"], win["done"][:, :-1]], axis=1)
        # Stored-state consistency: if col is the start of an episode
        # (done at col-1), the unroll resets anyway; otherwise the
        # stored carry matches what the actor used at col.
        s0 = replay_gather_at(replay_cfg, rstate, env, col,
                              fields=["rnn_c", "rnn_h"])
        batch = dict(obs=obs, action=win["action"],
                     reward=win["reward"], boundary=win["done"],
                     terminated=win["terminated"],
                     done_prev=done_prev,
                     state0=(s0["rnn_c"], s0["rnn_h"]),
                     weight=idx["weight"])

        (loss, (prio, q_sa)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.target_params,
                                   batch)
        if axis_name is not None:
            grads = jax.lax.pmean(grads, axis_name)
            loss = jax.lax.pmean(loss, axis_name)
        updates, opt_state = tx.update(grads, state.opt_state,
                                       state.params)
        params = optax.apply_updates(state.params, updates)
        upd = state.updates + 1
        sync = (upd % algo_cfg.target_update_freq) == 0
        target_params = jax.tree.map(
            lambda t, p: jnp.where(sync, p, t),
            state.target_params, params)
        rstate = replay_update_priorities(replay_cfg, rstate,
                                          idx["leaf"], prio)
        metrics = dict(loss=loss, q=jnp.mean(q_sa),
                       td_abs=jnp.mean(prio),
                       grad_norm=optax.global_norm(grads),
                       mean_weight=jnp.mean(idx["weight"]))
        if algo_cfg.debug_outputs:
            metrics["debug_leaf"] = idx["leaf"]
            metrics["debug_td"] = prio
            metrics["debug_q"] = jnp.mean(q_sa, axis=-1)
        return TrainState(params=params, target_params=target_params,
                          opt_state=opt_state, key=key, updates=upd), \
            rstate, metrics

    return update_step
