"""Q-learning loss kernels: Huber / double-DQN / IQN quantile-Huber.

Device-side re-design of the reference's per-algorithm loss functions
(SURVEY.md §2 "DQN loss", "IQN loss"; §3.3). All functions are pure,
batch-first jnp — they fuse into the single jitted update step.
Per-sample TD errors are returned for priority updates (PER).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def huber(x: jnp.ndarray, kappa: float = 1.0) -> jnp.ndarray:
    """Elementwise Huber loss of a residual x."""
    ax = jnp.abs(x)
    quad = jnp.minimum(ax, kappa)
    return 0.5 * quad * quad + kappa * (ax - quad)


def double_q_target(q_next_online: jnp.ndarray, q_next_target: jnp.ndarray,
                    rewards: jnp.ndarray, discounts: jnp.ndarray):
    """Double-DQN n-step target (SURVEY.md §3.3 DQN path).

    a* = argmax_a Q_online(s'); y = R_n + discount * Q_target(s', a*).
    `discounts` already folds in gamma^n and termination masking
    (see ops.returns.nstep_return).
    """
    a_star = jnp.argmax(q_next_online, axis=-1)
    q_boot = jnp.take_along_axis(
        q_next_target, a_star[..., None], axis=-1)[..., 0]
    return rewards + discounts * q_boot


def q_learning_loss(q, actions, targets, weights=None, kappa: float = 1.0):
    """Weighted Huber TD loss; returns (scalar_loss, |td| per sample)."""
    q_sa = jnp.take_along_axis(q, actions[..., None], axis=-1)[..., 0]
    td = targets - q_sa
    per_sample = huber(td, kappa)
    if weights is not None:
        per_sample = per_sample * weights
    return jnp.mean(per_sample), jnp.abs(td)


def quantile_huber_loss(quantiles: jnp.ndarray, taus: jnp.ndarray,
                        target_quantiles: jnp.ndarray,
                        weights=None, kappa: float = 1.0):
    """IQN pairwise quantile-Huber (pinball) loss (SURVEY.md §3.3 IQN).

    Args:
      quantiles: (B, N) predicted quantile values for the taken action.
      taus: (B, N) quantile fractions for `quantiles`.
      target_quantiles: (B, N') target distribution samples (no grad).
      weights: optional (B,) importance weights.
      kappa: Huber threshold.

    Returns (scalar_loss, per_sample_td (B,)) where per_sample_td is the
    mean absolute pairwise TD (priority signal).
    """
    target = jax.lax.stop_gradient(target_quantiles)
    # Pairwise residuals: u[b, j, i] = target[b, j] - pred[b, i]
    u = target[:, :, None] - quantiles[:, None, :]
    h = huber(u, kappa)
    indicator = (u < 0.0).astype(quantiles.dtype)
    rho = jnp.abs(taus[:, None, :] - indicator) * h / kappa
    # sum over prediction quantiles i, mean over target samples j.
    per_sample = jnp.sum(jnp.mean(rho, axis=1), axis=-1)
    loss = per_sample
    if weights is not None:
        loss = loss * weights
    td_abs = jnp.mean(jnp.abs(u), axis=(1, 2))
    return jnp.mean(loss), td_abs


def sequence_priority(td_abs: jnp.ndarray, mask: jnp.ndarray,
                      eta: float = 0.9):
    """R2D2 sequence priority: eta*max + (1-eta)*mean over valid steps.

    Args:
      td_abs: (B, T) per-step |TD|.
      mask: (B, T) 1.0 for steps contributing to the loss.
    """
    m = mask.astype(td_abs.dtype)
    masked = td_abs * m
    mx = jnp.max(masked, axis=-1)
    mean = jnp.sum(masked, axis=-1) / jnp.maximum(jnp.sum(m, axis=-1), 1.0)
    return eta * mx + (1.0 - eta) * mean
