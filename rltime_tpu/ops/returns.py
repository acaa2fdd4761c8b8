"""Return pipelines: n-step returns, lambda returns, value rescaling.

The reference assembles n-step returns on the host BEFORE inserting
into replay (SURVEY.md §2 "Online/n-step history"). Device-side
re-design: replay stores RAW per-step transitions in time-major per-env
rings, and n-step quantities are computed AT SAMPLE TIME on device from
the gathered reward/done windows — no host assembler, no duplicated
storage, and the same stored data serves 1-step, n-step, and R2D2
sequence sampling.

Conventions (tested in tests/test_returns.py against brute force):
  * window arrays are time-major trailing axis: rewards (..., n)
    where index i is the reward of transition t+i;
  * `terminated[i]` ends the episode at step t+i (no bootstrap past it);
  * `done[i] = terminated | truncated` marks an env reset boundary.
    Truncation (time-limit) still bootstraps — handled by callers
    sampling windows that never cross `done` except via `terminated`
    masking, see history/replay.py validity rules.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def nstep_return(rewards: jnp.ndarray, terminated: jnp.ndarray,
                 gamma: float):
    """n-step discounted reward sum with early termination.

    Args:
      rewards: (..., n) float, r_{t+i}.
      terminated: (..., n) bool/float, episode terminated at step t+i.
      gamma: discount.

    Returns (R, discount):
      R: (...,) = sum_i gamma^i * r_i * prod_{j<i}(1 - term_j)
      discount: (...,) = gamma^n * prod_i (1 - term_i); multiply the
        bootstrap value by this (0 if episode ended inside the window).
    """
    term = terminated.astype(rewards.dtype)
    n = rewards.shape[-1]
    alive = jnp.cumprod(1.0 - term, axis=-1)  # alive[i] = prod_{j<=i}
    # mask[i] = prod_{j<i} (1 - term_j): shift alive right by one.
    mask = jnp.concatenate(
        [jnp.ones_like(alive[..., :1]), alive[..., :-1]], axis=-1)
    gammas = gamma ** jnp.arange(n, dtype=rewards.dtype)
    ret = jnp.sum(rewards * mask * gammas, axis=-1)
    discount = (gamma ** n) * alive[..., -1]
    return ret, discount


def nstep_bootstrap_index(terminated: jnp.ndarray):
    """Index (0..n) of the bootstrap state: n, or first termination + 1.

    When the episode terminates inside the window the discount is zero,
    so the bootstrap value is irrelevant — but gathering at a clamped
    index keeps all memory reads in-episode (useful for stored-state
    consistency checks).
    """
    term = terminated.astype(jnp.int32)
    n = term.shape[-1]
    any_term = jnp.max(term, axis=-1) > 0
    first = jnp.argmax(term, axis=-1)
    return jnp.where(any_term, first + 1, n)


def truncation_mask(terminated: jnp.ndarray, done: jnp.ndarray):
    """1.0 where an n-step window's target is exact, 0.0 where biased.

    A window whose FIRST episode boundary is a truncation
    (done & ~terminated) has no valid bootstrap: auto-reset discarded
    the time-limit terminal observation, and treating the truncation
    as termination would bias Q downward. Such windows are excluded —
    zero loss weight AND zero priority write-back, so PER drains them
    (the exact-truncation design; see training/learner.py).

    Windows whose first boundary is a termination are exact (discount
    0), as are boundary-free windows (bootstrap from stored obs).

    Args: terminated, done: (..., n) window flags. Returns (...,) f32.
    """
    d = done.astype(bool)
    any_d = jnp.any(d, axis=-1)
    first = jnp.argmax(d, axis=-1)
    first_term = jnp.take_along_axis(
        terminated.astype(bool), first[..., None], axis=-1)[..., 0]
    bad = any_d & (~first_term)
    return 1.0 - bad.astype(jnp.float32)


def truncation_suffix_mask(terminated: jnp.ndarray, done: jnp.ndarray):
    """Per-step exactness mask for lambda returns over a window.

    A lambda return G_t folds in every reward until its episode
    segment's boundary (or the window end, where it bootstraps). Step t
    is biased iff the segment containing t ends in a truncation INSIDE
    the window: carry `bad` backwards, set at a truncation, cleared at
    a termination.

    Args: terminated, done: (..., L). Returns (..., L) f32 (1 = exact).
    """
    term = terminated.astype(bool)
    trunc = done.astype(bool) & (~term)

    def step(carry, xs):
        tr, te = xs
        bad = jnp.where(tr, True, jnp.where(te, False, carry))
        return bad, bad

    xs = (jnp.moveaxis(trunc, -1, 0)[::-1],
          jnp.moveaxis(term, -1, 0)[::-1])
    init = jnp.zeros(trunc.shape[:-1], bool)
    _, bads = jax.lax.scan(step, init, xs)
    return 1.0 - jnp.moveaxis(bads[::-1], 0, -1).astype(jnp.float32)


def lambda_returns(rewards: jnp.ndarray, terminated: jnp.ndarray,
                   values: jnp.ndarray, gamma: float, lam: float):
    """Peng-style lambda returns over a window (SURVEY.md §0 item 3).

    Args:
      rewards: (..., n) r_{t+i}
      terminated: (..., n)
      values: (..., n) bootstrap values V(s_{t+i+1}) (value AFTER step i).
    Returns G: (..., n) lambda returns for each step in the window.

    G_i = r_i + gamma*(1-term_i) * ((1-lam) * V_{i+1} + lam * G_{i+1}),
    with G_n-1 closing on V_n (values[..., n-1]).
    """
    term = terminated.astype(rewards.dtype)
    cont = 1.0 - term

    def step(carry, xs):
        r, c, v = xs
        g = r + gamma * c * ((1.0 - lam) * v + lam * carry)
        return g, g

    # scan from the end of the window backwards over the trailing axis.
    xs = (jnp.moveaxis(rewards, -1, 0), jnp.moveaxis(cont, -1, 0),
          jnp.moveaxis(values, -1, 0))
    xs_rev = jax.tree.map(lambda x: x[::-1], xs)
    init = values[..., -1]
    _, gs = jax.lax.scan(step, init, xs_rev)
    return jnp.moveaxis(gs[::-1], 0, -1)


def value_rescale(x: jnp.ndarray, eps: float = 1e-3) -> jnp.ndarray:
    """R2D2 invertible value rescaling h(x) (SURVEY.md §3.3 R2D2 path)."""
    return jnp.sign(x) * (jnp.sqrt(jnp.abs(x) + 1.0) - 1.0) + eps * x


def value_rescale_inv(x: jnp.ndarray, eps: float = 1e-3) -> jnp.ndarray:
    """Inverse of `value_rescale` (closed form)."""
    a = jnp.sqrt(1.0 + 4.0 * eps * (jnp.abs(x) + 1.0 + eps))
    return jnp.sign(x) * ((((a - 1.0) / (2.0 * eps)) ** 2) - 1.0)
