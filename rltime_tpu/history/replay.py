"""Device-resident replay: time-major per-env rings + sum-tree PER.

Device-resident re-design of the reference's history layer (SURVEY.md §1 L4,
§2 "Uniform replay"/"Prioritized replay"/"Online/n-step history").
Differences from the reference, by design:

  * Storage lives ON DEVICE as fixed-shape jnp arrays `(E, T, ...)` —
    env-major, time-minor. Envs step in lockstep, so one acting chunk
    writes the same column range for every env; inserts are a single
    `dynamic_update_slice` per field, no host round-trips.
  * Raw per-step transitions are stored once; n-step returns, frame
    stacks, and R2D2 sequences are GATHERED AT SAMPLE TIME (see
    ops/returns.py) instead of being assembled host-side before insert.
    The reference's separate "online n-step history" layer disappears.
  * Priorities "activate" with a delay of `horizon` columns behind the
    write cursor, so the sum tree only ever holds sampleable entries:
    a leaf is live iff its full gather window [c, c+horizon] is in
    storage. Freshly-complete entries get max-priority-on-insert
    (arxiv 1511.05952 semantics).

Invariants (tested in tests/test_replay.py):
  * leaf(e, c) > 0 implies column c has `horizon` successors stored;
  * insert overwrites => overwritten columns' leaves zeroed first;
  * duplicate sampled indices get last-write-wins priority updates,
    and updates to since-overwritten leaves are dropped.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from jax.experimental.layout import Layout as _Layout
from jax.experimental.layout import with_layout_constraint as _with_layout

from rltime_tpu.ops import dense_tree, sum_tree
from rltime_tpu.utils.pytree import PyTreeNode


def _tree_ops(cfg: "ReplayConfig"):
    """Priority-structure backend for this replay (see cfg.sampler)."""
    return dense_tree if cfg.sampler == "dense" else sum_tree


def _pin_rowmajor(storage: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """Pin every storage ring to the row-major (default) layout.

    XLA's layout assignment is free to pick image-ring layouts per
    program, and a ring whose layout differs between the program that
    makes it and the one that consumes it pays a full-ring relayout
    copy per dispatch. Pinning the layout at insert/init keeps init,
    insert, and update agreeing so donation aliases the ring instead
    of copying it. (On the GPU the compiled learner superstep is the
    same with and without the pin — row-major ring, no ring-sized
    copy, as tools/dump_superstep_hlo.py shows.)"""
    def pin(x):
        if x.ndim < 2:
            return x
        return _with_layout(
            x, _Layout(major_to_minor=tuple(range(x.ndim))))
    return {k: pin(v) for k, v in storage.items()}


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Static replay geometry (hashable: safe as a jit static arg)."""
    num_envs: int            # E: lockstep env lanes feeding this shard
    steps_per_env: int       # T: ring length per env (capacity = E*T)
    horizon: int             # gather window beyond the sampled column
                             # (n for n-step; burn+len+n for R2D2)
    chunk_len: int           # L: acting chunk columns per insert
    lookback: int = 0        # backward gather reach (frame_stack - 1):
                             # a sampled column must keep its stack
                             # frames un-overwritten
    prioritized: bool = True
    alpha: float = 0.6       # PER exponent (priorities stored ^alpha)
    min_priority: float = 1e-6
    # Priority structure backend: "dense" (ops/dense_tree.py — flat
    # array + block partial sums, all vector ops; the default) or
    # "tree" (ops/sum_tree.py — classic binary sum tree,
    # log-depth descend/scatter chains; kept for comparison and for
    # the reference's exact data structure).
    sampler: str = "dense"
    # Ape-X actor-side initial priorities ([BJ] "actors produce
    # transitions with initial priorities"): when True and the chunk
    # carries a "priority" field (raw |TD| estimates from the actor),
    # activation uses (p + min_priority)^alpha instead of max-priority.
    use_inserted_priorities: bool = False

    def __post_init__(self):
        if self.sampler not in ("dense", "tree"):
            raise ValueError(
                f"sampler must be 'dense' or 'tree', got "
                f"{self.sampler!r}")
        if self.steps_per_env % self.chunk_len != 0:
            raise ValueError("steps_per_env must be a multiple of "
                             "chunk_len (keeps ring inserts unsplit)")
        if self.steps_per_env < 2 * (self.chunk_len + self.horizon
                                     + self.lookback):
            raise ValueError(
                "steps_per_env too small: need >= 2*(chunk_len + "
                "horizon + lookback) so live/dead leaf windows "
                "cannot collide")

    @property
    def capacity(self) -> int:
        return self.num_envs * self.steps_per_env


class ReplayState(PyTreeNode):
    """Replay buffer contents (a pytree: donate into jitted steps)."""
    storage: Dict[str, jnp.ndarray]   # each (E, T, ...)
    t: jnp.ndarray                    # int32 — unwrapped write cursor (columns)
    tree: jnp.ndarray                 # (2N,) sum tree ((1,) dummy if uniform)
    max_priority: jnp.ndarray         # f32 running max (already ^alpha)


def replay_init(cfg: ReplayConfig,
                field_specs: Dict[str, Tuple[Tuple[int, ...], Any]]
                ) -> ReplayState:
    """Allocate storage. field_specs: name -> (per-step shape, dtype)."""
    E, T = cfg.num_envs, cfg.steps_per_env
    storage = {
        name: jnp.zeros((E, T) + tuple(shape), dtype=dtype)
        for name, (shape, dtype) in field_specs.items()
    }
    storage = jax.jit(_pin_rowmajor)(storage)
    tree = (_tree_ops(cfg).init(cfg.capacity) if cfg.prioritized
            else jnp.zeros((1,), jnp.float32))
    return ReplayState(
        storage=storage,
        t=jnp.zeros((), jnp.int32),
        tree=tree,
        max_priority=jnp.ones((), jnp.float32),
    )


def _flat_leaf(cfg: ReplayConfig, env: jnp.ndarray, col: jnp.ndarray):
    """(env, ring column) -> sum-tree leaf index."""
    return env * cfg.steps_per_env + col


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def replay_insert(cfg: ReplayConfig, state: ReplayState,
                  chunk: Dict[str, jnp.ndarray]) -> ReplayState:
    """Insert an acting chunk: each field shaped (E, L, ...).

    Writes columns [t, t+L) (mod T) for all envs, zeroes the
    overwritten columns' priorities, and activates columns
    [t-horizon, t+L-horizon) at max priority (their gather windows are
    now complete).
    """
    E, T, L = cfg.num_envs, cfg.steps_per_env, cfg.chunk_len
    col = jnp.mod(state.t, T)

    storage = dict(state.storage)
    for name, arr in chunk.items():
        dst = state.storage[name]
        zeros_idx = (0,) * (dst.ndim - 2)
        storage[name] = jax.lax.dynamic_update_slice(
            dst, arr.astype(dst.dtype), (0, col) + zeros_idx)
    storage = _pin_rowmajor(storage)

    tree = state.tree
    if cfg.prioritized:
        st = _tree_ops(cfg)
        env_ids = jnp.repeat(jnp.arange(E, dtype=jnp.int32), L)
        offs = jnp.tile(jnp.arange(L, dtype=jnp.int32), E)
        # 1) zero the columns being overwritten, plus the columns
        #    `lookback` ahead whose backward stack-frames the new data
        #    just clobbered.
        new_cols = jnp.mod(col + offs, T)
        dead = _flat_leaf(cfg, env_ids, new_cols)
        tree = st.set_priorities(
            tree, dead, jnp.zeros_like(dead, dtype=tree.dtype),
            unique=True)
        if cfg.lookback > 0:
            lb_cols = jnp.mod(col + offs + cfg.lookback, T)
            dead2 = _flat_leaf(cfg, env_ids, lb_cols)
            tree = st.set_priorities(
                tree, dead2, jnp.zeros_like(dead2, dtype=tree.dtype),
                unique=True)
        # 2) activate columns whose horizon just completed.
        act_u = state.t + offs - cfg.horizon      # unwrapped times
        act_cols = jnp.mod(act_u, T)
        live = _flat_leaf(cfg, env_ids, act_cols)
        if cfg.use_inserted_priorities and "priority" in storage:
            raw = storage["priority"][env_ids, act_cols]
            base = (raw + cfg.min_priority) ** cfg.alpha
        else:
            base = state.max_priority
        prio = jnp.where(act_u >= 0, base, 0.0)
        tree = st.set_priorities(tree, live, prio.astype(tree.dtype),
                                 unique=True)

    max_p = state.max_priority
    if cfg.prioritized and cfg.use_inserted_priorities \
            and "priority" in storage:
        max_p = jnp.maximum(max_p, jnp.max(prio))
    return ReplayState(storage=storage, t=state.t + L, tree=tree,
                       max_priority=max_p)


def valid_range(cfg: ReplayConfig, t: jnp.ndarray):
    """Unwrapped sampleable columns [lo, hi): full horizon stored
    ahead AND full lookback (stack frames) still un-overwritten."""
    lo = jnp.maximum(t - cfg.steps_per_env + cfg.lookback, 0)
    hi = jnp.maximum(t - cfg.horizon, lo)
    return lo, hi


@functools.partial(jax.jit, static_argnames=("cfg", "batch", "beta_static"))
def replay_sample_indices(cfg: ReplayConfig, state: ReplayState, key,
                          batch: int, beta: float = 0.4,
                          beta_static: bool = False):
    """Sample (env, col) pairs + normalized importance weights.

    Uniform: iid over the valid unwrapped range, all weights 1.
    PER: stratified sum-tree descend; weights (N*P)^-beta / max.
    Returns dict(env, col, leaf, weight, num_valid).
    """
    del beta_static
    E, T = cfg.num_envs, cfg.steps_per_env
    lo, hi = valid_range(cfg, state.t)
    num_valid = (hi - lo) * E

    if not cfg.prioritized:
        ukey, ekey = jax.random.split(key)
        u = lo + jax.random.randint(ukey, (batch,), 0, jnp.maximum(hi - lo, 1))
        env = jax.random.randint(ekey, (batch,), 0, E)
        col = jnp.mod(u, T)
        return dict(env=env, col=col.astype(jnp.int32),
                    leaf=_flat_leaf(cfg, env, col),
                    weight=jnp.ones((batch,), jnp.float32),
                    num_valid=num_valid)

    st = _tree_ops(cfg)
    leaf, prio = st.sample(state.tree, key, batch)
    env = leaf // T
    col = leaf - env * T
    tot = st.total(state.tree)
    p = prio / jnp.maximum(tot, 1e-30)
    w = (num_valid.astype(jnp.float32) * p) ** (-beta)
    # Belt-and-braces: the descend cannot land on a zero leaf while
    # total > 0, but a zero weight (not inf/NaN) is the safe failure.
    w = jnp.where(prio > 0, w, 0.0)
    w = w / jnp.maximum(jnp.max(w), 1e-30)
    return dict(env=env.astype(jnp.int32), col=col.astype(jnp.int32),
                leaf=leaf, weight=w.astype(jnp.float32),
                num_valid=num_valid)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(1,))
def replay_update_priorities(cfg: ReplayConfig, state: ReplayState,
                             leaf: jnp.ndarray,
                             td_abs: jnp.ndarray,
                             keep=None) -> ReplayState:
    """Write |TD|-derived priorities back after a learner step.

    p = (|td| + min_priority)^alpha. Updates to leaves that have been
    zeroed since sampling (overwritten by inserts) are dropped so dead
    entries cannot be resurrected. `keep` (optional (B,) 0/1 mask)
    writes priority 0 instead — used to DRAIN entries the learner
    excluded (truncation-biased windows, ops/returns.truncation_mask).
    """
    if not cfg.prioritized:
        return state
    p = (td_abs + cfg.min_priority) ** cfg.alpha
    if keep is not None:
        p = p * keep.astype(p.dtype)
    st = _tree_ops(cfg)
    cur = st.get(state.tree, leaf)
    p = jnp.where(cur > 0, p, 0.0)
    tree = st.set_priorities(state.tree, leaf, p)
    max_p = jnp.maximum(state.max_priority, jnp.max(p))
    return state.replace(tree=tree, max_priority=max_p)


def replay_gather_window(cfg: ReplayConfig, state: ReplayState,
                         env: jnp.ndarray, col: jnp.ndarray,
                         length: int, fields=None) -> Dict[str, jnp.ndarray]:
    """Gather [col, col+length) (mod T) per sampled (env, col).

    Returns each requested field shaped (B, length, ...). `length` must
    be <= horizon+1 for sampled indices to be fully valid.
    """
    T = cfg.steps_per_env
    offs = jnp.arange(length, dtype=jnp.int32)
    cols = jnp.mod(col[:, None] + offs[None, :], T)      # (B, length)
    names = fields if fields is not None else list(state.storage)
    return {
        name: state.storage[name][env[:, None], cols]
        for name in names
    }


def replay_gather_at(cfg: ReplayConfig, state: ReplayState,
                     env: jnp.ndarray, col: jnp.ndarray,
                     fields=None) -> Dict[str, jnp.ndarray]:
    """Gather single columns per sample: field -> (B, ...)."""
    T = cfg.steps_per_env
    cols = jnp.mod(col, T)
    names = fields if fields is not None else list(state.storage)
    return {name: state.storage[name][env, cols] for name in names}


def frame_stack_gather(cfg: ReplayConfig, state: ReplayState,
                       env: jnp.ndarray, col: jnp.ndarray,
                       num_frames: int, obs_field: str = "obs",
                       done_field: str = "done") -> jnp.ndarray:
    """Reconstruct stacked observations (B, num_frames, ...) on device.

    Frames are stored singly (4x memory saving vs storing stacks — the
    lazy-frames idea executed as a device gather). Frames belonging to a
    previous episode (a `done` at column c-j, j>=1, resets the stack)
    are zeroed — matching the actor-side stacker in acting/actor.py.
    Stack order: index 0 is the OLDEST frame.
    """
    T = cfg.steps_per_env
    offs = jnp.arange(num_frames - 1, -1, -1, dtype=jnp.int32)  # old..new
    cols = jnp.mod(col[:, None] - offs[None, :], T)
    frames = state.storage[obs_field][env[:, None], cols]
    if num_frames == 1:
        return frames
    # done[c-j] for j in [1, num_frames): boundary between c-j and c-j+1.
    dcols = jnp.mod(col[:, None] - jnp.arange(1, num_frames)[None, ::-1], T)
    dones = state.storage[done_field][env[:, None], dcols]  # (B, F-1) old..new
    # frame slot i (i < F-1) is valid iff no done in (c-(F-1-i), c].
    # valid[i] = prod_{j=i..F-2} (1 - done_at_slot_j)
    dnf = dones.astype(frames.dtype)
    rev_cum = jnp.cumprod((1.0 - dnf)[:, ::-1], axis=1)[:, ::-1]
    valid = jnp.concatenate(
        [rev_cum, jnp.ones_like(rev_cum[:, :1])], axis=1)  # (B, F)
    # Cross-episode frames may also be older than the episode start when
    # col is near the episode beginning; the same mask covers that case
    # because the reset `done` sits inside the window.
    shape = (valid.shape[0], valid.shape[1]) + (1,) * (frames.ndim - 2)
    return frames * valid.reshape(shape).astype(frames.dtype)


def _stack_validity(dones: jnp.ndarray, dtype) -> jnp.ndarray:
    """(B, F-1) done flags old..new -> (B, F) frame validity (the
    cumprod rule from frame_stack_gather, factored for reuse)."""
    dnf = dones.astype(jnp.float32)
    rev_cum = jnp.cumprod((1.0 - dnf)[:, ::-1], axis=1)[:, ::-1]
    return jnp.concatenate(
        [rev_cum, jnp.ones_like(rev_cum[:, :1])], axis=1).astype(dtype)


def frame_stack_union_gather(cfg: ReplayConfig, state: ReplayState,
                             env: jnp.ndarray, col: jnp.ndarray,
                             num_frames: int, n_step: int,
                             obs_field: str = "obs",
                             done_field: str = "done"):
    """Both of the FF learner's frame stacks from ONE row gather.

    The stacks at `col` and `col + n_step` overlap in F - n rows; the
    union window [col-F+1, col+n] is F+n rows vs 2F for two separate
    frame_stack_gather calls (for the bench shapes F=4, n=3: 7 rows
    instead of 8, and one gather kernel instead of two). Validity
    masks are applied per slice with the exact frame_stack_gather
    rule, so the result is bit-identical to the two-call path
    (tests/test_replay.py::test_union_gather_matches_two_stacks).
    Returns (obs_t, obs_tn), each (B, num_frames, ...).
    """
    F, n = num_frames, n_step
    assert F > 1, "union gather only pays off for real frame stacks"
    T = cfg.steps_per_env
    W = F + n
    offs = jnp.arange(W, dtype=jnp.int32)          # 0..W-1, old..new
    cols = jnp.mod(col[:, None] - (F - 1) + offs[None, :], T)
    rows = state.storage[obs_field][env[:, None], cols]   # (B, W, ...)
    # done flags between consecutive union rows: done[col-F+1+j] for
    # j in [0, W-1), i.e. the boundary ABOVE row j.
    dcols = jnp.mod(col[:, None] - (F - 1) + offs[None, :-1], T)
    dones = state.storage[done_field][env[:, None], dcols]  # (B, W-1)
    shape0 = (rows.shape[0], F) + (1,) * (rows.ndim - 2)
    v_t = _stack_validity(dones[:, :F - 1], rows.dtype).reshape(shape0)
    v_tn = _stack_validity(dones[:, n:n + F - 1],
                           rows.dtype).reshape(shape0)
    obs_t = rows[:, :F] * v_t
    obs_tn = rows[:, n:n + F] * v_tn
    return obs_t, obs_tn


def frame_stack_union_gather_nhwc(cfg: ReplayConfig, state: ReplayState,
                                  env: jnp.ndarray, col: jnp.ndarray,
                                  num_frames: int, n_step: int,
                                  obs_field: str = "obs",
                                  done_field: str = "done"):
    """Union gather emitted CHANNELS-LAST: (B, H, W, F) stacks.

    Same math as frame_stack_union_gather (one union window, two
    masked slices — bit-identical modulo the axis order), but the
    frame axis lands MINOR-most: one gather per union slot, stacked on
    the last axis, so the conv-ready NHWC tensor comes straight out of
    the gathers and the whole-batch (B, W, H, Wd) -> NHWC relayout
    copy between gather and conv never exists.
    Used by the learner when the model is configured channels_last.
    Returns (obs_t, obs_tn), each (B, ..., num_frames).
    """
    F, n = num_frames, n_step
    assert F > 1, "union gather only pays off for real frame stacks"
    T = cfg.steps_per_env
    W = F + n
    ring = state.storage[obs_field]
    slots = [ring[env, jnp.mod(col - (F - 1) + j, T)]   # (B, H, Wd)
             for j in range(W)]
    rows = jnp.stack(slots, axis=-1)                    # (B, H, Wd, W)
    offs = jnp.arange(W - 1, dtype=jnp.int32)
    dcols = jnp.mod(col[:, None] - (F - 1) + offs[None, :], T)
    dones = state.storage[done_field][env[:, None], dcols]  # (B, W-1)
    shape0 = (rows.shape[0],) + (1,) * (rows.ndim - 2) + (F,)
    v_t = _stack_validity(dones[:, :F - 1], rows.dtype).reshape(shape0)
    v_tn = _stack_validity(dones[:, n:n + F - 1],
                           rows.dtype).reshape(shape0)
    obs_t = rows[..., :F] * v_t
    obs_tn = rows[..., n:n + F] * v_tn
    return obs_t, obs_tn
