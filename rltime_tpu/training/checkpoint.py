"""Checkpoint/resume (SURVEY.md §5.4).

Checkpoints of {params, target params, opt state, PRNG key, counters}
plus host-side counters — enough for deterministic resume (the
fixed-seed parity bar). Replay contents are optionally included (off
by default, matching the reference's model-only checkpoints).

Format: `checkpoints/<step>/arrays.npz` holds every leaf as a host
numpy array; `tree.json` maps each leaf's pytree path to its entry.
A save is written to a hidden temporary directory and renamed into
place, so a reader never sees a half-written step.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from rltime_tpu.training.learner import TrainState


def _is_key(x) -> bool:
    return (hasattr(x, "dtype")
            and jnp.issubdtype(x.dtype, jax.dtypes.prng_key))


def _strip_keys(tree):
    """Typed PRNG key leaves -> raw uint32 key data (serializable)."""
    return jax.tree.map(
        lambda x: np.asarray(jax.random.key_data(x)) if _is_key(x)
        else x, tree)


def _rewrap_keys(example, restored):
    """Re-type restored raw key data wherever `example` had a key."""
    def f(ex, x):
        if _is_key(ex):
            return jax.random.wrap_key_data(
                jnp.asarray(x), impl=jax.random.key_impl(ex))
        return x
    return jax.tree.map(f, example, restored)


def _path_entry(k) -> list:
    """One pytree path element as JSON: ["d", key] for dict keys and
    dataclass fields, ["s", index] for sequence positions."""
    if isinstance(k, jax.tree_util.DictKey):
        return ["d", k.key]
    if isinstance(k, jax.tree_util.GetAttrKey):
        return ["d", k.name]
    if isinstance(k, jax.tree_util.SequenceKey):
        return ["s", k.idx]
    raise TypeError(f"unsupported pytree path element {k!r}")


def _path_id(path) -> str:
    return json.dumps([_path_entry(k) for k in path])


def _write(path: str, tree) -> None:
    """Host-side write of `tree` (no collective: only the caller's
    process takes part, so a lead-only save cannot deadlock a
    multi-process run)."""
    leaves = jax.tree_util.tree_flatten_with_path(_strip_keys(tree))[0]
    arrays = {f"a{i}": np.asarray(jax.device_get(x))
              for i, (_, x) in enumerate(leaves)}
    index = {_path_id(p): f"a{i}" for i, (p, _) in enumerate(leaves)}
    parent, name = os.path.split(path)
    tmp = os.path.join(parent, f".{name}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump(index, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _as_plain(entries) -> Any:
    """Nested dicts/lists from [(path entries, array)] (no example)."""
    root: dict = {}
    for keys, x in entries:
        node = root
        for kind, k in keys[:-1]:
            node = node.setdefault((kind, k), {})
        node[tuple(keys[-1])] = x

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(kind == "s" for kind, _ in node):
            return [build(node[k]) for k in sorted(node)]
        return {k: build(v) for (_, k), v in node.items()}
    return build(root)


def save(result_dir: str, step: int, train_state: TrainState,
         host_state: Dict[str, Any], replay_state=None,
         extra: Optional[Dict[str, Any]] = None):
    """`extra`: additional top-level pytrees (e.g. the fused trainer's
    actor_state, or the Ape-X actor's PRNG key) saved alongside."""
    path = os.path.abspath(os.path.join(result_dir, "checkpoints",
                                        str(step)))
    ckpt = {
        "train_state": train_state,
        "host_state": host_state,
    }
    if replay_state is not None:
        ckpt["replay_state"] = replay_state
    if extra:
        ckpt.update(extra)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write(path, ckpt)
    return path


def latest_step(result_dir: str) -> Optional[int]:
    d = os.path.join(result_dir, "checkpoints")
    if not os.path.isdir(d):
        return None
    steps = [int(x) for x in os.listdir(d) if x.isdigit()]
    return max(steps) if steps else None


def record_best(result_dir: str, step: int, score: float,
                best_only: bool = False) -> None:
    """Mark the checkpoint at `step` as the best-scoring one so far
    (training-time episode return mean). `best_only` records whether
    the checkpoint dir exists SOLELY for best-tracking (i.e. is not
    also an interval/final checkpoint) — such dirs are reclaimed by
    `maybe_record_best` when a newer best supersedes them."""
    d = os.path.join(result_dir, "checkpoints")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "best.json"), "w") as f:
        json.dump({"step": int(step), "score": float(score),
                   "best_only": bool(best_only)}, f)


def maybe_record_best(result_dir: str, best_score: float,
                      mean_return: float, n_episodes: int,
                      min_episodes: int, env_steps: int, save_fn,
                      protected_steps=(), lead: bool = True) -> float:
    """Best-checkpoint rule shared by Trainer and FusedApexTrainer.

    Snapshot whenever the log-interval episode mean (over at least
    `min_episodes` episodes) makes a new high; `eval --best` loads the
    marked step. Returns the updated best score (== `best_score` when
    no new best). When a new best is recorded, the PREVIOUS best
    checkpoint dir is deleted iff it was created solely by best
    tracking (`best_only` in best.json) and is not in
    `protected_steps` (interval/final checkpoint steps) — so a
    steadily improving long run keeps exactly ONE best snapshot
    instead of accumulating dozens.

    Multi-process: every process must call this with IDENTICAL
    (globally pooled) stats — the decision and `save_fn` (collective
    sidecar save) run everywhere, while best.json + GC are lead-only
    (`lead=False` skips them)."""
    if n_episodes < min_episodes or mean_return <= best_score:
        return best_score
    prev = best_step(result_dir)
    save_fn()
    if not lead:
        return mean_return
    protected = set(int(s) for s in protected_steps)
    record_best(result_dir, env_steps, mean_return,
                best_only=env_steps not in protected)
    if (prev is not None and prev.get("best_only")
            and int(prev["step"]) != int(env_steps)
            and int(prev["step"]) not in protected):
        shutil.rmtree(os.path.join(result_dir, "checkpoints",
                                   str(prev["step"])),
                      ignore_errors=True)
        # the fused trainer writes matching per-process sidecars under
        # checkpoints_aux/<step>/ — reclaim them too (advisor r4: an
        # improving run otherwise accumulates orphaned sidecar dirs)
        shutil.rmtree(os.path.join(result_dir, "checkpoints_aux",
                                   str(prev["step"])),
                      ignore_errors=True)
    return mean_return


def unmark_best_only(result_dir: str, step: int) -> None:
    """An interval/final save at a step previously recorded as
    best_only upgrades it to a protected checkpoint: clear the
    best_only flag so a post-resume new best cannot GC it (the live
    _protected_steps set shields it in-process, but resume-time
    reconstruction excludes the best_only step — advisor-class
    finding, r5)."""
    b = best_step(result_dir)
    if (b is not None and int(b["step"]) == int(step)
            and b.get("best_only")):
        record_best(result_dir, int(b["step"]), float(b["score"]),
                    best_only=False)


def derive_protected_steps(result_dir: str) -> set:
    """Resume-time reconstruction of interval/final checkpoint steps:
    every existing checkpoint dir except the one best.json marks
    best_only (shared by the fused and apex trainers)."""
    ckdir = os.path.join(result_dir, "checkpoints")
    if not os.path.isdir(ckdir):
        return set()
    b = best_step(result_dir)
    bo = (int(b["step"]) if b is not None and b.get("best_only")
          else None)
    return {int(x) for x in os.listdir(ckdir)
            if x.isdigit() and int(x) != bo}


def best_step(result_dir: str) -> Optional[Dict[str, Any]]:
    """{"step": int, "score": float} of the best checkpoint, or None."""
    p = os.path.join(result_dir, "checkpoints", "best.json")
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return json.load(f)


def restore(result_dir: str, step: Optional[int] = None,
            example: Optional[dict] = None) -> Dict[str, Any]:
    """Load a checkpoint as host numpy arrays. With `example`, the
    result has its structure (dataclasses and typed PRNG keys
    included); without one, plain nested dicts and lists."""
    if step is None:
        step = latest_step(result_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {result_dir!r}")
    path = os.path.abspath(os.path.join(result_dir, "checkpoints",
                                        str(step)))
    with open(os.path.join(path, "tree.json")) as f:
        index = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        if example is not None:
            paths, treedef = jax.tree_util.tree_flatten_with_path(
                _strip_keys(example))
            restored = jax.tree_util.tree_unflatten(
                treedef, [arrays[index[_path_id(p)]] for p, _ in paths])
            restored = _rewrap_keys(example, restored)
        else:
            restored = _as_plain([(json.loads(p), arrays[a])
                                  for p, a in index.items()])
    restored["step"] = step
    return restored
