"""Mesh plane: sharded replay + data-parallel learner (SURVEY.md §2b,
§3.5, §5.8).

The reference's "distributed layer" is multiprocess actors feeding one
learner over pipes (SURVEY.md §2c). The device-mesh equivalent:

  * a global `jax.sharding.Mesh` with axes ('data', 'model') — 'model'
    reserved/unused (SURVEY.md §2b: cheap future-proofing);
  * replay SHARDED over 'data' on the env axis: each device owns
    E_local = E/d env lanes, their ring columns, and an INDEPENDENT
    per-shard sum tree (SURVEY.md §2b "sampling via per-shard segment
    trees") — sampling never crosses shards, so no collective is paid
    on the sample path;
  * the update step runs under `shard_map`: each device samples B/d
    from its shard, computes grads, `pmean`s them over the interconnect
    (NVLink between GPUs), and applies
    the identical optimizer step — params/opt state stay replicated
    (target-net "broadcast" is free: replicated arrays never move);
  * priority write-back is shard-local; `max_priority` is kept
    coherent with one `pmax` per insert/update.

Everything composes the UNCHANGED single-device functions from
history/replay.py and training/learner.py — the local code IS the
distributed code, shard_map just changes what "E" means.
"""
from __future__ import annotations


import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from rltime_tpu.history.replay import (
    ReplayConfig, ReplayState, replay_init, replay_insert,
)
from rltime_tpu.models.policy import ModelConfig
from rltime_tpu.training.learner import AlgoConfig, TrainState


def make_mesh(devices=None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """Mesh over all (or given) devices: ('data', 'model')."""
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devices) // model
    arr = np.array(devices[:data * model]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def make_global_array(x, mesh: Mesh, spec: P):
    """Host/local array -> GLOBAL array sharded per `spec` over `mesh`.

    Works in true multi-process runs (where the mesh spans devices this
    process cannot address and plain `jax.device_put` is illegal):
    `make_array_from_callback` materializes only the local shards. The
    caller must pass the same `x` on every process.
    """
    x = np.asarray(x)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])


def replicate_global(tree, mesh: Mesh):
    """Replicate a (process-identical) pytree over the full mesh.

    Typed PRNG key leaves are round-tripped through key_data /
    wrap_key_data (numpy can't hold them directly).
    """
    sh = NamedSharding(mesh, P())

    def f(x):
        if (hasattr(x, "dtype")
                and jnp.issubdtype(x.dtype, jax.dtypes.prng_key)):
            impl = jax.random.key_impl(x)
            data = make_global_array(
                np.asarray(jax.random.key_data(x)), mesh, P())
            wrap = functools.partial(jax.random.wrap_key_data,
                                     impl=impl)
            return jax.jit(wrap, out_shardings=sh)(data)
        return make_global_array(x, mesh, P())

    return jax.tree.map(f, tree)


def local_shard_rows(x) -> np.ndarray:
    """This process's rows of a leading-axis-'data'-sharded global
    array, oldest shard first. Typed PRNG key leaves come back as raw
    uint32 key data (serializable). The per-process building block of
    sidecar checkpoints (SURVEY.md §5.4 on the multi-host paths): no
    cross-process data movement, no global-size host allocation."""
    if (hasattr(x, "dtype")
            and jnp.issubdtype(x.dtype, jax.dtypes.prng_key)):
        x = jax.random.key_data(x)
    shards = sorted(x.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def tree_from_local_rows(example, local_tree, mesh: Mesh):
    """Inverse of mapping `local_shard_rows` over a pytree: rebuild the
    'data'-sharded global pytree from each process's own rows.
    `example` supplies key-leaf typing (its leaves may be live arrays
    or shape/dtype skeletons)."""
    sh = NamedSharding(mesh, P("data"))

    def f(ex, x):
        arr = jax.make_array_from_process_local_data(sh, np.asarray(x))
        if (hasattr(ex, "dtype")
                and jnp.issubdtype(ex.dtype, jax.dtypes.prng_key)):
            impl = jax.random.key_impl(ex)
            wrap = functools.partial(jax.random.wrap_key_data,
                                     impl=impl)
            arr = jax.jit(wrap, out_shardings=sh)(arr)
        return arr

    return jax.tree.map(f, example, local_tree)


def sharded_replay_init(local_cfg: ReplayConfig, num_shards: int,
                        field_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                        mesh: Mesh) -> ReplayState:
    """Global replay state for `num_shards` independent shards.

    Layout: storage (d*E_local, T, ...) and tree (d*2N_local,) —
    sharding either on its leading axis over 'data' gives each device
    exactly the local single-device state. NOT a pow2(E_global*T)
    monolithic tree: per-shard trees keep the descend local.
    """
    local = replay_init(local_cfg, field_specs)
    def rep(x, spec):
        # every shard holds an identical copy of the LOCAL init state;
        # the callback serves each device's block from the one local
        # array — no global-size host allocation (matters on pods).
        x = np.asarray(x)
        gshape = (x.shape[0] * num_shards,) + x.shape[1:]
        sh = NamedSharding(mesh, spec)

        def cb(idx):
            start, stop, _ = idx[0].indices(gshape[0])
            return x[(slice(0, stop - start),) + tuple(idx[1:])]

        return jax.make_array_from_callback(gshape, sh, cb)
    storage = {k: rep(v, P("data")) for k, v in local.storage.items()}
    return ReplayState(
        storage=storage,
        t=make_global_array(local.t, mesh, P()),
        tree=rep(local.tree, P("data")),
        max_priority=make_global_array(local.max_priority, mesh, P()),
    )


def replay_partition_specs(state: ReplayState) -> ReplayState:
    """PartitionSpec pytree matching sharded_replay_init's layout."""
    return ReplayState(
        storage={k: P("data") for k in state.storage},
        t=P(),
        tree=P("data"),
        max_priority=P(),
    )


def shard_chunk(chunk: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Place an acting chunk (E_global, L, ...) sharded over 'data'."""
    sh = NamedSharding(mesh, P("data"))
    return {k: jax.device_put(jnp.asarray(v), sh)
            for k, v in chunk.items()}


def make_sharded_insert(local_cfg: ReplayConfig, mesh: Mesh,
                        example_state: ReplayState):
    """shard_map'd insert: every device inserts its local env lanes."""
    specs = replay_partition_specs(example_state)

    def _insert(state, chunk):
        new = replay_insert(local_cfg, state, chunk)
        # keep the replicated scalars coherent across shards
        return new.replace(
            t=jax.lax.pmax(new.t, "data"),
            max_priority=jax.lax.pmax(new.max_priority, "data"))

    chunk_specs = {k: P("data") for k in example_state.storage}
    f = shard_map(_insert, mesh=mesh,
                  in_specs=(specs, chunk_specs),
                  out_specs=specs,
                  check_vma=False)
    return jax.jit(f, donate_argnums=(0,))


def make_sharded_update_step(model_cfg: ModelConfig,
                             algo_cfg: AlgoConfig,
                             local_replay_cfg: ReplayConfig,
                             frame_stack: int, flatten: bool,
                             mesh: Mesh,
                             example_rstate: ReplayState,
                             num_updates: int = 1):
    """shard_map'd learner update (SURVEY.md §3.5).

    algo_cfg.batch_size is the PER-DEVICE batch; the effective global
    batch is batch_size * mesh 'data' size. Gradients pmean over
    'data'; params/opt-state/target stay replicated (out_specs P()).
    num_updates > 1 fuses K updates into one launch via lax.scan
    INSIDE the shard_map (collectives stay in the loop body).
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

    rspecs = replay_partition_specs(example_rstate)

    def _one(tstate, rstate, beta):
        # Decorrelate shard sampling: fold the shard index into the
        # key; the carried key update stays replicated (same split
        # applied everywhere).
        shard = jax.lax.axis_index("data")
        local_t = tstate.replace(
            key=jax.random.fold_in(tstate.key, shard))
        new_t, new_r, metrics = local_update(local_t, rstate, beta)
        # Restore the replicated key stream (split of the shared key).
        new_key = jax.random.split(tstate.key, 3)[0]
        new_t = new_t.replace(key=new_key)
        metrics = jax.tree.map(lambda m: jax.lax.pmean(m, "data"),
                               metrics)
        new_r = new_r.replace(
            max_priority=jax.lax.pmax(new_r.max_priority, "data"))
        return new_t, new_r, metrics

    def _update(tstate, rstate, beta):
        if num_updates == 1:
            return _one(tstate, rstate, beta)

        # Storage stays OUT of the scan carry (read-only in updates;
        # carrying it costs full-ring boundary copies — see
        # learner._scan_updates).
        storage = rstate.storage

        def body(carry, _):
            t, tree, cur, max_p = carry
            r = rstate.replace(storage=storage, tree=tree, t=cur,
                               max_priority=max_p)
            t, r, m = _one(t, r, beta)
            return (t, r.tree, r.t, r.max_priority), m
        carry0 = (tstate, rstate.tree, rstate.t, rstate.max_priority)
        (tstate, tree, cur, max_p), ms = jax.lax.scan(
            body, carry0, None, length=num_updates)
        rstate = rstate.replace(tree=tree, t=cur, max_priority=max_p)
        return tstate, rstate, jax.tree.map(lambda m: m[-1], ms)

    def wrapped(tstate: TrainState, rstate: ReplayState, beta):
        ts_specs = jax.tree.map(lambda _: P(), tstate)
        f = shard_map(
            _update, mesh=mesh,
            in_specs=(ts_specs, rspecs, P()),
            out_specs=(ts_specs, rspecs,
                       jax.tree.map(lambda _: P(),
                                    dict(loss=0, q=0, td_abs=0,
                                         grad_norm=0, mean_weight=0))),
            check_vma=False)
        return f(tstate, rstate, beta)

    return jax.jit(wrapped, donate_argnums=(0, 1))


def pool_process_stats(values, cap: int):
    """Pool per-process scalar stats across ALL processes (a gloo/DCN
    rendezvous — every process must call this at the same point).

    Returns (pooled_values, global_sum, global_count):
      pooled_values — the union multiset via a fixed-shape NaN-padded
        process_allgather, truncated at `cap` entries PER PROCESS
        (order-invariant statistics like mean/median are process-
        count-invariant on it);
      global_sum / global_count — EXACT totals carried alongside, so
        means and episode counts stay unbiased even when a process
        held more than `cap` values (advisor-class finding, r5: a
        silent per-process cap would bias the best-checkpoint
        decision toward early episodes).

    Shared by fused.global_episode_stats (whose source is bounded by
    its stat rings, so cap is exact there) and apex (unbounded
    per-interval episode lists).
    """
    import numpy as np
    vals = np.asarray(values, np.float32).reshape(-1)
    if jax.process_count() == 1:
        return ([float(v) for v in vals], float(vals.sum()),
                int(vals.size))
    from jax.experimental import multihost_utils
    buf = np.full((cap,), np.nan, np.float32)
    n = min(vals.size, cap)
    buf[:n] = vals[:n]
    meta = np.array([vals.sum(dtype=np.float64), vals.size],
                    np.float64)
    g = multihost_utils.process_allgather({"v": buf, "m": meta})
    pooled = [float(x) for x in np.asarray(g["v"]).reshape(-1)
              if not np.isnan(x)]
    m = np.asarray(g["m"]).reshape(-1, 2)
    return pooled, float(m[:, 0].sum()), int(m[:, 1].sum())
