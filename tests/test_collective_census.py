"""d=8 collective census of the compiled fused superstep (VERDICT r4
Next #3): the scaling claim's in-sandbox evidence.

parallel/mesh.py promises the sample/gather/insert plane is
shard-local — the ONLY interconnect traffic per superstep is the
replicated plane: gradient pmeans (params-sized), scalar metric
pmeans, and t/max_priority pmaxes. These tests pin that structurally
on the REAL compiled 8-device program, so a future change cannot
silently add a sample-path all-to-all or a storage-sized all-gather.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from rltime_tpu.utils.hlo_census import collective_census, summarize


def _fused_trainer(tmp_path, algo="dqn"):
    from rltime_tpu.parallel.fused import FusedApexTrainer
    cfg = {
        "seed": 0,
        # image env (uint8 ring) so a storage-sized collective would
        # dwarf the byte cap by >4x
        "env": {"type": "minatar_breakout", "num_envs": 8},
        "model": {"torso": "minatar_cnn", "cnn_channels": [16],
                  "cnn_fc": 128, "head": "dueling"},
        "replay": {"steps_per_env": 4096, "prioritized": True},
        "algo": {"algo": algo, "batch_size": 32, "n_step": 3,
                 "double_q": True, "lr": 1e-3,
                 "target_update_freq": 100},
        "train": {"total_env_steps": 10**6, "warmup_env_steps": 0,
                  "chunk_len": 16, "updates_per_chunk": 2,
                  "log_interval": 10**9,
                  "supersteps_per_dispatch": 1},
    }
    return FusedApexTrainer(cfg, str(tmp_path / f"census_{algo}"))


def _compiled_text(t):
    from rltime_tpu.parallel.mesh import make_global_array
    eps = make_global_array(t._eps(t.loop_cfg.chunk_len), t.mesh,
                            P(None, "data"))
    beta = make_global_array(np.float32(0.4), t.mesh, P())
    return t._super.lower(t.train_state, t.actor_state,
                          t.replay_state, eps, beta).compile().as_text()


def test_fused_superstep_collective_census(tmp_path):
    t = _fused_trainer(tmp_path)
    assert t.num_shards == 8
    ents = collective_census(_compiled_text(t))

    # 1) every collective is a pmean/pmax-style all-reduce — no
    #    all-gather / all-to-all / permute anywhere (a sample-path
    #    reshard would show up as one of those)
    ops = {e["op"] for e in ents}
    assert ops <= {"all-reduce"}, summarize(ents)
    assert ents, "expected grad/scalar all-reduces in the program"

    # 2) byte cap: the largest collective payload is bounded by the
    #    replicated plane (params-sized; XLA may combine grad leaves,
    #    so cap at total-params x small slack + metric scalars).
    params_bytes = sum(
        leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree.leaves(t.train_state.params))
    cap = 2 * params_bytes + 4096
    worst = max(e["bytes"] for e in ents)
    assert worst <= cap, summarize(ents)

    # 3) the cap is BINDING vs the sample plane: each shard's obs ring
    #    alone is >4x the cap, so a storage-sized collective trips #2.
    obs = t.replay_state.storage["obs"]
    shard_bytes = (obs.size * obs.dtype.itemsize) // t.num_shards
    assert shard_bytes > 4 * cap

    # 4) bytes-over-interconnect model (d=8 collective census):
    #    per superstep = K x combined-grad all-reduce + scalars. The
    #    census total must be explained by K x params + slack.
    K = t.loop_cfg.updates_per_chunk
    total = sum(e["bytes"] for e in ents)
    assert total <= (K + 1) * params_bytes + 16384, summarize(ents)


def test_fused_r2d2_superstep_collective_census(tmp_path):
    """Same census on the R2D2 sequence-update superstep."""
    from rltime_tpu.parallel.fused import FusedApexTrainer
    cfg = {
        "seed": 0,
        "env": {"type": "cartpole_device", "num_envs": 8},
        "model": {"torso": "mlp", "mlp_hidden": [32],
                  "head": "linear", "lstm_size": 16},
        "replay": {"steps_per_env": 512, "prioritized": True},
        "algo": {"algo": "r2d2", "batch_size": 8, "n_step": 2,
                 "burn_in": 4, "seq_len": 8, "lr": 1e-3,
                 "target_update_freq": 100},
        "train": {"total_env_steps": 10**6, "warmup_env_steps": 0,
                  "chunk_len": 32, "updates_per_chunk": 1,
                  "log_interval": 10**9},
    }
    t = FusedApexTrainer(cfg, str(tmp_path / "census_r2d2"))
    ents = collective_census(_compiled_text(t))
    ops = {e["op"] for e in ents}
    assert ops <= {"all-reduce"}, summarize(ents)
    params_bytes = sum(
        leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree.leaves(t.train_state.params))
    assert max(e["bytes"] for e in ents) <= 2 * params_bytes + 4096, \
        summarize(ents)


def test_census_parser_smoke():
    txt = """
  %ar = f32[128,64]{1,0} all-reduce(f32[128,64]{1,0} %x), to_apply=%add
  %ag.1 = u8[64,1024,10,10,4]{4,3,2,1,0} all-gather(u8[8,1024,10,10,4]{4,3,2,1,0} %s), dimensions={0}
  %ars = (f32[2]{0}, u32[]) all-reduce-start(f32[2]{0} %y), to_apply=%max
  %ard = f32[2]{0} all-reduce-done((f32[2]{0}, u32[]) %ars)
"""
    ents = collective_census(txt)
    assert [e["op"] for e in ents] == ["all-reduce", "all-gather",
                                      "all-reduce"]
    assert ents[0]["bytes"] == 128 * 64 * 4
    assert ents[1]["bytes"] == 64 * 1024 * 10 * 10 * 4
    # async -start: payload counted ONCE (first tuple element), not
    # the whole (operand, result) tuple
    assert ents[2]["bytes"] == 2 * 4
