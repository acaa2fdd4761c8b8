"""Dump the optimized HLO of bench.py's learner superstep; list copies.

Prints every `copy` instruction that moves a ring-shaped array, with
its shape and layout, so ring-sized relayout copies can be attributed
(companion to tools/profile_bench.py). The program is built by the
same rltime_tpu/utils/benchprog.py definition bench.py runs.

    python tools/dump_superstep_hlo.py [out.txt]
    python tools/dump_superstep_hlo.py --fused

`--fused` compiles the fused superstep on an 8-device CPU mesh and
prints its collective census.
"""
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(out_path: str):
    import jax.numpy as jnp

    from rltime_tpu.utils import benchprog
    from rltime_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = benchprog.build()
    beta = jnp.float32(0.4)
    txt = p.superstep.lower(p.tstate, p.rstate, beta,
                            p.stacked(1)).compile().as_text()
    with open(out_path, "w") as f:
        f.write(txt)
    print(f"wrote {len(txt)} bytes to {out_path}")

    # copies whose operand or result is ring-shaped (E, T, ...)
    ring = f"[{benchprog.E},{benchprog.T}"
    n = 0
    for line in txt.splitlines():
        s = line.strip()
        if (re.search(r"\scopy(-start)?\(", s)
                and any(f"{dt}{ring}" in s for dt in ("u8", "f32", "pred",
                                                      "s32"))):
            n += 1
            print(s[:220])
    print(f"ring-sized copies: {n}")
    for line in txt.splitlines():
        if "entry_computation_layout" in line:
            print(line.strip()[:400])


def main_fused():
    """--fused: compile the fused superstep on the 8-device CPU mesh
    and print the collective census + the bytes each device sends per
    superstep (the structural version is pinned by
    tests/test_collective_census.py)."""
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import PartitionSpec as P
    import tempfile

    from rltime_tpu.parallel.fused import FusedApexTrainer
    from rltime_tpu.parallel.mesh import make_global_array
    from rltime_tpu.utils.hlo_census import (
        collective_census, summarize)

    cfg = {
        "seed": 0,
        "env": {"type": "minatar_breakout", "num_envs": 64},
        "model": {"torso": "minatar_cnn", "cnn_channels": [16],
                  "cnn_fc": 128, "head": "dueling"},
        "replay": {"steps_per_env": 512, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 256, "n_step": 3,
                 "double_q": True, "lr": 2.5e-4,
                 "target_update_freq": 500},
        "train": {"total_env_steps": 10**9, "warmup_env_steps": 0,
                  "chunk_len": 16, "updates_per_chunk": 32,
                  "log_interval": 10**9,
                  "supersteps_per_dispatch": 1},
    }
    t = FusedApexTrainer(cfg, tempfile.mkdtemp())
    eps = make_global_array(t._eps(t.loop_cfg.chunk_len), t.mesh,
                            P(None, "data"))
    beta = make_global_array(np.float32(0.4), t.mesh, P())
    lowered = t._super.lower(t.train_state, t.actor_state,
                             t.replay_state, eps, beta)
    ents = collective_census(lowered.compile().as_text())
    print(summarize(ents))
    d = t.num_shards
    K = t.loop_cfg.updates_per_chunk
    params_b = sum(x.size * x.dtype.itemsize
                   for x in jax.tree.leaves(t.train_state.params))
    total_b = sum(e["bytes"] for e in ents)
    # ring-allreduce wire model: each all-reduce moves
    # 2*(d-1)/d * payload per device over the interconnect; the
    # combined grad all-reduce (+ metric pmeans) sits INSIDE the
    # K-update scan body, so it executes K times per superstep
    wire = K * sum(e["bytes"] * 2 * (d - 1) / d for e in ents)
    ca = lowered.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    print(f"\nd={d} K={K} params={params_b:,d} B  "
          f"census_total={total_b:,d} B  "
          f"wire_per_device={wire:,.0f} B/superstep")
    if flops:
        print(f"flops/superstep={flops:,.0f}  "
              f"arith-intensity vs interconnect: "
              f"{flops / max(wire, 1):,.0f} FLOP/wire-byte")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if "--fused" in sys.argv:
        main_fused()
    else:
        main(args[0] if args else "superstep_hlo.txt")
