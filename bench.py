"""Benchmark: on-device throughput of the two production pipelines on
one GPU.

1. LEARNER pipeline: the steady-state jitted update cycle of the Atari
   double/dueling n-step PER config (BASELINE.json config #2 shapes),
   S x (chunk insert + K updates) per dispatch — built by
   rltime_tpu/utils/benchprog.py (the same definition the profiling
   tools dump/trace).
2. FULL acting+learning loop (env-steps/s): the fused one-dispatch
   SPMD superstep (parallel/fused.py) on the on-device MinAtar Breakout
   workload — device env dynamics + policy + replay insert + PER
   updates, zero host round trips.

Also reports achieved model TFLOP/s and MFU for the learner program:
FLOPs from XLA's cost analysis of the lowered program (fallback: an
analytic conv/fc count), divided by the published bf16 peak of the
device (rltime_tpu/utils/device_info.PEAKS, keyed by device_kind; an
unknown device is an error).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "update_tflops_per_s": N,
   "mfu_pct_bf16": N, "minatar_env_steps_per_s": N, "platform": ...,
   "device_kind": ..., "device_count": N, "cards": [...]}

Exits non-zero without a GPU.
"""
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _bench_learner():
    """Learner superstep bench. Returns (transitions/s, flops/dispatch)."""
    import jax
    from rltime_tpu.utils import benchprog

    p = benchprog.build()
    beta = jax.numpy.float32(0.4)

    # compile + warmup
    warm = p.stacked(50)
    # FLOPs from the HLO cost model of the lowered program
    flops = None
    try:
        ca = p.superstep.lower(p.tstate, p.rstate, beta,
                               warm).cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0)) or None
    except Exception:
        flops = None
    tstate, rstate, metrics = p.superstep(p.tstate, p.rstate, beta,
                                          warm)
    float(np.asarray(metrics["loss"]))

    # 4 dispatches x S=64 chunks x K=1 update x batch 1024 = 262,144
    # transitions timed
    dispatches = 4
    # Pregenerate + pre-transfer insert chunks so the timed region
    # measures the DEVICE pipeline (sample/gather/fwd/bwd/priorities +
    # inserts), not host-side numpy RNG.
    device_chunks = [p.stacked(100 + p.S * i) for i in range(dispatches)]
    float(np.asarray(device_chunks[-1]["reward"][0, 0, 0]))

    t0 = time.perf_counter()
    for i in range(dispatches):
        tstate, rstate, metrics = p.superstep(tstate, rstate, beta,
                                              device_chunks[i])
    float(np.asarray(metrics["loss"]))   # drains the whole chain
    dt = time.perf_counter() - t0

    updates = dispatches * p.S * p.K
    tx_per_s = updates * p.batch / dt
    if flops is None:
        flops = _analytic_flops_per_dispatch(p)
    flops_per_s = flops * dispatches / dt
    return tx_per_s, flops_per_s


def _analytic_flops_per_dispatch(p):
    """Fallback analytic FLOPs: Nature-CNN fwd (conv+fc matmul MACs*2)
    x batch x 3 forwards (online s, target s', online s') + ~2x fwd
    for the backward of the one differentiated forward, per update."""
    convs = [(84, 8, 4, 4, 32), (20, 4, 2, 32, 64), (9, 3, 1, 64, 64)]
    f = 0.0
    for size, k, s, cin, cout in convs:
        out = (size - k) // s + 1
        f += 2.0 * out * out * cout * k * k * cin
    f += 2.0 * 7 * 7 * 64 * 512            # fc
    f += 2.0 * (512 * 256 * 2 + 256 * 7)   # dueling head (V+A)
    per_update = p.batch * f * (3 + 2)
    return per_update * p.S * p.K


def _bench_minatar_fused():
    """Full on-chip acting+learning loop: fused superstep, MinAtar
    Breakout flagship shapes. Returns env-steps/s."""
    import jax
    from rltime_tpu.parallel.fused import FusedApexTrainer
    from rltime_tpu.parallel.mesh import make_mesh

    cfg = {
        "seed": 0,
        "env": {"type": "minatar_breakout", "num_envs": 256},
        "model": {"torso": "minatar_cnn", "cnn_channels": [16],
                  "cnn_fc": 128, "head": "dueling"},
        "replay": {"steps_per_env": 512, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 256, "n_step": 3,
                 "double_q": True, "lr": 2.5e-4,
                 "target_update_freq": 500},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 0.05, "anneal_steps": 200_000},
        # Long chunks at the recipe ratio (2 updates per env step,
        # batch 256): fewer chunk boundaries amortize the per-chunk
        # insert + scan epilogue. L=256 is excluded by the ring-safety
        # constraint (steps_per_env >= 2*(L+n)). Learning validated
        # in-band at this cadence: Breakout 5M greedy eval 12.3 (band
        # ~12-16). The presets run L=32/u=64/S=4.
        "train": {"total_env_steps": 10**9, "warmup_env_steps": 0,
                  "chunk_len": 128, "updates_per_chunk": 256,
                  "log_interval": 10**9,
                  "supersteps_per_dispatch": 1},
    }
    t = FusedApexTrainer(cfg, tempfile.mkdtemp(),
                         mesh=make_mesh(jax.devices()[:1]))
    # compile + warm (also fills the replay past sampling range)
    for _ in range(2):
        m = t.superstep()
    float(np.asarray(m["loss"]))

    dispatches = 6
    s0 = t.env_steps
    t0 = time.perf_counter()
    for _ in range(dispatches):
        m = t.superstep()
    float(np.asarray(m["loss"]))
    dt = time.perf_counter() - t0
    return (t.env_steps - s0) / dt


def main():
    from rltime_tpu.utils import device_info
    from rltime_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = device_info.require_gpu()
    cards = device_info.nvidia_smi_cards()
    peak = device_info.peak(dev["kind"])

    tx_per_s, flops_per_s = _bench_learner()
    env_steps_per_s = _bench_minatar_fused()

    print(json.dumps({
        "metric": "learner_transitions_per_s_single_chip",
        "value": tx_per_s,
        "unit": "transitions/s",
        "update_tflops_per_s": flops_per_s / 1e12,
        "mfu_pct_bf16": 100 * flops_per_s / peak,
        "minatar_env_steps_per_s": env_steps_per_s,
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "cards": cards,
    }))


if __name__ == "__main__":
    main()
