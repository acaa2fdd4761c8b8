"""IQN and R2D2 learner throughput legs.

The learner bench is DQN-shaped; these legs record device tx/s for the
other two update programs at config-#3/#4-like Atari shapes so
regressions there are visible:

  iqn_b256_k4   IQN (64x64 pairwise quantile-Huber, dueling-free
                head), batch 256 x 4 updates/chunk (1024 tx ratio)
  iqn_b1024_k1  same at the DQN-bench batch shape
  r2d2_b32_k1   R2D2 seq update: burn 40 + train 80 + n 3 window
                gathers, Nature CNN per step, LSTM-512 scan unroll,
                batch 32 sequences (2560 trained tx per update)
  r2d2_b64_k1   batch 64 sequences

tx/s counts transitions CONSUMED (R2D2: batch x seq_len). Compare
legs only within one process. Usage:
python tools/bench_algo_legs.py [leg ...]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LEGS = {
    "dqn_base": dict(algo="dqn"),
    "iqn_b256_k4": dict(algo="iqn", batch=256, k=4),
    "iqn_b1024_k1": dict(algo="iqn", batch=1024, k=1),
    "r2d2_b32_k1": dict(algo="r2d2", batch=32, k=1, supersteps=8),
    "r2d2_b64_k1": dict(algo="r2d2", batch=64, k=1, supersteps=8),
}


def run_leg(name, overrides, dispatches=4):
    import jax
    from rltime_tpu.utils import benchprog

    t0 = time.perf_counter()
    p = benchprog.build(**overrides)
    beta = jax.numpy.float32(0.4)
    warm = p.stacked(50)
    tstate, rstate, metrics = p.superstep(p.tstate, p.rstate, beta,
                                          warm)
    loss0 = float(np.asarray(metrics["loss"]))
    compile_s = time.perf_counter() - t0

    chunks = [p.stacked(100 + p.S * i) for i in range(dispatches)]
    float(np.asarray(chunks[-1]["reward"][0, 0, 0]))
    t0 = time.perf_counter()
    for i in range(dispatches):
        tstate, rstate, metrics = p.superstep(tstate, rstate, beta,
                                              chunks[i])
    float(np.asarray(metrics["loss"]))
    dt = time.perf_counter() - t0
    tx = dispatches * p.S * p.K * p.tx_per_update / dt
    upd = dispatches * p.S * p.K / dt
    print(f"RESULT {name}: {tx:,.0f} tx/s  {upd:,.1f} updates/s  "
          f"(compile+warm {compile_s:.1f}s, loss0 {loss0:.4f})",
          flush=True)
    return tx


def main():
    from rltime_tpu.utils.compile_cache import enable_compile_cache
    from rltime_tpu.utils.device_info import require_gpu
    enable_compile_cache()
    print(require_gpu(), flush=True)
    names = sys.argv[1:] or list(LEGS)
    for n in names:
        print(f"--- building {n} ...", flush=True)
        run_leg(n, LEGS[n])


if __name__ == "__main__":
    main()
