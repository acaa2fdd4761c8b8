"""Multi-host Ape-X train CLI (SURVEY.md §5.8, [BJ] config #5).

Launch the SAME command on every host, once per host:

    python -m rltime_tpu.train_distributed apex_multihost \
        [--coordinator HOST:PORT --num-processes N --process-id I] \
        [--key.sub=value ...]

One process per host drives all of that host's GPUs. If several
processes share a host, each must see only its own GPU (set
CUDA_VISIBLE_DEVICES per process): a JAX process reserves most of the
memory of every GPU it opens, so two processes that open the same
cards fail for want of memory. Without coordinator flags this is a
single-process multi-device run on the local devices
(RLTIME_TPU_AUTO_DISTRIBUTED=1 defers to jax.distributed.initialize()'s
own cluster detection instead). The compile cache follows
`JAX_COMPILATION_CACHE_DIR`, else `<checkout>/.jax_cache/`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config")
    parser.add_argument("--result-dir", default=None)
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--cpu", action="store_true")
    args, overrides = parser.parse_known_args(argv)

    import jax
    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    if args.coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id)
    elif int(os.environ.get("RLTIME_TPU_AUTO_DISTRIBUTED", "0")):
        jax.distributed.initialize()
    from rltime_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from rltime_tpu.config.config import apply_overrides, load_config

    cfg = load_config(args.config)
    cfg = apply_overrides(cfg, [o for o in overrides if "=" in o])
    name = os.path.splitext(os.path.basename(args.config))[0]
    result_dir = args.result_dir or os.path.join(
        "results", f"{name}-{time.strftime('%Y%m%d-%H%M%S')}")
    if jax.process_index() == 0:
        print(f"result dir: {result_dir} | devices: "
              f"{len(jax.devices())} global / "
              f"{jax.local_device_count()} local | "
              f"processes: {jax.process_count()}")
        print(json.dumps(cfg, indent=2))
    # train.trainer selects the topology, like rltime_tpu.train:
    # "apex" (default here): host envs, per-process actor shards;
    # "fused": device envs, one-dispatch SPMD superstep per iteration
    # across the whole process-spanning mesh (the flagship path).
    trainer_kind = cfg.get("train", {}).get("trainer", "apex")
    if trainer_kind == "fused":
        from rltime_tpu.parallel.fused import FusedApexTrainer
        FusedApexTrainer(cfg, result_dir).train()
    else:
        from rltime_tpu.parallel.apex import ApexTrainer
        ApexTrainer(cfg, result_dir).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
