"""Train CLI (SURVEY.md §1 L0; §3.1).

    python -m rltime_tpu.train <config-or-preset> [--key.sub=value ...]
                               [--result-dir DIR] [--cpu]

`<config>` is a JSON path or a preset name under configs/
(cartpole_dqn, pong_dqn, breakout_iqn, atari_r2d2, apex_multihost).
Dotted overrides compose onto the loaded config. The compile cache
follows `JAX_COMPILATION_CACHE_DIR`, else `<checkout>/.jax_cache/`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", help="JSON config path or preset name")
    parser.add_argument("--result-dir", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="force the CPU backend (8 virtual devices)")
    parser.add_argument("--resume", action="store_true")
    args, overrides = parser.parse_known_args(argv)

    import jax
    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    from rltime_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from rltime_tpu.config.config import apply_overrides, load_config

    cfg = load_config(args.config)
    cfg = apply_overrides(cfg, [o for o in overrides if "=" in o])
    if args.resume:
        cfg.setdefault("train", {})["resume"] = True

    name = os.path.splitext(os.path.basename(args.config))[0]
    result_dir = args.result_dir or os.path.join(
        "results", f"{name}-{time.strftime('%Y%m%d-%H%M%S')}")
    print(f"result dir: {result_dir}")
    print(json.dumps(cfg, indent=2))

    kind = cfg.get("train", {}).get("trainer", "default")
    if kind == "fused":
        from rltime_tpu.parallel.fused import FusedApexTrainer
        trainer = FusedApexTrainer(cfg, result_dir)
    elif kind == "apex":
        from rltime_tpu.parallel.apex import ApexTrainer
        trainer = ApexTrainer(cfg, result_dir)
    else:
        from rltime_tpu.training.trainer import Trainer
        trainer = Trainer(cfg, result_dir)
    trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
