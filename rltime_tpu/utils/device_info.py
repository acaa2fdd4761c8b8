"""The accelerator a measurement ran on: its identity, its published
peaks, and the check that there is one.

Every benchmark line names the device (JAX platform, `device_kind`,
count) and the card as `nvidia-smi` reports it (name, power limit: a
card set below its maximum power runs slower under load). A device
whose peak is not in `PEAKS` is an error, never an assumed default.
"""
from __future__ import annotations

import subprocess
from typing import Dict, List

# Published dense bf16 FLOP/s per `jax.devices()[0].device_kind`.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, without
# sparsity, at the full 700 W power limit.
PEAKS: Dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak(device_kind: str) -> float:
    """Published dense bf16 FLOP/s of `device_kind`; KeyError if
    unknown."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peak for device_kind {device_kind!r}; add it "
            "to rltime_tpu/utils/device_info.PEAKS with its source")
    return PEAKS[device_kind]


def nvidia_smi_cards() -> List[str]:
    """One `name, power.limit` line per GPU, as nvidia-smi prints them
    (`--query-gpu=name,power.limit --format=csv,noheader`)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def require_gpu() -> Dict[str, object]:
    """The JAX device record; raises SystemExit unless the default
    backend is a GPU (a measurement never falls back to the CPU)."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is {backend!r}")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
