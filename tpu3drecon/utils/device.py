"""What the accelerator is and what it offers: the one capability module.

Every platform decision in the package goes through here instead of
comparing backend strings at the call site.  Nothing in this module touches
the jax backend at import time.
"""

from __future__ import annotations

import shutil
import subprocess
from dataclasses import asdict, dataclass
from typing import Optional, Sequence

import jax


class NoAcceleratorError(RuntimeError):
    """A measurement path found only the CPU backend."""


@dataclass(frozen=True)
class DeviceInfo:
    """The device a result was measured on, as JAX reports it."""

    platform: str  # jax.devices()[0].platform: "gpu", "cpu", ...
    device_kind: str  # e.g. "NVIDIA H100 80GB HBM3"
    count: int  # len(jax.devices())

    def as_dict(self) -> dict:
        return asdict(self)


def device_info(devices: Optional[Sequence] = None) -> DeviceInfo:
    """Platform, kind and count of ``devices`` (default: ``jax.devices()``)."""
    devs = list(jax.devices() if devices is None else devices)
    if not devs:
        raise RuntimeError("JAX reports no devices")
    return DeviceInfo(
        platform=devs[0].platform,
        device_kind=devs[0].device_kind,
        count=len(devs),
    )


def require_accelerator(
    devices: Optional[Sequence] = None, what: str = "this measurement"
) -> DeviceInfo:
    """``device_info`` for a measurement path: refuses the CPU backend.

    A measurement that silently ran on the host would be reported as an
    accelerator number, so a missing accelerator is an error here, never a
    fallback.  Callers that mean to run on the CPU say so explicitly
    (``--cpu``) and skip this check."""
    info = device_info(devices)
    if info.platform == "cpu":
        raise NoAcceleratorError(
            f"{what} needs an accelerator, but JAX found only the CPU "
            f"backend ({info.count} device(s)); pass --cpu to run on the "
            "host on purpose"
        )
    return info


def memory_bytes(device=None) -> int:
    """Bytes the allocator may hand out on ``device`` (default: the first),
    from ``memory_stats()["bytes_limit"]``.  Raises when the backend does
    not report it: a guessed capacity would size buffers for another card."""
    dev = jax.devices()[0] if device is None else device
    stats = dev.memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    if limit <= 0:
        raise RuntimeError(
            f"device {dev} ({dev.platform}) does not report its memory "
            "limit (memory_stats()['bytes_limit'])"
        )
    return limit


def peak_bytes_in_use(device=None) -> Optional[int]:
    """``memory_stats()["peak_bytes_in_use"]``, or None where unreported."""
    dev = jax.devices()[0] if device is None else device
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return None if peak is None else int(peak)


def nvidia_smi_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per
    card), or None where there is no ``nvidia-smi``.  Runs a child process
    that stays off JAX, so it never competes for the card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip()
