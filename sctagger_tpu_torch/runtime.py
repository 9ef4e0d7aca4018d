"""Device selection for the port (counterpart of jax.default_backend()).

Devices are explicit: library functions take a ``device`` argument, and
``default_device()`` is consulted only where the caller gave none.
"""

from __future__ import annotations

import sys

import torch


def default_device() -> torch.device:
    """``cuda`` when torch sees a GPU, else ``cpu``; the choice goes to
    stderr so a run's log always names the device it ran on."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "host"
    print(f"[sctagger_tpu_torch] device: {dev.type} ({name})", file=sys.stderr)
    return dev


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device (default_device() when None). Asking for
    cuda on a machine without one raises: the port never falls back."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
