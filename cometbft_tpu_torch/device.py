"""Where the port's kernels run.

The counterpart of the JAX package's backend probe (crypto/batch.py
`_accel_backend`), with one difference on purpose: there is no silent
host fallback. The kernels are written for Hopper (sm_90a), so
`default_device()` returns the CUDA device only when the card is one, and
raises otherwise. Callers that want the plain PyTorch versions on the host
pass `device="cpu"` explicitly, as the CPU tests do.
"""
from __future__ import annotations

import torch

HOPPER_CAPABILITY = (9, 0)


class DeviceError(RuntimeError):
    pass


def default_device() -> torch.device:
    """The CUDA device the kernels run on; raises if there is none or it is
    not a Hopper card."""
    if not torch.cuda.is_available():
        raise DeviceError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host"
        )
    cap = torch.cuda.get_device_capability(0)
    if tuple(cap) != HOPPER_CAPABILITY:
        raise DeviceError(
            f"the kernels are built for sm_90a; device 0 has compute "
            f"capability {cap[0]}.{cap[1]}"
        )
    return torch.device("cuda", 0)


def resolve(device=None) -> torch.device:
    """`device` as a torch.device, or `default_device()` when None."""
    return default_device() if device is None else torch.device(device)
