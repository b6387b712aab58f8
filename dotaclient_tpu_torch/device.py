"""Device resolution shared by the port's entry points, and host indices
moved to the device without a synchronisation."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device, and raises when there is none:
    the port never carries on on the CPU unless the caller asks for it with
    ``device="cpu"``. A bare ``"cuda"`` gets the current device's index, so
    devices compare equal."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_index(values, device: torch.device) -> torch.Tensor:
    """An int64 index tensor on ``device`` from host ints (a list, numpy
    array or CPU tensor). On CUDA the ints go through pinned memory with a
    non-blocking copy ordered on the current stream, so the host neither
    waits for the card nor for the copy (a copy from pageable memory would
    synchronise)."""
    if isinstance(values, torch.Tensor) and values.device == device:
        return values.to(torch.int64)
    t = torch.as_tensor(np.asarray(values, dtype=np.int64))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
