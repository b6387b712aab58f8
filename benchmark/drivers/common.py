"""What a driver hands back to the harness."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from benchmark.trace import Profile


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]            # metric name -> value (setup_s included)
    attempted: int
    failed: int
    compared: Dict[str, float]              # number compared -> reading
    memory_peak_bytes: int
    profile: Optional[Profile] = None
    ctx: Dict[str, Any] = dataclasses.field(default_factory=dict)   # what the per-layer readers read


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
