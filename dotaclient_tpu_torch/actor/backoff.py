"""Bounded reconnects with exponential backoff and full jitter.

Copy of ``connect_with_backoff`` from ``dotaclient_tpu/actor/__main__.py``:
the serve client's connect path takes the same schedule as the reference
actors, and the actor CLI (``actor/__main__.py``) reconnects with it.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

from dotaclient_tpu_torch.utils import telemetry

T = TypeVar("T")


def connect_with_backoff(
    factory: Callable[[], T],
    max_attempts: int = 6,
    base_delay: float = 0.5,
    max_delay: float = 10.0,
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    should_abort: Optional[Callable[[], bool]] = None,
) -> T:
    """Call ``factory()`` until it returns, sleeping (``sleep``) a uniform
    draw of ``rng`` (a fresh ``random.Random()`` by default) from (0,
    min(max_delay, base_delay * 2^(k-1))] before retry k. Each retry counts
    ``transport/reconnects_total``; after ``max_attempts`` the last
    connection error is re-raised as the cause. ``should_abort`` is polled
    before every attempt and ends the schedule within one sleep."""
    rng = rng or random.Random()
    tel = telemetry.get_registry()
    last: Optional[BaseException] = None
    for attempt in range(max_attempts):
        if attempt:
            tel.counter("transport/reconnects_total").inc()
            delay = min(max_delay, base_delay * (2 ** (attempt - 1)))
            sleep(rng.uniform(0.0, delay))
        if should_abort is not None and should_abort():
            raise ConnectionError("reconnect abandoned: stop requested") from last
        try:
            return factory()
        except (ConnectionError, OSError) as e:
            last = e
    raise ConnectionError(f"transport unreachable after {max_attempts} attempts") from last
