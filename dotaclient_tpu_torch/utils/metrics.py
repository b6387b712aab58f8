"""The learner's run record: scalars and the telemetry registry, to every sink.

Copy of ``dotaclient_tpu/utils/metrics.py``. Every ``log`` merges the
registry's snapshot (spans, gauges, counters) into the scalars it is given,
so the training scalars and the pipeline telemetry travel through the same
sinks: the console (the short line, telemetry keys left out), tensorboardX
when a ``logdir`` is given and the package is installed (a missing install
is one warning, never a failure), and JSONL for headless runs. The scalars
arrive on the host; nothing here reads the device.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Mapping, Optional

from dotaclient_tpu_torch.utils import telemetry


class MetricsLogger:
    def __init__(
        self,
        logdir: Optional[str] = None,
        console: bool = True,
        jsonl: Optional[str] = None,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        self.registry = registry if registry is not None else telemetry.get_registry()
        self.console = console
        self._t0 = time.time()
        self._sinks = []
        if console:
            self._sinks.append(telemetry.ConsoleSink(self._t0))
        if logdir is not None:
            tb = telemetry.TensorBoardSink.create(logdir)
            if tb is not None:
                self._sinks.append(tb)
        if jsonl is not None:
            self._sinks.append(telemetry.JsonlSink(jsonl))

    def log(self, step: int, scalars: Mapping[str, float], prefix: str = "") -> Dict[str, float]:
        """Emit ``scalars`` and the registry's snapshot to every sink;
        returns the merged dict (what a caller keeps as the last logged
        metrics)."""
        flat = {f"{prefix}{k}": float(v) for k, v in scalars.items()}
        return self._emit(step, flat, console=True)

    def log_files_only(self, step: int, scalars: Mapping[str, float]) -> Dict[str, float]:
        """:meth:`log` without the console: the end-of-run line that closes
        the record."""
        return self._emit(step, {k: float(v) for k, v in scalars.items()}, console=False)

    def _emit(self, step: int, flat: Dict[str, float], console: bool) -> Dict[str, float]:
        flat.update(self.registry.snapshot())
        for sink in self._sinks:
            if console or not isinstance(sink, telemetry.ConsoleSink):
                sink.emit(step, flat)
        return flat

    def emit_event(self, event: Dict[str, object]) -> None:
        """One structured event (the ``ALERT`` channel) to every sink that
        takes events (the JSONL line), and one ``ALERT {json}`` console
        line. Thread-safe: the fleet aggregator's thread calls it."""
        for sink in self._sinks:
            fn = getattr(sink, "emit_event", None)
            if fn is not None:
                fn(event)
        if self.console:
            print(f"ALERT {json.dumps(event, sort_keys=True)}", flush=True)

    def close(self) -> None:
        for sink in self._sinks:
            sink.close()
