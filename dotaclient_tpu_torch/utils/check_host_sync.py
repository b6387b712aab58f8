"""CI guard: no per-step host↔device syncs in the port's hot-path modules.

THIN WRAPPER, the counterpart of the JAX package's
``scripts/check_host_sync.py``. The analysis (the torch spellings of a host
read, the ``ALLOWED_FUNCS``/``SCAN_ONLY_FUNCS`` module lists, and the
annotation escape hatch) lives in :mod:`dotaclient_tpu_torch.lint.host_sync`,
where it runs as the ``host-sync`` pass of ``python -m
dotaclient_tpu_torch.lint``. This module keeps the historical contract:

* exit 0 when clean, printing ``host-sync discipline OK: <modules>``;
* exit 1 with per-line ``file:line: <pattern> in <func>() — ...``
  diagnostics on stderr under a ``host-sync discipline check FAILED:``
  header;
* ``check_source``, ``ALLOWED_FUNCS``, ``SCAN_ONLY_FUNCS``, and
  ``ANNOTATION`` re-exported unchanged for the tests that drive them.

Annotate a deliberate host-value sync with ``# host-sync-ok: <why>`` on
the line (or the line above); ``# lint-ok: host-sync(<why>)`` works too.
Allowlist edits go in ``dotaclient_tpu_torch/lint/host_sync.py``.

Usage:
    python -m dotaclient_tpu_torch.utils.check_host_sync
    python -m dotaclient_tpu_torch.lint --rule host-sync   # framework form
"""

from __future__ import annotations

import sys

from dotaclient_tpu_torch.lint.host_sync import (
    ALLOWED_FUNCS,
    ANNOTATION,
    SCAN_ONLY_FUNCS,
    check_source,
    run_standalone as main,
)

__all__ = [
    "ALLOWED_FUNCS",
    "ANNOTATION",
    "SCAN_ONLY_FUNCS",
    "check_source",
    "main",
]

if __name__ == "__main__":
    sys.exit(main())
