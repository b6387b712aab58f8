"""graftlint for the port: multi-pass static analysis of its disciplines.

``python -m dotaclient_tpu_torch.lint`` runs every pass over
``dotaclient_tpu_torch/``; see ``core.py`` for the framework (a copy of the
JAX package's ``lint/core.py``) and docs/ARCHITECTURE.md "Static analysis"
for the rule catalog, the ``# lint-ok: <rule>(<why>)`` waiver, and when to
baseline. What only the port has is documented in
``dotaclient_tpu_torch/OPERATIONS.md``, which the drift passes read beside
docs/ARCHITECTURE.md and docs/OPERATIONS.md.

The JAX package's ``use-after-donate`` pass has no counterpart: no port
module donates a buffer, and eager PyTorch has no ``donate_argnums``.

Import-light by design (stdlib only, no torch or numpy): the tier-1 test
(``tests/test_torch_lint.py``) runs the full lint in-process.
"""

from dotaclient_tpu_torch.lint.alert_drift import AlertDriftRule
from dotaclient_tpu_torch.lint.config_drift import ConfigCliDriftRule
from dotaclient_tpu_torch.lint.core import (
    DEFAULT_BASELINE,
    Diagnostic,
    FileCtx,
    LintResult,
    Rule,
    fingerprint,
    load_baseline,
    run_rules,
)
from dotaclient_tpu_torch.lint.host_sync import HostSyncRule
from dotaclient_tpu_torch.lint.ownership import ThreadOwnershipRule
from dotaclient_tpu_torch.lint.telemetry_drift import TelemetryDriftRule

# registration order = report order (the reference's, less use-after-donate)
ALL_RULES = (
    HostSyncRule,
    ThreadOwnershipRule,
    TelemetryDriftRule,
    ConfigCliDriftRule,
    AlertDriftRule,
)

__all__ = [
    "ALL_RULES",
    "DEFAULT_BASELINE",
    "Diagnostic",
    "FileCtx",
    "LintResult",
    "Rule",
    "fingerprint",
    "load_baseline",
    "run_rules",
]
