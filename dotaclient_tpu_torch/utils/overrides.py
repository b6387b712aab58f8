"""Comma-separated dataclass-field overrides for CLI flags.

Copy of ``dotaclient_tpu/utils/overrides.py`` (``parse_dataclass_overrides``):
the parser behind ``--serve k=v,...``. Raises ``ValueError`` naming the flag;
the CLIs turn it into ``argparse`` errors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


def parse_dataclass_overrides(cls: Any, text: str, flag: str) -> Dict[str, Any]:
    """Parse ``"k=v,k2=v2"`` into typed values for ``cls`` fields: str
    fields take the raw string, int fields ``int()``, bool fields
    true/false/1/0, everything else ``float()``. Unknown names, bad values
    and unknown enum strings raise ``ValueError`` mentioning ``flag``."""
    fields = {f.name: f.type for f in dataclasses.fields(cls)}
    out: Dict[str, Any] = {}
    for kv in text.split(","):
        k, _, v = kv.partition("=")
        k = k.strip()
        if k not in fields:
            raise ValueError(f"{flag}: unknown field {k!r} (one of {sorted(fields)})")
        if fields[k] in (str, "str"):
            caster: Any = str
        elif fields[k] in (bool, "bool"):
            def caster(s: str) -> bool:
                low = s.lower()
                if low in ("true", "1"):
                    return True
                if low in ("false", "0"):
                    return False
                raise ValueError(s)

            caster.__name__ = "bool"
        elif fields[k] in (int, "int"):
            caster = int
        else:
            caster = float
        try:
            out[k] = caster(v.strip())
        except ValueError:
            raise ValueError(f"{flag}: bad {caster.__name__} for {k!r}: {v!r}") from None
    from dotaclient_tpu_torch.config import ADV_NORM_MODES, ADVANTAGE_MODES
    from dotaclient_tpu_torch.transport.serialize import ROLLOUT_WIRE_DTYPES

    for name, allowed in (
        ("adv_norm", ADV_NORM_MODES),
        ("advantage", ADVANTAGE_MODES),
        ("request_wire_dtype", ROLLOUT_WIRE_DTYPES),
    ):
        if name in fields and out.get(name) is not None and out[name] not in allowed:
            raise ValueError(f"{flag}: {name} must be one of {allowed}, got {out[name]!r}")
    return out
