"""Actors: the on-device rollout, the host pools (the scalar proto pool and
the numpy vec pool) and the actor process.

Exports the JAX package's names, resolved on first use: the serve client
imports ``actor/backoff.py`` and must not load torch through this package.
"""

import importlib

_EXPORTS = {"ActorPool": "runtime", "build_game_config": "runtime", "VecActorPool": "vec_runtime",
            "make_device_step": "vec_runtime"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
