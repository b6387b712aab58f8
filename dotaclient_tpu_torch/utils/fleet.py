"""Fleet peer labels.

Copy of ``peer_label`` from the reference's ``utils/fleet.py``: the stable
name a fleet peer publishes its metric rows under. ``SessionRouter.status``
names each backend's row with it. The rest of the fleet plane (publisher,
aggregator, rollups) waits for ROADMAP queue 1, item 8.
"""

from __future__ import annotations


def peer_label(kind: str, peer_id: int) -> str:
    """``<kind initial><peer id>``: ``a0``, ``s7788``. Serve peers key on
    their listen port, so a label survives a restart of the process and the
    router can name a backend's row from its address alone."""
    return f"{kind[0]}{int(peer_id)}"
