"""Child producer of the bench's transport stage.

Counterpart of the reference's ``scripts/bench_transport_producer.py``.
Runs as a separate OS process (the split topology's shape: an actor process
feeding the learner's transport) and ships ``--frames`` rollout frames of
``--bytes`` wire bytes each through the socket lane or the shm lane. It
imports no torch, so the process is up in milliseconds and the parent's
window (which starts at the first frame's arrival) measures the transport,
not the interpreter's start-up.

Usage (the bench spawns it; it also runs by hand):
    python -m dotaclient_tpu_torch.transport.bench_producer --lane socket \\
        --addr 127.0.0.1:7777 --frames 2000 --bytes 65536
    python -m dotaclient_tpu_torch.transport.bench_producer --lane shm \\
        --addr lane0 --frames 2000 --bytes 65536
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

# a ring that stays full this long means the consumer is gone
STUCK_S = 60.0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lane", choices=("socket", "shm"), required=True)
    p.add_argument("--addr", required=True, help="host:port (socket) or lane name (shm)")
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--bytes", type=int, default=65536)
    p.add_argument("--payload-hex", default=None, help="explicit payload bytes (hex); default zeros")
    args = p.parse_args(argv)

    payload = bytes.fromhex(args.payload_hex) if args.payload_hex else b"\x00" * args.bytes
    if args.lane == "socket":
        from dotaclient_tpu_torch.transport.socket_transport import SocketTransport

        host, port = args.addr.rsplit(":", 1)
        t = SocketTransport(host, int(port))
        for _ in range(args.frames):
            # TCP applies its own backpressure (sendall blocks when the
            # consumer falls behind)
            t.publish_rollout_bytes(payload)
    else:
        from dotaclient_tpu_torch.transport.shm_transport import ShmTransport

        t = ShmTransport(args.addr)
        stuck_since = None
        for _ in range(args.frames):
            # a full ring means the consumer owes a drain: spin-yield (the
            # actor drops instead; a bench must deliver every frame to
            # measure sustained throughput), bounded so that a consumer
            # that stopped draining leaves no spinning orphan
            while not t.publish_rollout_bytes(payload):
                now = time.monotonic()
                if stuck_since is None:
                    stuck_since = now
                elif now - stuck_since > STUCK_S:
                    print(f"producer: ring full for {STUCK_S:.0f} s; consumer gone", file=sys.stderr)
                    t.close()
                    return 1
                time.sleep(0)
            stuck_since = None
    t.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
