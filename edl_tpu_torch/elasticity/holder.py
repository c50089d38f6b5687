"""Lease-holder subprocess for the multi-process chaos lane: the port of
``edl_tpu/elasticity/holder.py``.

``python -m edl_tpu_torch.elasticity.holder`` is one chip-lease holder as a
real OS process: it connects to a running ``edl-coordinator``, takes a
lease through :class:`~edl_tpu_torch.elasticity.distbroker.DistributedChipBroker`,
and then behaves per ``--mode``:

* ``confirm`` — the well-behaved holder: confirm on a short heartbeat
  for ``--hold-s`` seconds, then recall+free its own lease and exit 0.
  If the broker restarts underneath it, the client's reconnect window
  absorbs the gap and the re-confirm ends the RECOVERING window.
* ``die`` — grant, report the lease on stdout, then ``os._exit`` while
  still holding it (the SIGKILL analog): the chips come back only via
  the broker's recovery reaper or an explicit ``LCRASH``.
* ``zombie`` — a holder restarted with STALE memory: adopt the
  ``--lease-id``/``--epoch`` it remembers and confirm. The broker must
  fence it (exit 0 iff fenced) — the process-level proof that a
  force-released holder cannot keep computing on chips it lost.

``--events-out`` dumps this process's flight ring as JSONL on the way
out so the parent can merge every process's timeline into one.

Stdout protocol (parent-parsed, one line):
    ``LEASE <lease_id> <epoch> <chips>`` after a successful grant, or
    ``FENCED <reason-bool>`` from a zombie.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from edl_tpu_torch.elasticity.broker import LeaseError
from edl_tpu_torch.elasticity.distbroker import DistributedChipBroker
from edl_tpu_torch.obs import events as flight
from edl_tpu_torch.runtime.coordinator import CoordinatorClient


def _dump_events(path: str) -> None:
    if not path:
        return
    with open(path, "w") as f:
        f.write(flight.default_recorder().to_jsonl())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="edl-lease-holder",
        description="one chip-lease holder process (chaos-lane actor)",
    )
    ap.add_argument("--coordinator", required=True, help="HOST:PORT")
    ap.add_argument("--holder", required=True, help="side:name holder id")
    ap.add_argument("--chips", type=int, default=1)
    ap.add_argument("--total", type=int, default=8, help="pool size (LINIT)")
    ap.add_argument(
        "--mode", choices=("confirm", "die", "zombie"), default="confirm"
    )
    ap.add_argument(
        "--hold-s", type=float, default=1.0,
        help="confirm mode: seconds to hold before freeing",
    )
    ap.add_argument(
        "--confirm-every", type=float, default=0.05,
        help="confirm mode: heartbeat period",
    )
    ap.add_argument(
        "--lease-id", default="",
        help="zombie mode: the lease this holder remembers",
    )
    ap.add_argument(
        "--epoch", type=int, default=-1,
        help="zombie mode: the (stale) epoch this holder remembers",
    )
    ap.add_argument("--events-out", default="", help="flight-ring JSONL dump")
    args = ap.parse_args(argv)

    host, port = args.coordinator.rsplit(":", 1)
    flight.default_recorder().set_context(worker=args.holder)
    cli = CoordinatorClient(host, int(port))
    broker = DistributedChipBroker(cli, args.total)

    if args.mode == "zombie":
        # re-attach with remembered (possibly stale) state, then ask
        # the fence; a zombie MUST come back fenced
        lease = broker.adopt(
            args.lease_id, args.holder, args.chips, args.epoch
        )
        ok = broker.confirm(lease.lease_id)
        _dump_events(args.events_out)
        print(f"FENCED {not ok}", flush=True)
        return 0 if not ok else 4

    lease = broker.grant(args.holder, args.chips)
    print(f"LEASE {lease.lease_id} {lease.epoch} {lease.chips}", flush=True)

    if args.mode == "die":
        # flush the timeline first — a SIGKILLed process can't
        _dump_events(args.events_out)
        sys.stdout.flush()
        os._exit(9)

    deadline = time.monotonic() + args.hold_s
    while time.monotonic() < deadline:
        if not broker.confirm(lease.lease_id):
            _dump_events(args.events_out)
            return 3  # fenced mid-hold: stop using the chips
        time.sleep(args.confirm_every)
    try:
        broker.recall(lease.lease_id)
        broker.free(lease.lease_id)
    except LeaseError:
        pass  # settled from the other side (recall race) — chips safe
    _dump_events(args.events_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
