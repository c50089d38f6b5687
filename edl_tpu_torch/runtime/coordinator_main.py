"""Coordinator entrypoint — run the per-job coordinator service: the
port's copy of ``edl_tpu/runtime/coordinator_main.py``.

The coordinator is the master-pod analog: one per job, owning
membership, KV, barriers and the elastic task queue. This wrapper
builds the native server (``native/coordinator``, through
``runtime/coordinator.ensure_native_built``) and execs it, so the
container's PID-1 signal handling applies to the server itself.

With ``--metrics-port`` the wrapper instead SUPERVISES the server as a
child and runs the job's fleet telemetry endpoint beside it
(:func:`serve_fleet`): every worker pushes metric snapshots, its
flight-recorder window and its span window into this coordinator's KV
(``{job}/metrics/{worker}`` and siblings, obs/fleet.py), and each scrape
of ``/metrics`` re-exposes the aggregated union with every series
labeled by worker, ``/events`` the worker-labeled event log on one
clock and ``/trace`` the offset-corrected fleet trace. With
``--tsdb-dir`` the aggregated snapshot is appended to a metric history
every ``--watch-interval`` seconds and the alert rules run over it,
printing ``ALERT <transition> <rule> [<severity>]`` lines. SIGTERM (or
SIGINT) stops the endpoint and the server and exits 0.

    python -m edl_tpu_torch.runtime.coordinator_main --port 7164 \\
        [--metrics-port 9100 --job myjob [--tsdb-dir DIR --rules R.json]]
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time
from typing import Callable, Optional

# non-member sources whose snapshots the aggregation also reads (the
# epoch's dist_service host pushes under this reserved name)
EXTRA_METRIC_SOURCES = ("dist_service",)


def serve_fleet(
    client,
    job: str,
    metrics_port: int,
    *,
    tsdb_dir: Optional[str] = None,
    rules: Optional[str] = None,
    watch_interval: float = 10.0,
    alive: Callable[[], bool] = lambda: True,
    stop: Optional[threading.Event] = None,
    announce: Optional[Callable[[str], None]] = None,
) -> None:
    """The supervised body: serve the fleet's ``/metrics``, ``/events``
    and ``/trace`` (and ``/history`` with ``tsdb_dir``) of ``job`` from
    the coordinator behind ``client`` on ``metrics_port`` (0 =
    ephemeral) until ``alive()`` turns false or ``stop`` is set.
    ``announce(url)`` receives the bound URL once the endpoint is up.
    With ``tsdb_dir``, every ``watch_interval`` seconds the aggregated
    snapshot is appended to the history there and the alert rules
    (``rules``: a rules JSON path, default ``DEFAULT_RULES``) evaluate
    over it; each transition prints as ``ALERT <transition> <rule>
    [<severity>]``."""
    from edl_tpu_torch import obs

    stop = stop or threading.Event()
    # optional fleet watchdog: append the aggregated snapshot to an
    # on-disk history and run the alert rules over it — the coordinator
    # is the one process that already sees every worker's series, so
    # fleet-level burn rates evaluate here
    db = engine = None
    if tsdb_dir:
        db = obs.TSDB(tsdb_dir)
        engine = obs.engine_from_doc(obs.load_rules_doc(rules))

    exporter = obs.start_exporter(
        lambda: obs.collect_fleet(client, job, EXTRA_METRIC_SOURCES),
        port=metrics_port,
        # /events here is the worker-labeled FLEET log: the union of
        # every member's pushed flight-recorder window ({job}/events/*)
        # on ONE clock axis (per-worker offsets applied)
        events_source=lambda: obs.collect_fleet_events(
            client, job, EXTRA_METRIC_SOURCES
        ),
        # /trace here is the FLEET merge: every member's pushed span
        # window, offset-corrected, worker-labeled, with RPC flow
        # links (obs/fleet.collect_fleet_trace -> disttrace)
        trace_source=lambda: obs.collect_fleet_trace(
            client, job, EXTRA_METRIC_SOURCES
        ),
        history=db,
    )
    try:
        if announce is not None:
            announce(exporter.url)
        next_watch = time.time()
        while alive() and not stop.wait(0.5):
            if db is not None and time.time() >= next_watch:
                next_watch = time.time() + watch_interval
                try:
                    reg = obs.collect_fleet(client, job, EXTRA_METRIC_SOURCES)
                    now = time.time()
                    db.append(reg.snapshot(), t=now)
                    for tr in engine.evaluate(db, now):
                        print(
                            f"ALERT {tr['transition']} {tr['rule']} "
                            f"[{tr['severity']}]",
                            flush=True,
                        )
                except Exception:  # edl: no-lint[silent-failure] the watchdog must never take down the coordinator it watches; next pass retries
                    pass
    finally:
        if db is not None:
            db.flush()
        exporter.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="edl-coordinator")
    ap.add_argument("--port", type=int, default=7164)
    ap.add_argument(
        "--member-ttl", type=float, default=10.0,
        help="seconds without heartbeat before a member is reaped",
    )
    ap.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve the fleet-aggregated telemetry endpoint on this "
        "port (0 = ephemeral; prints the bound URL). Aggregates the "
        "metric snapshots workers push into this coordinator's KV.",
    )
    ap.add_argument(
        "--job", default="job",
        help="job name for the metrics KV prefix ({job}/metrics/*); "
        "only used with --metrics-port",
    )
    ap.add_argument(
        "--tsdb-dir", default=None,
        help="record the fleet-aggregated snapshot into this metric-"
        "history directory (obs/tsdb.py) every --watch-interval and "
        "evaluate the alert rules over it; served on /history and "
        "replayable with the watch verb. Only with --metrics-port.",
    )
    ap.add_argument(
        "--rules", default=None,
        help="alert-rules JSON for the fleet watchdog (default: the "
        "built-in obs/alerts.py DEFAULT_RULES); only with --tsdb-dir",
    )
    ap.add_argument(
        "--watch-interval", type=float, default=10.0,
        help="seconds between fleet snapshot/alert-evaluation passes "
        "when --tsdb-dir is set",
    )
    a = ap.parse_args(argv)

    from edl_tpu_torch.runtime.coordinator import (
        BIN_PATH,
        CoordinatorServer,
        ensure_native_built,
    )

    if not ensure_native_built():
        print("native coordinator unavailable (no toolchain?)", file=sys.stderr)
        return 1

    if a.metrics_port is None:
        os.execv(
            BIN_PATH,
            [BIN_PATH, "--port", str(a.port), "--member-ttl", str(a.member_ttl)],
        )
        return 0  # unreachable

    # supervised mode: server child + aggregation exporter in this
    # process (telemetry rides the same pod, same lifecycle)
    server = CoordinatorServer(port=a.port, member_ttl_s=a.member_ttl)
    client = server.client()
    stop = threading.Event()
    # a supervisor's SIGTERM is a clean stop: the endpoint and the
    # server shut down and the process exits 0
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    def announce(url: str) -> None:
        print(
            f"coordinator on :{server.port}; fleet metrics at {url}/metrics "
            f"(fleet event log at /events, merged fleet trace at /trace)",
            flush=True,
        )

    try:
        serve_fleet(
            client, a.job, a.metrics_port,
            tsdb_dir=a.tsdb_dir, rules=a.rules,
            watch_interval=a.watch_interval,
            alive=lambda: server._proc.poll() is None,
            stop=stop, announce=announce,
        )
        return 0 if stop.is_set() else (server._proc.returncode or 0)
    except KeyboardInterrupt:
        return 0
    finally:
        client.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
