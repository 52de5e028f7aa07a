"""Trace exporters: Chrome trace-event / Perfetto JSON (port's copy of
``repro.telemetry.export``).

The Chrome trace-event format (``{"traceEvents": [...]}``) loads directly
in https://ui.perfetto.dev and ``chrome://tracing``.  Mapping:

* each telemetry **track** becomes a Perfetto *process* (``pid``) named
  via a ``process_name`` metadata event — engine spans land on ``main``,
  cluster spans on ``replica-<i>`` tracks, so a multi-replica run renders
  as parallel swimlanes on one timeline;
* **spans** export as complete events (``ph:"X"``, ``ts``/``dur`` in
  microseconds); span ``value`` metadata (e.g. a probe's token count)
  rides in ``args``;
* **counter/gauge samples** export as counter events (``ph:"C"``), which
  Perfetto draws as stepped value tracks (queue depth, KV occupancy,
  head-mass fraction, ...).
"""

from __future__ import annotations

import json
import math
import os
from typing import List

from .core import Telemetry


def trace_events(tel: Telemetry) -> List[dict]:
    """Telemetry ring -> Chrome trace-event dicts (oldest first)."""
    evs: List[dict] = []
    for pid, track in enumerate(tel.tracks):
        evs.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": track},
            }
        )
    track_pid = {track: pid for pid, track in enumerate(tel.tracks)}
    for e in tel.events():
        pid = track_pid[e["track"]]
        ts_us = e["t0_ns"] / 1e3
        if e["kind"] == "span":
            ev = {
                "name": e["name"],
                "ph": "X",
                "ts": ts_us,
                "dur": e["dur_ns"] / 1e3,
                "pid": pid,
                "tid": 0,
            }
            if not math.isnan(e["value"]):
                ev["args"] = {"value": e["value"]}
            evs.append(ev)
        else:
            evs.append(
                {
                    "name": e["name"],
                    "ph": "C",
                    "ts": ts_us,
                    "pid": pid,
                    "args": {"value": e["value"]},
                }
            )
    return evs


def write_trace(tel: Telemetry, path: str) -> str:
    """Write the session as a Perfetto-loadable trace JSON; returns path."""
    out_dir = os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    doc = {
        "traceEvents": trace_events(tel),
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "repro_torch.telemetry",
            "n_overflowed": tel.n_overflowed,
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
