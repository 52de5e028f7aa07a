"""Runtime telemetry and the measured cost loop (counterpart of
``repro.telemetry``).

* :class:`Telemetry`: ring-buffered spans + counters/gauges/histograms;
  an allocation-free no-op when disabled (the default posture;
  ``REPRO_TELEMETRY=1`` enables the process default).
* :func:`write_trace` / :func:`trace_events`: Chrome trace-event /
  Perfetto JSON export.
* :class:`TimingFeed`: measured stage spans -> the EMA cost table
  (``cost_source="measured"``).
* :class:`StageProbes`: decode stages run standalone through the port's
  kernels, timed with CUDA events on the card.
"""

from .core import NULL_SPAN, Telemetry, default  # noqa: F401
from .export import trace_events, write_trace  # noqa: F401
from .probes import StageProbes  # noqa: F401
from .timing_feed import TimingFeed  # noqa: F401
