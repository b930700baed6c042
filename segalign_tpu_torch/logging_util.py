"""Structured logging: JSON-lines event stream on stderr.

The reference logs unstructured fprintf progress lines (stderr), keeping
stdout reserved as the LASTZ-command data channel
(reference/src/segment_printer.cpp:111). We keep that contract and
add an opt-in machine-readable mirror: SEGALIGN_LOG_JSON=1 makes every
pipeline event a single JSON object on stderr, e.g.

  {"ts": 1771234567.12, "event": "interval_done", "block": 0,
   "interval": 3, "hsps": 1742, "seconds": 0.51}

Events: run_start, ref_block, query_block, interval_done, stats,
run_end (pairwise); rm_block, interval_done, stats, run_end (RM). The
port's stats event also carries each kernel wrapper's launch count in the
process (`launches`), every card's peak memory (`peak_device_bytes`) and
the branches the run took (PipelineStats: target blocks, chunk-strands,
logical hit batches, the fewest and most hits of a chunk-strand).
"""

from __future__ import annotations

import json
import os
import sys
import time

_ENABLED = os.environ.get("SEGALIGN_LOG_JSON", "") == "1"


def json_logging_enabled() -> bool:
    return _ENABLED


def log_event(event: str, **fields):
    """Emit one JSON event line to stderr (no-op unless enabled)."""
    if not _ENABLED:
        return
    rec = {"ts": round(time.time(), 3), "event": event}
    rec.update(fields)
    print(json.dumps(rec, separators=(",", ":")), file=sys.stderr,
          flush=True)
