"""``scripts/trace_report.py`` with the port's own span names in its phase table.

The report buckets each slice of a change's lane into a critical-path
phase by its name (``PHASE_OF``).  The port's ingest control plane and its
cohort stream have spans that table does not name: the five that split
``stats["host_seconds"]`` read as ``control``, the stream's host waits on
its events as ``wait``.  This module loads a private copy of the report,
puts :data:`PORT_PHASES` ahead of its table, and runs it unchanged
otherwise.

Usage:
    python -m peritext_tpu_torch.bench.trace_report trace.jsonl [--top K] [--json]
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys
from types import ModuleType

PORT_PHASES = (
    ("ingest.group", "control"),
    ("ingest.encode", "control"),
    ("ingest.plan", "control"),
    ("ingest.upload", "control"),
    ("ingest.commit", "control"),
    ("stream.wait", "wait"),
)

REPORT = pathlib.Path(__file__).resolve().parents[2] / "scripts" / "trace_report.py"


def load() -> ModuleType:
    """A fresh copy of the report module whose ``phase_of`` knows the
    port's spans; other importers of the report are left as they were."""
    spec = importlib.util.spec_from_file_location("peritext_tpu_torch_trace_report", REPORT)
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    report.PHASE_OF = PORT_PHASES + report.PHASE_OF
    return report


def main() -> int:
    return load().main()


if __name__ == "__main__":
    sys.exit(main())
