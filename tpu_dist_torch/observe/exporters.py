"""Exporters: schema-versioned JSONL time-series and Prometheus textfiles.

The port's own copy of ``tpu_dist/observe/exporters.py``: the same schema
tag and metric names, so a series either package writes reads back in the
other, and one snapshot renders to the same Prometheus text.

Two sinks, two audiences:

* **JSONL** for machines and the ``python -m tpu_dist_torch.observe`` CLI —
  one self-describing record per snapshot, append-only so a crashed run
  keeps everything written before the crash (the same line-atomicity
  contract as ``resilience.events.EventLog``). ``read_series`` tolerates
  a torn final line by default, because that is exactly what a
  kill-at-step-N chaos run produces.
* **Prometheus textfile** for humans with a node_exporter — the standard
  ``textfile collector`` handoff: write to a tmp file, ``os.replace``
  into place so the scraper never reads a half-written file.

Schema versioning: every JSONL record carries ``"schema":
"tpu_dist.observe/v1"``. Readers reject records from a different major
schema rather than silently misparsing them.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import IO, Optional, Union

from tpu_dist_torch.observe import metrics as metrics_lib

#: Version tag stamped into every JSONL record.
SCHEMA = "tpu_dist.observe/v1"


class SchemaError(ValueError):
    """A series record is missing or carries an incompatible schema tag."""


class JsonlExporter:
    """Append metric snapshots to a JSONL file, one record per write."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh: Optional[IO[str]] = open(self.path, "a", encoding="utf-8")

    def write(self, snapshot: dict, **stamp) -> dict:
        """Write one record: ``{"schema", "ts", **stamp, "metrics"}``.
        Extra stamp fields (epoch=, rank=, kind=) label the record."""
        if self._fh is None:
            raise RuntimeError(f"exporter for {self.path} is closed")
        record = {"schema": SCHEMA, "ts": time.time(), **stamp,
                  "metrics": snapshot}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        return record

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_series(path: Union[str, Path], *, strict: bool = False) -> list[dict]:
    """Read every record of a JSONL series back, schema-checked.

    By default a torn/unparsable line (the tail a killed writer leaves)
    is skipped; ``strict=True`` raises on it instead. A record whose
    schema tag is missing or from a different series format always
    raises ``SchemaError`` — that is corruption, not a torn write.
    """
    records = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                if strict:
                    raise
                continue
            tag = record.get("schema") if isinstance(record, dict) else None
            if tag != SCHEMA:
                raise SchemaError(
                    f"{path}:{lineno}: expected schema {SCHEMA!r}, "
                    f"got {tag!r}")
            records.append(record)
    return records


def _prom_name(name: str) -> str:
    """Sanitize a dotted metric name into the Prometheus grammar
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = []
    for i, ch in enumerate(name):
        if ch.isalnum() or ch == "_":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out)
    if not s or not (s[0].isalpha() or s[0] == "_"):
        s = "_" + s
    return "tpu_dist_" + s


def write_prometheus_textfile(snapshot: dict,
                              path: Union[str, Path]) -> None:
    """Render a registry snapshot as a Prometheus textfile and atomically
    replace ``path`` (tmp + ``os.replace``), so a concurrent textfile
    collector never scrapes a partial file. ``Telemetry`` writes it at
    every epoch's end, so it makes few system calls: raw ``os`` writes
    (no buffered text file's probes), the parent made only when missing."""
    path = Path(path)
    lines = []
    for name, value in snapshot.get("counters", {}).items():
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {value}")
    for name, value in snapshot.get("gauges", {}).items():
        if value is None:
            continue
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {value}")
    for name, stats in snapshot.get("distributions", {}).items():
        pname = _prom_name(name)
        # Prometheus has no native distribution type for textfiles;
        # export as a summary (quantile labels) plus _count/_sum.
        lines.append(f"# TYPE {pname} summary")
        # Summary quantile labels, one per registry snapshot quantile —
        # derived from metrics.SNAPSHOT_QUANTILES so a new quantile there
        # shows up here without a second edit (the snapshot's flattened
        # pNN keys are the JSONL schema and stay unchanged).
        for q in metrics_lib.SNAPSHOT_QUANTILES:
            v = stats.get(f"p{int(q * 100)}")
            if v is not None:
                lines.append(f'{pname}{{quantile="{q}"}} {v}')
        lines.append(f"{pname}_count {stats.get('count', 0)}")
        lines.append(f"{pname}_sum {stats.get('sum', 0.0)}")
    data = memoryview(("\n".join(lines) + "\n").encode("utf-8"))
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
    try:
        fd = os.open(tmp, flags, 0o666)
    except FileNotFoundError:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(tmp, flags, 0o666)
    try:
        while data:
            data = data[os.write(fd, data):]
    finally:
        os.close(fd)
    os.replace(tmp, path)
