"""The ``RESULT:{...}`` line protocol of supervised workers.

Counterpart of ``tpu_dist/resilience/cli.py``'s :func:`parse_result_line`:
a supervised worker prints one ``RESULT:`` line with its JSON result, and
the supervising process reads it back from the worker's log. The training
chaos runner around it is not ported yet (ROADMAP.md queue 1, item 18).
"""

from __future__ import annotations

import json
from typing import Optional

_RESULT_PREFIX = "RESULT:"


def parse_result_line(text: str) -> Optional[dict]:
    """The LAST ``RESULT:{...}`` line in ``text`` — a restarted worker's log
    holds one per completed run; the last is the one that finished."""
    result = None
    for line in text.splitlines():
        if line.startswith(_RESULT_PREFIX):
            try:
                result = json.loads(line[len(_RESULT_PREFIX):])
            except ValueError:
                continue
    return result
