"""The result line and the numbers that decided ``correct``."""

from __future__ import annotations

import json
import math
import sys
from typing import Dict, List, Tuple

Check = Tuple[str, float, float]          # (name, value, upper limit)


def passed(checks: List[Check]) -> bool:
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def emit(line: Dict, checks: List[Check]) -> None:
    """The compared numbers as the last lines of stderr, then the result
    ``line`` as the last line of stdout, the numbers last in it."""
    for name, value, limit in checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(line, checks={name: {"value": _num(value), "limit": limit}
                              for name, value, limit in checks})
    print(json.dumps(line), flush=True)


def _num(v: float):
    return v if math.isfinite(v) else str(v)
