"""Structured JSONL metrics and console logging (port of
``llzlab_tpu/utils/metrics.py``; stdlib only, the same code).

Every CLI run appends one JSON object per event to a ``.jsonl`` log (config
hash, Msamples/s, SNR) and prints a human summary to stderr.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger", "config_hash"]


def config_hash(obj: Any) -> str:
    """Stable short hash of any JSON-serialisable config."""
    s = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(s.encode()).hexdigest()[:12]


class MetricsLogger:
    """Append-only JSONL event log with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, run: Optional[str] = None,
                 echo: bool = True):
        self.path = path
        self.run = run or time.strftime("%Y%m%d-%H%M%S")
        self.echo = echo
        self._t0 = time.perf_counter()

    def event(self, kind: str, **fields) -> Dict[str, Any]:
        rec = {
            "run": self.run,
            "t": round(time.perf_counter() - self._t0, 6),
            "kind": kind,
            **fields,
        }
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        if self.echo:
            pretty = " ".join(
                f"{k}={v}" for k, v in fields.items() if not isinstance(v, dict)
            )
            print(f"[{kind}] {pretty}", file=sys.stderr, flush=True)
        return rec

    def stage(self, name: str, samples: int, seconds: float, **extra):
        return self.event(
            "stage",
            stage=name,
            msps=round(samples / seconds / 1e6, 3),
            seconds=round(seconds, 6),
            **extra,
        )
