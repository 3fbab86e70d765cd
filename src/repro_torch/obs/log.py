"""Structured logging gated by the ``REPRO_LOG`` environment variable.

Library code calls :func:`log` instead of ``print``; by default
(``REPRO_LOG`` unset/empty/``0``/``off``) nothing is emitted, so
training/serving/fitting loops are quiet and benchmark CLIs keep their
stdout tables clean.  ``REPRO_LOG=1`` (or any other value) emits
human-readable ``[event] k=v ...`` lines; ``REPRO_LOG=json`` emits one
JSON object per line.  Output goes to stderr so it never interleaves
with machine-read stdout.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any

ENV = "REPRO_LOG"

_OFF = ("", "0", "off", "false")


def enabled() -> bool:
    return os.environ.get(ENV, "").lower() not in _OFF


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def log(event: str, **fields) -> None:
    """Emit one structured log line for ``event`` if logging is on."""
    mode = os.environ.get(ENV, "").lower()
    if mode in _OFF:
        return
    if mode == "json":
        line = json.dumps({"event": event, **fields}, default=str,
                          sort_keys=True)
    else:
        kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        line = f"[{event}] {kv}" if kv else f"[{event}]"
    sys.stderr.write(line + "\n")
    sys.stderr.flush()
