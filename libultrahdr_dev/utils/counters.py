"""Process-wide event counters for observability.

Device paths do not fall back on failure: an exception propagates to
the caller. What the counters record are the routes the DATA decides
(a frame too small for the device entropy coder, dense content that
overflows the device word buffers, content that does not compress on
readback, a stream the device decoder does not take). A serving loop
on content the device path is built for leaves every counter at zero;
bench.py and chip_smoke.py print the snapshot. Analog of the
reference's ALOGW-on-degraded-path habit
(/root/reference/lib/src/jpegr.cpp error funnels).
"""

from __future__ import annotations

import threading
from collections import defaultdict

_lock = threading.Lock()
_counters: dict[str, int] = defaultdict(int)


def bump(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


def snapshot() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
