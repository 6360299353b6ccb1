"""A read-only tap on the program's trace spans while a traced run lasts:
each span that closes is kept with its host-clock start and end and its
thread, so the profiler's idle gaps can be named by the span open on the
host.  The program's spans are unchanged (the tap calls the original
close first)."""
from __future__ import annotations

import threading
import time
from typing import List, Tuple


class SpanTap:
    def __init__(self):
        from pinot_tpu_torch.utils import metrics

        self._cls = metrics.Span
        self._orig = metrics.Span.close
        self.recording = False
        self.spans: List[Tuple[str, float, float, int]] = []
        tap = self

        def close(span):
            tap._orig(span)
            if tap.recording:
                tap.spans.append((span.name, span.start, time.perf_counter(), threading.get_ident()))

        self._cls.close = close

    def remove(self) -> None:
        self._cls.close = self._orig
