"""Helpers of the per-layer metric readers."""

from __future__ import annotations

from typing import Optional

from benchmark.lib import roofline


def roofline_pct(t, span: str) -> Optional[float]:
    """The least time of the window's ``span`` calls (their work over the
    card's peaks) as a share, in %, of the device time of every operation
    they launched. None where the span did not run, launched nothing or
    the card's peaks are not known."""
    s, w = t.span(span), t.work.get(span)
    if s is None or w is None or not s.device_s or t.peak is None:
        return None
    least, _ = roofline.least_seconds(w[0], w[1], t.peak)
    return 100.0 * least / s.device_s
