"""Pulse-train clock recovery: run-length decode OOK pulses into bits.

Mirror of the reference's ``src/bits.rs``: ``scan`` walks a boolean
pulse stream with an estimated samples-per-bit ``scale``, tolerating up
to ``scale/2`` contrary samples inside a run (single glitches don't
break a pulse), emits ``round(run/scale)`` copies of each bit, and
accumulates ``sum |run/scale - round(run/scale)|`` as a clock-error
metric.  Like the reference it is a library helper (exported but not
wired to a CLI command; the README's OOK workflow does this step in
shell).

The algorithm is inherently sequential with data-dependent control flow
— a poor fit for the device and a fine fit for the host — so it runs in
numpy-accelerated Python over run-length encodings rather than as a
device kernel.
"""

from __future__ import annotations

import numpy as np


def run_of(data, scale: int, val: bool) -> int:
    """Length of the run of ``val`` at the start of ``data``, tolerating
    short contrary bursts of up to ``scale`` samples (``src/bits.rs:40-55``)."""
    bad = 0
    for i, bit in enumerate(data):
        if bool(bit) != val:
            bad += 1
        else:
            bad = 0
        if bad > scale:
            return i + 1 - bad
    return len(data)


def scan(data, scale: float) -> tuple[float, list[bool]]:
    """Decode a pulse train into bits (``src/bits.rs:3-38``).

    Returns ``(clock_error, bits)``.
    """
    data = np.asarray(data, dtype=bool)
    half = int(_rust_round(scale / 2.0))
    i = 0
    bit = False
    error = 0.0
    ret: list[bool] = []
    n = len(data)
    while i != n:
        found = _run_of_fast(data, i, half, bit)
        i += found
        if found <= half:
            if found == 0:
                # the stream opens with a long run of the *other* value;
                # the reference spins forever here (run_of returns 0 and
                # nothing advances, src/bits.rs:9-35) — we flip the
                # expected bit and move on instead of hanging
                bit = not bit
            continue
        bits = found / scale
        rounded = _rust_round(bits)
        error += abs(bits - rounded)
        ret.extend([bit] * int(rounded))
        bit = not bit
    return error, ret


def _rust_round(x: float) -> float:
    """f64::round — half away from zero (Python's round() is half-even)."""
    return float(np.floor(x + 0.5)) if x >= 0 else float(np.ceil(x - 0.5))


def _run_of_fast(data: np.ndarray, start: int, scale: int, val: bool) -> int:
    """``run_of`` on ``data[start:]`` without copying.

    Semantics identical to :func:`run_of`: scan until more than ``scale``
    consecutive contrary samples, then report the run length up to (and
    excluding) that contrary burst.
    """
    sub = data[start:]
    mismatch = sub != val
    if not mismatch.any():
        return len(sub)
    # positions where a contrary burst of length scale+1 completes
    if scale == 0:
        return int(np.argmax(mismatch))
    # sliding window sum of mismatches over windows of size scale+1
    w = scale + 1
    if len(sub) < w:
        # can't complete a burst; run covers everything
        return len(sub)
    csum = np.concatenate([[0], np.cumsum(mismatch.astype(np.int64))])
    window = csum[w:] - csum[:-w]  # mismatches in sub[i-w+1 .. i]
    full = np.nonzero(window == w)[0]
    if len(full) == 0:
        return len(sub)
    end = int(full[0]) + w  # i+1 in the reference's loop terms
    return end - w
