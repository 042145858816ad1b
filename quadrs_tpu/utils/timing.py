"""Shared benchmark timing: warmup, calibration, fetch-synchronized
differencing."""

from __future__ import annotations

import time
from typing import Callable


def measure_msps_acc(
    acc_step: Callable[[int, object], object],
    samples_per_step: int,
    min_secs: float,
    min_iters: int = 4,
    reps: int = 2,
    stats_out: dict | None = None,
) -> float:
    """Throughput of ``acc_step(i, acc) -> acc'`` in Msamples/sec, where
    ``acc'`` must fold a *full reduction of iteration i's entire output*
    into the carried scalar (``acc + jnp.sum(out)`` inside the same jit).

    The timing fetch at a window's end observes one scalar; with the
    full-sum accumulator every element of every iteration is in its
    dependency cone, so the fetch waits for all the work, while
    iterations may still overlap, which is what a throughput number
    wants.  Windows of n and 3n iterations are differenced so the fixed
    fetch/dispatch cost cancels (best of ``reps``, min-time rule).

    ``stats_out``: optional dict the harness fills with the audit trail
    of the accepted measurement — ``linearity`` (the observed t(3n)/t(n)
    ratio of the best rep; 3.0 is perfect), ``n1`` (the window size) —
    so every bench artifact can carry proof its windows scaled.
    """
    import jax.numpy as jnp

    def run(iters: int) -> float:
        acc = jnp.float32(0.0)
        t0 = time.perf_counter()
        for i in range(iters):
            acc = acc_step(i, acc)
        float(acc)
        return time.perf_counter() - t0

    run(1)  # warmup / compile
    per = max(run(2) / 2, 1e-5)
    best = 0.0
    best_ratio = 0.0
    best_n1 = 0
    # The linearity check applies to any real benchmark (multi-second
    # min_secs) regardless of how small its windows came out — a tiny t1
    # there means the calibration itself was off and must retry, not
    # that the check should be waived.  Only explicit smoke runs
    # (min_secs < 0.5, e.g. unit tests) skip it when the window sits
    # below dispatch jitter.
    # Multi-second runs get the tight gate: a 3x window under 2.25x the
    # time means >25% of the extra work was skipped or batched away —
    # reject; the loose lower bound only covers sub-second windows where
    # dispatch jitter is comparable to the window itself.  The upper
    # bound stays wide on purpose: a too-SLOW 3x window (a host hiccup
    # inside t2) deflates the differenced rate — conservative, and the
    # min-time best-of rule already prefers cleaner reps.
    strict = min_secs >= 0.5
    lo = 2.25 if min_secs >= 2.0 else 1.8
    for attempt in range(4):
        n1 = max(min_iters, min(4096, int(min_secs / per / (2 * max(1, reps)))))
        n2 = 3 * n1
        ok = False
        for _ in range(max(1, reps)):
            t1, t2 = run(n1), run(n2)
            ratio = t2 / max(t1, 1e-9)
            # honesty check: a 3x window must take ~3x the time.  A ratio
            # far off means the runtime skipped or deferred work (or the
            # calibration was off) and the difference is meaningless.
            # a non-positive difference is never meaningful (jitter ate
            # the window) — recalibrate even on waived smoke runs
            if t2 <= t1 or ((strict or t1 >= 0.05) and not (lo <= ratio <= 5.0)):
                per = max((t1 + t2) / (n1 + n2), 1e-5)
                break
            msps = (n2 - n1) * samples_per_step / max(t2 - t1, 1e-9) / 1e6
            if msps > best:
                best = msps
                best_ratio = ratio
                best_n1 = n1
            ok = True
        if ok:
            if stats_out is not None:
                stats_out["linearity"] = round(best_ratio, 3)
                stats_out["n1"] = best_n1
            return best
    raise RuntimeError(
        "measure_msps_acc: timing windows never scaled linearly with "
        "iteration count; the runtime is skipping or batching work"
    )
