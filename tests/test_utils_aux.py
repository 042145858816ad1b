import numpy as np

from quadrs_tpu.sources import ToneGen
from quadrs_tpu.utils.determinism import check_repeatable, compare_backends
from quadrs_tpu.utils.profiling import PROFILER, profiled


def test_profiler_counts_executor_stages():
    PROFILER.reset()
    g = ToneGen([20], 400, 1.0)
    with profiled():
        g.read_at(0, 64)
        g.read_at(64, 64)
    stats = PROFILER.stages["tonegen"]
    assert stats.steps == 2
    assert stats.samples == 128
    assert stats.seconds > 0
    assert "tonegen" in PROFILER.report()
    # accounting is off outside the context
    g.read_at(0, 64)
    assert PROFILER.stages["tonegen"].steps == 2


def test_determinism_check():
    g = ToneGen([20, 33], 400, 1.0)
    check_repeatable(lambda: g.read_at(3, 128)[0])


def test_compare_backends_runs():
    # on the CPU this compares cpu vs cpu; on an accelerator it
    # cross-checks the accelerator against the host backend
    g = ToneGen([20], 400, 1.0)
    compare_backends(lambda: np.asarray(g.read_at(0, 64)[0]), atol=1e-5)


def test_measure_msps_acc_harness():
    import jax.numpy as jnp

    from quadrs_tpu.utils.timing import measure_msps_acc

    calls = []

    def step(i, acc):
        calls.append(i)
        return acc + jnp.float32(1.0)

    import jax

    try:
        msps = measure_msps_acc(step, samples_per_step=1_000_000, min_secs=0.01, min_iters=2)
    except RuntimeError:
        # on an accelerator a trivial step is pure dispatch jitter;
        # the harness legitimately refuses to report a number
        assert jax.devices()[0].platform != "cpu"
        return
    assert msps > 0
    assert calls[0] == 0 and len(calls) >= 5  # warmup + calibration + windows


def test_measure_msps_acc_rejects_nonlinear_timing(monkeypatch):
    """If windows don't scale with iteration count (a runtime skipping
    work), the harness must refuse to report a number."""
    import itertools
    import quadrs_tpu.utils.timing as timing

    fake_now = itertools.count(step=0.5)
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(fake_now))
    # every run() takes exactly one tick regardless of iters -> ratio 1.0

    import pytest

    with pytest.raises(RuntimeError, match="skipping"):
        timing.measure_msps_acc(
            lambda i, acc: acc, samples_per_step=1, min_secs=0.01, min_iters=2
        )
