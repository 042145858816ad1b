"""Matched-filter pattern search: ``sinks.find_pattern`` + ``quadjax
find`` (an addition, no reference counterpart).

Conformance target is the definition itself: the normalized-correlation
score ``|sum conj(p) x|^2 / (E_p E_x)`` — pinned against a sequential
f64 numpy oracle over every lag — plus exact recovery of patterns
planted at known offsets under gain, phase, and noise.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from quadrs_tpu import sinks
from quadrs_tpu.formats import FileFormat
from quadrs_tpu.ops.correlate import PeakScan, suppress
from quadrs_tpu.sources import SampleSource


def cf32_source(x: np.ndarray, sr: int = 48_000) -> SampleSource:
    raw = np.empty(2 * len(x), dtype=np.float32)
    raw[0::2] = x.real
    raw[1::2] = x.imag
    return SampleSource(
        np.frombuffer(raw.tobytes(), dtype=np.uint8), FileFormat.COMPLEX_FLOAT32, sr
    )


def oracle_scores(x: np.ndarray, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sequential f64 normalized correlation at every lag."""
    x = np.asarray(x, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    l, n = len(p), len(x)
    e_p = float(np.sum(np.abs(p) ** 2))
    score = np.empty(n - l + 1)
    scale = np.empty(n - l + 1)
    for o in range(n - l + 1):
        w = x[o : o + l]
        c = np.sum(np.conj(p) * w)
        e_x = float(np.sum(np.abs(w) ** 2))
        score[o] = 0.0 if e_x == 0.0 else abs(c) ** 2 / (e_p * e_x)
        scale[o] = abs(c) / e_p
    return score, scale


def device_scores(x: np.ndarray, p: np.ndarray, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """Full per-lag device scores via the same executor plumbing
    find_pattern uses (threshold 0 local-max scan would drop non-peaks,
    so this drives the post directly)."""
    from quadrs_tpu.ops.correlate import make_xcorr_post
    from quadrs_tpu.runtime import Executor, _round_up_pow2, window_batches

    src = cf32_source(x)
    l = len(p)
    c = _round_up_pow2(max(2 * l, min(chunk, src.length)))
    n_out = c - l + 1
    n_lags = src.length - l + 1
    offsets = np.arange(0, n_lags, n_out, dtype=np.int64)
    batch, batches = window_batches(offsets, c)
    ex = Executor(src, c, batch=batch, post=make_xcorr_post(p, c))
    score = np.empty(n_lags, dtype=np.float32)
    scale = np.empty(n_lags, dtype=np.float32)
    for offs in batches:
        (s, a, _fidx), valid = ex.run(offs)
        for i in range(len(offs)):
            o, v = int(offs[i]), int(valid[i])
            m = min(max(0, v - l + 1), n_lags - o)
            score[o : o + m] = np.asarray(s)[i][:m]
            scale[o : o + m] = np.asarray(a)[i][:m]
    return score, scale


def test_scores_match_oracle_every_lag():
    rng = np.random.default_rng(3)
    n, l = 3_000, 37
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x[500 : 500 + l] += 2.0 * p  # one strong plant so the peak row is covered

    want_score, want_scale = oracle_scores(x, p)
    got_score, got_scale = device_scores(x, p, chunk=1024)
    np.testing.assert_allclose(got_score, want_score, atol=2e-4)
    np.testing.assert_allclose(got_scale, want_scale, atol=2e-4)


def test_planted_patterns_recovered_exactly():
    """Plants at arbitrary offsets (one flush with EOF) come back at
    exactly those offsets, gain- and phase-invariantly."""
    rng = np.random.default_rng(7)
    n, l = 200_000, 511
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    plants = {1_234: 0.3, 77_777: 2.0, 150_000: 0.05, n - l: 1.0}
    for i, (o, g) in enumerate(plants.items()):
        x[o : o + l] += np.complex64(g * np.exp(1j * (0.9 * i))) * p

    res = sinks.find_pattern(cf32_source(x), p, threshold=0.5)
    assert list(res.offsets) == sorted(plants)
    # the 0.05-gain plant sits ~14 dB over the noise floor: score ~0.96
    assert np.all(res.scores > 0.9)
    for o, g in plants.items():
        got = float(res.scales[list(res.offsets).index(o)])
        assert abs(got - g) < 0.05 * max(g, 0.1)
    assert res.pattern_len == l and res.scanned == n


def test_chunk_size_invariance():
    """The FFT block size is an implementation knob: offsets identical,
    scores equal to f32 tolerance across chunk sizes."""
    rng = np.random.default_rng(9)
    n, l = 50_000, 200
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    for o in (0, 20_011, 49_800):
        x[o : o + l] += 0.7 * p
    src = cf32_source(x)
    a = sinks.find_pattern(src, p, threshold=0.5, chunk=1 << 16)
    b = sinks.find_pattern(src, p, threshold=0.5, chunk=3_000)
    assert np.array_equal(a.offsets, b.offsets)
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-4)
    assert list(a.offsets) == [0, 20_011, 49_800]


def test_device_extract_matches_full_path(monkeypatch):
    """The device-side candidate scan (top-k + boundary scalars,
    sinks.find_pattern's default for full batches) yields byte-identical
    matches to the full-score PeakScan path, across multi-dispatch runs,
    pending-element handoffs at every dispatch boundary, and top-k
    overflow fallbacks."""
    rng = np.random.default_rng(21)
    l = 512
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    n = 120_000
    x = 0.03 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    plants = [100, 30_000, 59_777, 90_000, 119_000]
    for i, o in enumerate(plants):
        x[o : o + l] += np.complex64(0.8 * np.exp(1j * i)) * p
    src = cf32_source(x)

    # tiny budget: c=8192 -> 4-window dispatches, ~15 full + ragged tail
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 1 << 15)
    a = sinks.find_pattern(src, p, threshold=0.5, chunk=8192)
    # top-k of 1 overflows whenever a dispatch holds >1 candidate,
    # exercising the full-score fallback mid-run
    monkeypatch.setattr(sinks, "FIND_TOPK", 1)
    b = sinks.find_pattern(src, p, threshold=0.5, chunk=8192)
    # single fat dispatch (default budget), extract path end-to-end
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 1 << 22)
    monkeypatch.setattr(sinks, "FIND_TOPK", 1024)
    d = sinks.find_pattern(src, p, threshold=0.5, chunk=8192)

    assert list(a.offsets) == plants
    for other in (b, d):
        assert np.array_equal(a.offsets, other.offsets)
        np.testing.assert_allclose(a.scores, other.scores, atol=1e-4)
        np.testing.assert_allclose(a.scales, other.scales, atol=1e-4)
        assert np.array_equal(a.which, other.which)


def test_device_extract_clustered_candidates(monkeypatch):
    """Two candidates landing in ONE extraction block exercise the
    hierarchical scan's flat-sort fallback branch (a block's masked max
    carries only one candidate, so the program must detect the
    collision and take the full lax.top_k path).  min_distance=1 keeps
    both matches through NMS so a dropped candidate would be visible."""
    rng = np.random.default_rng(24)
    l = 256
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    n = 40_000
    x = 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    # 2048 is a multiple of every block width the program can pick, so
    # lags 2048 and 2051 always share a block; the overlapping copies
    # cross-talk only ~1/sqrt(l), leaving two distinct local maxima
    x[2048 : 2048 + l] += np.complex64(0.9) * p
    x[2051 : 2051 + l] += np.complex64(0.7 * np.exp(0.4j)) * p
    src = cf32_source(x)
    kw = dict(threshold=0.2, chunk=8192, min_distance=1)
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 1 << 15)
    a = sinks.find_pattern(src, p, **kw)  # extract path, full-sort branch
    monkeypatch.setattr(sinks, "FIND_TOPK", 1)  # overflow -> full-score rerun
    b = sinks.find_pattern(src, p, **kw)
    assert np.array_equal(a.offsets, b.offsets)
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-4)
    np.testing.assert_allclose(a.scales, b.scales, atol=1e-4)
    assert {2048, 2051} <= set(a.offsets.tolist())


def test_device_extract_aligned_tail(monkeypatch):
    """A stream whose last window is exactly full (no ragged tail)
    drives the PENDING element through finish() off the extract path;
    a plant at the very last lag must still be found."""
    rng = np.random.default_rng(22)
    l = 512
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    c = 8192
    n_out = c - l + 1
    n = 4 * n_out + l - 1  # windows tile [0, n_lags) exactly
    x = 0.03 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    x[n - l :] += 0.8 * p  # match at the final lag = the last pending
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 1 << 15)
    res = sinks.find_pattern(cf32_source(x), p, threshold=0.5, chunk=c)
    assert list(res.offsets) == [n - l]


def test_device_extract_bank_and_grid(monkeypatch):
    """Extract path parity for the template-bank + frequency-grid
    search: which/freqs/scores identical to the full-score path."""
    rng = np.random.default_rng(23)
    sr = 48_000
    l = 400
    pa = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    pb = (rng.standard_normal(l // 2) + 1j * rng.standard_normal(l // 2)).astype(
        np.complex64
    )
    n = 60_000
    x = 0.03 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    m = np.arange(l)
    cfo = 110.0  # Hz
    x[5_000 : 5_000 + l] += 0.7 * pa * np.exp(2j * np.pi * cfo * m / sr).astype(
        np.complex64
    )
    x[40_000 : 40_000 + l // 2] += 0.9 * pb
    src = cf32_source(x, sr=sr)
    kw = dict(threshold=0.4, chunk=4096, freq_tol=300.0)
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 1 << 14)  # 4-window
    a = sinks.find_pattern(src, [pa, pb], **kw)
    monkeypatch.setattr(sinks, "FIND_TOPK", 1)  # force overflow fallback
    b = sinks.find_pattern(src, [pa, pb], **kw)
    assert list(a.offsets) == [5_000, 40_000]
    assert list(a.which) == [0, 1]
    assert abs(a.freqs[0] - cfo) <= 0.5 * 0.4 * sr / l
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.which, b.which)
    assert np.array_equal(a.freqs, b.freqs)
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-4)


def test_sharded_find_matches_single_device(monkeypatch):
    """find_pattern(mesh=4x1) time-shards the capture with an l-1
    halo; matches equal the single-device run (offsets/which exact,
    scores to f32 accumulation order), including candidates straddling
    shard boundaries and the unaligned capture tail that runs
    single-device."""
    import jax

    from quadrs_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    rng = np.random.default_rng(31)
    l = 512
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    c = 4096
    n_out = c - l + 1
    # small shard budget -> several mesh chunks of 4 shards x 1 window,
    # plus an unaligned remainder handled by the single-device path
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 4 * c)
    step_lags = 4 * n_out
    n = 3 * step_lags + 2 * n_out + 777
    x = 0.03 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    plants = [
        5,
        n_out - 30,  # straddles the shard-0/shard-1 lag boundary
        2 * n_out,  # exactly at a shard boundary
        step_lags - 100,  # straddles a mesh-chunk boundary
        3 * step_lags + 50,  # inside the single-device tail
        n - l,  # the final lag
    ]
    for i, o in enumerate(plants):
        x[o : o + l] += np.complex64(0.8 * np.exp(0.7j * i)) * p
    src = cf32_source(x)
    want = sinks.find_pattern(src, p, threshold=0.5, chunk=c)
    got = sinks.find_pattern(
        src, p, threshold=0.5, chunk=c, mesh=make_mesh(4, 1)
    )
    assert list(want.offsets) == sorted(plants)
    assert np.array_equal(want.offsets, got.offsets)
    # same window partitioning; scores agree to f32 accumulation order
    # (XLA tiles the DFT matmuls differently per batch shape)
    np.testing.assert_allclose(want.scores, got.scores, rtol=0, atol=4e-6)
    np.testing.assert_allclose(want.scales, got.scales, rtol=1e-5, atol=0)
    assert np.array_equal(want.which, got.which)


def test_sharded_find_bank_grid(monkeypatch):
    """Sharded template bank + frequency grid: which/freqs parity."""
    import jax

    from quadrs_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    rng = np.random.default_rng(32)
    sr = 48_000
    l = 256
    pa = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    pb = (rng.standard_normal(l // 2) + 1j * rng.standard_normal(l // 2)).astype(
        np.complex64
    )
    c = 2048
    monkeypatch.setattr(sinks, "FIND_DISPATCH_BUDGET", 2 * c)
    n = 6 * 2 * (c - l + 1) + 123
    x = 0.03 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    m = np.arange(l)
    x[4_000 : 4_000 + l] += 0.7 * pa * np.exp(
        2j * np.pi * 120.0 * m / sr
    ).astype(np.complex64)
    x[15_000 : 15_000 + l // 2] += 0.9 * pb
    src = cf32_source(x, sr=sr)
    kw = dict(threshold=0.4, chunk=c, freq_tol=300.0)
    want = sinks.find_pattern(src, [pa, pb], **kw)
    got = sinks.find_pattern(src, [pa, pb], mesh=make_mesh(2, 1), **kw)
    assert np.array_equal(want.offsets, got.offsets)
    np.testing.assert_allclose(want.scores, got.scores, rtol=0, atol=4e-6)
    assert np.array_equal(want.which, got.which)
    assert np.array_equal(want.freqs, got.freqs)


def test_sharded_find_rejects_chained_stream():
    import jax

    from quadrs_tpu.parallel.sharding import make_mesh
    from quadrs_tpu.stream import Shift

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    rng = np.random.default_rng(33)
    x = (rng.standard_normal(9000) + 1j * rng.standard_normal(9000)).astype(
        np.complex64
    )
    p = x[100:356].copy()
    chain = Shift(cf32_source(x), 1000, 48_000)
    with pytest.raises(ValueError, match="raw capture"):
        sinks.find_pattern(chain, p, mesh=make_mesh(2, 1))


def test_nms_collapses_sidelobes():
    """A repeated pattern (period < distance) yields one match per
    plant; near-duplicate candidates within min_distance collapse to
    the best."""
    rng = np.random.default_rng(5)
    l = 64
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    # a pattern with strong self-similarity: p followed by p again ->
    # candidates at both starts; distance=2*l keeps only the better
    x = 0.01 * (rng.standard_normal(4_000) + 1j * rng.standard_normal(4_000)).astype(
        np.complex64
    )
    x[1_000 : 1_000 + l] += p
    x[1_000 + l : 1_000 + 2 * l] += p
    res = sinks.find_pattern(cf32_source(x), p, threshold=0.5, min_distance=2 * l)
    assert len(res.offsets) == 1 and res.offsets[0] in (1_000, 1_000 + l)
    both = sinks.find_pattern(cf32_source(x), p, threshold=0.5)  # default l
    assert list(both.offsets) == [1_000, 1_000 + l]


def test_max_matches_keeps_strongest():
    rng = np.random.default_rng(13)
    l = 100
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = 0.3 * (rng.standard_normal(30_000) + 1j * rng.standard_normal(30_000)).astype(
        np.complex64
    )
    x[2_000 : 2_000 + l] += 0.8 * p  # weaker (more noise-diluted)
    x[9_000 : 9_000 + l] += 5.0 * p  # strongest
    res = sinks.find_pattern(cf32_source(x), p, threshold=0.2, max_matches=1)
    assert list(res.offsets) == [9_000]


def test_peakscan_boundary_exact():
    """Feeding the same score sequence in ragged chunks finds exactly
    the hits of a one-shot feed — boundaries hold back one element."""
    rng = np.random.default_rng(21)
    s = rng.random(997).astype(np.float32)
    aux = rng.random(997).astype(np.float32)

    one = PeakScan(0.6)
    one.feed(0, s, aux)
    one.finish()

    ragged = PeakScan(0.6)
    o = 0
    for sz in (1, 2, 317, 100, 1, 576):
        ragged.feed(o, s[o : o + sz], aux[o : o + sz])
        o += sz
    ragged.finish()
    assert ragged.offsets == one.offsets
    assert ragged.scores == one.scores
    assert np.array_equal(np.asarray(ragged.aux), np.asarray(one.aux))
    assert len(one.offsets) > 10  # the fixture actually exercises hits


def test_suppress_orders_and_bounds():
    off = np.array([10, 12, 100, 103, 500])
    sc = np.array([0.9, 0.95, 0.8, 0.85, 0.7])
    keep = suppress(off, sc, min_distance=5)
    assert [int(off[i]) for i in keep] == [12, 103, 500]
    keep2 = suppress(off, sc, min_distance=5, max_matches=2)
    assert [int(off[i]) for i in keep2] == [12, 103]
    assert len(suppress(off, sc, min_distance=5, max_matches=0)) == 0


def test_degenerate_template_fails_fast(monkeypatch):
    """A template that matches nearly everywhere (a CW tone over its
    own carrier) must error with guidance, not accumulate millions of
    rounding-noise candidates."""
    n, l = 60_000, 64
    t = np.arange(n)
    x = np.exp(2j * np.pi * 0.01 * t).astype(np.complex64)
    p = x[:l].copy()
    monkeypatch.setattr(sinks, "FIND_CANDIDATE_CAP", 1_000)
    with pytest.raises(ValueError, match="matches nearly everywhere"):
        sinks.find_pattern(cf32_source(x), p, threshold=0.5, chunk=8_192)


def test_find_on_chained_stream():
    """find composes after shift/lowpass: a slice of the decimated
    chain read back as the pattern matches itself at its own offset."""
    from quadrs_tpu.stream import LowPass, Shift

    rng = np.random.default_rng(17)
    n = 80_000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    chain = LowPass(Shift(cf32_source(x), 3_000), 5_000, 4, 80)
    pat, valid = chain.read_at(5_000, 300)
    assert valid == 300
    res = sinks.find_pattern(chain, pat, threshold=0.9)
    assert 5_000 in list(res.offsets)
    i = list(res.offsets).index(5_000)
    assert res.scores[i] > 0.999 and abs(res.scales[i] - 1.0) < 1e-3


def test_freq_tolerant_search_recovers_offset_and_cfo():
    """A pattern received under carrier offset is invisible to the
    plain search (|sinc(f*l/rate)| wipes the score) but found by the
    frequency grid, which also reports the offset to grid resolution."""
    rng = np.random.default_rng(29)
    sr, n, l = 48_000, 60_000, 960  # 20 ms pattern
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    f_off = 137.0  # Hz; f*l/rate = 2.74 cycles over the pattern
    rot = np.exp(2j * np.pi * f_off * np.arange(l) / sr)
    for o in (7_000, 31_000):
        x[o : o + l] += (0.6 * rot * p).astype(np.complex64)
    src = cf32_source(x, sr)

    plain = sinks.find_pattern(src, p, threshold=0.5)
    assert len(plain.offsets) == 0  # CFO kills the uncompensated match

    res = sinks.find_pattern(src, p, threshold=0.5, freq_tol=300.0)
    assert list(res.offsets) == [7_000, 31_000]
    step = 0.4 * sr / l
    assert np.all(np.abs(res.freqs - f_off) <= 0.5 * step + 1e-9)
    assert np.all(res.scores > 0.8)
    assert np.all(np.abs(res.scales - 0.6) < 0.05)


def test_freq_grid_matches_oracle_max():
    """Device best-of-grid scores equal the f64 oracle's per-row max."""
    rng = np.random.default_rng(33)
    sr, n, l = 10_000, 2_000, 50
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)

    from quadrs_tpu.ops.correlate import make_xcorr_post
    from quadrs_tpu.runtime import Executor, _round_up_pow2

    step = 0.4 * sr / l
    grid_hz = np.arange(-2, 3) * step
    c = _round_up_pow2(2 * l + n)
    ex = Executor(
        cf32_source(x, sr), c, post=make_xcorr_post(p, c, grid_hz / sr)
    )
    (score, _scale, fidx), valid = ex.run(np.asarray([0], dtype=np.int64))
    m = int(valid[0]) - l + 1
    got = np.asarray(score)[0][:m]
    got_f = np.asarray(fidx)[0][:m]

    rows = []
    mm = np.arange(l, dtype=np.float64)
    for f in grid_hz:
        pf = p * np.exp(2j * np.pi * f * mm / sr)
        rows.append(oracle_scores(x, pf)[0])
    want = np.max(np.stack(rows), axis=0)
    want_f = np.argmax(np.stack(rows), axis=0)
    np.testing.assert_allclose(got, want, atol=5e-4)
    # ties between grid rows can flip under f32; compare scores instead
    picked = np.stack(rows)[got_f, np.arange(m)]
    np.testing.assert_allclose(picked, want, atol=5e-4)


def test_template_bank_classifies_matches():
    """A bank of two sync words (different lengths): one device pass
    finds both kinds of plant and reports which template fired, with
    per-template normalization (different energies compete fairly)."""
    rng = np.random.default_rng(41)
    n = 100_000
    p_a = (rng.standard_normal(300) + 1j * rng.standard_normal(300)).astype(
        np.complex64
    )
    p_b = 3.0 * (rng.standard_normal(200) + 1j * rng.standard_normal(200)).astype(
        np.complex64
    )  # different length AND energy
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    plants = [(5_000, 0), (40_000, 1), (70_000, 0), (90_000, 1)]
    for o, k in plants:
        p = (p_a, p_b)[k]
        x[o : o + len(p)] += 0.5 * p

    res = sinks.find_pattern(cf32_source(x), [p_a, p_b], threshold=0.5)
    assert [(int(o), int(w)) for o, w in zip(res.offsets, res.which)] == plants
    assert np.all(res.scores > 0.9)
    np.testing.assert_allclose(res.scales, 0.5, atol=0.03)
    assert res.pattern_len == 300  # the longest template


def test_template_bank_with_freq_grid():
    """Bank x frequency grid: the row index decodes to (which, freq)."""
    rng = np.random.default_rng(43)
    sr, n = 48_000, 50_000
    p_a = (rng.standard_normal(480) + 1j * rng.standard_normal(480)).astype(
        np.complex64
    )
    p_b = (rng.standard_normal(480) + 1j * rng.standard_normal(480)).astype(
        np.complex64
    )
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    rot = np.exp(2j * np.pi * 90.0 * np.arange(480) / sr)
    x[9_000 : 9_000 + 480] += (0.7 * rot * p_a).astype(np.complex64)
    x[30_000 : 30_000 + 480] += (0.7 * rot * p_b).astype(np.complex64)

    res = sinks.find_pattern(
        cf32_source(x, sr), [p_a, p_b], threshold=0.5, freq_tol=200.0
    )
    assert [(int(o), int(w)) for o, w in zip(res.offsets, res.which)] == [
        (9_000, 0),
        (30_000, 1),
    ]
    step = 0.4 * sr / 480
    assert np.all(np.abs(res.freqs - 90.0) <= 0.5 * step + 1e-9)


def test_live_pipe_matches_file_exactly():
    """find over a LivePipeStream (length unknown until EOF, windows
    walked forward, EOF batch re-planned) returns byte-identical
    matches to the file path on the same samples."""
    import io

    from quadrs_tpu.sources import LivePipeStream, PipeSource

    rng = np.random.default_rng(51)
    n, l = 120_000, 400
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    for o in (100, 60_000, n - l - 7):
        x[o : o + l] += 0.4 * p
    raw = np.empty(2 * n, dtype=np.float32)
    raw[0::2] = x.real
    raw[1::2] = x.imag

    want = sinks.find_pattern(cf32_source(x), p, threshold=0.5, chunk=8_192)
    pipe = PipeSource(io.BytesIO(raw.tobytes()), FileFormat.COMPLEX_FLOAT32, 48_000)
    got = sinks.find_pattern(
        LivePipeStream(pipe), p, threshold=0.5, chunk=8_192
    )
    assert np.array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.scales, want.scales)
    assert got.scanned == want.scanned == n
    assert list(want.offsets) == [100, 60_000, n - l - 7]


def test_error_surface():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(100) + 1j * rng.standard_normal(100)).astype(np.complex64)
    src = cf32_source(x)
    with pytest.raises(ValueError, match="at least 2"):
        sinks.find_pattern(src, x[:1])
    with pytest.raises(ValueError, match="shorter than the pattern"):
        sinks.find_pattern(cf32_source(x[:10]), x[:50])
    with pytest.raises(ValueError, match="threshold"):
        sinks.find_pattern(src, x[:10], threshold=0.0)
    with pytest.raises(ValueError, match="all zero"):
        sinks.find_pattern(src, np.zeros(8, np.complex64))
    with pytest.raises(ValueError, match="exceeds 256"):
        sinks.find_pattern(src, x[:50], freq_tol=20_000.0, freq_step=1.0)


class TestCli:
    def _files(self, tmp_path):
        rng = np.random.default_rng(31)
        n, l = 40_000, 400
        p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
        x = 0.01 * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n)
        ).astype(np.complex64)
        x[12_345 : 12_345 + l] += 0.5 * p
        for name, arr in (("cap", x), ("pat", p)):
            raw = np.empty(2 * len(arr), dtype=np.float32)
            raw[0::2] = arr.real
            raw[1::2] = arr.imag
            (tmp_path / f"{name}.sr48k.cf32").write_bytes(raw.tobytes())
        return tmp_path / "cap.sr48k.cf32", tmp_path / "pat.sr48k.cf32"

    def test_find_reports_plant(self, tmp_path, capsys):
        from quadrs_tpu.cli import main

        cap, pat = self._files(tmp_path)
        rc = main(["from", str(cap), "find", "-pattern", str(pat),
                   "-threshold", "0.8"])
        assert rc == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[-1] == "find: 1 matches, pattern 400 samples, 40000 scanned"
        off, score, scale, freq = lines[0].split(",")
        assert int(off) == 12_345
        assert float(score) > 0.95
        assert abs(float(scale) - 0.5) < 0.05
        assert float(freq) == 0.0

    def test_find_mesh_cli_matches_single_device(self, tmp_path, capsys):
        import jax

        from quadrs_tpu.cli import main

        if len(jax.devices()) < 4:
            pytest.skip("needs >= 4 devices")
        cap, pat = self._files(tmp_path)
        rc = main(["from", str(cap), "find", "-pattern", str(pat),
                   "-threshold", "0.8"])
        assert rc == 0
        want = capsys.readouterr().out.strip().splitlines()
        rc = main(["from", str(cap), "find", "-pattern", str(pat),
                   "-threshold", "0.8", "-mesh", "4"])
        assert rc == 0
        got = capsys.readouterr().out.strip().splitlines()
        # the auto block (2048 here) puts the whole aligned prefix
        # through the real mesh step: offsets/freqs exact, scores and
        # scales within f32 accumulation order (the documented mesh
        # contract), trailer identical
        assert len(got) == len(want) and got[-1] == want[-1]
        for wl, gl in zip(want[:-1], got[:-1]):
            wo, ws, wa, wf = wl.split(",")
            go, gs, ga, gf = gl.split(",")
            assert (go, gf) == (wo, wf)
            assert abs(float(gs) - float(ws)) <= 1e-3
            assert abs(float(ga) - float(wa)) <= 1e-4 * max(1.0, abs(float(wa)))

    def test_find_mesh_rejects_stream_axis(self, capsys):
        from quadrs_tpu.cli import main

        rc = main(["from", "x.sr1k.cf32", "find", "-pattern", "p.sr1k.cf32",
                   "-mesh", "2x2"])
        assert rc != 0
        assert "Tx1" in capsys.readouterr().err

    def test_find_rate_mismatch_errors(self, tmp_path, capsys):
        from quadrs_tpu.cli import main

        cap, pat = self._files(tmp_path)
        rc = main(["from", str(cap), "find", "-pattern", str(pat),
                   "-sr", "96k"])
        assert rc == 1
        assert "pattern rate" in capsys.readouterr().err

    def test_find_parse_errors(self, capsys):
        from quadrs_tpu.cli import main

        assert main(["find"]) == 1
        assert "requires -pattern" in capsys.readouterr().err
        assert main(["find", "-pattern", "x.sr1k.cf32", "-threshold", "1.5"]) == 1
        assert "(0, 1]" in capsys.readouterr().err
        assert main(["find", "-pattern", "x.sr1k.cf32", "-freq-tol", "-5"]) == 1
        assert "-freq-tol" in capsys.readouterr().err
        assert main(["find", "-pattern", "x.sr1k.cf32", "-freq-step", "0"]) == 1
        assert "-freq-step" in capsys.readouterr().err
        assert main(["gen", "-cos", "1k", "-len", "0.1", "48k", "find",
                     "-pattern", "nope.sr48k.cf32"]) == 1
        capsys.readouterr()

    def test_find_pattern_bank_cli(self, tmp_path, capsys):
        """Repeated -pattern flags form a bank; match lines gain the
        winning template index."""
        from quadrs_tpu.cli import main

        rng = np.random.default_rng(47)
        n = 30_000
        p0 = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
            np.complex64
        )
        p1 = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(
            np.complex64
        )
        x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
        x[4_000 : 4_000 + 256] += p0
        x[20_000 : 20_000 + 256] += p1
        for name, arr in (("cap", x), ("p0", p0), ("p1", p1)):
            raw = np.empty(2 * len(arr), dtype=np.float32)
            raw[0::2] = arr.real
            raw[1::2] = arr.imag
            (tmp_path / f"{name}.sr48k.cf32").write_bytes(raw.tobytes())
        rc = main(["from", str(tmp_path / "cap.sr48k.cf32"), "find",
                   "-pattern", str(tmp_path / "p0.sr48k.cf32"),
                   "-pattern", str(tmp_path / "p1.sr48k.cf32"),
                   "-threshold", "0.8"])
        assert rc == 0
        lines = capsys.readouterr().out.strip().splitlines()
        rows = [ln.split(",") for ln in lines[:-1]]
        assert [(int(r[0]), int(r[4])) for r in rows] == [
            (4_000, 0),
            (20_000, 1),
        ]

    def test_find_requires_input(self, tmp_path, capsys):
        from quadrs_tpu.cli import main

        _, pat = self._files(tmp_path)
        assert main(["find", "-pattern", str(pat)]) == 1
        assert "find requires an input" in capsys.readouterr().err

    def test_find_stdin_matches_file(self, tmp_path, capsys, monkeypatch):
        """``find -stdin yes`` over a pipe prints the matches the
        ``from FILE find`` run prints for the same bytes: offsets,
        frequencies, and the trailer exactly; scores/scales within f32
        accumulation order (the pipe walks small fixed window batches
        while the file path sizes its batch to the capture, and batch
        shape shifts XLA's matmul tiling)."""
        import io
        import sys
        from types import SimpleNamespace

        from quadrs_tpu.cli import main

        cap, pat = self._files(tmp_path)
        rc = main(["from", str(cap), "find", "-pattern", str(pat),
                   "-threshold", "0.8"])
        assert rc == 0
        want = capsys.readouterr().out.strip().splitlines()

        monkeypatch.setattr(
            sys, "stdin", SimpleNamespace(buffer=io.BytesIO(cap.read_bytes()))
        )
        rc = main(["find", "-pattern", str(pat), "-threshold", "0.8",
                   "-stdin", "yes", "-sr", "48k", "-format", "cf32"])
        assert rc == 0
        got = capsys.readouterr().out.strip().splitlines()
        assert len(got) == len(want) and got[-1] == want[-1]
        for wl, gl in zip(want[:-1], got[:-1]):
            wo, ws, wa, wf = wl.split(",")
            go, gs, ga, gf = gl.split(",")
            assert (go, gf) == (wo, wf)
            assert abs(float(gs) - float(ws)) <= 1e-3
            assert abs(float(ga) - float(wa)) <= 1e-4 * max(1.0, abs(float(wa)))

    def test_find_write_extracts_match_slices(self, tmp_path, capsys):
        """-write saves each match as a byte-exact, re-from-able slice
        of the original capture, widened by -pre/-post; re-searching a
        slice finds the pattern again."""
        import glob

        from quadrs_tpu.cli import main

        cap, pat = self._files(tmp_path)  # plant at 12_345, l=400
        rc = main(["from", str(cap), "find", "-pattern", str(pat),
                   "-threshold", "0.8", "-write", str(tmp_path / "pkt"),
                   "-pre", "100", "-post", "200"])
        assert rc == 0
        out = capsys.readouterr().out
        files = glob.glob(str(tmp_path / "pkt.m*"))
        assert len(files) == 1
        name = pathlib.Path(files[0]).name
        s0 = int(name.split(".s")[1].split(".")[0])
        assert s0 == 12_345 - 100  # raw source: span is identity
        data = pathlib.Path(files[0]).read_bytes()
        src = cap.read_bytes()
        assert data == src[s0 * 8 : s0 * 8 + len(data)]
        assert len(data) == (400 + 100 + 200) * 8
        assert f"wrote {files[0]}" in out

        # the slice is a valid capture: the pattern matches inside it
        assert main(["from", files[0], "find", "-pattern", str(pat),
                     "-threshold", "0.8"]) == 0
        line = capsys.readouterr().out.splitlines()[0]
        assert int(line.split(",")[0]) == 100

        # overwrite guard (same -pre/-post -> same slice filename)
        assert main(["from", str(cap), "find", "-pattern", str(pat),
                     "-threshold", "0.8", "-write", str(tmp_path / "pkt"),
                     "-pre", "100", "-post", "200"]) == 1
        assert "Error:" in capsys.readouterr().err

    def test_find_write_spans_through_chain(self, tmp_path, capsys):
        """Matching on a decimated chain still slices the RAW capture:
        the span mapping covers the match's FIR lookahead."""
        import glob

        from quadrs_tpu.cli import main
        from quadrs_tpu.sources import open_capture
        from quadrs_tpu.stream import LowPass

        rng = np.random.default_rng(71)
        n = 80_000
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64
        )
        raw = np.empty(2 * n, dtype=np.float32)
        raw[0::2] = x.real
        raw[1::2] = x.imag
        cap = tmp_path / "chain.sr48k.cf32"
        cap.write_bytes(raw.tobytes())

        # the pattern IS a slice of the decimated chain at offset 4000
        chain = LowPass(open_capture(str(cap)), 5_000, 4, 80)
        pat, valid = chain.read_at(4_000, 250)
        assert valid == 250
        praw = np.empty(2 * 250, dtype=np.float32)
        praw[0::2] = pat.real
        praw[1::2] = pat.imag
        pat_path = tmp_path / "pat.sr12k.cf32"
        pat_path.write_bytes(praw.tobytes())

        rc = main(["from", str(cap), "lowpass", "-power", "40",
                   "-decimate", "4", "5k", "find", "-pattern",
                   str(pat_path), "-threshold", "0.99", "-write",
                   str(tmp_path / "pkt")])
        assert rc == 0
        capsys.readouterr()
        files = glob.glob(str(tmp_path / "pkt.m*"))
        assert len(files) == 1
        name = pathlib.Path(files[0]).name
        s0 = int(name.split(".s")[1].split(".")[0])
        want_s0, want_n = chain.span(4_000, 250)
        assert s0 == max(0, want_s0)
        data = pathlib.Path(files[0]).read_bytes()
        src = cap.read_bytes()
        assert data == src[s0 * 8 : s0 * 8 + len(data)]
        # re-demodulating the slice reproduces the decimated pattern:
        # the span included the FIR lookahead
        sliced = LowPass(open_capture(files[0]), 5_000, 4, 80)
        got, v = sliced.read_at(0, 250)
        assert v == 250
        np.testing.assert_allclose(got, pat, atol=2e-6)

    def test_find_write_gating(self, tmp_path, capsys):
        from quadrs_tpu.cli import main

        assert main(["find", "-pattern", "x.sr1k.cf32", "-pre", "5"]) == 1
        assert "requires 'find -write" in capsys.readouterr().err
        assert main(["find", "-pattern", "x.sr1k.cf32", "-write", "y",
                     "-stdin", "yes", "-sr", "1k", "-format", "cf32"]) == 1
        assert "seekable" in capsys.readouterr().err

    def test_find_stdin_requires_wire_format(self, capsys):
        from quadrs_tpu.cli import main

        assert main(["find", "-pattern", "x.sr1k.cf32", "-stdin", "yes"]) == 1
        assert "requires -sr and -format" in capsys.readouterr().err

    def test_usage_lists_find(self):
        from quadrs_tpu.cli import USAGE

        assert "find [-pattern" in USAGE


@pytest.mark.parametrize("impl", ["four_step", "three_step"])
def test_house_fft_impl_matches_xla(impl):
    """The house matmul DFT engines (fft_impl="four_step"/"three_step") are
    drop-ins for XLA's FFT: same offsets, scores to f32 tolerance, on
    both the single-template and the template-bank/grid paths."""
    rng = np.random.default_rng(15)
    n, l = 60_000, 512
    p = (rng.standard_normal(l) + 1j * rng.standard_normal(l)).astype(np.complex64)
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64
    )
    for o in (100, 30_000, n - l):
        x[o : o + l] += 0.8 * p
    src = cf32_source(x)
    a = sinks.find_pattern(src, p, threshold=0.5, chunk=4096)
    b = sinks.find_pattern(src, p, threshold=0.5, chunk=4096, fft_impl=impl)
    assert np.array_equal(a.offsets, b.offsets)
    np.testing.assert_allclose(a.scores, b.scores, atol=2e-4)
    np.testing.assert_allclose(a.scales, b.scales, atol=2e-4)

    q = (rng.standard_normal(l // 2) + 1j * rng.standard_normal(l // 2)).astype(
        np.complex64
    )
    ga = sinks.find_pattern(
        src, [p, q], threshold=0.5, chunk=4096, freq_tol=300.0
    )
    gb = sinks.find_pattern(
        src, [p, q], threshold=0.5, chunk=4096, freq_tol=300.0,
        fft_impl=impl,
    )
    assert np.array_equal(ga.offsets, gb.offsets)
    assert np.array_equal(ga.which, gb.which)
    np.testing.assert_allclose(ga.scores, gb.scores, atol=2e-4)

    with pytest.raises(ValueError, match="fft impl"):
        sinks.find_pattern(src, p, fft_impl="nope")
