"""Rational resampler conformance (an addition; no reference
counterpart — quadrs only decimates, ``src/filter.rs``).

The oracle is a sequential f64 transcription of the documented formula
(:mod:`quadrs_tpu.ops.resample`): zero-stuff by L, correlate with the
L-scaled Blackman-sinc taps at stride M with the house group-delay pick
``c = N - N//2``, skipping out-of-range taps like the reference's
truncated convolution.
"""

import math

import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat
from quadrs_tpu.ops.fir import lowpass_taps
from quadrs_tpu.sources import SampleSource, ToneGen
from quadrs_tpu.stream import LowPass, Resample, Shift


def oracle_resample(x: np.ndarray, up: int, down: int, size: int) -> np.ndarray:
    """All outputs whose window starts inside the zero-stuffed input;
    trailing outputs use the truncation skip (for comparing only the
    full-window prefix the stream declares valid)."""
    l, m, n = up, down, size
    taps = lowpass_taps(min(1 / (2 * l), 1 / (2 * m)), n).astype(np.float64) * l
    c = n - n // 2
    u = np.zeros(len(x) * l, dtype=np.complex128)
    u[::l] = x
    ys = []
    p = 0
    while p * m + c < len(u):
        acc = 0.0 + 0.0j
        for j in range(n):
            t = p * m + c + j
            if t < len(u):
                acc += taps[j] * u[t]
        ys.append(acc)
        p += 1
    return np.asarray(ys)


def _capture(n=1200, sr=48_000, seed=11):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    src = SampleSource(
        np.ascontiguousarray(data).view(np.uint8), FileFormat.COMPLEX_FLOAT32, sr
    )
    return src, data


@pytest.mark.parametrize(
    "up,down,size",
    [(1, 2, 33), (3, 2, 48), (2, 3, 40), (5, 4, 64), (7, 3, 80), (1, 1, 32), (4, 7, 56)],
)
def test_matches_oracle(up, down, size):
    sr = 48_000 * down  # keep up/down * sr integral for every case
    src, data = _capture(sr=sr)
    rs = Resample(src, up, down, size=size)
    assert rs.sample_rate == sr * up // down
    ref = oracle_resample(data, up, down, size)

    y, valid = rs.read_at(0, rs.length)
    assert valid == rs.length  # length is the exact readable count
    np.testing.assert_allclose(np.asarray(y[:valid]), ref[:valid], atol=2e-6, rtol=2e-6)

    # random access is phase-coherent: a mid-stream read sees the same
    # samples as the full read
    off = rs.length // 3 + 1
    n2 = min(64, rs.length - off)
    y2, v2 = rs.read_at(off, n2)
    assert v2 == n2
    np.testing.assert_allclose(np.asarray(y2[:v2]), ref[off : off + v2], atol=2e-6, rtol=2e-6)


@pytest.mark.slow
def test_chunked_reads_bit_match_full_read():
    src, _ = _capture()
    rs = Resample(src, 3, 2, size=48)
    full, valid = rs.read_at(0, rs.length)
    full = np.asarray(full[:valid])
    got = []
    off = 0
    while off < rs.length:
        n = min(37, rs.length - off)
        y, v = rs.read_at(off, n)
        assert v == n
        got.append(np.asarray(y[:v]))
        off += n
    got = np.concatenate(got)
    # interior windows always see their full input span, so chunking
    # computes the same tap-by-input products; XLA may tile the einsum
    # reduction differently for different batch shapes, so allow ULP-
    # level reassociation but nothing more
    np.testing.assert_allclose(got, full, rtol=1e-6, atol=1e-7)


def test_downsample_only_matches_lowpass_sums():
    """Resample(1, M, size=N) computes LowPass(sr/(2M), M, N)'s exact
    sums; only f32 accumulation order differs (<=2e-6 rel)."""
    src, _ = _capture(n=2000)
    m, n = 4, 40
    rs = Resample(src, 1, m, size=n)
    lp = LowPass(src, src.sample_rate // (2 * m), m, n)
    # pull the LowPass whole so its per-read truncation window covers
    # every input the resampler's exact-length windows cover
    a, va = lp.read_at(0, lp.length)
    b, vb = rs.read_at(0, rs.length)
    k = min(va, vb)
    a = np.asarray(a[:k])
    b = np.asarray(b[:k])
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=2e-6)
    # and the rates agree
    assert rs.sample_rate == lp.sample_rate


def test_ratio_reduced_by_gcd():
    src, _ = _capture()
    a = Resample(src, 6, 4, size=48)
    b = Resample(src, 3, 2, size=48)
    assert (a.up, a.down) == (3, 2)
    assert a.length == b.length and a.sample_rate == b.sample_rate
    ya, _ = a.read_at(0, a.length)
    yb, _ = b.read_at(0, b.length)
    assert np.asarray(ya).tobytes() == np.asarray(yb).tobytes()


def test_tone_survives_resampling():
    """A 5 kHz tone at 48 kHz resampled 3/2 is the same tone at 72 kHz,
    amplitude preserved by the *L gain."""
    sr, f = 48_000, 5_000
    src = ToneGen([f], sample_rate=sr, seconds=0.05)
    rs = Resample(src, 3, 2, size=96)
    assert rs.sample_rate == 72_000
    y, valid = rs.read_at(0, rs.length)
    y = np.asarray(y[:valid])
    # skip the filter's edge transient at both ends
    edge = 96
    core = y[edge:-edge]
    k = np.arange(edge, valid - edge)
    expect = np.exp(2j * np.pi * f * k / rs.sample_rate)
    # constant complex gain (group delay is an integer shift in the
    # upsampled grid, folded into the pick): correlate and check flatness
    g = core / expect
    assert np.abs(np.mean(g)) == pytest.approx(1.0, abs=0.01)
    assert np.max(np.abs(g - np.mean(g))) < 0.01


def test_stacks_under_shift():
    src, data = _capture(sr=96_000)
    chain = Resample(Shift(src, 12_000), 2, 3, size=40)
    mixed = data * np.exp(2j * np.pi * 12_000 * np.arange(len(data)) / 96_000)
    ref = oracle_resample(mixed.astype(np.complex64), 2, 3, 40)
    y, valid = chain.read_at(0, chain.length)
    np.testing.assert_allclose(np.asarray(y[:valid]), ref[:valid], atol=4e-6, rtol=4e-6)


def test_error_surface():
    src, _ = _capture(n=100, sr=48_000)
    with pytest.raises(ValueError, match="positive"):
        Resample(src, 0, 2)
    with pytest.raises(ValueError, match="positive"):
        Resample(src, 1, -1)
    with pytest.raises(ValueError, match="non-integer sample rate"):
        Resample(src, 1, 7)  # 48000/7 is not integral
    with pytest.raises(ValueError, match="shorter than the resampling filter"):
        Resample(src, 1, 2, size=512)
    with pytest.raises(ValueError, match="at least 2"):
        Resample(src, 1, 2, size=1)


def test_default_size_scales_with_ratio():
    src, _ = _capture()
    rs = Resample(src, 3, 2, power=8)
    assert rs.size == 2 * 8 * 3
    rs2 = Resample(src, 2, 3)
    assert rs2.size == 2 * 8 * 3


def test_length_is_exact():
    """Every declared output index is readable with a full window; the
    next one is not."""
    src, data = _capture(n=500)
    for up, down, size in [(3, 2, 48), (1, 2, 33), (5, 4, 64)]:
        rs = Resample(src, up, down, size=size)
        ref = oracle_resample(data, up, down, size)
        # the last valid output's window must end inside the input:
        # compare against an f64 full-window recompute
        l, m, n = rs.up, rs.down, rs.size
        c = n - n // 2

        def window_full(p: int) -> bool:
            # output p touches real input x[t//l] for every tap index
            # t = p*m + c + j with l | t; full iff all those exist
            ts = p * m + c + np.arange(n)
            hits = ts[ts % l == 0] // l
            return bool(hits.size == 0 or hits.max() < len(data))

        assert window_full(rs.length - 1)
        assert not window_full(rs.length)
        y, valid = rs.read_at(0, rs.length)
        assert valid == rs.length
        np.testing.assert_allclose(np.asarray(y[:valid]), ref[: rs.length], atol=2e-6, rtol=2e-6)


def test_cli_resample_pipeline(tmp_path, monkeypatch):
    """`from tone.cf32 resample 3/2 write out` writes the library
    path's samples with the converted rate in the filename.  (A file
    source truncates at EOF, so the write ends at exactly `length` —
    unlike `gen`, whose reference-mandated always-full reads make the
    writer emit whole pulls.)"""
    from quadrs_tpu.cli import main

    monkeypatch.chdir(tmp_path)
    assert main("gen -cos 500 -len 0.1 48k write tone".split()) == 0
    rc = main(f"from {tmp_path}/tone.sr48000.cf32 resample 3/2 write out".split())
    assert rc == 0
    path = tmp_path / "out.sr72000.cf32"
    assert path.exists()
    written = np.fromfile(path, dtype=np.complex64)

    from quadrs_tpu.formats import FileDetails, FileFormat
    from quadrs_tpu.sources import SampleSource

    src = SampleSource.from_file(
        str(tmp_path / "tone.sr48000.cf32"),
        FileDetails(FileFormat.COMPLEX_FLOAT32, 48_000),
    )
    rs = Resample(src, 3, 2)  # CLI default: -power 8
    assert len(written) == rs.length
    y, valid = rs.read_at(0, rs.length)
    assert valid == rs.length
    np.testing.assert_allclose(written, np.asarray(y[:valid]), atol=1e-6, rtol=1e-6)


def test_cli_resample_parse_errors(capsys):
    from quadrs_tpu.cli import main

    assert main("gen -cos 5 4k resample".split()) == 1
    assert "requires an UP/DOWN ratio" in capsys.readouterr().err
    assert main("gen -cos 5 4k resample 3:2".split()) == 1
    assert "must be UP/DOWN" in capsys.readouterr().err
    assert main("gen -cos 5 4k resample 0/2".split()) == 1
    assert "must be positive" in capsys.readouterr().err
    assert main("gen -cos 5 4k resample -power 4 -size 32 3/2".split()) == 1
    assert "not both" in capsys.readouterr().err


def test_cli_resample_si_suffixes():
    from quadrs_tpu.args import parse

    cmds = parse("gen -cos 5 4k resample -size 96 147/160".split())
    op = cmds[-1].op
    assert (op.up, op.down, op.size) == (147, 160, 96)
