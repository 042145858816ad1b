import numpy as np
import pytest

from oracle import OracleGen, oracle_freq_levels
from quadrs_tpu import sinks
from quadrs_tpu.formats import FileFormat, decode_bytes
from quadrs_tpu.ops.stft import blackman_harris_window
from quadrs_tpu.sources import SampleSource, ToneGen


def test_bucket_two_tone_symbols():
    # A tone below DC lands in the upper (shifted) half ... use the raw
    # (unshifted) halves exactly as the reference does.
    g = ToneGen([30], 400, 1.0)  # positive freq -> first half of spectrum
    levels = sinks.freq_levels(g, fft_width=64, stride=64)
    assert set(levels.vals) == {1}

    g = ToneGen([-30], 400, 1.0)  # negative freq -> second half
    levels = sinks.freq_levels(g, fft_width=64, stride=64)
    assert set(levels.vals) == {0}


def test_bucket_matches_oracle():
    g = ToneGen([30, -110], 400, 2.0)
    o = OracleGen([30, -110], 400, 2.0)
    got = sinks.freq_levels(g, fft_width=32, stride=24)
    assert got.vals == oracle_freq_levels(o, 32, 24)


def test_bucket_window_count():
    g = ToneGen([30], 400, 1.0)
    got = sinks.freq_levels(g, fft_width=64, stride=48)
    assert len(got.vals) == (400 - 64) // 48


def test_bucket_rejects_other_levels():
    g = ToneGen([30], 400, 1.0)
    with pytest.raises(ValueError):
        sinks.freq_levels(g, 64, 64, levels=3)


def test_write_roundtrip(tmp_path):
    g = ToneGen([20], 400, 1.0)
    path = sinks.do_write(g, False, "tone", directory=str(tmp_path))
    assert path.endswith("tone.sr400.cf32")
    raw = np.fromfile(path, dtype=np.uint8)
    data = decode_bytes(raw, FileFormat.COMPLEX_FLOAT32)
    # reference writer pulls 0x1000 chunks and Gen always fills, so the
    # output is padded up to a chunk multiple (src/lib.rs:199-210)
    assert len(data) == 0x1000
    want, _ = g.read_at(0, 0x1000)
    assert data.tobytes() == np.asarray(want).tobytes()


def test_write_no_clobber(tmp_path):
    g = ToneGen([20], 400, 0.1)
    sinks.do_write(g, False, "x", directory=str(tmp_path))
    with pytest.raises(FileExistsError):
        sinks.do_write(g, False, "x", directory=str(tmp_path))
    sinks.do_write(g, True, "x", directory=str(tmp_path))  # overwrite ok


def test_write_stdout_unimplemented():
    g = ToneGen([20], 400, 0.1)
    with pytest.raises(NotImplementedError):
        sinks.do_write(g, False, "-")


def test_write_roundtrip_through_source(tmp_path):
    g = ToneGen([20, 60], 400, 1.0)
    path = sinks.do_write(g, False, str(tmp_path / "rt"), directory=None)
    src = SampleSource.from_file(path)
    assert src.sample_rate == 400
    got, valid = src.read_at(0, 256)
    want, _ = g.read_at(0, 256)
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def _file_source(n, seed=21, sr=48_000):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    return SampleSource(
        np.ascontiguousarray(data).view(np.uint8), FileFormat.COMPLEX_FLOAT32, sr
    )


def test_write_batched_matches_sequential(tmp_path, monkeypatch):
    """Many 0x1000-pulls run per device dispatch; bytes must equal the
    reference's one-pull-per-iteration loop, with far fewer dispatches."""
    import io

    from quadrs_tpu import runtime

    src = _file_source(0x1000 * 21 + 517)  # 21 chunks + ragged tail

    calls = []
    real_run = runtime.Executor.run

    def counting_run(self, offs):
        calls.append(len(offs))
        return real_run(self, offs)

    monkeypatch.setattr(runtime.Executor, "run", counting_run)

    path = sinks.do_write(src, False, "batched", directory=str(tmp_path))
    assert len(calls) <= -(-src.length // 0x1000) // 10 + 1  # >=10x fewer

    seq = io.BytesIO()
    sinks._write_sequential(seq, src, 0)
    with open(path, "rb") as fh:
        assert fh.read() == seq.getvalue()


def test_write_batched_decimated_chain_matches_sequential(tmp_path):
    """gen -> shift -> lowpass -> write: the decimated chain batches
    through the same program and produces identical bytes (gen always
    fills reads, so this chain writes cleanly end to end)."""
    import io

    from quadrs_tpu.stream import LowPass, Shift

    g = ToneGen([200, -1200], 48_000, 2.1)
    chain = LowPass(Shift(g, 1000), 2000, 8, 40)
    path = sinks.do_write(chain, False, "chain", directory=str(tmp_path))
    seq = io.BytesIO()
    sinks._write_sequential(seq, chain, 0)
    with open(path, "rb") as fh:
        assert fh.read() == seq.getvalue()


def test_write_decimated_file_tail_panics_like_reference(tmp_path):
    """The reference's writer hits a zero-length read at the claimed-but-
    unreadable final output of a decimated file stream and panics
    (src/lib.rs:203: the last read_at returns (valid-N)/D = 0).  The
    batched writer reproduces that error exactly."""
    from quadrs_tpu.stream import LowPass

    lp = LowPass(_file_source(0x1000 * 2 * 8 + 40 + 517), 2000, 8, 40)
    with pytest.raises(RuntimeError, match="short read at offset"):
        sinks.do_write(lp, False, "tailpanic", directory=str(tmp_path))


def test_write_batched_gen_pads_to_chunk(tmp_path):
    """Gen always fills its reads, so the written length rounds up to a
    whole 0x1000 chunk even batched (reference src/lib.rs:199-210)."""
    g = ToneGen([20, 50], 4000, 2.5)  # length 10000 -> 3 chunks = 12288
    path = sinks.do_write(g, False, "pad", directory=str(tmp_path))
    raw = np.fromfile(path, dtype=np.uint8)
    data = decode_bytes(raw, FileFormat.COMPLEX_FLOAT32)
    assert len(data) == 3 * 0x1000
    want, _ = g.read_at(2 * 0x1000, 0x1000)
    assert data[2 * 0x1000 :].tobytes() == np.asarray(want).tobytes()


def test_blackman_harris_window_formula():
    w = blackman_harris_window(512)
    i = np.arange(512, dtype=np.float64)
    x = 2 * np.pi * i / 511
    want = 0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x) - 0.01168 * np.cos(3 * x)
    np.testing.assert_allclose(w, want, atol=1e-6)


def test_take_fft_shapes_and_extents():
    g = ToneGen([40], 4000, 1.0)
    res = sinks.take_fft(g, None, width=128, output_len=16)
    assert res.output_len == 16
    assert res.get(0).shape == (128,)
    with pytest.raises(IndexError):
        res.get(16)
    assert res.min() >= 0.0
    assert res.max() > res.min()


def test_take_fft_window_positions():
    """step = visible/output_len with Rust round-half-away-from-zero."""
    g = ToneGen([40], 4000, 1.0)
    with pytest.raises(ValueError):
        sinks.take_fft(g, (100, 100), 64, 16)
    with pytest.raises(ValueError):
        sinks.take_fft(g, (0, 4000), 64, 16)  # end must be < len
    with pytest.raises(ValueError):
        sinks.take_fft(g, (0, 10), 64, 16)  # visible must exceed output_len


def test_take_fft_matches_manual_stft():
    g = ToneGen([40], 4000, 0.5)  # len 2000
    res = sinks.take_fft(g, (0, 1000), width=64, output_len=10, windowing="rectangular")
    step = 1000 / 10
    for row in range(10):
        off = int(np.floor(step * row + 0.5))
        win, _ = g.read_at(off, 64)
        spec = np.fft.fft(np.asarray(win).astype(np.complex128))
        spec = np.concatenate([spec[32:], spec[:32]])
        np.testing.assert_allclose(res.get(row), np.abs(spec), atol=1e-3)


def test_wide_fft_impls_agree():
    """Wide widths route to the four-step matmul split (or jnp.fft when
    the width won't factor); every impl must agree with numpy.  Calls
    are jitted like the production paths."""
    import jax

    from quadrs_tpu.ops.stft import batched_fft

    rng = np.random.default_rng(71)
    x = (rng.normal(size=(3, 2048)) + 1j * rng.normal(size=(3, 2048))).astype(
        np.complex64
    )
    from util import to_device_complex, from_device_complex

    fft_impl = {
        impl: jax.jit(lambda v, impl=impl: batched_fft(v, impl=impl))
        for impl in ("auto", "matmul", "xla", "four_step")
    }
    want = np.fft.fft(x.astype(np.complex128))
    for impl in ("auto", "xla", "four_step"):
        got = from_device_complex(fft_impl[impl](to_device_complex(x)))
        np.testing.assert_allclose(
            got, want, atol=2e-3 * np.abs(want).max(), err_msg=impl
        )
    # all three engines agree at a width each can run (1024)
    y = (rng.normal(size=(2, 1024)) + 1j * rng.normal(size=(2, 1024))).astype(np.complex64)
    outs = {
        impl: from_device_complex(fft_impl[impl](to_device_complex(y)))
        for impl in ("matmul", "xla", "four_step")
    }
    np.testing.assert_allclose(outs["matmul"], outs["xla"], atol=2e-3 * np.abs(outs["xla"]).max())
    np.testing.assert_allclose(outs["four_step"], outs["xla"], atol=2e-3 * np.abs(outs["xla"]).max())


def test_four_step_fft_planes_exact():
    """The four-step split (forward and inverse) matches numpy across
    widths including non-powers-of-two; prime widths report no factor."""
    import jax

    from quadrs_tpu.ops.stft import _four_step_factor, four_step_fft_planes

    rng = np.random.default_rng(72)
    for w in (96, 512, 1024, 1536, 4096):
        a = _four_step_factor(w)
        assert a is not None and w % a == 0
        x = (rng.normal(size=(4, w)) + 1j * rng.normal(size=(4, w))).astype(
            np.complex64
        )
        fwd = jax.jit(lambda r, i, a=a: four_step_fft_planes(r, i, a))
        inv = jax.jit(lambda r, i, a=a: four_step_fft_planes(r, i, a, inverse=True))
        yr, yi = fwd(x.real, x.imag)
        want = np.fft.fft(x.astype(np.complex128))
        np.testing.assert_allclose(
            np.asarray(yr) + 1j * np.asarray(yi), want, atol=3e-6 * np.abs(want).max()
        )
        zr, zi = inv(
            want.real.astype(np.float32), want.imag.astype(np.float32)
        )
        np.testing.assert_allclose(
            np.asarray(zr) + 1j * np.asarray(zi), x, atol=3e-5 * np.abs(x).max()
        )
    assert _four_step_factor(1021) is None  # prime width -> xla fallback


def test_three_step_fft_planes_exact():
    """The three-factor split (forward and inverse) matches numpy across
    widths; the factor picker returns splits whose product is the width
    and minimizes a+b1+b2; batched_fft(impl="three_step") agrees with
    XLA's FFT."""
    import jax

    from quadrs_tpu.ops.stft import (
        _three_step_factors,
        batched_fft,
        three_step_fft_planes,
    )
    from util import from_device_complex, to_device_complex

    rng = np.random.default_rng(73)
    for w in (512, 1024, 4096, 6144, 65536):
        fac = _three_step_factors(w)
        assert fac is not None
        a, b1 = fac
        assert w % (a * b1) == 0
        x = (rng.normal(size=(4, w)) + 1j * rng.normal(size=(4, w))).astype(
            np.complex64
        )
        fwd = jax.jit(lambda r, i, a=a, b1=b1: three_step_fft_planes(r, i, a, b1))
        inv = jax.jit(
            lambda r, i, a=a, b1=b1: three_step_fft_planes(r, i, a, b1, inverse=True)
        )
        yr, yi = fwd(x.real, x.imag)
        want = np.fft.fft(x.astype(np.complex128))
        np.testing.assert_allclose(
            np.asarray(yr) + 1j * np.asarray(yi), want, atol=3e-6 * np.abs(want).max()
        )
        zr, zi = inv(want.real.astype(np.float32), want.imag.astype(np.float32))
        np.testing.assert_allclose(
            np.asarray(zr) + 1j * np.asarray(zi), x, atol=3e-5 * np.abs(x).max()
        )
    # the split really is three-way cheap: at 65536 a+b1+b2 = 128
    a, b1 = _three_step_factors(65536)
    assert a + b1 + 65536 // (a * b1) == 128
    assert _three_step_factors(1021) is None  # prime width
    y = (rng.normal(size=(2, 2048)) + 1j * rng.normal(size=(2, 2048))).astype(
        np.complex64
    )
    got = from_device_complex(
        jax.jit(lambda v: batched_fft(v, impl="three_step"))(to_device_complex(y))
    )
    want = np.fft.fft(y.astype(np.complex128))
    np.testing.assert_allclose(got, want, atol=2e-3 * np.abs(want).max())


def test_mxu_fft_choice_eff_cost_routing():
    """The shared chooser picks by effective MACs with the 128-lane
    floor: two-factor at 4096 (measured 1.8x winner on the os_poly FIR
    chain), three-factor at 65536 (measured winner on the pattern
    search), None at primes; and mxu_fft_planes is exact under both
    routes."""
    import jax

    from quadrs_tpu.ops.stft import _eff_macs, mxu_fft_choice, mxu_fft_planes

    kind4, a4 = mxu_fft_choice(4096)
    assert kind4 == "four_step"
    kindl, fac3 = mxu_fft_choice(65536)
    assert kindl == "three_step"
    assert _eff_macs(*fac3, 65536 // (fac3[0] * fac3[1])) < _eff_macs(64, 1024)
    assert mxu_fft_choice(1021) is None  # prime
    assert _eff_macs(16, 16, 16) == 384  # the floor, not 48

    rng = np.random.default_rng(5)
    for w in (4096, 65536):
        x = (rng.normal(size=(2, w)) + 1j * rng.normal(size=(2, w))).astype(
            np.complex64
        )
        yr, yi = jax.jit(mxu_fft_planes)(x.real, x.imag)
        want = np.fft.fft(x.astype(np.complex128))
        np.testing.assert_allclose(
            np.asarray(yr) + 1j * np.asarray(yi), want,
            atol=3e-6 * np.abs(want).max(),
        )
        zr, zi = jax.jit(lambda r, i: mxu_fft_planes(r, i, inverse=True))(
            want.real.astype(np.float32), want.imag.astype(np.float32)
        )
        np.testing.assert_allclose(
            np.asarray(zr) + 1j * np.asarray(zi), x, atol=3e-5 * np.abs(x).max()
        )


# ---------------------------------------------------------------------------
# write -format (integer quantization; an addition)


def test_encode_samples_roundtrips():
    import numpy as np

    from quadrs_tpu.formats import FileFormat, decode_bytes, encode_samples

    rng = np.random.default_rng(7)
    for fmt in (FileFormat.COMPLEX_INT8, FileFormat.COMPLEX_UINT8):
        raw = rng.integers(0, 256, 800 * fmt.pair_bytes, dtype=np.int64).astype(
            np.uint8
        ).tobytes()
        assert encode_samples(decode_bytes(raw, fmt), fmt) == raw
    # cs16: the reference DECODE collapses ~4 codes per f32 value (its
    # formula, not ours), so the pin is re-decode equality
    fmt = FileFormat.COMPLEX_INT16
    raw = rng.integers(0, 256, 800 * fmt.pair_bytes, dtype=np.int64).astype(
        np.uint8
    ).tobytes()
    dec = decode_bytes(raw, fmt)
    again = decode_bytes(encode_samples(dec, fmt), fmt)
    np.testing.assert_array_equal(
        dec.view(np.float32), again.view(np.float32)
    )
    # cf32 passes through encode_cf32 exactly
    vals = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(
        np.complex64
    )
    assert encode_samples(vals, FileFormat.COMPLEX_FLOAT32) == vals.view(
        np.float32
    ).tobytes()


def test_cli_write_format_converts_and_reopens(tmp_path, capsys, monkeypatch):
    """gen -> write -format cs8 produces a cs8 capture that from reads
    back as the quantized signal; -format bogus is rejected."""
    import numpy as np

    from quadrs_tpu.cli import main
    from quadrs_tpu.formats import FileFormat, decode_bytes, encode_samples
    from quadrs_tpu.sources import ToneGen, open_capture

    monkeypatch.chdir(tmp_path)
    assert main("gen -cos 1k -len 0.05 48k write -format cs8 small".split()) == 0
    path = tmp_path / "small.sr48000.cs8"
    # gen fills whole pulls past its length (reference semantics), so
    # the writer emits one full 0x1000-sample chunk — as the cf32
    # writer does for the same pipeline
    assert path.exists() and path.stat().st_size == 2 * 4096

    tone = ToneGen([1000], 48_000, 0.05)
    from quadrs_tpu.runtime import Executor

    ex = Executor(tone, 4096, batch=1)
    samples, valid = ex.run(np.asarray([0], dtype=np.int64))
    ref = samples[0]
    assert path.read_bytes() == encode_samples(ref, FileFormat.COMPLEX_INT8)
    # and it re-opens through the normal sniffing path
    src = open_capture(str(path))
    assert src.format is FileFormat.COMPLEX_INT8 and src.length == 4096

    assert main("gen -cos 1k 48k write -format f64 x".split()) == 1
    assert "unknown -format" in capsys.readouterr().err


def test_encode_samples_saturation_warns():
    """cu8/cs16 carry the reference decode's DC offset: encoding an
    offset-free signal saturates and must warn (not silently destroy)."""
    import warnings

    import numpy as np
    import pytest as _pytest

    from quadrs_tpu.formats import FileFormat, encode_samples

    tone = np.exp(2j * np.pi * np.arange(256) / 16).astype(np.complex64)
    with _pytest.warns(UserWarning, match="saturate"):
        enc = encode_samples(tone, FileFormat.COMPLEX_UINT8)
    assert set(enc) <= {0, 255}  # everything clipped, as warned
    with _pytest.warns(UserWarning, match="saturate"):
        encode_samples(tone, FileFormat.COMPLEX_INT16)
    # cs8's range is sane: no warning for a unit tone
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        encode_samples(tone, FileFormat.COMPLEX_INT8)
