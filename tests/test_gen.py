import numpy as np
import pytest

from oracle import OracleGen
from quadrs_tpu.sources import ToneGen


def test_gen_matches_oracle_single_tone():
    g = ToneGen([20], 400, 1.0)
    o = OracleGen([20], 400, 1.0)
    got, valid = g.read_at(0, 400)
    assert valid == 400
    np.testing.assert_allclose(got, o.read_at(0, 400), atol=3e-7)


def test_gen_matches_oracle_multi_tone_offset():
    g = ToneGen([-7000, 1, 12_345], 48_000, 0.25)
    o = OracleGen([-7000, 1, 12_345], 48_000, 0.25)
    got, valid = g.read_at(777, 512)
    assert valid == 512
    np.testing.assert_allclose(got, o.read_at(777, 512), atol=4e-6)


def test_gen_phase_coherent_at_huge_offsets():
    # absolute-index phase must stay exact far beyond f32 range
    g = ToneGen([333], 48_000, 1.0)
    off = 3_000_000_000_017
    got, _ = g.read_at(off, 8)
    want = np.array(
        [
            np.exp(2j * np.pi * ((333 * (off + k)) % 48_000) / 48_000)
            for k in range(8)
        ],
        dtype=np.complex64,
    )
    np.testing.assert_allclose(got, want, atol=3e-7)


def test_gen_length_truncates():
    assert ToneGen([1], 400, 1.0).length == 400
    assert ToneGen([1], 400, 0.9999).length == 399  # f64 multiply, trunc
    assert ToneGen([1], 3, 0.5).length == 1


def test_gen_always_fills():
    g = ToneGen([10], 100, 0.1)  # length 10
    got, valid = g.read_at(8, 64)
    assert valid == 64  # reference Gen ignores its len (src/gen.rs:35-47)
    assert np.all(np.abs(got) > 0.99)


def test_gen_validation():
    with pytest.raises(ValueError):
        ToneGen([], 400, 1.0)
    with pytest.raises(ValueError):
        ToneGen([1], 0, 1.0)
    with pytest.raises(ValueError):
        ToneGen([1], 400, 0.0)


# ---------------------------------------------------------------------------
# gen -noise (seeded, counter-based; an addition)


def test_gen_noise_deterministic_and_random_access():
    import numpy as np

    from quadrs_tpu.sources import ToneGen

    a = ToneGen([100], 48_000, 0.1, noise=0.2, seed=7)
    b = ToneGen([100], 48_000, 0.1, noise=0.2, seed=7)
    x1, _ = a.read_at(0, 2000)
    x2, _ = b.read_at(0, 2000)
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
    # random access: any window equals the slice of a bigger read — the
    # NOISE is bit-identical (hash of the absolute index); the tones are
    # ulp-coherent like the noiseless generator (theta0 + delta splits
    # the same angle differently per window)
    y, _ = a.read_at(700, 300)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(x1)[700:1000], atol=1e-5
    )
    clean = ToneGen([100], 48_000, 0.1)
    y0, _ = clean.read_at(700, 300)
    x0, _ = clean.read_at(0, 2000)
    # the extracted noise agrees to f32 rounding of the (tone + noise)
    # sum; the underlying noise values are identical by construction
    np.testing.assert_allclose(
        np.asarray(y) - np.asarray(y0),
        (np.asarray(x1) - np.asarray(x0))[700:1000],
        atol=1e-6,
    )
    # a different seed decorrelates
    c = ToneGen([100], 48_000, 0.1, noise=0.2, seed=8)
    x3, _ = c.read_at(0, 2000)
    assert not np.array_equal(np.asarray(x3), np.asarray(x1))


def test_gen_noise_statistics_and_default_off():
    import numpy as np

    from quadrs_tpu.sources import ToneGen

    clean = ToneGen([100], 48_000, 0.5)
    noisy = ToneGen([100], 48_000, 0.5, noise=0.25, seed=3)
    x0, _ = clean.read_at(0, 20_000)
    x1, _ = noisy.read_at(0, 20_000)
    d = np.asarray(x1) - np.asarray(x0)
    assert abs(float(np.mean(d.real))) < 0.01
    assert float(np.std(d.real)) == pytest.approx(0.25, rel=0.05)
    assert float(np.std(d.imag)) == pytest.approx(0.25, rel=0.05)
    # noise=0 (the default) is the bit-exact reference generator
    z = ToneGen([100], 48_000, 0.5, noise=0.0, seed=3)
    x2, _ = z.read_at(0, 20_000)
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(x0))
    with pytest.raises(ValueError, match=">= 0"):
        ToneGen([100], 48_000, 0.5, noise=-1.0)


def test_cli_gen_noise(tmp_path, monkeypatch, capsys):
    import numpy as np

    from quadrs_tpu.cli import main
    from quadrs_tpu.formats import FileFormat, decode_bytes

    monkeypatch.chdir(tmp_path)
    assert main("gen -cos 1k -len 0.1 -noise 0.1 -seed 5 48k write noisy".split()) == 0
    assert main("gen -cos 1k -len 0.1 48k write clean".split()) == 0
    a = decode_bytes((tmp_path / "noisy.sr48000.cf32").read_bytes(), FileFormat.COMPLEX_FLOAT32)
    b = decode_bytes((tmp_path / "clean.sr48000.cf32").read_bytes(), FileFormat.COMPLEX_FLOAT32)
    d = a - b
    assert float(np.std(d.real)) == pytest.approx(0.1, rel=0.1)
    capsys.readouterr()
    assert main("gen -cos 1k -noise -2 48k write x".split()) == 1
    assert "-noise must be >= 0" in capsys.readouterr().err
