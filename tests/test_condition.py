"""Frontend-conditioning stages (additions; no reference
counterpart): DC-offset removal, AGC, and IQ-imbalance correction.

Oracles are sequential f64 transcriptions of the documented formulas
(:class:`quadrs_tpu.stream.DcBlock` / :class:`~quadrs_tpu.stream.Agc` /
:class:`~quadrs_tpu.stream.IqCorrect`).  Unlike LowPass's
reference-mandated per-read truncation these stages choose exact
semantics, so the tests also pin pull-size invariance and random-access
coherence (to the f32 prefix-sum tolerance: the trailing mean is a
cumsum difference, so values carry ~1e-4 absolute noise at unit scale
rather than being bit-identical across pull sizes).
"""

import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat
from quadrs_tpu.sources import SampleSource, ToneGen
from quadrs_tpu.stream import Agc, DcBlock, IqCorrect, LowPass, Shift


def oracle_dcblock(x: np.ndarray, window: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.complex128)
    y = np.empty_like(x)
    for m in range(len(x)):
        lo = max(0, m - window + 1)
        y[m] = x[m] - x[lo : m + 1].mean()
    return y


def oracle_agc(
    x: np.ndarray, window: int, target: float, max_gain: float
) -> np.ndarray:
    x = np.asarray(x, dtype=np.complex128)
    y = np.empty_like(x)
    for m in range(len(x)):
        lo = max(0, m - window + 1)
        rms = np.sqrt(np.mean(np.abs(x[lo : m + 1]) ** 2))
        y[m] = x[m] * target / max(rms, target / max_gain)
    return y


def _capture(n=1500, sr=48_000, seed=7, dc=0.0):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=n) + 1j * rng.normal(size=n) + dc).astype(np.complex64)
    src = SampleSource(
        np.ascontiguousarray(data).view(np.uint8), FileFormat.COMPLEX_FLOAT32, sr
    )
    return src, data


@pytest.mark.parametrize("window", [1, 7, 64, 300])
def test_dcblock_matches_oracle(window):
    src, data = _capture(dc=0.35 - 0.2j)
    st = DcBlock(src, window)
    assert st.length == src.length and st.sample_rate == src.sample_rate
    got, valid = st.read_at(0, src.length)
    assert valid == src.length
    want = oracle_dcblock(data, window)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_dcblock_random_access_and_pull_invariance():
    src, data = _capture(dc=0.5)
    st = DcBlock(src, 128)
    full, _ = st.read_at(0, src.length)
    # random access lands mid-stream with a clamped-at-start lookback
    for off, n in [(0, 64), (3, 100), (127, 64), (128, 64), (901, 321)]:
        part, valid = st.read_at(off, n)
        assert valid == min(n, src.length - off)
        np.testing.assert_allclose(
            part[:valid], full[off : off + valid], rtol=1e-4, atol=1e-4
        )
    # pulls of different sizes tile to the same stream
    for chunk in (64, 257):
        tiles = []
        for off in range(0, src.length, chunk):
            t, v = st.read_at(off, chunk)
            tiles.append(t[:v])
        np.testing.assert_allclose(
            np.concatenate(tiles), full, rtol=1e-4, atol=1e-4
        )


def test_dcblock_removes_generator_dc():
    # cos 0 is a pure DC tone riding the 900 Hz carrier
    gen = ToneGen([0, 900], 48_000, 0.05)
    st = DcBlock(gen, 256)
    y, _ = st.read_at(0, gen.length)
    warm = y[512:]
    assert abs(np.mean(warm)) < 0.02  # DC component gone
    assert np.std(warm) > 0.5  # the carrier survives


def test_dcblock_zero_past_valid():
    src, _ = _capture(n=100, dc=1.0)
    st = DcBlock(src, 16)
    y, valid = st.read_at(90, 32)
    assert valid == 10
    assert np.all(y[10:] == 0)


@pytest.mark.parametrize("window", [1, 50, 256])
def test_agc_matches_oracle(window):
    src, data = _capture()
    st = Agc(src, target=0.5, window=window, max_gain=100.0)
    got, valid = st.read_at(0, src.length)
    want = oracle_agc(data, window, 0.5, 100.0)
    np.testing.assert_allclose(got[:valid], want, rtol=1e-4, atol=1e-4)


def test_agc_levels_quiet_and_loud_sections():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=2000) + 1j * rng.normal(size=2000)).astype(np.complex64)
    x[:1000] *= 0.01  # quiet half
    x[1000:] *= 5.0  # loud half
    src = SampleSource(
        np.ascontiguousarray(x).view(np.uint8), FileFormat.COMPLEX_FLOAT32, 1000
    )
    st = Agc(src, target=1.0, window=128)
    y, _ = st.read_at(0, src.length)
    # after each section's warmup the output RMS sits at the target
    rms_quiet = np.sqrt(np.mean(np.abs(y[500:900]) ** 2))
    rms_loud = np.sqrt(np.mean(np.abs(y[1500:1900]) ** 2))
    assert 0.8 < rms_quiet < 1.2
    assert 0.8 < rms_loud < 1.2


def test_agc_max_gain_bounds_silence():
    x = np.zeros(300, dtype=np.complex64)
    x[200:] = 1.0
    src = SampleSource(
        np.ascontiguousarray(x).view(np.uint8), FileFormat.COMPLEX_FLOAT32, 1000
    )
    st = Agc(src, target=1.0, window=64, max_gain=10.0)
    y, _ = st.read_at(0, src.length)
    assert np.all(np.abs(y[:200]) == 0)  # silence stays silence
    assert np.isfinite(y).all()


def test_agc_validation():
    src, _ = _capture(n=64)
    with pytest.raises(ValueError, match="target"):
        Agc(src, target=0.0)
    with pytest.raises(ValueError, match="max-gain"):
        Agc(src, max_gain=-1.0)
    with pytest.raises(ValueError, match="window"):
        DcBlock(src, 0)


def _imbalanced(n=4000, beta=0.05 - 0.03j, seed=5):
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex128)
    s *= np.exp(2j * np.pi * 0.11 * np.arange(n))  # off-DC so it's proper
    z = s + beta * np.conj(s)
    return s, z.astype(np.complex64)


def test_iqbal_blind_estimate_cancels_image():
    s, z = _imbalanced()
    src = SampleSource(
        np.ascontiguousarray(z).view(np.uint8), FileFormat.COMPLEX_FLOAT32, 1000
    )
    st = IqCorrect(src)
    y, valid = st.read_at(0, src.length)
    # image power: projection of y onto conj(s), relative to signal power
    y = np.asarray(y[:valid], dtype=np.complex128)
    img_before = abs(np.vdot(np.conj(s), z[:valid]) / np.vdot(s, s))
    img_after = abs(np.vdot(np.conj(s), y) / np.vdot(s, s))
    assert img_before > 0.04  # the injected imbalance is visible
    # the residual floor is estimation noise ~sqrt(2/n)/2 ~ 0.006 at
    # n=4000 (the deterministic seed lands at ~0.005), not the third-
    # order analytic term — so assert against that floor, with margin
    assert img_after < img_before / 8
    assert img_after < 0.01


def test_iqbal_explicit_coefficient_is_exact_inverse_to_first_order():
    s, z = _imbalanced(beta=0.02 + 0.01j)
    src = SampleSource(
        np.ascontiguousarray(z).view(np.uint8), FileFormat.COMPLEX_FLOAT32, 1000
    )
    st = IqCorrect(src, c=0.02 + 0.01j)
    y, valid = st.read_at(0, src.length)
    resid = np.asarray(y[:valid], dtype=np.complex128) - (
        s[:valid] - abs(0.02 + 0.01j) ** 2 * s[:valid]
    )
    # y = (1 - |b|^2) s exactly for c = beta
    assert np.max(np.abs(resid)) < 1e-5 * np.max(np.abs(s))


def test_iqbal_rejects_noncircular_capture():
    rng = np.random.default_rng(9)
    x = rng.normal(size=512).astype(np.complex64)  # real noise: |rho| = 1
    src = SampleSource(
        np.ascontiguousarray(x).view(np.uint8), FileFormat.COMPLEX_FLOAT32, 1000
    )
    with pytest.raises(ValueError, match="non-circular"):
        IqCorrect(src)
    const = SampleSource(
        np.ascontiguousarray(np.ones(512, dtype=np.complex64)).view(np.uint8),
        FileFormat.COMPLEX_FLOAT32,
        1000,
    )
    with pytest.raises(ValueError, match="constant"):
        IqCorrect(const)


def test_iqbal_blind_estimate_ignores_dc_and_integer_baselines():
    # a DC offset must not bias the estimate (it is not an image) ...
    s, z = _imbalanced(beta=0.04 + 0.02j, seed=8)
    src = SampleSource(
        np.ascontiguousarray((z + (2.0 - 1.0j)).astype(np.complex64)).view(
            np.uint8
        ),
        FileFormat.COMPLEX_FLOAT32,
        1000,
    )
    st = IqCorrect(src)
    assert abs(st.c - (0.04 + 0.02j)) < 0.02  # noise floor ~sqrt(2/n)/2
    # ... and a raw cu8 capture (decoded baseline ~ -127-127j) must be
    # estimable at all rather than saturating the non-circular guard
    rng = np.random.default_rng(12)
    codes = rng.integers(117, 138, size=4096).astype(np.uint8)
    cu8 = SampleSource(codes, FileFormat.COMPLEX_UINT8, 1000)
    st2 = IqCorrect(cu8)
    assert abs(st2.c) < 0.1  # uncorrelated re/im codes: no real image


def test_conditioning_stacks_with_the_reference_chain():
    # from -> iqbal -> dcblock -> agc -> shift -> lowpass composes and
    # produces the expected valid accounting
    _, z = _imbalanced(n=3000)
    src = SampleSource(
        np.ascontiguousarray(z).view(np.uint8), FileFormat.COMPLEX_FLOAT32, 48_000
    )
    chain = LowPass(
        Shift(Agc(DcBlock(IqCorrect(src), 64), window=64), 1000), 6000, 4, 32
    )
    y, valid = chain.read_at(0, 128)
    assert valid == 128
    assert np.isfinite(y).all() and np.any(y != 0)


def test_cli_grammar_and_end_to_end(tmp_path, monkeypatch, capsys):
    from quadrs_tpu import args as argmod
    from quadrs_tpu.cli import main

    monkeypatch.chdir(tmp_path)
    rc = main("gen -cos 0 -cos 500 -len 0.1 12k write raw".split())
    assert rc == 0
    rc = main(
        "from raw.sr12000.cf32 dcblock -window 128 agc -target 0.5 "
        "write cond".split()
    )
    assert rc == 0
    out = tmp_path / "cond.sr12000.cf32"
    assert out.exists()
    got = np.frombuffer(out.read_bytes(), dtype=np.complex64)

    # library run over the same pulls (the writer pulls 0x1000 windows)
    src = SampleSource.from_file(str(tmp_path / "raw.sr12000.cf32"))
    st = Agc(DcBlock(src, 128), target=0.5, window=4000)  # CLI "4k" is decimal
    tiles = []
    for off in range(0, src.length, 0x1000):
        t, v = st.read_at(off, 0x1000)
        tiles.append(t[:v])
    np.testing.assert_allclose(
        got, np.concatenate(tiles), rtol=1e-4, atol=1e-4
    )

    # grammar errors surface cleanly
    for bad in (
        "gen -cos 1 1k agc -target 0",
        "gen -cos 1 1k dcblock -window 0",
        "gen -cos 1 1k iqbal -c nope",
        "gen -cos 1 1k iqbal -c 0.1:0.1 -est 5",
        "dcblock",  # no input
    ):
        assert main(bad.split()) != 0
    capsys.readouterr()

    cmds = argmod.parse("iqbal -c 0.01:-0.002".split())
    assert cmds[0].op.c == complex(0.01, -0.002)
