"""Polyphase channelizer: conformance to the reference composition.

The bank has no reference counterpart; its contract is that channel
``k`` equals the already-validated chain ``Shift(-k*sr/K)`` ->
``LowPass(cutoff, decimate=K, size)`` (src/shift.rs + src/filter.rs
semantics) within f32 commutation, pinned here per channel, plus an
independent sequential f64 numpy oracle (all channels, including K/2,
which the Shift stage cannot express: |f| = sr/2 is rejected).
"""

import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat
from quadrs_tpu.models.channelizer import Channelize, run_channelize
from quadrs_tpu.sources import SampleSource, ToneGen
from quadrs_tpu.stream import LowPass, Shift

CF32 = FileFormat("cf32")


def _cf32_source(x: np.ndarray, sr: int) -> SampleSource:
    raw = np.empty(2 * len(x), dtype="<f4")
    raw[0::2] = x.real
    raw[1::2] = x.imag
    return SampleSource(np.frombuffer(raw.tobytes(), dtype=np.uint8), CF32, sr)


def _capture(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
    ).astype(np.complex64)


def test_matches_shift_lowpass_composition_every_channel():
    k, size, sr = 8, 40, 8_000
    x = _capture(4096)
    src = _cf32_source(x, sr)
    chan = Channelize(src, k)
    assert chan.size == size and chan.frequency == sr // (2 * k)
    n = chan.length
    out, valid = chan.read_at(0, n)
    assert valid == (len(x) - size) // k

    for ch in range(k):
        if ch == k // 2:
            continue  # Shift rejects |f| == sr/2; covered by the oracle
        f = -ch * sr // k if ch < k // 2 else (k - ch) * sr // k
        ref = LowPass(Shift(src, f, sr), chan.frequency, k, size)
        want, v = ref.read_at(0, n)
        scale = max(np.max(np.abs(want[:v])), 1e-9)
        np.testing.assert_allclose(
            out[:v, ch], want[:v], atol=2e-6 * scale, rtol=0,
            err_msg=f"channel {ch}",
        )


def test_matches_sequential_oracle_all_channels():
    k, size, sr = 6, 34, 6_000  # odd-ish sizes: exercise c = N - N//2
    x = _capture(1200, seed=3)
    src = _cf32_source(x, sr)
    chan = Channelize(src, k, size=size)
    out, valid = chan.read_at(0, chan.length)

    c = size - size // 2
    h = chan.taps.astype(np.float64)
    xo = np.concatenate([x.astype(np.complex128), np.zeros(size + k * c)])
    j = np.arange(size)
    for ch in range(k):
        phase = np.exp(-2j * np.pi * ch * (c + j) / k)
        for i in range(0, valid, 11):
            want = np.sum(xo[i * k + c + j] * h * phase)
            got = out[i, ch]
            assert abs(got - want) <= 4e-6 * max(abs(want), 0.05), (ch, i)


def test_tone_lands_in_its_channel():
    k, sr = 16, 64_000
    # tones centered on channels 3 and -2 (i.e. DFT bin 14)
    gen = ToneGen([3 * sr // k, -2 * sr // k], sr, 0.25)
    chan = Channelize(gen, k, size=128)
    out, valid = chan.read_at(0, min(chan.length, 512))
    power = np.mean(np.abs(out[: valid - 16]) ** 2, axis=0)
    hot = {3, k - 2}
    for ch in range(k):
        if ch in hot:
            assert power[ch] > 0.5, (ch, power)
        else:
            assert power[ch] < 1e-3 * power.max(), (ch, power)


def test_chunked_run_matches_chunked_reference_chain():
    """Pulls of the same size truncate at the same boundaries (per-read
    truncated convolution is semantics, not an artifact): the chunked
    bank must equal the reference chain pulled at the same chunk size,
    boundary tails included."""
    k, size, sr = 4, 40, 4_000
    x = _capture(6000, seed=5)
    src = _cf32_source(x, sr)
    chan = Channelize(src, k)

    for chunk in (128, 500):
        for ch in (1, 3):
            f = -ch * sr // k if ch < k // 2 else (k - ch) * sr // k
            ref = LowPass(Shift(src, f, sr), chan.frequency, k, size)
            for piece in run_channelize(chan, chunk=chunk):
                want, v = ref.read_at(piece.start, chunk)
                n = min(v, piece.data.shape[1])
                scale = max(np.max(np.abs(want[:n])), 1e-3)
                np.testing.assert_allclose(
                    piece.data[ch, :n], want[:n], atol=2e-6 * scale, rtol=0,
                    err_msg=f"chunk={chunk} ch={ch} start={piece.start}",
                )


def test_chunked_run_matches_single_shot_away_from_boundaries():
    k, size, sr = 4, 40, 4_000
    x = _capture(6000, seed=5)
    src = _cf32_source(x, sr)
    chan = Channelize(src, k)
    single, valid = chan.read_at(0, chan.length)

    chunk = 128
    # the last ceil((N/2 - K)/K) outputs of each pull read a truncated
    # block (reference per-read semantics); everything else must match
    guard = -(-max(size - size // 2 - k, 0) // k)
    for piece in run_channelize(chan, chunk=chunk):
        n = min(piece.data.shape[1], valid - piece.start)
        keep = max(0, n - guard)
        np.testing.assert_allclose(
            piece.data[:, :keep].T,
            single[piece.start : piece.start + keep],
            atol=2e-6,
            rtol=0,
            err_msg=f"start={piece.start}",
        )


def test_run_channelize_respects_max_out():
    src = _cf32_source(_capture(4096), 8_000)
    chan = Channelize(src, 8)
    total = sum(p.data.shape[1] for p in run_channelize(chan, chunk=64, max_out=100))
    assert total == 100


def test_validation_errors():
    src = _cf32_source(_capture(256), 8_000)
    with pytest.raises(ValueError):
        Channelize(src, 1)
    with pytest.raises(ValueError):
        Channelize(src, 8, frequency=0)
    with pytest.raises(ValueError):
        Channelize(_cf32_source(_capture(16), 8_000), 8, size=40)


def test_cli_channelize_writes_channels(tmp_path, monkeypatch, capsys):
    from quadrs_tpu.cli import main

    k, sr = 4, 48_000
    x = _capture(9000, seed=7)
    raw = np.empty(2 * len(x), dtype="<f4")
    raw[0::2] = x.real
    raw[1::2] = x.imag
    cap = tmp_path / f"band.sr{sr // 1000}k.cf32"
    cap.write_bytes(raw.tobytes())
    monkeypatch.chdir(tmp_path)

    rc = main(f"channelize -channels {k} -select 0,3 -out bank {cap}".split())
    assert rc == 0
    out = capsys.readouterr().out
    assert "channelize: 4 channels" in out

    src = _cf32_source(x, sr)
    chan = Channelize(src, k)
    want, valid = chan.read_at(0, chan.length)
    for ch in (0, 3):
        path = tmp_path / f"bank.ch{ch}.sr{sr // k}.cf32"
        assert path.exists(), path
        got = np.frombuffer(path.read_bytes(), dtype="<f4").reshape(-1, 2)
        got = (got[:, 0] + 1j * got[:, 1]).astype(np.complex64)
        assert len(got) == valid
        np.testing.assert_allclose(got, want[:valid, ch], atol=2e-6, rtol=0)
    # channel 1 was not selected
    assert not (tmp_path / f"bank.ch1.sr{sr // k}.cf32").exists()

    # -overwrite no refuses to clobber
    rc = main(f"channelize -channels {k} -select 0 -out bank2 {cap}".split())
    assert rc == 0
    rc2 = main(f"channelize -channels {k} -select 0 -out bank2 {cap}".split())
    assert rc2 != 0 or capsys.readouterr().err  # FileExistsError surfaces


def test_cli_channelize_matches_reference_chain(tmp_path, monkeypatch, capsys):
    """One channel of the bank vs the reference command line that
    extracts the same channel: from .. shift .. lowpass .. write."""
    from quadrs_tpu.cli import main

    k, sr = 4, 48_000
    x = _capture(8192, seed=11)
    raw = np.empty(2 * len(x), dtype="<f4")
    raw[0::2] = x.real
    raw[1::2] = x.imag
    cap = tmp_path / f"band.sr{sr // 1000}k.cf32"
    cap.write_bytes(raw.tobytes())
    monkeypatch.chdir(tmp_path)

    cutoff = sr // (2 * k)
    assert main(
        f"channelize -channels {k} -select 1 -out pfb {cap}".split()
    ) == 0
    # the reference chain ends with its short-read panic at the
    # over-reported final sample (src/lib.rs:203 assert; LowPass::len
    # over-reports by one) — everything before it is on disk
    rc = main(
        f"from {cap} shift -{sr // k} lowpass -power 20 -decimate {k} "
        f"{cutoff} write chain".split()
    )
    assert rc != 0
    assert "short read" in capsys.readouterr().err

    pfb = np.frombuffer(
        (tmp_path / f"pfb.ch1.sr{sr // k}.cf32").read_bytes(), dtype="<f4"
    )
    chain = np.frombuffer(
        (tmp_path / f"chain.sr{sr // k}.cf32").read_bytes(), dtype="<f4"
    )
    # write pulls 0x1000 samples per read (per-read truncation falls
    # differently near EOF); compare the shared prefix sans the last
    # truncated region
    n = min(len(pfb), len(chain)) - 2 * 40
    np.testing.assert_allclose(pfb[:n], chain[:n], atol=3e-6, rtol=0)


def test_parse_errors():
    from quadrs_tpu import args as argmod

    with pytest.raises(ValueError):
        argmod.parse("channelize -channels 1 cap.sr8k.cf32".split())
    with pytest.raises(ValueError):
        argmod.parse("channelize -select 9 cap.sr8k.cf32".split())
    with pytest.raises(ValueError):
        argmod.parse("channelize -select , cap.sr8k.cf32".split())
    with pytest.raises(ValueError):
        argmod.parse(["channelize"])  # no capture
    cmd, = argmod.parse("channelize -channels 16 -power 30 cap.sr8k.cf32".split())
    assert cmd.channels == 16 and cmd.size == 60 and cmd.select is None


# ---------------------------------------------------------------- mesh


def _mesh_or_skip(n: int):
    import jax

    from quadrs_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < n:
        pytest.skip(f"needs >= {n} devices")
    return make_mesh(n, 1)


def test_sharded_channelize_matches_single_device():
    """run_channelize(mesh=4x1) time-shards the capture with a
    ``size``-sample halo; with shards pulling the same ``chunk`` as
    the single-device run the output is BIT-equal (the per-shard slice
    is the "read" for the per-read truncation semantics), including the
    unaligned capture tail that runs single-device."""
    mesh = _mesh_or_skip(4)
    x = _capture(40_000, seed=21)
    k, size, chunk = 8, 64, 512

    def run(m):
        chan = Channelize(_cf32_source(x, 16_000), k, size=size)
        return np.concatenate(
            [c.data for c in run_channelize(chan, chunk=chunk, mesh=m)],
            axis=1,
        )

    ref, got = run(None), run(mesh)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def test_sharded_channelize_cs8_odd_k():
    """8-way mesh, integer wire format, K that doesn't divide the
    prototype length (halo is not a whole number of output cells)."""
    mesh = _mesh_or_skip(8)
    rng = np.random.default_rng(22)
    n = 40_000
    raw = np.frombuffer(
        (np.clip(rng.standard_normal(2 * n), -1, 1) * 100)
        .astype(np.int8)
        .tobytes(),
        dtype=np.uint8,
    )

    def run(m):
        src = SampleSource(raw, FileFormat("cs8"), 16_000)
        chan = Channelize(src, 6, size=50)
        return np.concatenate(
            [c.data for c in run_channelize(chan, chunk=333, mesh=m)],
            axis=1,
        )

    ref, got = run(None), run(mesh)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def test_sharded_channelize_rejects_chained_stream():
    mesh = _mesh_or_skip(2)
    x = _capture(9_000, seed=23)
    chain = Shift(_cf32_source(x, 16_000), 1_000, 16_000)
    chan = Channelize(chain, 4, size=40)
    with pytest.raises(ValueError, match="raw capture"):
        next(run_channelize(chan, mesh=mesh))


def test_cli_channelize_mesh_matches_single_device(tmp_path, monkeypatch, capsys):
    """``channelize -mesh 4`` writes byte-identical channel files and
    prints the same meter lines as the single-device run (capture long
    enough that every shard pulls a full -chunk)."""
    import jax

    from quadrs_tpu.cli import main

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    x = _capture(20_000, seed=24)
    raw = np.empty(2 * len(x), dtype="<f4")
    raw[0::2] = x.real
    raw[1::2] = x.imag
    cap = tmp_path / "band.sr48k.cf32"
    cap.write_bytes(raw.tobytes())
    monkeypatch.chdir(tmp_path)

    base = "channelize -channels 4 -chunk 256 -select 0,3 -out {} {m}" + str(cap)
    assert main(base.format("single", m="").split()) == 0
    want = capsys.readouterr().out.replace("single", "{}")
    assert main(base.format("meshed", m="-mesh 4 ").split()) == 0
    got = capsys.readouterr().out.replace("meshed", "{}")
    # identical meter lines up to the (timing-dependent) rate summary
    assert got.splitlines()[:-1] == want.splitlines()[:-1]
    for ch in (0, 3):
        a = (tmp_path / f"single.ch{ch}.sr12000.cf32").read_bytes()
        b = (tmp_path / f"meshed.ch{ch}.sr12000.cf32").read_bytes()
        assert a == b


def test_channelize_mesh_parse_errors():
    from quadrs_tpu import args as argmod

    with pytest.raises(ValueError, match="Tx1"):
        argmod.parse("channelize -mesh 2x2 cap.sr8k.cf32".split())
    with pytest.raises(ValueError, match="-stdin"):
        argmod.parse("channelize -mesh 2 -stdin yes -sr 8k -format cf32".split())
    cmd, = argmod.parse("channelize -mesh 4 cap.sr8k.cf32".split())
    assert cmd.mesh == (4, 1)
