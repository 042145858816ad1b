"""Mesh-sharded demod front end: every receiver's ``mesh=`` path must
match the single-device run exactly (same windows, same per-pull
truncation, same per-window programs — only the batch tiling differs,
and on the CPU rig even that is bit-identical).

The sharded builder time-shards the streaming dispatch's WINDOW axis
(``models.demod._channel_step(mesh=)``): each chip holds a contiguous
run of windows' raw planes and pulls the window-overlap halo from its
right neighbor over the interconnect, exactly the find/channelize pattern
(``parallel/sharding.py``).  Mesh dispatches cover full windows only;
the EOF tail stitches through the single-device dispatches, so these
tests size captures to exercise BOTH the sharded prefix and the
stitched tail.
"""

import io
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest

from quadrs_tpu.models.demod import (
    AmDemod,
    FmDemod,
    FskDemod,
    OokDemod,
    PskDemod,
    SsbDemod,
    _channel_step,
)
from quadrs_tpu.parallel.sharding import make_mesh
from quadrs_tpu.sources import SampleSource
from quadrs_tpu.stream import DcBlock


@pytest.fixture(autouse=True)
def _needs_mesh_devices():
    """The module meshes up to 8 ways; with fewer devices (one card)
    every sharding test skips, like test_find's."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs >= 8 devices")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """FM-ish tone at +280 kHz in 21 Msps noise, long enough that the
    small-chunk demods below get a multi-dispatch sharded prefix AND a
    partial-window tail."""
    rng = np.random.default_rng(3)
    n = 1 << 17
    t = np.arange(n) / 21e6
    phase = 2 * np.pi * 280e3 * t + 50.0 * np.sin(2 * np.pi * 1000 * t)
    x = (
        0.5 * np.exp(1j * phase)
        + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64)
    path = tmp_path_factory.mktemp("meshdemod") / "tone.sr21M.cf32"
    x.tofile(path)
    return str(path)


def _assert_sharded_engages(demod, src_path, c, lead, mesh, post=None):
    """The parity below is vacuous unless the sharded builder actually
    covers windows — pin that the geometry engages (k a positive
    multiple of the mesh, full windows available)."""
    chan = demod.channel(SampleSource.from_file(src_path))
    if post is None:
        post = lambda x: jnp.real(x)
    built = _channel_step(chan, c, lead, post, mesh=mesh)
    assert built is not None, "sharded channel builder did not engage"
    geom = built[2]
    assert geom["k"] >= mesh.shape["time"]
    assert geom["k"] % mesh.shape["time"] == 0
    assert geom["n_full"] >= geom["k"]


def test_fm_mesh_matches_single_device(capture):
    fm = FmDemod(
        center=280_000, bandwidth=100_000, decimate=10, taps=400,
        audio_bandwidth=15_000, audio_decimate=10, audio_taps=64,
        chunk=1024,
    )
    mesh = make_mesh(4, 1)
    _assert_sharded_engages(fm, capture, 1024, 1, mesh)
    r1, a1 = fm.demodulate(SampleSource.from_file(capture))
    r2, a2 = fm.demodulate(SampleSource.from_file(capture), mesh=mesh)
    assert r1 == r2
    a1, a2 = np.asarray(a1), np.asarray(a2)
    assert a1.shape == a2.shape
    np.testing.assert_allclose(a2, a1, rtol=1e-5, atol=1e-5)


def test_am_mesh_matches_single_device(capture):
    am = AmDemod(
        center=280_000, bandwidth=10_000, decimate=20, taps=400, chunk=512
    )
    mesh = make_mesh(4, 1)
    _assert_sharded_engages(am, capture, 512, 0, mesh)
    r1, a1 = am.demodulate(SampleSource.from_file(capture))
    r2, a2 = am.demodulate(SampleSource.from_file(capture), mesh=mesh)
    assert r1 == r2
    np.testing.assert_allclose(
        np.asarray(a2), np.asarray(a1), rtol=1e-5, atol=1e-5
    )


def test_ssb_mesh_matches_single_device(capture):
    ssb = SsbDemod(
        center=-280_000, bandwidth=3000, decimate=20, taps=400, chunk=512
    )
    mesh = make_mesh(4, 1)
    r1, a1 = ssb.demodulate(SampleSource.from_file(capture))
    r2, a2 = ssb.demodulate(SampleSource.from_file(capture), mesh=mesh)
    assert r1 == r2
    np.testing.assert_allclose(
        np.asarray(a2), np.asarray(a1), rtol=1e-5, atol=1e-5
    )


def test_psk_baseband_mesh_matches_single_device(capture):
    psk = PskDemod(
        center=280_000, bandwidth=200_000, decimate=32, taps=400,
        symbol_rate=10_000, chunk=512,
    )
    mesh = make_mesh(4, 1)
    r1, b1 = psk.baseband(SampleSource.from_file(capture))
    r2, b2 = psk.baseband(SampleSource.from_file(capture), mesh=mesh)
    assert r1 == r2
    assert b1.shape == b2.shape
    np.testing.assert_allclose(b2, b1, rtol=1e-5, atol=1e-5)


def test_fsk_symbols_mesh_match(capture):
    fsk = FskDemod(
        center=280_000, bandwidth=200_000, decimate=32, taps=400,
        fft_width=64,
    )
    mesh = make_mesh(4, 1)
    s1 = fsk.symbols(SampleSource.from_file(capture))
    s2 = fsk.symbols(SampleSource.from_file(capture), mesh=mesh)
    assert s1 == s2 and len(s1) > 0


def test_fsk_gapped_stride_mesh_match(capture):
    """stride > width leaves gaps between windows (n_in <= hop): the
    sharded front end needs NO neighbor halo there — regression for the
    negative-halo slice bug."""
    fsk = FskDemod(
        center=280_000, bandwidth=200_000, decimate=8, taps=40,
        fft_width=64, stride=600,
    )
    mesh = make_mesh(4, 1)
    s1 = fsk.symbols(SampleSource.from_file(capture))
    s2 = fsk.symbols(SampleSource.from_file(capture), mesh=mesh)
    assert s1 == s2 and len(s1) > 0


def test_ook_pulses_mesh_match(capture):
    ook = OokDemod(width=4, stride=2, threshold=0.001)
    mesh = make_mesh(8, 1)
    p1 = np.asarray(ook.pulses(SampleSource.from_file(capture)))
    p2 = np.asarray(ook.pulses(SampleSource.from_file(capture), mesh=mesh))
    assert np.array_equal(p1, p2)


def test_mesh_requires_channel_chain(capture):
    """User-chained stages in front of the receiver can't shard (the
    front end shards the receiver's OWN chain over a raw capture) — the
    mesh request must fail loudly, not silently run single-device."""
    fm = FmDemod(center=280_000, decimate=10, chunk=1024)
    chained = DcBlock(SampleSource.from_file(capture), 1024)
    with pytest.raises(ValueError, match="-mesh"):
        fm.demodulate(chained, mesh=make_mesh(2, 1))
    ook = OokDemod()
    with pytest.raises(ValueError, match="-mesh"):
        ook.pulses(DcBlock(SampleSource.from_file(capture), 1024),
                   mesh=make_mesh(2, 1))
    fsk = FskDemod(center=280_000)
    with pytest.raises(ValueError, match="-mesh"):
        fsk.symbols(DcBlock(SampleSource.from_file(capture), 1024),
                    mesh=make_mesh(2, 1))


def test_mesh_short_capture_falls_back(tmp_path):
    """A capture too short to give every chip a full window still
    demodulates (entirely through the single-device stitch) and matches
    the unmeshed run — the mesh is a speed knob, not a semantics one."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(6000) + 1j * rng.standard_normal(6000)).astype(
        np.complex64
    )
    path = tmp_path / "short.sr1M.cf32"
    x.tofile(path)
    am = AmDemod(center=100_000, bandwidth=10_000, decimate=20, taps=400)
    r1, a1 = am.demodulate(SampleSource.from_file(str(path)))
    r2, a2 = am.demodulate(
        SampleSource.from_file(str(path)), mesh=make_mesh(8, 1)
    )
    assert r1 == r2
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))


class TestCli:
    def _run(self, argv):
        from quadrs_tpu.cli import main

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, buf.getvalue()

    def test_fsk_mesh_cli_matches_single_device(self, capture):
        rc1, out1 = self._run(["fsk", "-shift", "280k", capture])
        rc2, out2 = self._run(["fsk", "-shift", "280k", "-mesh", "4", capture])
        assert rc1 == rc2 == 0
        assert out1.splitlines()[0] == out2.splitlines()[0]

    def test_fm_mesh_cli_matches_single_device(self, capture):
        rc1, out1 = self._run(["fm", "-shift", "280k", "-decimate", "10", capture])
        rc2, out2 = self._run(
            ["fm", "-shift", "280k", "-decimate", "10", "-mesh", "4", capture]
        )
        assert rc1 == rc2 == 0
        assert out1.splitlines()[-1].rsplit(",", 1)[0] == (
            out2.splitlines()[-1].rsplit(",", 1)[0]
        )  # everything but the throughput figure

    def test_mesh_stream_axis_rejected(self, capture):
        rc, _ = self._run(["fm", "-mesh", "2x2", capture])
        assert rc == 1

    def test_mesh_stdin_rejected(self):
        rc, _ = self._run(
            ["ook", "-mesh", "4", "-stdin", "yes", "-sr", "1M",
             "-format", "cf32"]
        )
        assert rc == 1
