"""Capture statistics (`quadjax info` / `sinks.capture_info`): the
soxi of IQ files (an addition; no reference counterpart)."""

import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat
from quadrs_tpu.sinks import capture_info
from quadrs_tpu.sources import SampleSource


def _cf32(z, sr=48_000):
    return SampleSource(
        np.ascontiguousarray(z.astype(np.complex64)).view(np.uint8),
        FileFormat.COMPLEX_FLOAT32,
        sr,
    )


def test_stats_match_numpy_cf32():
    rng = np.random.default_rng(2)
    z = 0.3 * (rng.normal(size=5000) + 1j * rng.normal(size=5000)) + (0.1 - 0.05j)
    i = capture_info(_cf32(z), chunk=1777)  # multiple chunks incl. a ragged tail
    assert i.samples == 5000 and i.analyzed == 5000
    assert i.bytes == 5000 * 8 and i.clipped is None
    assert abs(i.dc - z.mean()) < 1e-4
    assert abs(i.rms - np.sqrt(np.mean(np.abs(z) ** 2))) < 1e-4
    assert abs(i.peak - np.abs(z).max()) < 1e-5
    zc = z - z.mean()
    rho = np.sum(zc * zc) / np.sum(np.abs(zc) ** 2)
    assert abs(i.rho - rho) < 1e-3


def test_rho_flags_an_iq_image_not_a_dc_offset():
    rng = np.random.default_rng(4)
    s = (rng.normal(size=8000) + 1j * rng.normal(size=8000)) * np.exp(
        2j * np.pi * 0.13 * np.arange(8000)
    )
    # a large DC offset alone must NOT read as an image
    clean = capture_info(_cf32(s + 3.0))
    assert abs(clean.rho) < 0.05
    # an injected image must
    dirty = capture_info(_cf32(s + 0.08 * np.conj(s) + 3.0))
    assert abs(dirty.rho) / 2.0 > 0.05


def test_cu8_neutral_and_clipping():
    # constant mid-codes decode near the cu8 neutral (-127 + -127j);
    # info reports dc ABOUT that neutral, so it reads near zero
    buf = np.full(2000, 127, dtype=np.uint8)
    buf[1::2] = 128
    src = SampleSource(buf, FileFormat.COMPLEX_UINT8, 1000)
    i = capture_info(src)
    assert abs(i.dc) < 0.01 and i.clipped == 0.0
    # rail codes count as clipped
    buf2 = buf.copy()
    buf2[:100] = 255
    buf2[100:150] = 0
    i2 = capture_info(SampleSource(buf2, FileFormat.COMPLEX_UINT8, 1000))
    assert i2.clipped == pytest.approx(150 / 2000)


def test_cs16_neutral_is_decode_of_code_zero():
    # an idle cs16 receiver holds code 0, which decodes to -32767.5
    # (raw/65535 - 32767.5); info's dc must read ~0 there, and a small
    # ripple must read at its true decoded scale (1/65535 per code)
    raw = np.zeros(4000, dtype="<i2")
    raw[0::2] = 100  # +100 codes on re only
    src = SampleSource(raw.view(np.uint8), FileFormat.COMPLEX_INT16, 1000)
    i = capture_info(src)
    assert abs(i.dc - (100 / 65535.0)) < 1e-6
    assert i.clipped == 0.0
    assert i.rho == 0  # constant capture: no AC power, report no image
    rails = np.array([-32768, 32767, 0, 0], dtype="<i2")
    i2 = capture_info(SampleSource(rails.view(np.uint8), FileFormat.COMPLEX_INT16, 1000))
    assert i2.clipped == pytest.approx(0.5)


def test_cs8_limit_and_rails():
    raw = np.zeros(400, dtype=np.int8)
    raw[:4] = 127
    raw[4:8] = -128
    src = SampleSource(raw.view(np.uint8), FileFormat.COMPLEX_INT8, 1000)
    i = capture_info(src, limit=100)
    assert i.analyzed == 100 and i.samples == 200
    assert i.clipped == pytest.approx(8 / 200)  # over the analyzed half
    full = capture_info(src)
    assert full.clipped == pytest.approx(8 / 400)


def test_cli_info(tmp_path, monkeypatch, capsys):
    from quadrs_tpu.cli import main

    monkeypatch.chdir(tmp_path)
    assert main("gen -cos 0 -cos 700 -len 0.1 12k write t".split()) == 0
    # the writer pulls 0x1000-sample chunks and gen reads never come
    # short (reference behavior), so the file holds 4096 samples
    assert main("info t.sr12000.cf32 t.sr12000.cf32".split()) == 0
    out = capsys.readouterr().out
    assert out.count("cf32, 12000 Hz, 4096 samples") == 2
    assert "|dc|/rms -3.0 dB" in out  # the cos-0 tone: unit DC vs rms sqrt(2)
    assert "clipped: n/a" in out
    assert "info: 2 files, 8192 samples" in out

    assert main("info -limit 100 t.sr12000.cf32".split()) == 0
    assert "stats over the first 100" in capsys.readouterr().out

    # grammar: no filenames / bad flags error cleanly
    assert main(["info"]) != 0
    assert main("info -limit 0 t.sr12000.cf32".split()) != 0
    capsys.readouterr()
