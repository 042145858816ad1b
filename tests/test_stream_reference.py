"""``PipelineModel.step_stream`` and the StreamRunner against an
independent float64 numpy reference: formats x decimations x taps, odd
and long filters, STFT widths, zero padding masked in the decoded
domain, and NCO phase continuity across chunks."""

import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat
from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu.selfcheck import stream_norms_ref
from quadrs_tpu.sources import SampleSource
from quadrs_tpu.stream_runner import StreamRunner


def _cfg(fmt, decimate, taps, width=64, shift=12_500):
    return PipelineConfig(
        sample_rate=1_000_000,
        shift_freq=shift,
        lp_freq=50_000,
        decimate=decimate,
        taps=taps,
        fft_width=width,
        fmt=fmt,
    )


def _ref(model, planes, windows, length=None):
    cfg = model.cfg
    return stream_norms_ref(
        planes, cfg.fmt, cfg.sample_rate, cfg.shift_freq, model.taps,
        cfg.decimate, cfg.fft_width, windows, length=length,
    )


def _check_step(cfg, n_windows=5, extra=29, rtol=2e-5):
    model = PipelineModel(cfg)
    n = cfg.decimate * cfg.fft_width * n_windows + cfg.taps + extra
    planes = model.synth_raw(n, seed=17)
    got = np.asarray(model.jit_step_stream(planes, np.float32(0.0)))
    want = _ref(model, planes, np.arange(got.shape[0]))
    assert got.shape[0] >= n_windows
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * want.max())


@pytest.mark.parametrize("fmt", list(FileFormat), ids=lambda f: f.value)
@pytest.mark.parametrize("decimate,taps", [(32, 400), (8, 64), (3, 40)])
def test_step_stream_matches_float64(fmt, decimate, taps):
    _check_step(_cfg(fmt, decimate, taps))


@pytest.mark.parametrize(
    "fmt,decimate,taps",
    [
        (FileFormat.COMPLEX_UINT8, 5, 77),       # odd taps, odd decimate
        (FileFormat.COMPLEX_INT8, 8, 65),        # odd taps: ceil(taps/2) lead
        (FileFormat.COMPLEX_INT16, 12, 200),     # non-dividing decimate
        (FileFormat.COMPLEX_INT8, 8, 400),       # CLI default -decimate 8, power 200
        (FileFormat.COMPLEX_FLOAT32, 32, 4000),  # power=2000: spectral FIR
    ],
)
def test_step_stream_filters(fmt, decimate, taps):
    _check_step(_cfg(fmt, decimate, taps))


@pytest.mark.parametrize(
    "fmt,width,decimate,taps",
    [
        (FileFormat.COMPLEX_INT8, 64, 32, 400),  # the headline chain
        (FileFormat.COMPLEX_UINT8, 128, 16, 100),
        (FileFormat.COMPLEX_FLOAT32, 32, 8, 64),
        (FileFormat.COMPLEX_INT16, 8, 12, 60),
    ],
)
def test_step_stream_widths(fmt, width, decimate, taps):
    _check_step(_cfg(fmt, decimate, taps, width=width, shift=12_345), n_windows=9, extra=13)


@pytest.mark.parametrize("fmt", list(FileFormat), ids=lambda f: f.value)
def test_zero_padding_masked_in_decoded_domain(fmt):
    """Raw zero bytes past ``valid`` decode to nonzero values for cu8
    and cs16; step_stream must treat them as zero samples."""
    cfg = _cfg(fmt, 8, 64, width=32)
    model = PipelineModel(cfg)
    n = cfg.decimate * cfg.fft_width * 6 + cfg.taps
    valid = n - 777
    planes = model.synth_raw(n, seed=23)
    planes[:, valid:] = 0
    got = np.asarray(model.jit_step_stream(planes, np.float32(0.0), np.int32(valid)))
    want = _ref(model, planes, np.arange(got.shape[0]), length=valid)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * want.max())


@pytest.mark.parametrize("windows_per_chunk", [1, 2, 3])
def test_runner_phase_continuity_across_chunks(windows_per_chunk):
    """Chunked streaming over a cs8 capture equals one float64 pass over
    the whole capture, every window, whatever the chunk size: each chunk
    starts its NCO at the exact absolute phase."""
    cfg = _cfg(FileFormat.COMPLEX_INT8, 8, 64, width=32, shift=123_457)
    model = PipelineModel(cfg)
    win_raw = cfg.decimate * cfg.fft_width
    n = win_raw * 7 + cfg.taps // 2
    planes = model.synth_raw(n, seed=31)
    interleaved = np.ascontiguousarray(planes.T).reshape(-1).view(np.uint8)
    src = SampleSource(interleaved, cfg.fmt, cfg.sample_rate)
    rows = {}
    StreamRunner(src, model, chunk_samples=win_raw * windows_per_chunk).run(
        lambda w0, norms: rows.update({w0 + i: norms[i] for i in range(len(norms))})
    )
    windows = np.array(sorted(rows))
    np.testing.assert_array_equal(windows, np.arange(len(windows)))
    got = np.stack([rows[w] for w in windows])
    want = _ref(model, planes, windows)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * want.max())
