"""Plain float64 numpy references of the device chains, and the checks
that hold the device to them at real sizes.

The references share no code with the device path: decode, the exact
NCO, the decimating FIR, the DFT and the band-survey reductions are
written out here in numpy float64, straight from their definitions (the
FIR taps are the configuration's own f32 taps).  They are the yardstick
for ``chip_smoke.py`` and for the card-only tests (``pytest -m gpu``).

The precision checks run the streaming chain and the waterfall bank as
users run them, under JAX's default matmul precision, and compare every
window with float64.  An f32 matmul that silently ran as TF32 (10-bit
mantissa) misses by ~3e-4 of the peak on an H100; the f32 path lands
near 3e-7, so :data:`PRECISION_RTOL` sits between the two.
"""

from __future__ import annotations

import numpy as np

from quadrs_tpu.formats import FileFormat

# |device - float64| / peak norm: above f32 rounding, below TF32's
PRECISION_RTOL = 2e-5

# (scale, offset) of the reference decode: value = raw * scale + offset
_DECODE = {
    FileFormat.COMPLEX_FLOAT32: (1.0, 0.0),
    FileFormat.COMPLEX_INT8: (1.0 / 127.0, 0.0),
    FileFormat.COMPLEX_UINT8: (1.0 / 255.0, -127.5),
    FileFormat.COMPLEX_INT16: (1.0 / 65535.0, -32767.5),
}


def decode_ref(planes: np.ndarray, fmt: FileFormat) -> np.ndarray:
    """(..., 2, n) native planes -> (..., n) complex128."""
    scale, offset = _DECODE[fmt]
    p = np.asarray(planes).astype(np.float64) * scale + offset
    return p[..., 0, :] + 1j * p[..., 1, :]


def nco_ref(start: int, n: int, shift: int, sample_rate: int) -> np.ndarray:
    """``exp(2j*pi*shift*m/sr)`` for absolute samples ``m = start ..
    start+n-1``, the phase reduced exactly in integers first."""
    m = np.arange(start, start + n, dtype=np.int64) % sample_rate
    frac = (m * (shift % sample_rate)) % sample_rate
    return np.exp(2j * np.pi * frac.astype(np.float64) / sample_rate)


def fftshift_norms(frames: np.ndarray) -> np.ndarray:
    """|DFT| of each row, zero frequency moved to the centre bin."""
    spec = np.fft.fft(frames, axis=-1)
    return np.abs(np.fft.fftshift(spec, axes=-1))


def stream_norms_ref(
    planes: np.ndarray,
    fmt: FileFormat,
    sample_rate: int,
    shift: int,
    taps: np.ndarray,
    decimate: int,
    width: int,
    windows,
    length: int | None = None,
) -> np.ndarray:
    """Spectrogram rows of shift -> FIR(decimate) -> STFT for the given
    STFT ``windows`` of a capture whose sample 0 is ``planes[:, 0]``.

    Decimated output ``i`` is ``sum_j x[i*D + ceil(T/2) + j] * h[j]``
    (the reference's group-delay pick) and window ``w`` holds outputs
    ``w*width .. w*width+width-1``.  Samples at or past ``length``
    (default: the planes' extent) are zero.  Returns float64
    ``(len(windows), width)``."""
    h = np.asarray(taps, dtype=np.float64)
    t = len(h)
    lead = t - t // 2
    span = (width - 1) * decimate + t
    length = planes.shape[-1] if length is None else length
    out = np.empty((len(windows), width))
    for k, w in enumerate(windows):
        lo = w * width * decimate + lead
        hi = min(lo + span, length)
        x = np.zeros(span, dtype=np.complex128)
        if hi > lo:
            x[: hi - lo] = decode_ref(planes[:, lo:hi], fmt)
            x[: hi - lo] *= nco_ref(lo, hi - lo, shift, sample_rate)
        frames = np.lib.stride_tricks.sliding_window_view(x, t)[::decimate]
        out[k] = fftshift_norms(np.dot(frames[:width], h))
    return out


def waterfall_norms_ref(
    planes: np.ndarray,
    fmt: FileFormat,
    width: int,
    stride: int,
    windows=None,
    window: np.ndarray | None = None,
) -> np.ndarray:
    """(..., windows, width) float64 norms of the strided STFT of
    ``planes`` (..., 2, n); ``windows`` defaults to every whole window,
    ``window`` is an optional taper applied to each frame."""
    x = decode_ref(planes, fmt)
    if windows is None:
        windows = np.arange((x.shape[-1] - width) // stride + 1)
    frames = x[..., np.asarray(windows)[:, None] * stride + np.arange(width)]
    if window is not None:
        frames = frames * np.asarray(window, dtype=np.float64)
    return fftshift_norms(frames)


def scan_ref(
    planes: np.ndarray, fmt: FileFormat, width: int, stride: int, threshold: float
):
    """Band survey of one (2, n) capture: per fftshifted bin the average
    and maximum norm over every window and the fraction of windows whose
    norm exceeds ``threshold``."""
    norms = waterfall_norms_ref(planes, fmt, width, stride)
    return norms.mean(axis=0), norms.max(axis=0), (norms > threshold).mean(axis=0)


def rel_err(got, want) -> float:
    """max |got - want| over the peak |want|."""
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def check_stream_precision(
    n_chunk: int = 1 << 22, taps: int = 400, seed: int = 0
) -> float:
    """The headline chain (cs8, 21 Msps, shift 280k, lowpass 200k,
    decimate 32, STFT-64; ``taps=4000`` is the long spectral FIR) over
    one ``n_chunk``-sample chunk, every window against float64.  Returns
    the relative error; raises when it exceeds :data:`PRECISION_RTOL`."""
    from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel

    cfg = PipelineConfig(taps=taps, fmt=FileFormat.COMPLEX_INT8)
    model = PipelineModel(cfg)
    lookahead = taps + (taps - taps // 2)
    planes = model.synth_raw(n_chunk + lookahead, seed=seed)
    got = np.asarray(model.jit_step_stream(planes, np.float32(0.0)))
    want = stream_norms_ref(
        planes,
        cfg.fmt,
        cfg.sample_rate,
        cfg.shift_freq,
        model.taps,
        cfg.decimate,
        cfg.fft_width,
        np.arange(got.shape[0]),
    )
    err = rel_err(got, want)
    if not err <= PRECISION_RTOL:
        raise AssertionError(f"stream chain off float64 by {err:.3g} of peak")
    return err


def check_waterfall_precision(
    n_streams: int = 64,
    n: int = 1 << 16,
    width: int = 1024,
    stride: int = 256,
    seed: int = 0,
) -> float:
    """The waterfall bank (cs8, ``width``-pt, ``stride``) over ``n``
    samples per stream, every window of every stream against float64.
    Returns the relative error; raises above :data:`PRECISION_RTOL`."""
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel

    model = WaterfallModel(
        WaterfallConfig(n_streams=n_streams, fft_width=width, stride=stride)
    )
    planes = model.synth_raw(n, seed=seed)
    got = np.asarray(model.jit_step()(planes))
    want = waterfall_norms_ref(planes, model.cfg.fmt, width, stride)
    err = rel_err(got, want)
    if not err <= PRECISION_RTOL:
        raise AssertionError(f"waterfall bank off float64 by {err:.3g} of peak")
    return err
