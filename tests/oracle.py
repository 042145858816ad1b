"""Sequential numpy mirror of the reference's pull-based semantics.

The Rust reference ships no goldens, so conformance is established
against this independent implementation: a direct sample-by-sample
transcription of the reference's math (decode formulas, f64 NCO phase,
f32 taps, truncated per-read convolution, glyph quantization), executed
window-by-window exactly as the reference sinks pull.  Tests then assert
the batched device-path output matches this oracle.

Accumulations (convolution dots, FFT) run in f64 here and cast to f32,
i.e. the oracle is the correctly-rounded target the f32 device path must
approach within float32 tolerance.
"""

from __future__ import annotations

import numpy as np

TAU = 2.0 * np.pi


class OracleStream:
    length: int
    sample_rate: int

    def read_at(self, off: int, n: int) -> np.ndarray:
        raise NotImplementedError

    def read_exact_at(self, off: int, n: int) -> np.ndarray:
        got = self.read_at(off, n)
        if len(got) != n:
            raise RuntimeError(f"read-exact messed up: {n} != {len(got)} at {off}")
        return got


class OracleArray(OracleStream):
    """A fully decoded capture held in memory (stands in for SampleFile)."""

    def __init__(self, data: np.ndarray, sample_rate: int):
        self.data = np.asarray(data, dtype=np.complex64)
        self.length = len(self.data)
        self.sample_rate = sample_rate

    def read_at(self, off: int, n: int) -> np.ndarray:
        assert off < self.length
        return self.data[off : off + n]


class OracleGen(OracleStream):
    """src/gen.rs: sum of cis(2*pi*f*m/sr), f64 phase, f32 components,
    always fills the buffer."""

    def __init__(self, cos, sample_rate: int, seconds: float):
        self.cos = list(cos)
        self.sample_rate = sample_rate
        self.length = int(seconds * float(sample_rate))

    def read_at(self, off: int, n: int) -> np.ndarray:
        m = off + np.arange(n, dtype=np.float64)
        base = m * TAU / float(self.sample_rate)
        out = np.zeros(n, dtype=np.complex64)
        for f in self.cos:
            angle = float(f) * base
            out = out + (
                np.cos(angle).astype(np.float32) + 1j * np.sin(angle).astype(np.float32)
            ).astype(np.complex64)
        return out


class OracleShift(OracleStream):
    """src/shift.rs: multiply sample m by cis(m * ratio), ratio f64."""

    def __init__(self, inner: OracleStream, frequency: int, sample_rate: int):
        assert abs(frequency) < sample_rate // 2
        self.inner = inner
        self.ratio = TAU * float(frequency) / float(sample_rate)
        self.sample_rate = sample_rate
        self.length = inner.length

    def read_at(self, off: int, n: int) -> np.ndarray:
        x = self.inner.read_at(off, n)
        place = (off + np.arange(len(x), dtype=np.float64)) * self.ratio
        mul = (
            np.cos(place).astype(np.float32) + 1j * np.sin(place).astype(np.float32)
        ).astype(np.complex64)
        return x * mul


def oracle_lowpass_taps(cutoff: float, size: int) -> np.ndarray:
    """src/filter.rs:86-105 in f32."""
    i = np.arange(size, dtype=np.float32)
    pi = np.float32(np.pi)
    x = np.float32(2.0) * np.float32(cutoff) * (
        i - (np.float32(size) - np.float32(1.0)) / np.float32(2.0)
    )
    sinc = np.sin(x * pi) / (x * pi)
    t = np.float32(2.0) * pi * i / (np.float32(size) - np.float32(1.0))
    win = (
        np.float32(0.42)
        - np.float32(0.5) * np.cos(t)
        + np.float32(0.08) * np.cos(np.float32(2.0) * t)
    )
    taps = sinc * win
    return (taps / taps.sum(dtype=np.float32)).astype(np.float32)


class OracleLowPass(OracleStream):
    """src/filter.rs: windowed-sinc FIR + decimate with the reference's
    per-read truncation: each pull convolves only the block it read, with
    out-of-block taps contributing zero."""

    def __init__(self, inner: OracleStream, frequency: int, decimate: int, size: int):
        self.inner = inner
        self.decimate = decimate
        self.size = size
        self.taps = oracle_lowpass_taps(frequency / inner.sample_rate, size)
        assert inner.length >= size
        self.length = 1 + (inner.length - size) // decimate
        self.sample_rate = inner.sample_rate // decimate

    def read_at(self, off: int, n: int) -> np.ndarray:
        d, size = self.decimate, self.size
        underlying = n * d + size
        raw = self.inner.read_at(off * d, underlying)
        valid = len(raw)
        if valid < size:
            raise RuntimeError("read shorter than the filter (reference panics here)")
        n_out = (valid - size) // d
        # y[i] = sum_j raw[i*d + size/2 + j] * h[j], zero outside the block
        padded = np.zeros(valid + size, dtype=np.complex128)
        padded[:valid] = raw
        out = np.empty(n_out, dtype=np.complex64)
        h = self.taps.astype(np.float64)
        for i in range(n_out):
            # reference pick convoluted[size + i*d] => x[i*d + ceil(size/2) + j]
            lo = i * d + (size - size // 2)
            out[i] = np.complex64(np.dot(padded[lo : lo + size], h))
        return out


def oracle_fft_norms(window: np.ndarray, shift: bool = True) -> np.ndarray:
    spec = np.fft.fft(window.astype(np.complex128))
    if shift:
        half = len(spec) // 2
        spec = np.concatenate([spec[half:], spec[:half]])
    return np.abs(spec).astype(np.float32)


def oracle_spark_fft(stream: OracleStream, width: int, stride: int, lo=None, hi=None):
    """src/fft.rs:12-69 — returns the glyph rows (without the header)."""
    lo = np.float32(0.08 if lo is None else lo)
    hi = np.float32(1.0 if hi is None else hi)
    glyphs = "▁▂▃▄▅▆▇"
    distinction = (hi - lo) / np.float32(len(glyphs))
    rows = []
    i = 0
    while i < stream.length - width:
        norms = oracle_fft_norms(stream.read_exact_at(i, width))
        buf = []
        for norm in norms:
            if norm < lo:
                buf.append(" ")
            elif norm >= hi:
                buf.append("█")
            else:
                buf.append(glyphs[int((norm - lo) / distinction)])
        rows.append("".join(buf))
        i += stride
    return rows


def oracle_freq_levels(stream: OracleStream, width: int, stride: int) -> list[int]:
    """src/fft.rs:77-101."""
    total = (stream.length - width) // stride
    vals = []
    for reading in range(total):
        spec = np.fft.fft(stream.read_exact_at(reading * stride, width).astype(np.complex128))
        norms = np.abs(spec).astype(np.float32)
        first = norms[: width // 2].sum(dtype=np.float32)
        second = norms[width // 2 :].sum(dtype=np.float32)
        vals.append(0 if first < second else 1)
    return vals
