"""The operation model: chainable pipeline commands and their dispatch.

Mirror of the reference's ``Operation`` enum and ``exec`` fold
(``src/lib.rs:25-176``): ``From``/``Gen`` create the stream accumulator,
``Shift``/``LowPass`` wrap it lazily, and the sinks (``SparkFft``,
``Bucket``, ``Write``) consume it but pass it through unchanged so
multiple sinks can be chained.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from quadrs_tpu.formats import FileDetails
from quadrs_tpu.sources import SampleSource, ToneGen
from quadrs_tpu.stream import LowPass, Shift, Stream


class Operation:
    """Base class for pipeline operations (reference ``src/lib.rs:25-59``)."""


@dataclass
class From(Operation):
    details: FileDetails
    filename: str


@dataclass
class ShiftOp(Operation):
    frequency: int


@dataclass
class LowPassOp(Operation):
    size: int
    decimate: int
    frequency: int


@dataclass
class ResampleOp(Operation):
    """Rational rate conversion by ``up/down`` (an addition;
    the reference only decimates)."""

    up: int
    down: int
    size: int | None = None
    power: int = 8


@dataclass
class DcBlockOp(Operation):
    """Trailing-mean DC-offset removal (an addition; see
    :class:`quadrs_tpu.stream.DcBlock`)."""

    window: int = 32_000  # the CLI default "32k" (decimal SI)


@dataclass
class AgcOp(Operation):
    """Trailing-RMS automatic gain control (an addition; see
    :class:`quadrs_tpu.stream.Agc`)."""

    target: float = 1.0
    window: int = 4_000  # the CLI default "4k" (decimal SI)
    max_gain: float = 1000.0


@dataclass
class IqbalOp(Operation):
    """IQ-imbalance correction (an addition; see
    :class:`quadrs_tpu.stream.IqCorrect`).  ``c`` is the explicit
    correction coefficient; None blind-estimates it from the first
    ``est`` samples."""

    c: complex | None = None
    est: int = 256_000  # matches the CLI's '-est 256k' (decimal SI)


@dataclass
class SparkFftOp(Operation):
    width: int = 128
    stride: int | None = None
    min: float | None = None
    max: float | None = None


@dataclass
class BucketOp(Operation):
    fft_width: int = 128
    stride: int | None = None
    levels: int = 2


@dataclass
class WriteOp(Operation):
    overwrite: bool
    prefix: str
    # Addition: quantize to an integer wire format (the
    # reference writes cf32 only); None keeps the reference behavior
    format: str | None = None


@dataclass
class FindOp(Operation):
    """Matched-filter pattern search (an addition; see
    :func:`quadrs_tpu.sinks.find_pattern`): locate every occurrence of
    the pattern capture(s) in the accumulated stream by gain/phase-
    invariant normalized cross-correlation, emitting one
    ``offset,score,scale,freq`` line per match (plus the winning
    template index when ``-pattern`` is given more than once)."""

    details: Sequence[FileDetails]
    filenames: Sequence[str]
    threshold: float = 0.5
    top: int = 0  # max matches to report (0 = all)
    distance: int | None = None  # NMS radius (default: pattern length)
    freq_tol: float = 0.0  # carrier-offset search half-width (Hz)
    freq_step: float | None = None  # grid spacing (default 0.4*rate/l)
    # -stdin: search a live pipe instead of the accumulator (cli.py
    # builds the LivePipeStream; these describe the pipe's wire format)
    stdin: bool = False
    sample_rate: str | None = None
    format: str | None = None
    # -write: save each match as a re-`from`-able slice of the ORIGINAL
    # capture (span-mapped through the chain, so a match on a decimated
    # stream still slices the raw file), widened by -pre/-post searched-
    # stream samples
    write: str | None = None
    pre: int = 0
    post: int = 0
    overwrite: bool = False
    # -mesh T (or Tx1): time-shard the capture's sample axis across the
    # device mesh with an l-1 halo (sinks.find_pattern's mesh path)
    mesh: tuple[int, int] | None = None


@dataclass
class GenOp(Operation):
    seconds: float
    sample_rate: int
    cos: Sequence[int] = field(default_factory=list)
    # Addition: seeded complex Gaussian noise (per-component
    # sigma); the reference generator is noiseless
    noise: float = 0.0
    seed: int = 0


def exec_operation(
    op: Operation,
    stream: Stream | None,
    emit: Callable[[str], None] = print,
    write_dir: str | None = None,
) -> Stream | None:
    """Execute one operation against the accumulator (``src/lib.rs:82-176``)."""
    from quadrs_tpu import sinks

    if isinstance(op, From):
        return SampleSource.from_file(op.filename, op.details)

    if isinstance(op, GenOp):
        return ToneGen(
            op.cos, op.sample_rate, op.seconds, noise=op.noise, seed=op.seed
        )

    if isinstance(op, ShiftOp):
        if stream is None:
            raise ValueError("shift requires an input")
        return Shift(stream, op.frequency, stream.sample_rate)

    if isinstance(op, LowPassOp):
        if stream is None:
            raise ValueError("lowpass requires an input")
        return LowPass(stream, op.frequency, op.decimate, op.size)

    if isinstance(op, ResampleOp):
        if stream is None:
            raise ValueError("resample requires an input")
        from quadrs_tpu.stream import Resample

        return Resample(stream, op.up, op.down, size=op.size, power=op.power)

    if isinstance(op, DcBlockOp):
        if stream is None:
            raise ValueError("dcblock requires an input")
        from quadrs_tpu.stream import DcBlock

        return DcBlock(stream, op.window)

    if isinstance(op, AgcOp):
        if stream is None:
            raise ValueError("agc requires an input")
        from quadrs_tpu.stream import Agc

        return Agc(stream, target=op.target, window=op.window, max_gain=op.max_gain)

    if isinstance(op, IqbalOp):
        if stream is None:
            raise ValueError("iqbal requires an input")
        from quadrs_tpu.stream import IqCorrect

        return IqCorrect(stream, c=op.c, est_samples=op.est)

    if isinstance(op, SparkFftOp):
        if stream is None:
            raise ValueError("sparkfft requires an input")
        sinks.spark_fft(stream, op.width, op.stride, op.min, op.max, out=emit)
        return stream

    if isinstance(op, BucketOp):
        if stream is None:
            raise ValueError("bucket -by freq requires an input")
        levels = sinks.freq_levels(stream, op.fft_width, op.stride, op.levels)
        emit("".join(str(v) for v in levels.vals))
        return stream

    if isinstance(op, FindOp):
        if stream is None:
            raise ValueError("find requires an input")
        pats = []
        for fname, details in zip(op.filenames, op.details):
            psrc = SampleSource.from_file(fname, details)
            if psrc.sample_rate != stream.sample_rate:
                raise ValueError(
                    f"pattern rate {psrc.sample_rate} != stream rate "
                    f"{stream.sample_rate}: resample one side first"
                )
            pat, valid = psrc.read_at(0, psrc.length)
            if valid != psrc.length:
                raise RuntimeError("short read loading the pattern capture")
            pats.append(pat)
        if op.mesh is not None:
            from quadrs_tpu.parallel.sharding import make_mesh

            mesh = make_mesh(n_time=op.mesh[0], n_stream=op.mesh[1])
        else:
            mesh = None
        res = sinks.find_pattern(
            stream,
            pats if len(pats) > 1 else pats[0],
            threshold=op.threshold,
            max_matches=op.top if op.top else None,
            min_distance=op.distance,
            freq_tol=op.freq_tol,
            freq_step=op.freq_step,
            mesh=mesh,
        )
        bank = len(pats) > 1
        for o, s, a, f, w in zip(
            res.offsets, res.scores, res.scales, res.freqs, res.which
        ):
            line = f"{int(o)},{float(s):.4f},{float(a):.6g},{float(f):+g}"
            emit(line + f",{int(w)}" if bank else line)  # bank adds which
        if op.write is not None:
            root = stream.root()
            if not hasattr(root, "raw_bytes"):
                raise ValueError(
                    "find -write needs a seekable capture file behind the "
                    "chain (a pipe keeps no history to slice)"
                )
            ext = root.format.value  # the enum values ARE the extensions
            for k, (o, w) in enumerate(zip(res.offsets, res.which)):
                # widen in searched-stream samples, then map the span
                # through the chain (FIR lookahead included) so the
                # slice re-demodulates cleanly
                a = max(0, int(o) - op.pre)
                n = int(o) + len(pats[int(w)]) + op.post - a
                s0, sn = stream.span(a, n)
                s0 = max(0, s0)
                s1 = min(s0 + sn, root.length)
                path = f"{op.write}.m{k}.s{s0}.sr{root.sample_rate}.{ext}"
                with open(path, "wb" if op.overwrite else "xb") as fh:
                    fh.write(root.raw_bytes(s0, s1))
                emit(f"find match {k}: samples {s0}..{s1}, wrote {path}")
        emit(
            f"find: {len(res.offsets)} matches, pattern {res.pattern_len} "
            f"samples, {res.scanned} scanned"
        )
        return stream

    if isinstance(op, WriteOp):
        if stream is None:
            raise ValueError("write requires an input")
        sinks.do_write(
            stream, op.overwrite, op.prefix, directory=write_dir, fmt=op.format
        )
        return stream

    raise ValueError(f"unknown operation: {op!r}")


def run_pipeline(
    ops: Sequence[Operation],
    emit: Callable[[str], None] = print,
    write_dir: str | None = None,
) -> Stream | None:
    """Fold operations left to right (``src/bin/quadrs.rs:48-57``)."""
    stream: Stream | None = None
    for op in ops:
        stream = exec_operation(op, stream, emit=emit, write_dir=write_dir)
    return stream
