"""Sinks and analyses: terminal spectrogram, frequency bucketer, writer,
and the GUI-grade windowed STFT.

Each sink pulls windows through a batched jitted program (decode + mix +
FIR + FFT fused by XLA) and performs only presentation on the host.
Pull sizes mirror the reference sinks exactly, because the reference's
per-read convolution truncation makes output depend on how sinks pull
(see :mod:`quadrs_tpu.stream`): sparkfft pulls ``width`` samples per
window (``src/fft.rs:27-30``), the writer pulls ``0x1000``-sample chunks
(``src/lib.rs:199-210``), bucket pulls ``width`` at ``reading*stride``
(``src/fft.rs:89-91``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np

from quadrs_tpu.formats import FileFormat, encode_cf32, encode_samples
from quadrs_tpu.ops.stft import blackman_harris_window, stft_norms
from quadrs_tpu.runtime import Executor, root_step_of, window_batches
from quadrs_tpu.stream import Stream

# The 9 display levels: blank below min, full block at/above max,
# seven partial blocks between (src/fft.rs:34-36).
SPARK_GLYPHS = np.array([" ", "▁", "▂", "▃", "▄", "▅", "▆", "▇", "█"])

DEFAULT_SPARK_MIN = 0.08  # src/fft.rs:22
DEFAULT_SPARK_MAX = 1.0  # src/fft.rs:23
WRITE_CHUNK = 0x1000  # src/lib.rs:201


def glyph_rows(norms: np.ndarray, lo: float, hi: float) -> list[str]:
    """Map magnitude rows to sparkline strings (``src/fft.rs:45-61``).

    ``< lo`` is blank, ``>= hi`` is the full block, otherwise the value
    truncates into one of seven partial blocks.
    """
    distinction = np.float32((np.float32(hi) - np.float32(lo)) / np.float32(7.0))
    mid = ((norms - np.float32(lo)) / distinction).astype(np.int64)
    idx = 1 + np.clip(mid, 0, 6)
    idx = np.where(norms < np.float32(lo), 0, idx)
    idx = np.where(norms >= np.float32(hi), 8, idx)
    return ["".join(row) for row in SPARK_GLYPHS[idx]]


def spark_fft(
    stream: Stream,
    width: int = 128,
    stride: int | None = None,
    lo: float | None = None,
    hi: float | None = None,
    out: Callable[[str], None] | None = None,
) -> list[str] | None:
    """Terminal Unicode spectrogram (reference ``src/fft.rs:12-69``).

    Strided rectangular-window STFT; each row is the fftshifted
    magnitudes quantized onto nine glyph levels, framed by ``│``.
    If ``out`` is None the rows are returned; otherwise each line
    (including the header) is passed to ``out`` as produced.
    """
    stride = width if stride is None else stride
    lo = DEFAULT_SPARK_MIN if lo is None else lo
    hi = DEFAULT_SPARK_MAX if hi is None else hi

    collected: list[str] | None = [] if out is None else None

    def emit(line: str) -> None:
        if collected is not None:
            collected.append(line)
        else:
            out(line)

    emit(f"sparkfft sample_rate={stream.sample_rate}")

    if stream.length <= width:
        # reference src/fft.rs:28 underflows here; we refuse cleanly
        if stream.length < width:
            raise ValueError("input shorter than fft width")
        return collected

    offsets = np.arange(0, stream.length - width, stride, dtype=np.int64)
    batch, batches = window_batches(offsets, width, root_step=root_step_of(stream))
    ex = Executor(stream, width, batch=batch, post=stft_norms)
    for offs in batches:
        norms, valid = ex.run(offs)
        if not np.all(valid == width):
            bad = offs[valid != width][0]
            raise RuntimeError(
                f"read-exact messed up: {width} (wanted) != "
                f"{int(valid[valid != width][0])} (read) at {int(bad)}"
            )
        for line in glyph_rows(norms, lo, hi):
            emit(f"│{line}│")
    return collected


@dataclass
class Levels:
    vals: list[int]


def freq_levels(
    stream: Stream,
    fft_width: int = 128,
    stride: int | None = None,
    levels: int = 2,
    mesh=None,
) -> Levels:
    """Two-level frequency discriminator (reference ``src/fft.rs:77-101``):
    per strided window, compare total magnitude in the lower vs upper
    half of the (unshifted) spectrum and emit 1 if lower >= upper.

    ``mesh``: a Tx1 :func:`quadrs_tpu.parallel.sharding.make_mesh` —
    the discriminator windows time-shard across the chips through the
    streaming front end (see
    :func:`quadrs_tpu.models.demod._channel_step`); requires a
    channel-shaped chain over a staged capture."""
    if levels != 2:
        raise ValueError("only supporting two levels for now")
    stride = fft_width if stride is None else stride

    total = (stream.length - fft_width) // stride
    offsets = np.arange(total, dtype=np.int64) * stride
    if total <= 0:
        return Levels(vals=[])

    def post(x):
        norms = stft_norms(x, shift=False)
        half = fft_width // 2
        return norms[:, :half].sum(axis=1), norms[:, half:].sum(axis=1)

    # streaming fast path for channel-shaped chains over a staged source
    # (one fused dispatch per ~raw-budget instead of per-window reads —
    # the FSK receiver's hot loop); lazy import, the models layer
    # imports sinks at module scope
    from quadrs_tpu.models.demod import _strided_windows_dev

    fast = _strided_windows_dev(
        stream, fft_width, stride, total, post, mesh=mesh
    )
    if fast is not None:
        first, second = fast
        return Levels(vals=[int(v) for v in np.where(first < second, 0, 1)])
    if mesh is not None:
        raise ValueError(
            "-mesh shards the streaming demod front end, which needs "
            "the receiver's own chain over a raw capture file; drop "
            "the chained stages / live pipe or drop -mesh"
        )

    batch, batches = window_batches(offsets, fft_width, root_step=root_step_of(stream))
    ex = Executor(stream, fft_width, batch=batch, post=post)
    vals: list[int] = []
    for offs in batches:
        (first, second), valid = ex.run(offs)
        if not np.all(valid == fft_width):
            raise RuntimeError("read-exact messed up in bucket")
        vals.extend(int(v) for v in np.where(first < second, 0, 1))
    return Levels(vals=vals)


def do_write(
    stream: Stream,
    overwrite: bool,
    prefix: str,
    directory: str | None = None,
    fmt: str | None = None,
) -> str:
    """Write the stream as ``{prefix}.sr{rate}.cf32`` (``src/lib.rs:178-213``).

    ``fmt`` (an addition; the reference emits cf32 only) writes
    an integer wire format instead — ``{prefix}.sr{rate}.{fmt}`` with
    :func:`~quadrs_tpu.formats.encode_samples`'s exact inverse-decode
    quantization — so ``from big.cs8 ... write -format cs8 small``
    shrinks a processed capture back to 2 bytes/sample.

    The 0x1000-sample pull size is semantics (each pull sees the
    per-read truncated convolution at its own boundaries), but the pulls
    are independent windows, so many of them run per device dispatch:
    the sequential reference loop's offsets are ``0, 0x1000, 0x2000, …``
    because every non-final read comes back full, and each batched
    window computes exactly what the corresponding sequential pull
    would.  A short read mid-stream (impossible for the shipped stages,
    which only come up short at EOF) falls back to the sequential loop
    so the ``off += read`` advance stays faithful.

    Raises on a zero-length read like the reference's short-read assert.
    With ``overwrite`` the reference opens with create-but-no-truncate,
    so a pre-existing longer file keeps its tail — reproduced here.
    """
    if prefix == "-":
        raise NotImplementedError("stdout writing is unimplemented in the reference")

    wire = FileFormat.COMPLEX_FLOAT32 if fmt is None else FileFormat(fmt)
    encode = lambda x: encode_samples(x, wire)  # noqa: E731
    filename = f"{prefix}.sr{stream.sample_rate}.{wire.value}"
    if directory is not None:
        filename = os.path.join(directory, filename)

    if overwrite:
        # OpenOptions::create + write: positions at 0, does not truncate.
        fh = open(filename, "r+b" if os.path.exists(filename) else "wb")
    else:
        fh = open(filename, "xb")  # create_new

    offsets = np.arange(0, stream.length, WRITE_CHUNK, dtype=np.int64)
    with fh:
        if len(offsets) == 0:
            return filename
        batch, batches = window_batches(
            offsets, WRITE_CHUNK, root_step=root_step_of(stream)
        )
        ex = Executor(stream, WRITE_CHUNK, batch=batch)
        for offs in batches:
            samples, valid = ex.run(offs)
            for i in range(len(offs)):
                read = int(valid[i])
                if read == 0:
                    raise RuntimeError(
                        f"short read at offset {int(offs[i])} of {stream.length}"
                    )
                fh.write(encode(samples[i][:read]))
                if read < WRITE_CHUNK:
                    # short read: resume the exact sequential advance
                    # (off += read) from here — including the reference's
                    # zero-read error when the stream's claimed tail is
                    # unreadable (a decimated stage's final sample often
                    # is: its raw span extends past the source)
                    next_off = int(offs[i]) + read
                    if next_off < stream.length:
                        _write_sequential(fh, stream, next_off, encode)
                    return filename
    return filename


def _write_sequential(fh, stream: Stream, off: int, encode=encode_cf32) -> None:
    """The reference's literal pull loop (``src/lib.rs:199-210``), used
    when a mid-stream short read desyncs the batched offsets."""
    ex = Executor(stream, WRITE_CHUNK, batch=1)
    while off < stream.length:
        samples, valid = ex.run(np.asarray([off], dtype=np.int64))
        read = int(valid[0])
        if read == 0:
            raise RuntimeError(f"short read at offset {off} of {stream.length}")
        fh.write(encode(samples[0][:read]))
        off += read


@dataclass
class FftResult:
    """Flat magnitude rows, the GUI waterfall's data (``src/ffts.rs:86-108``)."""

    norms: np.ndarray  # (output_len, fft_width) f32, fftshifted
    fft_width: int

    def get(self, index: int) -> np.ndarray:
        if not 0 <= index < self.output_len:
            raise IndexError(f"index out of bounds: {index}")
        return self.norms[index]

    @property
    def output_len(self) -> int:
        return self.norms.shape[0]

    def max(self) -> float:
        return float(np.max(self.norms, initial=0.0))

    def min(self) -> float:
        return float(np.min(self.norms, initial=np.inf))


def take_fft(
    stream: Stream,
    slice_: tuple[int, int] | None,
    width: int,
    output_len: int,
    windowing: str = "blackman-harris",
) -> FftResult:
    """Evenly-spaced windowed STFT (reference ``src/ffts.rs:18-85``).

    Picks ``output_len`` window positions across the visible span
    (``step = visible/output_len``, rounded half-away-from-zero like
    Rust's ``f64::round``), optionally Blackman-Harris windowed.
    """
    if slice_ is not None:
        start, end = slice_
    else:
        start, end = 0, stream.length - width

    if not end > start:
        raise ValueError(f"Invalid slice: end ({end}) must be greater than start ({start})")
    if not end < stream.length:
        raise ValueError(f"Slice end ({end}) exceeds sample length ({stream.length})")
    visible = end - start
    if not visible > output_len:
        raise ValueError(
            f"Visible samples ({visible}) must be greater than output length ({output_len})"
        )

    step = visible / output_len
    # f64::round: half away from zero (np.round would go half-even)
    offsets = start + np.floor(step * np.arange(output_len, dtype=np.float64) + 0.5).astype(
        np.int64
    )

    window = None
    if windowing in ("blackman-harris", "blackmanharris"):
        window = blackman_harris_window(width)
    elif windowing != "rectangular":
        raise ValueError(f"unknown windowing: {windowing}")

    batch, batches = window_batches(offsets, width, root_step=root_step_of(stream))
    ex = Executor(stream, width, batch=batch, post=lambda x: stft_norms(x, window=window))
    rows: list[np.ndarray] = []
    for offs in batches:
        norms, valid = ex.run(offs)
        if not np.all(valid == width):
            raise RuntimeError("read-exact messed up in take_fft")
        rows.append(norms)
    return FftResult(norms=np.concatenate(rows, axis=0), fft_width=width)


# A near-constant score track (e.g. a CW-like template over its own
# carrier) makes every lag a rounding-noise "local max"; find_pattern
# bounds its candidate list so a pathological search fails fast with
# guidance instead of accumulating gigabytes and an O(K^2) suppression.
FIND_CANDIDATE_CAP = 1 << 20

# Per-dispatch lag budget for find_pattern (fat dispatches: a thin
# dispatch is latency-bound, so dispatch volume is the first-order
# lever) and the device candidate scan's
# top-k width (a dispatch with more candidates than this falls back to
# the full-score path).  Module-level so tests can shrink them.
FIND_DISPATCH_BUDGET = 1 << 22
FIND_TOPK = 1024


@dataclass
class FindResult:
    """Matches from :func:`find_pattern`, sorted by offset."""

    offsets: np.ndarray  # int64 sample offsets into the searched stream
    scores: np.ndarray  # f32 normalized correlation in [0, 1]
    scales: np.ndarray  # f32 |match amplitude| relative to its template
    freqs: np.ndarray  # f64 carrier offset of each match (Hz; 0 w/o grid)
    which: np.ndarray  # int64 index of the matching template (0 w/o bank)
    pattern_len: int  # the longest template
    scanned: int  # stream samples scanned


def find_pattern(
    stream: Stream,
    pattern,
    threshold: float = 0.5,
    chunk: int | None = None,
    max_matches: int | None = None,
    min_distance: int | None = None,
    freq_tol: float = 0.0,
    freq_step: float | None = None,
    fft_impl: str = "auto",
    mesh=None,
) -> FindResult:
    """Find every occurrence of a complex ``pattern`` in ``stream`` by
    gain/phase-invariant normalized cross-correlation (an addition
    addition, see :mod:`quadrs_tpu.ops.correlate`).  ``pattern`` may be
    a sequence of templates (a sync-word BANK, lengths may differ): the
    bank rides one batched device axis, every lag keeps its best
    NORMALIZED row, and each match reports the winning template in
    ``which`` — one pass classifies which preamble fired.

    Windows of ``c = pow2(max(2*l_max, min(chunk, length)))`` samples
    step by ``c - l_max + 1`` (overlap-save: every lag is scored
    exactly once), each batch runs one fused FFT-correlation program on
    device, and a streaming local-maximum scanner keeps candidates
    ``>= threshold``; greedy non-maximum suppression within
    ``min_distance`` (default: the longest template) picks the matches.
    ``chunk=None`` (the default) picks ``max(4*l_max, 4096)``: the matmul
    DFT's effective MACs/sample GROW with the block (48 at c=4096 vs
    128 at 65536 for the three-factor splits) while the lag yield
    ``(c-l+1)/c`` saturates, so the smallest block with ~75% lag yield
    does the least work per lag.  Matches are chunk-invariant either
    way (pinned by test).

    ``freq_tol`` (Hz) searches a symmetric carrier-offset grid: an
    uncorrected offset ``f`` costs ``|sinc(f*l/rate)|`` of the score
    (a 1 kHz offset over a 1 ms pattern wipes the match entirely), so
    real preamble detection must scan frequency too.  The grid rides a
    batched device axis (one matched filter per grid row, best row
    wins); spacing defaults to ``0.4 * rate / l`` (worst-case residual
    loss ~7%) and each match reports its grid frequency in ``freqs``
    (resolution = the step; no interpolation).

    ``mesh``: an optional Tx1 :func:`quadrs_tpu.parallel.sharding.make_mesh`
    — the capture's sample axis time-shards across the chips, each
    exchanging the ``l-1``-sample halo with its right neighbor over the interconnect
    (:func:`~quadrs_tpu.parallel.sharding.make_sharded_find_step`).
    Sharded scores match the single-device program to f32 accumulation
    order (same window partitioning; offsets/which exact); the
    unaligned tail of the capture runs through the single-device path
    and the candidate scan stitches the two exactly.  Requires a raw capture stream (the chained-stage case
    is the flagship chain's sharding domain).
    """
    from quadrs_tpu.ops.correlate import PeakScan, make_xcorr_post, suppress
    from quadrs_tpu.runtime import _round_up_pow2

    pats = (
        [np.asarray(q) for q in pattern]
        if isinstance(pattern, (list, tuple))
        else [np.asarray(pattern)]
    )
    lens = [len(q) for q in pats]
    l = max(lens)  # the common lag range uses the longest template
    if min(lens) < 2:
        raise ValueError("pattern must have at least 2 samples")
    if stream.length < l:  # live pipes read as a huge sentinel here
        raise ValueError(
            f"stream ({stream.length} samples) shorter than the pattern ({l})"
        )
    if not 0.0 < threshold <= 1.0:
        raise ValueError("threshold must be in (0, 1]")
    if freq_tol < 0.0:
        raise ValueError("freq_tol must be >= 0")
    rate = stream.sample_rate
    if freq_tol > 0.0:
        step = 0.4 * rate / l if freq_step is None else float(freq_step)
        if step <= 0.0:
            raise ValueError("freq_step must be positive")
        n_side = int(np.ceil(freq_tol / step))
        if 2 * n_side + 1 > 256:
            raise ValueError(
                f"frequency grid of {2 * n_side + 1} rows (tol {freq_tol:g} "
                f"Hz / step {step:g} Hz) exceeds 256: raise freq_step or "
                "shift the stream closer first"
            )
        grid_hz = np.arange(-n_side, n_side + 1, dtype=np.float64) * step
        grid = grid_hz / rate  # cycles/sample for the ops layer
    else:
        grid_hz = np.zeros(1)
        grid = None
    if chunk is None:
        chunk = max(4 * l, 4096)  # cost-per-lag optimum (see docstring)
    live = bool(getattr(stream, "is_live", False)) and stream.length >= (1 << 59)
    c = _round_up_pow2(
        max(2 * l, chunk if live else min(chunk, stream.length))
    )
    n_out = c - l + 1

    # one f32 threshold for both comparison sites: the device candidate
    # scan compares in f32, the host pending logic in f64 — rounding
    # the threshold once keeps them bit-identical
    threshold = float(np.float32(threshold))
    # Fat dispatches (see FIND_DISPATCH_BUDGET).  The grid/bank rows
    # scan row-sequentially on device, so per-dispatch memory is
    # ~44*B*c bytes regardless of R (~190 MB at B=64, c=65536) plus
    # the R*c template spectra.
    budget = max(c, FIND_DISPATCH_BUDGET)
    scan = PeakScan(threshold)
    cand_cap = FIND_CANDIDATE_CAP

    def feed_batch(outs, offs, n_lags) -> None:
        (score, scale, ridx), valid = outs
        score = np.asarray(score)
        aux = np.stack([np.asarray(scale), np.asarray(ridx)], axis=-1)
        last = 0
        for i in range(len(offs)):
            o, v = int(offs[i]), int(valid[i])
            m = min(max(0, v - l + 1), n_lags - o)
            scan.feed(o, score[i][:m], aux[i][:m])
            last = o + m
        if len(scan.offsets) > cand_cap:
            raise ValueError(
                f"more than {cand_cap} candidate peaks above threshold "
                f"{threshold:g} in the first {last} samples: the pattern "
                "matches nearly everywhere — raise the threshold or use a "
                "more distinctive template"
            )

    if live:
        # a pipe's length is a sentinel until EOF: walk forward one
        # window batch at a time (the sliding facade reads the pipe on
        # demand and discards behind), and when EOF surfaces mid-batch,
        # RE-RUN that batch — the first run planned its valid counts
        # against the sentinel.  The kept lags only touch samples below
        # each window's valid count, so pipe and file runs score the
        # same lag grid (offsets/freqs/which exact; scores within f32
        # accumulation order — the file path sizes its batch to the
        # capture while the pipe walks small fixed batches, and batch
        # shape shifts XLA's matmul tiling).
        b = max(1, int(min(8, budget // c)))
        ex = Executor(stream, c, batch=b, post=make_xcorr_post(pats, c, grid))
        o = 0
        while True:
            offs = o + n_out * np.arange(b, dtype=np.int64)
            outs = ex.run(offs)  # advances the pipe; may discover EOF
            if stream.length < (1 << 59):  # EOF position now known
                n_lags = stream.length - l + 1
                if n_lags < 1:
                    raise ValueError(
                        f"stream ({stream.length} samples) shorter than "
                        f"the pattern ({l})"
                    )
                offs = offs[offs < n_lags]
                if len(offs):
                    # the first run planned valid counts against the
                    # sentinel; re-run so the EOF batch's valid is real
                    feed_batch(ex.run(offs), offs, n_lags)
                break
            feed_batch(outs, offs, 1 << 60)
            o += b * n_out
    else:
        n_lags = stream.length - l + 1
        lag0 = 0
        if mesh is not None:
            # time-shard the aligned prefix across the mesh; the
            # remainder continues through the single-device path below
            # (the candidate scan's pending element bridges exactly)
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            from quadrs_tpu.parallel.sharding import make_sharded_find_step

            if stream.root() is not stream or not getattr(
                stream, "has_staging", False
            ):
                raise ValueError(
                    "find -mesh shards a raw capture's sample axis; "
                    "shift/lowpass the result instead, or drop -mesh "
                    "(chained stages shard via the stream runner)"
                )
            n_time = int(mesh.shape["time"])
            # per-shard windows: the fat-dispatch budget, clamped to
            # what the capture can actually supply (so short captures
            # still exercise the mesh rather than skipping to the
            # single-device tail)
            avail = (stream.length - (l - 1)) // (n_time * n_out)
            b_shard = max(1, min(FIND_DISPATCH_BUDGET // (n_time * c), avail))
            step_lags = n_time * b_shard * n_out
            step_fn = make_sharded_find_step(
                pats, c, stream.format, mesh, grid, fft_impl=fft_impl
            )
            plane_sh = NamedSharding(mesh, P(None, "time"))
            tail_sh = NamedSharding(mesh, P(None, None))
            o = 0
            while o + step_lags + l - 1 <= stream.length:
                planes = stream.stage(o, o + step_lags)
                tail = stream.stage(o + step_lags, o + step_lags + l - 1)
                score, scale, ridx = step_fn(
                    jax.device_put(np.ascontiguousarray(planes), plane_sh),
                    jax.device_put(np.ascontiguousarray(tail), tail_sh),
                )
                aux = np.stack(
                    [np.asarray(scale), np.asarray(ridx)], axis=-1
                )
                scan.feed(o, np.asarray(score), aux)
                if len(scan.offsets) > cand_cap:
                    raise ValueError(
                        f"more than {cand_cap} candidate peaks above "
                        f"threshold {threshold:g} in the first "
                        f"{o + step_lags} samples: the pattern matches "
                        "nearly everywhere — raise the threshold or use "
                        "a more distinctive template"
                    )
                o += step_lags
            lag0 = o
        offsets = np.arange(lag0, n_lags, n_out, dtype=np.int64)
        batch, batches = window_batches(
            offsets, c, budget=budget, root_step=root_step_of(stream)
        )
        # Every full batch runs the device-side candidate scan: the
        # program returns top-k candidates + boundary scalars instead
        # of 12 bytes/lag of score planes (the full-score transfer
        # would otherwise bound the product).  The ragged
        # tail batch — and any dispatch whose candidate count overflows
        # k — falls back to the full-score path; PeakScan's pending
        # element bridges the two exactly (see feed_extract).
        k_top = FIND_TOPK
        ex_x = Executor(
            stream, c, batch=batch,
            post=make_xcorr_post(
                pats, c, grid, fft_impl=fft_impl, extract=(threshold, k_top)
            ),
            post_takes_aux=True, post_whole_batch=True,
        )
        ex_full = None
        for offs in batches:
            if len(offs) == batch and int(offs[-1]) + c <= stream.length:
                res, _ = ex_x.run(offs, aux=scan.carry)
                if scan.feed_extract(int(offs[0]), len(offs) * n_out, res):
                    if len(scan.offsets) > cand_cap:
                        raise ValueError(
                            f"more than {cand_cap} candidate peaks above "
                            f"threshold {threshold:g} in the first "
                            f"{int(offs[-1]) + n_out} samples: the pattern "
                            "matches nearly everywhere — raise the "
                            "threshold or use a more distinctive template"
                        )
                    continue
            if ex_full is None:
                ex_full = Executor(
                    stream, c, batch=batch,
                    post=make_xcorr_post(pats, c, grid, fft_impl=fft_impl),
                )
            feed_batch(ex_full.run(offs), offs, n_lags)
    scan.finish()

    cand_off = np.asarray(scan.offsets, dtype=np.int64)
    cand_score = np.asarray(scan.scores, dtype=np.float32)
    cand_aux = (
        np.asarray(scan.aux, dtype=np.float64)
        if scan.aux
        else np.zeros((0, 2))
    )
    keep = suppress(
        cand_off, cand_score, min_distance if min_distance is not None else l,
        max_matches,
    )
    ridx = cand_aux[keep, 1].astype(np.int64)  # pattern_index * F + f_index
    return FindResult(
        offsets=cand_off[keep],
        scores=cand_score[keep],
        scales=cand_aux[keep, 0].astype(np.float32),
        freqs=grid_hz[ridx % len(grid_hz)],
        which=ridx // len(grid_hz),
        pattern_len=l,
        scanned=stream.length,
    )


@dataclass
class CaptureInfo:
    """Per-capture statistics from :func:`capture_info` (the ``info``
    command): decoded-domain signal stats about the format's neutral
    value, plus raw-code clipping counts."""

    format: FileFormat
    sample_rate: int
    samples: int
    bytes: int
    seconds: float
    analyzed: int  # samples the stats below actually cover
    dc: complex  # mean deviation from the format's neutral value
    rms: float  # sqrt(E |x - neutral|^2)
    peak: float  # max |x - neutral|
    rho: complex  # circularity ratio E[z^2]/E[|z|^2] of z = x - mean(x)
    clipped: float | None  # fraction of raw components at a rail (int fmts)


_RAILS = {
    FileFormat.COMPLEX_INT8: (-128, 127),
    FileFormat.COMPLEX_UINT8: (0, 255),
    FileFormat.COMPLEX_INT16: (-32768, 32767),
}

# decode of each format's IDLE code (the center of its decoded range):
# the reference's cu8/cs16 formulas park the signal near -127 / -32767.5
# (src/lib.rs:250-253), so meaningful DC/RMS statistics subtract this
# neutral value first.  cs8/cs16 idle at code 0, cu8 at 127.5 (an idle
# rtl dongle dithers 127/128).
_NEUTRAL = {
    FileFormat.COMPLEX_FLOAT32: 0.0,
    FileFormat.COMPLEX_INT8: 0.0,  # decode(0)
    FileFormat.COMPLEX_UINT8: 127.5 / 255.0 - 127.5,  # decode(127.5) = -127.0
    FileFormat.COMPLEX_INT16: -32767.5,  # decode(0)
}


def _info_reducer(fmt: FileFormat):
    """The jitted per-chunk reduction for :func:`capture_info`, cached
    per format so a multi-file ``info`` run compiles once per (format,
    chunk-shape) instead of once per file."""
    import jax
    import jax.numpy as jnp

    from quadrs_tpu.formats import decode_plane

    neutral = jnp.float32(_NEUTRAL[fmt])
    rails = _RAILS.get(fmt)

    @jax.jit
    def reduce_chunk(planes):
        re = decode_plane(planes[0], fmt, xp=jnp) - neutral
        im = decode_plane(planes[1], fmt, xp=jnp) - neutral
        p = re * re + im * im
        # second moments are computed about the CHUNK's own mean (the
        # host recombines exactly via the parallel-variance identity):
        # E[x^2]-mu^2 cancels to f32 rounding noise on DC-dominated
        # captures, which made rho garbage on near-constant input
        cre = re - jnp.mean(re)
        cim = im - jnp.mean(im)
        out = (
            jnp.sum(re),
            jnp.sum(im),
            jnp.sum(p),
            jnp.max(p, initial=0.0),
            jnp.sum(cre * cre + cim * cim),  # centered power
            jnp.sum(cre * cre - cim * cim),  # Re sum (z-mu_k)^2
            jnp.sum(2.0 * cre * cim),  # Im sum (z-mu_k)^2
        )
        if rails is not None:
            clip = jnp.sum((planes[0] == rails[0]) | (planes[0] == rails[1]))
            clip += jnp.sum((planes[1] == rails[0]) | (planes[1] == rails[1]))
            # int32 keeps the count exact past 2^24 components/chunk
            # (f32 would round a heavily-clipped user-raised -chunk)
            out = out + (clip.astype(jnp.int32),)
        return out

    return reduce_chunk


_INFO_REDUCERS: dict = {}


def capture_info(source, chunk: int = 1 << 22, limit: int | None = None) -> CaptureInfo:
    """Analyze a capture (``quadjax info``): DC offset, RMS, peak,
    circularity ratio (the IQ-imbalance indicator ``iqbal`` corrects),
    and raw-code clipping fraction, reduced on device chunk by chunk
    (f32 per-chunk tree reductions, f64 host accumulation) so a
    multi-GB file costs one pass of native-dtype staging."""
    if chunk < 1:
        raise ValueError("chunk must be at least 1")
    fmt = source.format
    rails = _RAILS.get(fmt)
    if fmt not in _INFO_REDUCERS:  # setdefault would rebuild on hits
        _INFO_REDUCERS[fmt] = _info_reducer(fmt)
    reduce_chunk = _INFO_REDUCERS[fmt]

    total = source.length if limit is None else min(limit, source.length)
    acc = np.zeros(3, dtype=np.float64)  # sum re, sum im, sum p
    chunks: list[tuple[int, complex, float, complex]] = []  # per-chunk moments
    max_p = 0.0
    clips = 0.0
    off = 0
    while off < total:
        n_k = min(chunk, total - off)
        planes = source.stage(off, off + n_k)
        parts = [float(v) for v in reduce_chunk(planes)]
        acc += parts[:3]
        max_p = max(max_p, parts[3])
        mu_k = complex(parts[0] / n_k, parts[1] / n_k)
        chunks.append((n_k, mu_k, parts[4], complex(parts[5], parts[6])))
        if rails is not None:
            clips += parts[7]
        off += n_k
    n = max(1, total)
    mu = complex(acc[0] / n, acc[1] / n)
    # combine the chunk-centered second moments about the GLOBAL mean
    # (exact identity: sum|x-mu|^2 = sum|x-mu_k|^2 + n_k|mu_k-mu|^2,
    # and likewise for the unconjugated square) — circularity is about
    # the mean because a DC offset is not an IQ image
    s_pc = sum(cp + n_k * abs(mu_k - mu) ** 2 for n_k, mu_k, cp, _ in chunks)
    s_z2 = sum(cz + n_k * (mu_k - mu) ** 2 for n_k, mu_k, _, cz in chunks)
    rms = float(np.sqrt(acc[2] / n))
    # a (near-)constant capture has no AC power to be circular about —
    # centered sums are pure f32 rounding noise there, so report no
    # image below ~100 ulp of the signal scale; |rho| <= 1
    # mathematically, so clamp residual rounding too
    if np.sqrt(s_pc / n) < 1e-5 * (abs(mu) + rms + 1e-30):
        rho = 0j
    else:
        rho = s_z2 / s_pc
        if abs(rho) > 1.0:
            rho /= abs(rho)
    return CaptureInfo(
        format=fmt,
        sample_rate=source.sample_rate,
        samples=source.length,
        bytes=source.length * fmt.pair_bytes,
        seconds=source.length / source.sample_rate,
        analyzed=total,
        dc=mu,
        rms=rms,
        peak=float(np.sqrt(max_p)),
        rho=rho,
        clipped=None if rails is None else clips / (2.0 * n),
    )
