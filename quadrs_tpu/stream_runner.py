"""Sustained streaming: capture file -> fused pipeline -> spectrogram.

The production serving path.  Where the sinks in :mod:`quadrs_tpu.sinks`
reproduce the reference's pull semantics exactly (per-window truncated
convolution), this runner processes a capture as one continuous stream:
the native loader prefetches chunks in a background thread, a carry
buffer stitches chunk boundaries (so the FIR sees the true continuation,
no per-read truncation), and each chunk runs through
``PipelineModel.step_stream`` — one fused XLA program per chunk.

Every chunk's NCO phase is planned exactly on the host from its absolute
offset, so chunking is invisible in the output.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from quadrs_tpu.models.receiver import PipelineModel
from quadrs_tpu.sources import SampleSource
from quadrs_tpu.utils.profiling import PROFILER, sync_fetch


@dataclass
class RunStats:
    samples_in: int = 0
    windows_out: int = 0
    seconds: float = 0.0

    @property
    def msps(self) -> float:
        return self.samples_in / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class ScanResult:
    """Per-bin power statistics over every window of a scan run — the
    rtl_power-style band survey.  Bins are fftshifted (bin ``width//2``
    is DC; see :func:`quadrs_tpu.ops.stft.stft_norms`).

    Per-chunk sums/maxima/counts reduce on device (f32) and accumulate
    across chunks on the host in f64/int64, so error is bounded by the
    windows-per-chunk count, not the capture length."""

    sum_norms: np.ndarray  # (S, width) f64 — Σ norm over valid windows
    max_norms: np.ndarray  # (S, width) f32 — max norm over valid windows
    above: np.ndarray  # (S, width) int64 — windows with norm > threshold
    windows: int  # valid windows per stream
    threshold: float
    stats: RunStats

    @property
    def avg(self) -> np.ndarray:
        """(S, width) f64 mean norm per bin (zeros when no windows)."""
        return self.sum_norms / max(self.windows, 1)

    @property
    def occupancy(self) -> np.ndarray:
        """(S, width) f64 fraction of windows with norm > threshold."""
        return self.above / max(self.windows, 1)


def burst_spans(
    active, pre: int = 0, post: int = 0
) -> list[tuple[int, int]]:
    """Contiguous True runs of a per-window activity mask, each widened
    by ``pre``/``post`` context windows and merged where the widened
    spans touch — the burst segmentation behind ``stream -trigger``.
    Returns ``[(first_window, last_window)]`` inclusive."""
    spans: list[tuple[int, int]] = []
    n = len(active)
    i = 0
    while i < n:
        if not active[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and active[j + 1]:
            j += 1
        lo, hi = max(0, i - pre), min(n - 1, j + post)
        if spans and lo <= spans[-1][1] + 1:
            spans[-1] = (spans[-1][0], hi)
        else:
            spans.append((lo, hi))
        i = j + 1
    return spans


class BurstGate:
    """Incremental mirror of :func:`burst_spans` for live input: feed
    per-window activity in stream order; a widened span comes back as
    soon as no FUTURE window can merge into it (an active window at
    ``w`` reaches back to ``w - pre``, so a pending span ``(lo, hi)``
    is final once the cursor passes ``hi + pre + 1``).  ``finish(n)``
    closes the tail with :func:`burst_spans`'s end-clipping.  Feeding
    any mask in pieces yields exactly ``burst_spans`` of the whole
    (fuzz-pinned)."""

    def __init__(self, pre: int = 0, post: int = 0):
        self.pre, self.post = int(pre), int(post)
        self._w = 0  # next window index to consume
        self._run_start: int | None = None  # open raw run's first index
        self._pending: tuple[int, int] | None = None  # widened, mergeable
        self._closed: list[tuple[int, int]] = []

    def _close_run(self, i: int, j: int) -> None:
        lo, hi = max(0, i - self.pre), j + self.post
        if self._pending is not None and lo <= self._pending[1] + 1:
            self._pending = (self._pending[0], hi)
        else:
            if self._pending is not None:
                self._closed.append(self._pending)
            self._pending = (lo, hi)

    def feed(self, active) -> list[tuple[int, int]]:
        """Consume the next window-activity values; returns the spans
        that became final (widened, inclusive, in order)."""
        active = np.asarray(active, dtype=bool)
        if len(active) == 0:
            return []
        w0 = self._w
        if self._run_start is not None and not active[0]:
            # the run ended exactly at the previous feed's last window
            self._close_run(self._run_start, w0 - 1)
            self._run_start = None
        elif active[0] and self._run_start is None:
            self._run_start = w0
        for e in np.flatnonzero(np.diff(active.astype(np.int8))):
            if active[e]:  # True -> False: a run ends at w0 + e
                self._close_run(self._run_start, w0 + int(e))
                self._run_start = None
            else:  # False -> True: a run starts at w0 + e + 1
                self._run_start = w0 + int(e) + 1
        self._w = w0 + len(active)
        # spans in _closed were superseded by a later non-merging run:
        # final.  The pending span is final once the cursor passes
        # hi + pre + 1 with no open run left to merge into it.
        out = list(self._closed)
        self._closed.clear()
        if (
            self._run_start is None
            and self._pending is not None
            and self._w > self._pending[1] + self.pre + 1
        ):
            out.append(self._pending)
            self._pending = None
        return out

    def finish(self, n: int | None = None) -> list[tuple[int, int]]:
        """Close the stream after ``n`` total windows (defaults to the
        fed count): flush the open run and clip the final span's end
        like :func:`burst_spans`."""
        n = self._w if n is None else int(n)
        if self._run_start is not None:
            self._close_run(self._run_start, self._w - 1)
            self._run_start = None
        out = list(self._closed)
        self._closed.clear()
        if self._pending is not None:
            out.append(self._pending)
            self._pending = None
        return [(lo, min(hi, n - 1)) for lo, hi in out]

    def earliest_needed(self) -> int:
        """The smallest window index a future or unresolved span might
        still reference — everything below can be pruned."""
        cands = [self._w - self.pre]
        if self._pending is not None:
            cands.append(self._pending[0])
        if self._closed:
            cands.append(self._closed[0][0])
        if self._run_start is not None:
            cands.append(max(0, self._run_start - self.pre))
        return max(0, min(cands))


def _background(gen, depth: int = 2):
    """Run a generator on a daemon thread, yielding its items through a
    bounded queue: staging (pread + numpy copies + device_put) overlaps
    the consumer's device compute.  If the consumer abandons the
    generator, the producer notices (stop event) instead of pinning
    buffers; producer exceptions surface in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _DONE = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def fill():
        try:
            for item in gen:
                if not put(item):
                    return
            put(_DONE)
        except BaseException as e:  # surface staging errors to the consumer
            put(e)

    t = threading.Thread(target=fill, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():
            q.get_nowait()


def _check_pipe_sources(sources, mesh, allow_mesh: bool = False) -> None:
    """Pipe sources are sequential-only: one per runner, and meshed only
    where the runner's sharded staging reads strictly forward
    (StreamRunner wraps the pipe in a LivePipeStream for that)."""
    if any(getattr(s, "is_pipe", False) for s in sources):
        if len(sources) != 1:
            raise ValueError("a pipe source cannot be part of a bank")
        if mesh is not None and not allow_mesh:
            raise ValueError("pipe sources cannot be sharded (no random access)")


class WaterfallRunner:
    """Stream capture files through the waterfall bank (BASELINE config
    5 from disk): each chunk is a whole number of window *starts*, so
    chunking is invisible in the output — a ``width - stride`` lookahead
    covers windows that read past the chunk's last start.  ``sources``:
    one or more :class:`SampleSource` of equal length/format (the bank's
    streams).  ``on_norms(first_window_index, norms)`` receives
    (S, windows, width) f32 rows per chunk.

    Staging runs on a background thread (double-buffered against device
    compute), and :meth:`run_search` streams the on-device peak search —
    per (stream, window) the fftshifted argmax bin and magnitude — so
    BASELINE config 5's "spectrogram search" is served from disk, not
    just a device-resident bench.

    With ``mesh`` (a ``(stream, time)`` mesh), chunks shard across the
    devices: sources over the 'stream' axis, each chunk's sample axis
    over 'time' — overlapped strides exchange their ``width - stride``
    window halo over the interconnect with the true file continuation
    fed to the last shard, so chunking and sharding are both invisible
    in the output.  Search on a mesh runs the per-window reduction inside each
    shard.
    """

    def __init__(self, sources, model, chunk_windows: int = 1 << 11, mesh=None):
        sources = list(sources) if isinstance(sources, (list, tuple)) else [sources]
        cfg = model.cfg
        if len(sources) != cfg.n_streams:
            raise ValueError(
                f"{len(sources)} sources for a {cfg.n_streams}-stream bank"
            )
        for s in sources:
            if s.format is not cfg.fmt:
                raise ValueError(f"source format {s.format} != bank format {cfg.fmt}")
        _check_pipe_sources(sources, mesh, allow_mesh=True)
        if mesh is not None and getattr(sources[0], "is_pipe", False):
            # a live pipe shards like a file bank of one: the sharded
            # staging reads strictly forward (whole stride cells, then
            # the halo tail), which the sliding LivePipeStream facade
            # serves; EOF turns its sentinel length real mid-staging
            from quadrs_tpu.sources import LivePipeStream

            sources = [LivePipeStream(sources[0])]
        if len({s.length for s in sources}) != 1:
            raise ValueError("bank sources must have equal lengths")
        self.sources = sources
        self.model = model
        self.chunk_windows = max(1, chunk_windows)
        self.mesh = mesh
        self._wstep = None
        self._wstep_search = None
        if mesh is None:
            self._lookahead = max(0, cfg.fft_width - cfg.stride)
        else:
            from quadrs_tpu.parallel.sharding import (
                make_sharded_waterfall_step,
                waterfall_halo,
            )

            # the sharded step's halo length is the same invariant —
            # share the helper so the two cannot drift
            self._lookahead = waterfall_halo(cfg)
            if len(sources) % mesh.shape["stream"]:
                raise ValueError(
                    f"{len(sources)} sources do not shard over "
                    f"{mesh.shape['stream']} 'stream' mesh rows"
                )
            n_time = mesh.shape["time"]
            # each time-shard needs whole stride cells and must cover
            # the overlap halo it sends left
            quantum = n_time * max(1, -(-self._lookahead // cfg.stride))
            self.chunk_windows = max(
                quantum, self.chunk_windows // quantum * quantum
            )
            self._wstep = make_sharded_waterfall_step(model, mesh)
            # built once: per-call jax.jit wrappers would recompile on
            # every run_search invocation
            self._wstep_search = make_sharded_waterfall_step(
                model, mesh, search=True
            )

    def _total_windows(self) -> int:
        cfg = self.model.cfg
        length = self.sources[0].length
        return (
            (length - cfg.fft_width) // cfg.stride + 1
            if length >= cfg.fft_width
            else 0
        )

    def _staged_chunks(self, start_window: int, limit: int | None = None):
        """(first_window, n_valid, newly_staged_real_samples,
        ((S, 2, span) planes,)) per chunk.  ``limit`` bounds how many
        chunks are staged: the background thread must not run ahead of a
        ``max_chunks``-bounded consumer and queue device work that will
        only be abandoned."""
        cfg = self.model.cfg
        total_windows = self._total_windows()
        w = start_window
        prev_hi = None
        staged = 0
        while w < total_windows and (limit is None or staged < limit):
            staged += 1
            n_w = min(self.chunk_windows, total_windows - w)
            lo = w * cfg.stride
            # last window start + width (== advance + the overlap
            # lookahead when stride <= width; never reads past EOF)
            hi = (w + n_w - 1) * cfg.stride + cfg.fft_width
            new = hi - (lo if prev_hi is None else max(lo, prev_hi))
            prev_hi = hi
            yield w, n_w, new, (np.stack([s.stage(lo, hi) for s in self.sources]),)
            w += n_w

    def _staged_chunks_pipe(self, start_window: int, limit: int | None = None):
        """The :meth:`_staged_chunks` contract for a single
        :class:`~quadrs_tpu.sources.PipeSource` stream (a live
        spectrogram: ``rtl_sdr - | quadjax waterfall -stdin yes``).

        The pipe is read sequentially into an absolute-position buffer:
        each chunk's ``[lo, hi)`` span is ensured by reading forward,
        the ``width - stride`` overlap carries between chunks (a pipe
        cannot re-read), skipping strides' inter-chunk gaps are read
        and discarded (a pipe cannot seek), and the total window count
        is discovered at EOF — after which the staged spans, valid
        counts, and sample accounting match the file path exactly."""
        cfg = self.model.cfg
        src = self.sources[0]
        width, stride = cfg.fft_width, cfg.stride
        w = start_window
        staged = 0
        pos = 0  # absolute sample index of buf[:, 0]
        buf = None  # (2, m) unconsumed planes
        eof_len: int | None = None  # effective capture length, known at EOF

        def ensure(abs_hi: int) -> None:
            """Read forward until the buffer covers [pos, abs_hi) or EOF."""
            nonlocal buf, eof_len
            have = 0 if buf is None else buf.shape[1]
            need = abs_hi - (pos + have)
            if need > 0 and eof_len is None:
                new = src.read_planes(need)
                buf = new if buf is None else np.concatenate([buf, new], axis=1)
                if new.shape[1] < need:
                    eof_len = pos + buf.shape[1]

        def drop_to(abs_lo: int) -> None:
            """Discard samples below abs_lo (reading past the buffer if a
            skipping stride's gap hasn't been read yet)."""
            nonlocal buf, pos, eof_len
            while True:
                have = 0 if buf is None else buf.shape[1]
                k = abs_lo - pos
                if k <= 0:
                    return
                if k <= have:
                    buf = buf[:, k:]
                    pos = abs_lo
                    return
                pos += have
                buf = None
                if eof_len is not None:
                    return
                skip = src.read_planes(min(abs_lo - pos, 1 << 20))
                if skip.shape[1] == 0:
                    eof_len = pos
                    return
                buf = skip

        prev_hi = None
        while limit is None or staged < limit:
            n_w = self.chunk_windows
            lo = w * stride
            hi = (w + n_w - 1) * stride + width
            drop_to(lo)
            ensure(hi)
            if eof_len is not None:
                total = (eof_len - width) // stride + 1 if eof_len >= width else 0
                if w >= total:
                    return
                n_w = min(n_w, total - w)
                hi = (w + n_w - 1) * stride + width
            staged += 1
            planes = buf[:, : hi - pos][None, ...]  # (1, 2, span)
            new = hi - (lo if prev_hi is None else max(lo, prev_hi))
            prev_hi = hi
            yield w, n_w, new, (np.ascontiguousarray(planes),)
            w += n_w

    def _staged_chunks_sharded(self, start_window: int, limit: int | None = None):
        """Mesh chunks: a fixed ``chunk_windows`` advance of whole
        per-shard stride cells, with the true ``width - stride``
        continuation staged as the halo tail (zeros at EOF — the
        trailing windows reading them are past ``n_valid`` and
        dropped).  Device placement happens here, on the staging
        thread; ``limit`` bounds staging like :meth:`_staged_chunks`.

        Accounting uses the same convention as the single-device path —
        new real samples up to the last valid window's end — so
        ``RunStats.msps`` is comparable between the two paths.  For
        skipping strides the mesh path *stages* whole stride cells
        (trailing gap included); those extra staged-but-uncounted bytes
        are a mesh-layout necessity, not consumed input."""
        from quadrs_tpu.parallel.sharding import replicate_tail, shard_chunk

        cfg = self.model.cfg
        halo = self._lookahead
        total_windows = self._total_windows()
        length = self.sources[0].length
        # a live pipe's length is a sentinel until EOF: stage forward,
        # then re-read it after each read — the chunk where the short
        # read lands recomputes the real window total before yielding
        live = getattr(self.sources[0], "is_live", False)
        n_w = self.chunk_windows
        w = start_window
        prev_hi = None
        staged = 0
        while (live or w < total_windows) and (limit is None or staged < limit):
            lo = w * cfg.stride
            hi = lo + n_w * cfg.stride
            planes = np.stack([s.stage(lo, hi) for s in self.sources])
            if live:
                # the short read (if any) made the sentinel length real;
                # stop BEFORE the tail staging, which would otherwise
                # rewind the facade on a chunk wholly past EOF
                length = self.sources[0].length
                total_windows = self._total_windows()
                if w >= total_windows:
                    return
            if planes.shape[-1] < n_w * cfg.stride:  # zero-pad past EOF
                planes = np.pad(
                    planes,
                    ((0, 0), (0, 0), (0, n_w * cfg.stride - planes.shape[-1])),
                )
            args = [shard_chunk(planes, self.mesh)]
            if halo:
                tail = np.stack(
                    [s.stage(min(hi, length), min(hi, length) + halo) for s in self.sources]
                )
                if live:
                    length = self.sources[0].length
                if tail.shape[-1] < halo:
                    tail = np.pad(tail, ((0, 0), (0, 0), (0, halo - tail.shape[-1])))
                args.append(replicate_tail(tail, self.mesh))
            if live:
                total_windows = self._total_windows()
                if w >= total_windows:
                    return
            staged += 1
            n_valid = min(n_w, total_windows - w)
            # same formula as _staged_chunks: last valid window start +
            # width, capped at EOF (overlap with the previous chunk's
            # span counted once)
            acc_hi = min((w + n_valid - 1) * cfg.stride + cfg.fft_width, length)
            new = max(0, acc_hi - (lo if prev_hi is None else max(lo, prev_hi)))
            prev_hi = max(acc_hi, prev_hi or 0)
            yield w, n_valid, new, tuple(args)
            w += n_w

    def run(self, on_norms=None, start_window: int = 0, max_chunks=None) -> RunStats:
        step = self._wstep if self._wstep is not None else self.model.jit_step()
        return self._run(step, on_norms, start_window, max_chunks)

    def run_search(self, on_peaks=None, start_window: int = 0, max_chunks=None) -> RunStats:
        """Like :meth:`run` but through the peak-search reduction:
        ``on_peaks(first_window_index, (idx, val))`` receives per chunk
        the (S, windows) int32 fftshifted peak bins and f32 magnitudes
        (``WaterfallModel.search`` applied chunkwise — identical to the
        single-shot search over the whole capture).  On a mesh each
        shard runs the per-window reduction locally."""
        if self._wstep_search is not None:
            return self._run(self._wstep_search, on_peaks, start_window, max_chunks)
        return self._run(self.model.jit_search(), on_peaks, start_window, max_chunks)

    def _chunk_gen(self, start_window: int, limit):
        """The staged-chunk generator for this runner's source/mesh
        configuration — one selection point shared by every run mode."""
        if self._wstep is not None:
            return self._staged_chunks_sharded(start_window, limit=limit)
        if getattr(self.sources[0], "is_pipe", False):
            return self._staged_chunks_pipe(start_window, limit=limit)
        return self._staged_chunks(start_window, limit=limit)

    def run_scan(
        self,
        threshold: float = 0.0,
        start_window: int = 0,
        max_chunks=None,
    ) -> ScanResult:
        """Band survey (the rtl_power product): per fftshifted bin, the
        average and maximum window power plus the count of windows above
        ``threshold``, over every valid window of the run.  Each chunk's
        spectrogram reduces on device — only ``3 * width`` scalars per
        chunk cross to the host.  On the single-device path the
        reduction runs through ``WaterfallModel.jit_scan``; on a mesh a
        jitted reduction consumes the sharded step's global norms."""
        import time

        import jax
        import jax.numpy as jnp

        if self._wstep is None:
            # single-device (file bank or pipe): staged chunks carry
            # exactly n_valid windows, so the model-level scan step needs
            # no extra masking beyond its own tile padding
            scan_step = self.model.jit_scan()
            step = None
        else:
            step = self._wstep

        @jax.jit
        def reduce_chunk(norms, n_valid, thr):
            valid = (jnp.arange(norms.shape[1], dtype=jnp.int32) < n_valid)[
                None, :, None
            ]
            s = jnp.sum(jnp.where(valid, norms, 0.0), axis=1)
            mx = jnp.max(jnp.where(valid, norms, -jnp.inf), axis=1)
            above = jnp.sum(
                (valid & (norms > thr)).astype(jnp.int32), axis=1
            )
            return s, mx, above

        n_s = len(self.sources)
        width = self.model.cfg.fft_width
        sum_f64 = np.zeros((n_s, width), np.float64)
        max_f32 = np.full((n_s, width), -np.inf, np.float32)
        above = np.zeros((n_s, width), np.int64)
        windows = 0
        stats = RunStats()
        t0 = time.perf_counter()
        done = 0
        chunks = _background(self._chunk_gen(start_window, max_chunks))
        for w, n_valid, new_samples, args in chunks:
            if step is None:
                s, mx, ab = scan_step(args[0], jnp.float32(threshold))
            else:
                norms = step(*args)
                s, mx, ab = reduce_chunk(
                    norms, jnp.int32(n_valid), jnp.float32(threshold)
                )
            stats.samples_in += new_samples * n_s
            stats.windows_out += n_s * n_valid
            windows += n_valid
            sum_f64 += np.asarray(s, dtype=np.float64)
            np.maximum(max_f32, np.asarray(mx), out=max_f32)
            above += np.asarray(ab, dtype=np.int64)
            done += 1
            if max_chunks is not None and done >= max_chunks:
                chunks.close()
                break
        stats.seconds = time.perf_counter() - t0
        PROFILER.account("waterfall_runner", stats.samples_in, stats.seconds)
        if windows == 0:
            max_f32.fill(0.0)
        return ScanResult(
            sum_norms=sum_f64,
            max_norms=max_f32,
            above=above,
            windows=windows,
            threshold=float(threshold),
            stats=stats,
        )

    def _run(self, step, emit, start_window: int, max_chunks) -> RunStats:
        import time

        import jax.numpy as jnp

        stats = RunStats()
        t0 = time.perf_counter()
        # with no callback, fold every chunk's full output into one
        # accumulator: the closing fetch then waits for all of them
        acc = jnp.float32(0.0) if emit is None else None
        done = 0
        chunks = _background(self._chunk_gen(start_window, max_chunks))
        for w, n_valid, new_samples, args in chunks:
            out = step(*args)
            # each generator reports the real stream samples it newly
            # staged for this chunk (overlap re-staging counted once,
            # skipping-stride gaps only where they were actually read)
            stats.samples_in += new_samples * len(self.sources)
            if isinstance(out, tuple):  # search: (idx, val)
                idx, val = (a[:, :n_valid] for a in out)
                stats.windows_out += idx.shape[0] * idx.shape[1]
                if emit is None:
                    acc = acc + jnp.sum(val) + jnp.sum(idx.astype(jnp.float32))
                else:
                    emit(w, (np.asarray(idx), np.asarray(val)))
            else:
                out = out[:, :n_valid]
                stats.windows_out += out.shape[0] * out.shape[1]
                if emit is None:
                    acc = acc + jnp.sum(out)
                else:
                    emit(w, np.asarray(out))
            done += 1
            if max_chunks is not None and done >= max_chunks:
                chunks.close()
                break
        if acc is not None:
            sync_fetch(acc)
        stats.seconds = time.perf_counter() - t0
        PROFILER.account("waterfall_runner", stats.samples_in, stats.seconds)
        return stats


class StreamRunner:
    """Drive one or more captures through the fused pipeline at full rate.

    ``source``: a :class:`SampleSource`, or a sequence of them (equal
    length and format) to process as a data-parallel bank across the
    mesh's 'stream' axis.  ``chunk_samples`` is rounded down to a whole
    number of STFT windows.

    With ``mesh`` (a ``(stream, time)`` mesh from
    :func:`quadrs_tpu.parallel.sharding.make_mesh`), each chunk's time
    axis is sharded across the mesh's 'time' chips with halo
    exchange and the true next-chunk tail fed to the last shard — the
    captures stream through the whole mesh with no recomputation.

    ``on_windows(first_window_index, norms)`` receives ``(windows,
    fft_width)`` rows for a single source, or ``(n_stream, windows,
    fft_width)`` when running a bank.
    """

    def __init__(
        self,
        source,
        model: PipelineModel,
        chunk_samples: int = 1 << 22,
        mesh=None,
    ):
        sources = list(source) if isinstance(source, (list, tuple)) else [source]
        for s in sources:
            if s.format is not model.cfg.fmt:
                raise ValueError(
                    f"source format {s.format} != model format {model.cfg.fmt}"
                )
        _check_pipe_sources(sources, mesh, allow_mesh=True)
        if mesh is not None and getattr(sources[0], "is_pipe", False):
            # a live pipe CAN shard over time: the sharded staging reads
            # strictly forward with boundary overlap, which the sliding
            # LivePipeStream facade serves; EOF turns its sentinel
            # length real and the ragged tail runs as on files
            from quadrs_tpu.sources import LivePipeStream

            sources = [LivePipeStream(sources[0])]
        if len({s.length for s in sources}) != 1:
            raise ValueError("bank sources must have equal lengths")
        self.sources = sources
        self.source = sources[0]
        self.model = model
        self.mesh = mesh
        self._sharded_step = None
        self._sharded_search_step = None
        cfg = model.cfg
        self._win_raw = cfg.decimate * cfg.fft_width
        # lookahead: the last FIR output of a chunk reads ceil(taps/2) +
        # taps past its decimation point (group delay), and step_stream's
        # window reshape floor-drops the few extra decimated outputs
        self._lookahead = cfg.taps + (cfg.taps - cfg.taps // 2)
        if cfg.taps // 2 // cfg.decimate >= cfg.fft_width:
            raise ValueError("fft window shorter than the FIR group delay span")
        quantum = self._win_raw
        if mesh is not None:
            from quadrs_tpu.parallel.sharding import (
                halo_samples,
                make_sharded_stream_step,
            )

            if mesh.shape["stream"] != len(sources):
                raise ValueError(
                    f"mesh has {mesh.shape['stream']} stream shards for "
                    f"{len(sources)} sources"
                )
            self._halo = halo_samples(cfg)
            # each time-shard's slice must cover the halo it sends left
            quantum = (
                mesh.shape["time"] * -(-self._halo // self._win_raw) * self._win_raw
            )
            self._sharded_step = make_sharded_stream_step(model, mesh)
        elif len(sources) != 1:
            raise ValueError("a source bank needs a mesh with a 'stream' axis")
        self.chunk_samples = max(quantum, chunk_samples // quantum * quantum)
        self._quantum = quantum

    def _chunks(self, start_off: int = 0) -> Iterator[tuple[int, np.ndarray]]:
        """(offset, (2, chunk+taps) planes) with the taps lookahead."""
        la = self._lookahead
        length = self.source.length
        off = start_off
        while off < length - self.model.cfg.taps:
            n = min(self.chunk_samples, (length - off) // self._win_raw * self._win_raw)
            if n <= 0:
                return
            planes = self.source.stage(off, off + n + la)
            valid = planes.shape[1]
            if valid < n + la:
                # raw zero bytes decode to nonzero values for cu8/cs16,
                # so the model masks [valid:] in the decoded domain
                planes = np.pad(planes, ((0, 0), (0, n + la - valid)))
            yield off, planes, valid
            off += n

    def _emit_native(self, off: int, full: np.ndarray):
        """Shape one prefetched buffer (all-real bytes from ``off``) into
        the (off, (2, n+la) planes, valid) triple :meth:`_chunks` yields."""
        length = self.source.length
        if off >= length - self.model.cfg.taps:
            return None
        n = min(self.chunk_samples, (length - off) // self._win_raw * self._win_raw)
        if n <= 0:
            return None
        la = self._lookahead
        valid = min(full.shape[1], n + la)
        buf = full[:, : n + la]
        if buf.shape[1] < n + la:
            buf = np.pad(buf, ((0, 0), (0, n + la - buf.shape[1])))
        return off, buf, int(valid)

    def _chunks_native(self, start_off: int = 0) -> Iterator:
        """Chunks through the C++ ring prefetcher (native/loader.cc): the
        loader's worker threads pread + deinterleave upcoming chunks in
        parallel while the current one computes on the device — no
        Python staging thread, and each delivered buffer already carries
        the ``lookahead`` overlap (re-read in C), so no host-side
        stitching copies either."""
        it = self.source.native.prefetch(
            self.chunk_samples,
            start_off=start_off,
            overlap=self._lookahead,
        )
        try:
            for off, planes in it:
                item = self._emit_native(off, planes)
                if item is None:
                    return
                yield item
        finally:
            it.close()

    def _chunks_pipe(self, start_off: int = 0) -> Iterator:
        """Sequential chunks from a :class:`~quadrs_tpu.sources.
        PipeSource`: the same ``(off, planes, valid)`` triples and
        tail/window-floor semantics as :meth:`_chunks`, with the
        effective capture length discovered at EOF.  The ``lookahead``
        overlap is carried between chunks host-side (a pipe cannot
        re-read), and a nonzero ``start_off`` drains the skipped
        samples (pipes cannot seek) — resume phases stay exact because
        offsets are absolute."""
        la = self._lookahead
        src = self.source
        taps = self.model.cfg.taps
        win = self._win_raw
        off = 0
        while off < start_off:
            m = src.read_planes(min(self.chunk_samples, start_off - off)).shape[1]
            if m == 0:
                return
            off += m
        buf = None
        while True:
            need = self.chunk_samples + la - (0 if buf is None else buf.shape[1])
            if need > 0:
                new = src.read_planes(need)
                buf = new if buf is None else np.concatenate([buf, new], axis=1)
            avail = buf.shape[1]
            if avail == self.chunk_samples + la and not src.eof:
                n = self.chunk_samples
                yield off, buf, n + la
                buf = buf[:, n:]
                off += n
                continue
            # EOF: the stream's effective length is now known; mirror
            # _chunks' end-of-capture math (floor to whole windows, pad
            # the staged tail, stop inside the final taps span)
            length = off + avail
            while off < length - taps:
                n = min(self.chunk_samples, (length - off) // win * win)
                if n <= 0:
                    break
                planes = buf[:, : n + la]
                valid = planes.shape[1]
                if valid < n + la:
                    planes = np.pad(planes, ((0, 0), (0, n + la - valid)))
                yield off, planes, valid
                buf = buf[:, n:]
                off += n
            return

    def _prefetched(self, start_off: int = 0, depth: int = 2) -> Iterator:
        """Overlap staging with device compute.

        File-backed sources go through the C++ ring prefetcher
        (:meth:`_chunks_native`).  Pipe sources read sequentially on the
        background thread (:meth:`_chunks_pipe`); in-memory sources run
        :meth:`_chunks` staging there instead.  Either way, if the
        consumer abandons the generator (callback raised, interrupted),
        the producer notices and exits instead of pinning buffers."""
        if getattr(self.source, "native", None) is not None:
            yield from self._chunks_native(start_off)
            return
        if getattr(self.source, "is_pipe", False):
            yield from _background(self._chunks_pipe(start_off), depth)
            return
        yield from _background(self._chunks(start_off), depth)

    def run(
        self,
        on_windows: Callable[[int, np.ndarray], None] | None = None,
        start_window: int = 0,
        max_chunks: int | None = None,
    ) -> RunStats:
        """Process the capture from ``start_window`` onward.

        ``on_windows(first_window_index, norms)`` receives each chunk's
        (windows, fft_width) f32 rows.  Resuming mid-capture is exact —
        NCO phases are planned from absolute offsets, so a resumed run
        produces bit-identical rows to the corresponding tail of a full
        run (the checkpoint/resume counterpart of the reference's
        write-then-re-`from` workflow).  ``max_chunks`` stops after that
        many chunks (previews, bounded benchmarks); to resume later,
        pass ``start_window + windows_out // n_stream`` (``windows_out``
        counts across every stream of a bank).
        """
        return self._run(on_windows, start_window, max_chunks, search=False)

    def run_search(
        self,
        on_peaks: Callable[[int, tuple], None] | None = None,
        start_window: int = 0,
        max_chunks: int | None = None,
    ) -> RunStats:
        """Like :meth:`run` but through the per-window peak reduction
        (the :meth:`WaterfallRunner.run_search` counterpart for the
        shift+FIR chain): ``on_peaks(first_window_index, (idx, val))``
        receives per chunk the (windows,) int32 fftshifted peak bins and
        f32 magnitudes of the decimated channel — identical to
        ``argmax``/``max`` over :meth:`run`'s rows.  On a mesh each
        shard reduces its own windows locally (the reduction never
        crosses the interconnect)."""
        return self._run(on_peaks, start_window, max_chunks, search=True)

    def run_scan(
        self,
        threshold: float = 0.0,
        start_window: int = 0,
        max_chunks=None,
    ) -> ScanResult:
        """:meth:`WaterfallRunner.run_scan`'s counterpart for the
        shift+FIR chain: per fftshifted bin of the DECIMATED channel,
        the average/max window power and the count of windows above
        ``threshold``.  Single-device chunks reduce on device (a jitted
        consumer of the chunk's norms — 3*width scalars to the host per
        chunk); the mesh path reduces the assembled global rows in
        numpy as they stream (they are materialized for callbacks
        anyway).  Bin ``width//2`` is the channel center — the
        frequency at MINUS the shift (``shift f`` multiplies by
        ``e^{j 2 pi f n / sr}``, ``src/shift.rs:28``, so the tone that
        lands at DC is the one at ``-f``; the CLI prints absolute Hz as
        ``-shift + offset``)."""
        import time

        import jax
        import jax.numpy as jnp

        width = self.model.cfg.fft_width
        n_s = len(self.sources)
        sum_f64 = np.zeros((n_s, width), np.float64)
        max_f32 = np.full((n_s, width), -np.inf, np.float32)
        above = np.zeros((n_s, width), np.int64)
        windows = 0

        if self._sharded_step is None:
            model = self.model

            @jax.jit
            def red(norms, thr):
                return (
                    jnp.sum(norms, axis=0),
                    jnp.max(norms, axis=0),
                    jnp.sum((norms > thr).astype(jnp.float32), axis=0),
                )

            thr = jnp.float32(threshold)
            stats = RunStats()
            t0 = time.perf_counter()
            done = 0
            chunks = self._prefetched(start_window * self._win_raw)
            for off, planes, valid in chunks:
                theta0 = model.theta0(np.asarray([off]))[0]
                out = model.jit_step_stream(planes, theta0, np.int32(valid))
                sm, mx, ab = red(out, thr)
                stats.samples_in += planes.shape[1] - self._lookahead
                stats.windows_out += out.shape[0]
                windows += out.shape[0]
                sum_f64[0] += np.asarray(sm, dtype=np.float64)
                np.maximum(max_f32[0], np.asarray(mx), out=max_f32[0])
                above[0] += np.asarray(ab).astype(np.int64)
                done += 1
                if max_chunks is not None and done >= max_chunks:
                    chunks.close()
                    break
            stats.seconds = time.perf_counter() - t0
            PROFILER.account("stream_runner", stats.samples_in, stats.seconds)
        else:
            windows_box = [0]

            def on_rows(w0, rows):
                r = rows if rows.ndim == 3 else rows[None]
                windows_box[0] += r.shape[1]
                sum_f64[...] += r.astype(np.float64).sum(axis=1)
                np.maximum(max_f32, r.max(axis=1), out=max_f32)
                above[...] += (r > np.float32(threshold)).sum(axis=1)

            stats = self.run(on_rows, start_window, max_chunks)
            windows = windows_box[0]

        if windows == 0:
            max_f32.fill(0.0)
        return ScanResult(
            sum_norms=sum_f64,
            max_norms=max_f32,
            above=above,
            windows=windows,
            threshold=float(threshold),
            stats=stats,
        )

    def _run(self, emit, start_window: int, max_chunks, search: bool) -> RunStats:
        import time

        import jax.numpy as jnp

        model = self.model
        stats = RunStats()
        t0 = time.perf_counter()
        # with no callback, fold each chunk's full output into one
        # accumulator the closing fetch waits on, so stats.seconds
        # covers every chunk's device work
        last = None
        done_chunks = 0
        if self._sharded_step is None:
            chunks = self._prefetched(start_window * self._win_raw)
            step = model.jit_step_stream_search if search else model.jit_step_stream
            for off, planes, valid in chunks:
                theta0 = model.theta0(np.asarray([off]))[0]
                out = step(planes, theta0, np.int32(valid))
                stats.samples_in += planes.shape[1] - self._lookahead
                if search:
                    idx, val = out
                    stats.windows_out += idx.shape[0]
                    if emit is not None:
                        emit(off // self._win_raw, (np.asarray(idx), np.asarray(val)))
                    else:
                        s = jnp.sum(val) + jnp.sum(idx.astype(jnp.float32))
                        last = s if last is None else last + s
                else:
                    stats.windows_out += out.shape[0]
                    if emit is not None:
                        emit(off // self._win_raw, np.asarray(out))
                    else:
                        s = jnp.sum(out)
                        last = s if last is None else last + s
                done_chunks += 1
                if max_chunks is not None and done_chunks >= max_chunks:
                    # break before pulling (and staging) the next chunk
                    chunks.close()
                    break
        else:
            last = self._run_sharded(
                emit, stats, start_window * self._win_raw, max_chunks, search
            )
        if last is not None and emit is None:
            sync_fetch(last)
        stats.seconds = time.perf_counter() - t0
        PROFILER.account("stream_runner", stats.samples_in, stats.seconds)
        return stats

    def _sharded_search(self):
        """The search variant of the sharded step, built on first use
        (and cached: per-call jax.jit wrappers would recompile on every
        run_search invocation)."""
        if self._sharded_search_step is None:
            from quadrs_tpu.parallel.sharding import make_sharded_stream_step

            self._sharded_search_step = make_sharded_stream_step(
                self.model, self.mesh, search=True
            )
        return self._sharded_search_step

    def _run_sharded(
        self,
        on_windows,
        stats: RunStats,
        start_off: int = 0,
        max_chunks=None,
        search: bool = False,
    ):
        """Time-sharded chunks over the mesh.  Each chunk's true
        continuation (the next ``halo`` samples of the stream) feeds the
        last shard, so every window is exact and chunks advance by their
        full length; the ragged tail (where the continuation would cross
        EOF) runs single-device per stream with decoded-domain masking.
        Resume is exact: phases are planned from absolute offsets.

        Staging (pread + stack + the sharded device_put) runs on a
        background thread, double-buffered against the mesh compute —
        the multi-chip path overlaps host work with device work just
        like the single-device ring prefetcher does."""
        from quadrs_tpu.parallel.sharding import replicate_tail, shard_chunk

        model = self.model
        cfg = model.cfg
        n_time = self.mesh.shape["time"]
        n_stream = self.mesh.shape["stream"]
        n = self.chunk_samples
        n_local = n // n_time
        halo = self._halo
        length = self.source.length
        single = n_stream == 1
        last = None
        done_chunks = 0

        live = getattr(self.source, "is_live", False)

        def staged():
            # bounded like _staged_chunks: never stage (and device_put)
            # chunks a max_chunks-bounded consumer will abandon
            off = start_off
            count = 0
            while max_chunks is None or count < max_chunks:
                if live:
                    # one forward read per chunk; a short return IS EOF
                    # (the facade's sentinel length turns real), and the
                    # leftover feeds the ragged tail below
                    buf = self.source.stage(off, off + n + halo)
                    if buf.shape[1] < n + halo:
                        return
                    planes = buf[None, :, :n]
                    tails = buf[None, :, n:]
                elif off + n + halo > length:
                    return
                else:
                    planes = np.stack([s.stage(off, off + n) for s in self.sources])
                    tails = np.stack(
                        [s.stage(off + n, off + n + halo) for s in self.sources]
                    )
                count += 1
                theta = np.broadcast_to(
                    model.theta0(
                        off + np.arange(n_time, dtype=np.int64) * n_local
                    )[None],
                    (n_stream, n_time),
                ).copy()
                # device placement happens here, on the staging thread:
                # the transfers overlap the consumer's mesh compute
                yield off, (
                    shard_chunk(planes, self.mesh),
                    shard_chunk(theta, self.mesh),
                    replicate_tail(tails, self.mesh),
                )
                off += n

        import jax.numpy as jnp

        off = start_off
        step = self._sharded_search() if search else self._sharded_step
        chunks = _background(staged())
        for off, args in chunks:
            done_chunks += 1
            out = step(*args)
            stats.samples_in += n * n_stream
            if search:
                idx, val = out
                stats.windows_out += idx.shape[0] * idx.shape[1]
                if on_windows is not None:
                    i, v = np.asarray(idx), np.asarray(val)
                    on_windows(
                        off // self._win_raw,
                        (i[0], v[0]) if single else (i, v),
                    )
                else:
                    s = jnp.sum(val) + jnp.sum(idx.astype(jnp.float32))
                    last = s if last is None else last + s
            else:
                stats.windows_out += out.shape[0] * out.shape[1]
                if on_windows is not None:
                    rows = np.asarray(out)
                    on_windows(off // self._win_raw, rows[0] if single else rows)
                else:
                    # fold every chunk into the fetched cone (see run())
                    s = jnp.sum(out)
                    last = s if last is None else last + s
        if max_chunks is not None and done_chunks >= max_chunks:
            return last  # bounded run stops before the ragged tail
        off = off + n if stats.samples_in else start_off
        if live:
            # the staging loop ended on a short read, so the facade's
            # sentinel length is real now; re-read it for the tail math
            length = self.source.length
        # ragged tail, single-device per stream (lockstep offsets)
        while off < length - cfg.taps:
            m = (length - off) // self._win_raw * self._win_raw
            if m <= 0:
                break
            theta0 = model.theta0(np.asarray([off]))[0]
            tail_step = model.jit_step_stream_search if search else model.jit_step_stream
            rows = []
            for s in self.sources:
                planes = s.stage(off, off + m + self._lookahead)
                valid = planes.shape[1]
                if valid < m + self._lookahead:
                    planes = np.pad(planes, ((0, 0), (0, m + self._lookahead - valid)))
                out = tail_step(planes, theta0, np.int32(valid))
                rows.append(out)
                if on_windows is None:
                    if search:
                        s_sum = jnp.sum(out[1]) + jnp.sum(out[0].astype(jnp.float32))
                    else:
                        s_sum = jnp.sum(out)
                    last = s_sum if last is None else last + s_sum
            stats.samples_in += m * n_stream
            stats.windows_out += (rows[0][0] if search else rows[0]).shape[0] * n_stream
            if on_windows is not None:
                if search:
                    idx = np.stack([np.asarray(r[0]) for r in rows])
                    val = np.stack([np.asarray(r[1]) for r in rows])
                    on_windows(
                        off // self._win_raw,
                        (idx[0], val[0]) if single else (idx, val),
                    )
                else:
                    got = [np.asarray(r) for r in rows]
                    on_windows(off // self._win_raw, got[0] if single else np.stack(got))
            off += m
        return last
