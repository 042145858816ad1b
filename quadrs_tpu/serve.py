"""CLI drivers for the serving products.

The reference is a CLI tool first (``src/bin/quadrs.rs:9-28`` — its
usage text is its product surface).  This module gives the rebuild's
flagship capabilities the same shell surface: sustained
:class:`~quadrs_tpu.stream_runner.StreamRunner` streaming (``stream``),
the fused waterfall bank with in-kernel peak search (``waterfall``), and
the composed demodulator models (``ook``/``fsk``) — none of which exist
in the reference, so their command grammar is ours, styled after the
reference's ``-flag value`` conventions.

Every command prints a final stats line
``<cmd>: N samples, M windows, S.SSs, R.R Msps`` so shell pipelines can
assert on throughput, and ``-out PREFIX`` streams results to files
chunk-by-chunk (norms as raw f32 rows, peaks as CSV) without holding the
capture's output in memory.
"""

from __future__ import annotations

import contextlib

import numpy as np

from quadrs_tpu import args as argmod
from quadrs_tpu.sources import open_capture
from quadrs_tpu.stream_runner import RunStats


def _stdin_details(cmd):
    """Resolve a ``-stdin yes`` command's capture metadata + byte
    stream.  The parser guaranteed ``-sr``/``-format`` (a pipe has no
    filename to sniff), so the sniff sentinel never matters."""
    import sys

    from quadrs_tpu.utils.sniff import guess_details

    return guess_details("-", cmd.sample_rate, cmd.format), sys.stdin.buffer


def _stdin_pipe_source(cmd):
    """Live, unbuffered stdin as a :class:`PipeSource` (stream/waterfall)."""
    from quadrs_tpu.sources import PipeSource

    details, buf = _stdin_details(cmd)
    return PipeSource(buf, details.format, details.sample_rate)


# demod commands buffer the whole piped burst in memory; cap it so a
# live radio stream mistakenly piped into ook/fsk errors instead of
# growing without bound (use stream/waterfall for live input)
_STDIN_BUFFER_CAP = 1 << 30


def _cmd_source(cmd):
    """The capture behind a demod command: a file, or all of stdin
    buffered into an in-memory :class:`SampleSource` — demod captures
    are short sensor bursts (the ``stream``/``waterfall`` commands
    stream stdin unbuffered via ``PipeSource`` instead)."""
    if not cmd.stdin:
        return open_capture(cmd.filename, cmd.sample_rate, cmd.format)
    from quadrs_tpu.sources import SampleSource

    details, buf = _stdin_details(cmd)
    data = buf.read(_STDIN_BUFFER_CAP + 1)
    if len(data) > _STDIN_BUFFER_CAP:
        raise ValueError(
            "stdin capture exceeds the demod buffer cap (1 GiB); ook/fsk "
            "buffer the whole burst — use stream/waterfall for live streams"
        )
    return SampleSource(
        np.frombuffer(data, dtype=np.uint8), details.format, details.sample_rate
    )


def _make_mesh(shape: tuple[int, int] | None):
    if shape is None:
        return None
    from quadrs_tpu.parallel.sharding import make_mesh

    return make_mesh(n_time=shape[0], n_stream=shape[1])


def _stats_line(name: str, stats: RunStats) -> str:
    return (
        f"{name}: {stats.samples_in} samples, {stats.windows_out} windows, "
        f"{stats.seconds:.2f}s, {stats.msps:.1f} Msps"
    )


class _PeakTracker:
    """Running (stream, window, bin, mag) maxima across chunks."""

    def __init__(self, n_streams: int):
        self.best = [(-1, -1, float("-inf"))] * n_streams  # (window, bin, mag)

    def update(self, s: int, w0: int, idx: np.ndarray, val: np.ndarray):
        if len(val) == 0:
            return
        i = int(np.argmax(val))
        if float(val[i]) > self.best[s][2]:
            self.best[s] = (w0 + i, int(idx[i]), float(val[i]))

    def lines(self, prefix: str) -> list[str]:
        out = []
        for s, (w, b, m) in enumerate(self.best):
            tag = f" stream={s}" if len(self.best) > 1 else ""
            out.append(f"{prefix} peak{tag} window={w} bin={b} mag={m:.6g}")
        return out


def run_stream(cmd: argmod.StreamCmd) -> int:
    """Drive the fused shift -> lowpass -> STFT chain over a capture."""
    from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel
    from quadrs_tpu.stream_runner import StreamRunner

    # live pipe input: rtl_sdr - | quadjax stream -stdin yes ...
    if cmd.stdin:
        src = _stdin_pipe_source(cmd)
    else:
        src = open_capture(cmd.filename, cmd.sample_rate, cmd.format)
    cfg = PipelineConfig(
        sample_rate=src.sample_rate,
        shift_freq=cmd.shift,
        lp_freq=cmd.lowpass,
        decimate=cmd.decimate,
        taps=cmd.size,
        fft_width=cmd.fft_width,
        fmt=src.format,
    )
    model = PipelineModel(cfg)
    runner = StreamRunner(
        src, model, chunk_samples=cmd.chunk, mesh=_make_mesh(cmd.mesh)
    )
    if cmd.trigger is not None:
        return _run_stream_trigger(cmd, src, runner)
    if cmd.scan:
        # band survey of the DECIMATED channel: bins at the channel
        # rate, centered on the shift frequency (absolute Hz printed)
        result = runner.run_scan(threshold=cmd.threshold, max_chunks=cmd.chunks)
        width = cfg.fft_width
        ch_rate = src.sample_rate / cmd.decimate
        # shift f multiplies by e^{j 2pi f n / sr} (src/shift.rs:28), so
        # the tone that lands at DC is the one at -f: center = -shift
        freq = -cmd.shift + (np.arange(width) - width // 2) * (ch_rate / width)
        if cmd.out is not None:
            path = f"{cmd.out}.scan.csv"
            with open(path, "w") as fh:
                fh.writelines(_scan_csv_lines(result, 0, freq))
            print(f"wrote {path}")
        _print_survey(result, freq, cmd.top, cmd.db, name="stream scan")
        print(_stats_line("stream", result.stats))
        return 0
    tracker = _PeakTracker(1)
    wrote: list[str] = []

    # ExitStack so a mid-run failure (staging IO, callback, ^C) still
    # flushes and closes every output file
    with contextlib.ExitStack() as stack:
        if cmd.search:
            csv = None
            if cmd.out is not None:
                path = f"{cmd.out}.peaks.csv"
                csv = stack.enter_context(open(path, "w"))
                csv.write("window,bin,mag\n")
                wrote.append(path)

            def on_peaks(w0, out):
                idx, val = out
                tracker.update(0, w0, idx, val)
                if csv is not None:
                    for i in range(len(idx)):
                        csv.write(f"{w0 + i},{int(idx[i])},{float(val[i]):.9g}\n")

            stats = runner.run_search(on_peaks, max_chunks=cmd.chunks)
        else:
            f = None
            if cmd.out is not None:
                path = f"{cmd.out}.norms.f32"
                f = stack.enter_context(open(path, "wb"))
                wrote.append(path)

            def on_windows(w0, norms):
                tracker.update(
                    0, w0, np.argmax(norms, axis=-1), np.max(norms, axis=-1)
                )
                if f is not None:
                    f.write(np.ascontiguousarray(norms, dtype=np.float32).tobytes())

            stats = runner.run(on_windows, max_chunks=cmd.chunks)

    for line in tracker.lines("stream"):
        print(line)
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("stream", stats))
    return 0


def _run_stream_trigger(cmd: argmod.StreamCmd, src, runner) -> int:
    """Burst recorder (the rtl_433-style squelch): gate on the decimated
    channel's per-window peak magnitude (the in-kernel search output),
    widen each active run by -pre/-post windows, and write every burst
    as a byte-exact, re-``from``-able slice of the ORIGINAL capture —
    ``{out}.bK.s{start}.sr{rate}.{fmt}`` (native format, no decode)."""
    from quadrs_tpu.stream_runner import burst_spans

    if getattr(src, "is_pipe", False):
        return _run_stream_trigger_live(cmd, src, runner)

    vals: list[np.ndarray] = []
    stats = runner.run_search(
        lambda w0, out: vals.append(np.asarray(out[1])), max_chunks=cmd.chunks
    )
    val = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    win_raw = cmd.decimate * cmd.fft_width
    spans = burst_spans(val > np.float32(cmd.trigger), cmd.pre, cmd.post)
    ext = src.format.value  # the enum values ARE the extensions
    for k, (a, b) in enumerate(spans):
        s0 = a * win_raw
        s1 = min((b + 1) * win_raw, src.length)
        path = f"{cmd.out}.b{k}.s{s0}.sr{src.sample_rate}.{ext}"
        with open(path, "wb") as fh:
            fh.write(src.raw_bytes(s0, s1))
        peak = float(val[a : b + 1].max())
        print(
            f"stream burst {k}: windows {a}..{b}, samples {s0}..{s1}, "
            f"peak {peak:.6g}, wrote {path}"
        )
    print(
        f"stream trigger: {len(spans)} bursts over {len(val)} windows, "
        f"level {cmd.trigger:g}"
    )
    print(_stats_line("stream", stats))
    return 0


def _run_stream_trigger_live(cmd: argmod.StreamCmd, src, runner) -> int:
    """The burst recorder off a LIVE pipe (``stream -stdin -trigger``):
    the pipe retains a rolling raw-byte ring (pruned to the earliest
    window an unresolved span might still need, so memory is O(open
    burst + context), capped), an incremental :class:`BurstGate`
    resolves spans with exactly :func:`burst_spans`'s semantics, and
    each burst file is written AS IT RESOLVES — same bytes and names as
    the file run over the same stream (tested)."""
    from quadrs_tpu.sources import RawRing
    from quadrs_tpu.stream_runner import BurstGate

    ring = RawRing(src.format.pair_bytes)
    src.byte_ring = ring
    gate = BurstGate(cmd.pre, cmd.post)
    win_raw = cmd.decimate * cmd.fft_width
    lvl = np.float32(cmd.trigger)
    ext = src.format.value
    # per-window peaks retained for the same horizon as the byte ring
    # (the summary line prints each burst's peak)
    vals: list[float] = []
    vals_base = 0
    state = {"k": 0, "windows": 0}

    def emit(a: int, b: int) -> None:
        s0 = a * win_raw
        s1 = min((b + 1) * win_raw, ring.end)
        path = f"{cmd.out}.b{state['k']}.s{s0}.sr{src.sample_rate}.{ext}"
        with open(path, "wb") as fh:
            fh.write(ring.slice(s0, s1))
        peak = max(vals[a - vals_base : b + 1 - vals_base])
        print(
            f"stream burst {state['k']}: windows {a}..{b}, samples "
            f"{s0}..{s1}, peak {peak:.6g}, wrote {path}"
        )
        state["k"] += 1

    def on_peaks(w0, out):
        nonlocal vals, vals_base
        val = np.asarray(out[1])
        vals.extend(float(v) for v in val)
        state["windows"] = w0 + len(val)
        for a, b in gate.feed(val > lvl):
            emit(a, b)
        keep = gate.earliest_needed()
        ring.prune(keep * win_raw)
        if keep > vals_base:
            vals = vals[keep - vals_base :]
            vals_base = keep

    stats = runner.run_search(on_peaks, max_chunks=cmd.chunks)
    for a, b in gate.finish(state["windows"]):
        emit(a, b)
    print(
        f"stream trigger: {state['k']} bursts over {state['windows']} "
        f"windows, level {cmd.trigger:g}"
    )
    print(_stats_line("stream", stats))
    return 0


def run_waterfall(cmd: argmod.WaterfallCmd) -> int:
    """Stream a bank of captures through the fused waterfall kernel."""
    sources, model, runner = _open_bank(cmd)
    tracker = _PeakTracker(len(sources))
    wrote: list[str] = []

    with contextlib.ExitStack() as stack:
        if cmd.search:
            csv = None
            if cmd.out is not None:
                path = f"{cmd.out}.peaks.csv"
                csv = stack.enter_context(open(path, "w"))
                csv.write("stream,window,bin,mag\n")
                wrote.append(path)

            def on_peaks(w0, out):
                idx, val = out  # (S, nw) each
                for s in range(idx.shape[0]):
                    tracker.update(s, w0, idx[s], val[s])
                    if csv is not None:
                        for i in range(idx.shape[1]):
                            csv.write(
                                f"{s},{w0 + i},{int(idx[s, i])},{float(val[s, i]):.9g}\n"
                            )

            stats = runner.run_search(on_peaks, max_chunks=cmd.chunks)
        else:
            files = None
            if cmd.out is not None:
                files = []
                for s in range(len(sources)):
                    path = f"{cmd.out}.s{s}.norms.f32"
                    files.append(stack.enter_context(open(path, "wb")))
                    wrote.append(path)

            def on_norms(w0, norms):  # (S, nw, width)
                for s in range(norms.shape[0]):
                    tracker.update(
                        s, w0, np.argmax(norms[s], axis=-1), np.max(norms[s], axis=-1)
                    )
                    if files is not None:
                        files[s].write(
                            np.ascontiguousarray(norms[s], dtype=np.float32).tobytes()
                        )

            stats = runner.run(on_norms, max_chunks=cmd.chunks)

    for line in tracker.lines("waterfall"):
        print(line)
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("waterfall", stats))
    return 0


def _open_bank(cmd):
    """Sources + model + runner for a waterfall-bank command (shared by
    ``waterfall`` and ``scan`` — same knobs: width/stride/window/chunk/
    mesh/stdin/filenames)."""
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.stream_runner import WaterfallRunner

    if cmd.stdin:
        sources = [_stdin_pipe_source(cmd)]
    else:
        sources = [
            open_capture(f, cmd.sample_rate, cmd.format) for f in cmd.filenames
        ]
    fmts = {s.format for s in sources}
    if len(fmts) != 1:
        raise ValueError(f"bank files disagree on format: {sorted(f.name for f in fmts)}")
    cfg = WaterfallConfig(
        n_streams=len(sources),
        fft_width=cmd.fft_width,
        stride=cmd.stride if cmd.stride is not None else cmd.fft_width,
        fmt=sources[0].format,
        windowing=cmd.windowing,
    )
    model = WaterfallModel(cfg)
    runner = WaterfallRunner(
        sources, model, chunk_windows=cmd.chunk_windows, mesh=_make_mesh(cmd.mesh)
    )
    return sources, model, runner


def _scan_csv_lines(result, s: int, freq) -> "list[str]":
    """The survey CSV rows for stream ``s`` (shared by ``quadjax scan
    -out`` and ``serve -mode scan``)."""
    avg, occ = result.avg, result.occupancy
    lines = ["bin,freq_hz,avg,max,above,occupancy\n"]
    for b in range(freq.shape[0]):
        lines.append(
            f"{b},{freq[b]:.6g},{avg[s, b]:.9g},"
            f"{result.max_norms[s, b]:.9g},{result.above[s, b]},"
            f"{occ[s, b]:.6g}\n"
        )
    return lines


def _print_survey(result, freq, top: int, db: bool, name: str = "scan") -> None:
    """Print the strongest-bins table of a :class:`ScanResult` (shared
    by ``quadjax scan`` and ``stream -scan``)."""
    width = freq.shape[0]
    avg, occ = result.avg, result.occupancy

    def fmt_pow(v: float) -> str:
        # norms are MAGNITUDES (sqrt(re^2+im^2)); power dB of a
        # magnitude is 20*log10 — the rtl_power convention the survey
        # claims parity with (10*log10 would halve every ratio)
        if not db:
            return f"{v:12.6g}"
        return f"{20.0 * np.log10(max(v, 1e-30)):9.2f} dB"

    for s in range(avg.shape[0]):
        tag = f" stream={s}" if avg.shape[0] > 1 else ""
        print(
            f"{name}{tag}: {result.windows} windows of {width} bins, "
            f"threshold {result.threshold:g}"
        )
        order = np.argsort(avg[s])[::-1][:top]
        print("   bin     freq_hz          avg          max  occupancy")
        for b in order:
            print(
                f"  {b:4d} {freq[b]:+11.1f} {fmt_pow(avg[s, b])} "
                f"{fmt_pow(float(result.max_norms[s, b]))} {occ[s, b]:9.1%}"
            )


def run_scan(cmd: argmod.ScanCmd) -> int:
    """Band survey (the rtl_power product): per-bin average/max power
    and occupancy over every window, reduced on device — prints the
    strongest bins with their frequency offsets; ``-out`` writes the
    full per-bin table as CSV per stream."""
    sources, model, runner = _open_bank(cmd)
    result = runner.run_scan(threshold=cmd.threshold, max_chunks=cmd.chunks)

    width = model.cfg.fft_width
    sr = sources[0].sample_rate
    # fftshifted bin b <-> frequency offset (b - width//2) * sr / width
    freq = (np.arange(width) - width // 2) * (sr / width)

    wrote: list[str] = []
    if cmd.out is not None:
        for s in range(len(sources)):
            path = f"{cmd.out}.s{s}.scan.csv"
            with open(path, "w" if cmd.overwrite else "x") as fh:
                fh.writelines(_scan_csv_lines(result, s, freq))
            wrote.append(path)
    if cmd.plot:
        from quadrs_tpu.viz.survey import survey_render_file

        for s in range(len(sources)):
            path = f"{cmd.out or 'scan'}.s{s}.png"
            wrote.append(
                str(survey_render_file(result, s, path, overwrite=cmd.overwrite))
            )

    _print_survey(result, freq, cmd.top, cmd.db, name="scan")
    for path in wrote:
        print(f"wrote {path}")
    print(_stats_line("scan", result.stats))
    return 0


def run_ook(cmd: argmod.OokCmd) -> int:
    """Demodulate an OOK capture and print the recovered bits."""
    from quadrs_tpu.models.demod import OokDemod, manchester_decode

    src = _cmd_source(cmd)
    demod = OokDemod(
        width=cmd.width,
        stride=cmd.stride,
        threshold=cmd.threshold,
        samples_per_bit=cmd.bit,
    )
    err, raw_bits = demod.demodulate(src, mesh=_make_mesh(cmd.mesh))
    if cmd.raw:
        print("".join("1" if b else "0" for b in raw_bits))
    else:
        print("".join(str(b) for b in manchester_decode(raw_bits)))
    print(f"ook: {len(raw_bits)} raw bits, clock error {err:.3f}")
    return 0


def run_fsk(cmd: argmod.FskCmd) -> int:
    """Demodulate a two-tone FSK capture and print the recovered bits."""
    from quadrs_tpu.models.demod import FskDemod

    src = _cmd_source(cmd)
    demod = FskDemod(
        center=cmd.shift,
        bandwidth=cmd.lowpass,
        decimate=cmd.decimate,
        taps=cmd.size,
        fft_width=cmd.fft_width,
        stride=cmd.stride,
        samples_per_symbol=1.0 if cmd.bit is None else cmd.bit,
    )
    if cmd.bit is None:
        # raw discriminator symbols (one per window, like `bucket` but
        # through the composed channel model)
        syms = demod.symbols(src, mesh=_make_mesh(cmd.mesh))
        print("".join(str(int(s)) for s in syms))
        print(f"fsk: {len(syms)} symbols")
    else:
        err, bits = demod.demodulate(src, mesh=_make_mesh(cmd.mesh))
        print("".join("1" if b else "0" for b in bits))
        print(f"fsk: {len(bits)} bits, clock error {err:.3f}")
    return 0


def run_psk(cmd: argmod.PskCmd) -> int:
    """Demodulate a BPSK/QPSK capture and print the recovered bits."""
    from quadrs_tpu.models.demod import PskDemod

    src = _cmd_source(cmd)
    demod = PskDemod(
        center=cmd.shift,
        bandwidth=cmd.lowpass,
        decimate=cmd.decimate,
        taps=cmd.size,
        symbol_rate=cmd.symbol_rate,
        order=cmd.order,
        differential=cmd.differential,
        block=cmd.block,
    )
    est, sym = demod.symbols(src, mesh=_make_mesh(cmd.mesh))
    bits = demod.slice(sym)
    print("".join(map(str, bits)))
    print(
        f"psk: {len(bits)} bits, freq {est.freq_hz:+.1f} Hz, "
        f"phase {est.phase:+.3f} rad, tau {est.tau:.2f}, sps {est.sps:g}"
    )
    if cmd.plot is not None:
        from quadrs_tpu.viz.constellation import constellation_render_file

        path = constellation_render_file(
            sym, cmd.order, cmd.plot, overwrite=cmd.overwrite
        )
        print(f"psk: constellation -> {path}")
    return 0


def _write_audio(cmd, rate: int, audio: "np.ndarray") -> str | None:
    """Write demodulated audio per the command's output flags: raw mono
    LE f32 (`{prefix}.sr{rate}.f32`) or, with `-wav yes`, a playable
    mono float32 WAV (`{prefix}.wav` — same samples, RIFF-wrapped).
    `-out -` streams the same bytes to STDOUT instead (pipe into a
    player: `quadjax fm ... -out - | aplay -f FLOAT_LE -r RATE`) and
    returns None — the meter line moves to stderr in that case.  The
    reference refuses `write -` (its TODO panic, src/lib.rs:179-181);
    audio-to-a-player is the one place streaming out is the point."""
    import sys

    if cmd.out == "-":
        if cmd.wav:
            from quadrs_tpu.utils.wav import wav_bytes

            sys.stdout.buffer.write(wav_bytes(rate, audio))
        else:
            sys.stdout.buffer.write(audio.astype("<f4").tobytes())
        sys.stdout.buffer.flush()
        return None
    if cmd.wav:
        from quadrs_tpu.utils.wav import write_wav

        return write_wav(f"{cmd.out}.wav", rate, audio, overwrite=cmd.overwrite)
    filename = f"{cmd.out}.sr{rate}.f32"
    with open(filename, "wb" if cmd.overwrite else "xb") as fh:
        fh.write(audio.astype("<f4").tobytes())
    return filename


def _emit_audio(cmd, rate: int, audio: "np.ndarray"):
    """Handle an audio command's output flags; returns the stream the
    meter line should print to (stderr when the audio itself went to
    stdout, keeping the byte stream clean)."""
    import sys

    if cmd.out is None:
        return sys.stdout
    written = _write_audio(cmd, rate, audio)
    if written is None:
        return sys.stderr
    print(written)
    return sys.stdout


def run_fm(cmd: argmod.FmCmd) -> int:
    """Demodulate an analog-FM capture to audio: write it as mono LE
    f32 (``-out``) or print a deviation-meter summary."""
    import time

    from quadrs_tpu.models.demod import FmDemod

    src = _cmd_source(cmd)
    demod = FmDemod(
        center=cmd.shift,
        bandwidth=cmd.lowpass,
        decimate=cmd.decimate,
        taps=cmd.size,
        deviation=cmd.deviation,
        audio_bandwidth=cmd.audio_lowpass,
        audio_decimate=cmd.audio_decimate,
        audio_taps=cmd.audio_size,
        audio_rate=cmd.audio_rate,
    )
    t0 = time.perf_counter()
    rate, audio = demod.demodulate(src, mesh=_make_mesh(cmd.mesh))
    secs = time.perf_counter() - t0
    meter_out = _emit_audio(cmd, rate, audio)
    dev = np.float32(cmd.deviation)
    peak = float(np.max(np.abs(audio)) * dev) if len(audio) else 0.0
    rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64))) * dev) if len(audio) else 0.0
    print(
        f"fm: {len(audio)} audio samples @ {rate} Hz "
        f"({len(audio) / rate:.3f} s), peak deviation {peak:.0f} Hz, "
        f"rms {rms:.0f} Hz, {src.length / max(secs, 1e-9) / 1e6:.1f} Msps",
        file=meter_out,
    )
    return 0


def run_am(cmd: argmod.AmCmd) -> int:
    """Demodulate an AM capture to audio (modulation-depth units):
    write mono LE f32 (``-out``) or print a modulation-meter summary."""
    import time

    from quadrs_tpu.models.demod import AmDemod

    src = _cmd_source(cmd)
    demod = AmDemod(
        center=cmd.shift,
        bandwidth=cmd.lowpass,
        decimate=cmd.decimate,
        taps=cmd.size,
        audio_bandwidth=cmd.audio_lowpass,
        audio_decimate=cmd.audio_decimate,
        audio_taps=cmd.audio_size,
        audio_rate=cmd.audio_rate,
    )
    t0 = time.perf_counter()
    rate, audio = demod.demodulate(src, mesh=_make_mesh(cmd.mesh))
    secs = time.perf_counter() - t0
    meter_out = _emit_audio(cmd, rate, audio)
    peak = float(np.max(np.abs(audio))) if len(audio) else 0.0
    rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64)))) if len(audio) else 0.0
    print(
        f"am: {len(audio)} audio samples @ {rate} Hz "
        f"({len(audio) / rate:.3f} s), peak modulation {peak:.3f}, "
        f"rms {rms:.3f}, {src.length / max(secs, 1e-9) / 1e6:.1f} Msps",
        file=meter_out,
    )
    return 0


def run_info(cmd: argmod.InfoCmd) -> int:
    """Per-capture statistics (``quadjax info``): the ``soxi`` of IQ
    files.  Prints format/rate/length from the header math plus the
    device-reduced signal stats of :func:`quadrs_tpu.sinks.capture_info`
    — DC offset (a direct-conversion tuner's center spike; ``dcblock``
    removes it), RMS/peak/crest, the circularity ratio (the IQ-image
    indicator ``iqbal`` corrects: image level in dB is ``|rho|/2``),
    and the raw-code clipping fraction (components at a rail — gain
    too hot)."""
    import time

    from quadrs_tpu.sinks import capture_info

    def db(x: float) -> str:
        import math

        return f"{20.0 * math.log10(max(x, 1e-30)):.1f} dB"

    t0 = time.perf_counter()
    total = 0
    for name in cmd.filenames:
        src = open_capture(name, cmd.sample_rate, cmd.format)
        i = capture_info(src, chunk=cmd.chunk, limit=cmd.limit)
        total += i.analyzed
        scope = (
            "" if i.analyzed == i.samples
            else f" (stats over the first {i.analyzed})"
        )
        print(
            f"{name}: {i.format.value}, {i.sample_rate} Hz, "
            f"{i.samples} samples, {i.bytes} bytes, {i.seconds:.3f} s{scope}"
        )
        dc_rel = abs(i.dc) / max(i.rms, 1e-30)
        print(
            f"  dc {i.dc.real:+.5g}{i.dc.imag:+.5g}j"
            f" (|dc|/rms {db(dc_rel)})   rms {i.rms:.5g}   "
            f"peak {i.peak:.5g} (crest {db(i.peak / max(i.rms, 1e-30))})"
        )
        clip = (
            "n/a (float format)" if i.clipped is None
            else f"{100.0 * i.clipped:.4g}% of components"
        )
        print(
            f"  iq image |rho|/2 {abs(i.rho) / 2.0:.4g}"
            f" ({db(abs(i.rho) / 2.0)} image)   clipped: {clip}"
        )
    dt = max(time.perf_counter() - t0, 1e-9)
    print(
        f"info: {len(cmd.filenames)} files, {total} samples, "
        f"{dt:.2f}s, {total / dt / 1e6:.0f} Msps"
    )
    return 0


def run_replay(cmd: argmod.ReplayCmd) -> int:
    """Stream a capture's raw bytes to stdout paced at its sample rate
    (``quadjax replay``): the producer side of the live-pipe story —
    any ``-stdin`` consumer can be exercised against a recorded
    capture exactly as it would run against a radio.  Bytes are the
    file's own (no decode), so the consumer sees the identical wire
    format; pacing writes ``-chunk`` samples then sleeps to the global
    schedule (cumulative, so jitter does not accumulate).  Stats go to
    stderr — stdout IS the data stream."""
    import sys
    import time

    src = open_capture(cmd.filename, cmd.sample_rate, cmd.format)
    if not hasattr(src, "raw_bytes"):
        raise ValueError("replay needs a seekable capture file")
    out = sys.stdout.buffer
    total = 0
    t0 = time.perf_counter()
    try:
        for _ in range(cmd.loop):
            off = 0
            while off < src.length:
                n = min(cmd.chunk, src.length - off)
                out.write(src.raw_bytes(off, off + n))
                off += n
                total += n
                if cmd.speed > 0:
                    due = t0 + total / (src.sample_rate * cmd.speed)
                    delay = due - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
        out.flush()
    except BrokenPipeError:
        # the consumer closed its end (e.g. piped into `head` or a
        # -chunks-bounded run): stop quietly, and point stdout at
        # devnull so interpreter shutdown doesn't re-raise on flush
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    dt = max(time.perf_counter() - t0, 1e-9)
    print(
        f"replay: {total} samples, {dt:.2f}s, {total / dt / 1e6:.1f} Msps",
        file=sys.stderr,
    )
    return 0


def run_channelize(cmd: argmod.ChannelizeCmd) -> int:
    """Split a capture into K channels in one polyphase-bank pass:
    write each selected channel as ``{prefix}.ch{k}.sr{rate}.cf32``
    (``-out``), or print a per-channel RMS meter."""
    import time

    from quadrs_tpu.models.channelizer import Channelize, run_channelize as run_bank

    src = _cmd_source(cmd)
    chan = Channelize(
        src, cmd.channels, frequency=cmd.frequency, size=cmd.size
    )
    k = chan.channels
    select = tuple(range(k)) if cmd.select is None else cmd.select
    rate = chan.sample_rate

    def center(ch: int) -> int:
        # DFT-bin order: the upper half aliases to negative frequencies
        return ch * src.sample_rate // k if ch < (k + 1) // 2 else (
            (ch - k) * src.sample_rate // k
        )

    files = {}
    sumsq = np.zeros(k, dtype=np.float64)
    n_out = 0
    t0 = time.perf_counter()
    try:
        if cmd.out is not None:
            for ch in select:
                name = f"{cmd.out}.ch{ch}.sr{rate}.cf32"
                files[ch] = open(name, "wb" if cmd.overwrite else "xb")
        for piece in run_bank(chan, chunk=cmd.chunk, mesh=_make_mesh(cmd.mesh)):
            n_out = piece.start + piece.data.shape[1]
            sumsq += np.sum(
                np.square(piece.data.real, dtype=np.float64)
                + np.square(piece.data.imag, dtype=np.float64),
                axis=1,
            )
            for ch, fh in files.items():
                row = piece.data[ch]
                pair = np.empty((len(row), 2), dtype="<f4")
                pair[:, 0] = row.real
                pair[:, 1] = row.imag
                fh.write(pair.tobytes())
    finally:
        for fh in files.values():
            fh.close()
    secs = time.perf_counter() - t0
    rms = np.sqrt(sumsq / max(n_out, 1))
    for ch in select:
        line = f"channel {ch}: center {center(ch)} Hz, rms {rms[ch]:.6g}"
        if cmd.out is not None:
            line += f", wrote {cmd.out}.ch{ch}.sr{rate}.cf32"
        print(line)
    print(
        f"channelize: {k} channels @ {rate} Hz, {n_out} samples each, "
        f"{secs:.2f}s, {src.length / max(secs, 1e-9) / 1e6:.1f} Msps"
    )
    return 0


def run_ssb(cmd: argmod.SsbCmd) -> int:
    """Demodulate a single-sideband capture to audio (usb/lsb)."""
    import time

    from quadrs_tpu.models.demod import SsbDemod

    src = _cmd_source(cmd)
    demod = SsbDemod(
        center=cmd.shift,
        sideband=cmd.sideband,
        bandwidth=cmd.bandwidth,
        decimate=cmd.decimate,
        taps=cmd.size,
        audio_bandwidth=cmd.audio_lowpass,
        audio_decimate=cmd.audio_decimate,
        audio_taps=cmd.audio_size,
        audio_rate=cmd.audio_rate,
    )
    t0 = time.perf_counter()
    rate, audio = demod.demodulate(src, mesh=_make_mesh(cmd.mesh))
    secs = time.perf_counter() - t0
    meter_out = _emit_audio(cmd, rate, audio)
    peak = float(np.max(np.abs(audio))) if len(audio) else 0.0
    rms = float(np.sqrt(np.mean(np.square(audio, dtype=np.float64)))) if len(audio) else 0.0
    print(
        f"ssb: {len(audio)} audio samples @ {rate} Hz "
        f"({len(audio) / rate:.3f} s, {cmd.sideband}), peak {peak:.3f}, "
        f"rms {rms:.3f}, {src.length / max(secs, 1e-9) / 1e6:.1f} Msps",
        file=meter_out,
    )
    return 0


def _make_serve_demod(cmd: argmod.ServeCmd):
    """The demod model behind ``serve -mode ook|fsk`` (built once at
    startup; the jitted chain it drives is shared by shapes across
    connections like the stream/waterfall modes)."""
    if cmd.mode == "ook":
        from quadrs_tpu.models.demod import OokDemod

        return OokDemod(
            width=cmd.fft_width,
            stride=cmd.stride if cmd.stride is not None else 2,
            threshold=cmd.threshold,
            samples_per_bit=cmd.bit if cmd.bit is not None else 8.0,
        )
    if cmd.mode == "am":
        from quadrs_tpu.models.demod import AmDemod

        return AmDemod(
            center=cmd.shift,
            bandwidth=cmd.lowpass,
            decimate=cmd.decimate,
            taps=cmd.size,
            audio_bandwidth=cmd.audio_lowpass,
            audio_decimate=cmd.audio_decimate,
            audio_taps=cmd.audio_size,
            audio_rate=cmd.audio_rate,
        )
    if cmd.mode == "fm":
        from quadrs_tpu.models.demod import FmDemod

        return FmDemod(
            center=cmd.shift,
            bandwidth=cmd.lowpass,
            decimate=cmd.decimate,
            taps=cmd.size,
            deviation=cmd.deviation,
            audio_bandwidth=cmd.audio_lowpass,
            audio_decimate=cmd.audio_decimate,
            audio_taps=cmd.audio_size,
            audio_rate=cmd.audio_rate,
        )
    if cmd.mode == "ssb":
        from quadrs_tpu.models.demod import SsbDemod

        return SsbDemod(
            center=cmd.shift,
            sideband=cmd.sideband,
            bandwidth=cmd.bandwidth,
            decimate=cmd.decimate,
            taps=cmd.size,
            audio_bandwidth=cmd.audio_lowpass,
            audio_decimate=cmd.audio_decimate,
            audio_taps=cmd.audio_size,
            audio_rate=cmd.audio_rate,
        )
    if cmd.mode == "psk":
        from quadrs_tpu.models.demod import PskDemod

        return PskDemod(
            center=cmd.shift,
            bandwidth=cmd.lowpass,
            decimate=cmd.decimate,
            taps=cmd.size,
            symbol_rate=cmd.symbol_rate,
            order=cmd.order,
            differential=cmd.differential,
            block=cmd.block,
        )
    from quadrs_tpu.models.demod import FskDemod

    return FskDemod(
        center=cmd.shift,
        bandwidth=cmd.lowpass,
        decimate=cmd.decimate,
        taps=cmd.size,
        fft_width=cmd.fft_width,
        stride=cmd.stride,
        samples_per_symbol=1.0 if cmd.bit is None else cmd.bit,
    )


def _demod_connection(
    conn, demod, cmd: argmod.ServeCmd, fmt, sample_rate: int, mesh=None
) -> RunStats:
    """One demod session: the client sends its whole burst and
    half-closes; the server buffers it (same 1 GiB cap as
    ``ook -stdin``), demodulates, and sends the bits text back —
    exactly the lines the ``ook``/``fsk`` commands print, so a shell
    client can swap ``quadjax ook FILE`` for
    ``... | nc host port`` and parse nothing new."""
    import time

    from quadrs_tpu.sources import SampleSource

    rf = conn.makefile("rb")
    wf = conn.makefile("wb")
    try:
        data = rf.read(_STDIN_BUFFER_CAP + 1)
        if len(data) > _STDIN_BUFFER_CAP:
            msg = (
                "connection burst exceeds the demod buffer cap (1 GiB); "
                "demod modes buffer the whole burst — use -mode "
                "stream/waterfall for unbounded streams"
            )
            try:
                wf.write(f"# error: {msg}\n".encode())
                wf.flush()
            except OSError:
                pass
            raise ValueError(msg)
        src = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, sample_rate)
        t0 = time.perf_counter()
        try:
            return _demod_reply(wf, demod, cmd, src, t0, mesh=mesh)
        except ValueError as e:
            # a bad burst (empty, shorter than the filter/window) is a
            # client mistake, not a daemon fault: answer with the error
            # so a shell client sees WHY instead of silence, and keep
            # the session "served" (the accept loop logs stats, not a
            # failure)
            wf.write(f"# error: {e}\n".encode())
            wf.flush()
            return RunStats(
                samples_in=src.length,
                windows_out=0,
                seconds=time.perf_counter() - t0,
            )
    finally:
        try:
            wf.close()
        except OSError:
            pass
        finally:
            rf.close()


def _demod_reply(
    wf, demod, cmd: argmod.ServeCmd, src, t0, mesh=None
) -> RunStats:
    """Demodulate one buffered burst and write the bits text; split
    from :func:`_demod_connection` so burst-validation errors can be
    answered over the socket."""
    import time

    if cmd.mode in ("fm", "am", "ssb"):
        # audio is binary: a self-describing header line gives the
        # client the exact byte count before the f32 payload, then the
        # stats trailer closes the session like the other demod modes
        rate, audio = demod.demodulate(src, mesh=mesh)
        wf.write(f"# {cmd.mode} {len(audio)} {rate}\n".encode())
        wf.write(audio.astype("<f4").tobytes())
        wf.write(
            f"\n# {cmd.mode}: {len(audio)} audio samples @ {rate} Hz\n".encode()
        )
        wf.flush()
        return RunStats(
            samples_in=src.length,
            windows_out=len(audio),
            seconds=time.perf_counter() - t0,
        )
    if cmd.mode == "psk":
        est, bits = demod.demodulate(src, mesh=mesh)
        line = "".join(map(str, bits))
        n_out = len(bits)
        trailer = (
            f"psk: {len(bits)} bits, freq {est.freq_hz:+.1f} Hz, "
            f"phase {est.phase:+.3f} rad, tau {est.tau:.2f}, sps {est.sps:g}"
        )
    elif cmd.mode == "ook":
        from quadrs_tpu.models.demod import manchester_decode

        err, raw_bits = demod.demodulate(src, mesh=mesh)
        if cmd.raw:
            line = "".join("1" if b else "0" for b in raw_bits)
        else:
            line = "".join(str(b) for b in manchester_decode(raw_bits))
        n_out = len(raw_bits)
        trailer = f"ook: {len(raw_bits)} raw bits, clock error {err:.3f}"
    elif cmd.bit is None:
        syms = demod.symbols(src, mesh=mesh)
        line = "".join(str(int(s)) for s in syms)
        n_out = len(syms)
        trailer = f"fsk: {len(syms)} symbols"
    else:
        err, bits = demod.demodulate(src, mesh=mesh)
        line = "".join("1" if b else "0" for b in bits)
        n_out = len(bits)
        trailer = f"fsk: {len(bits)} bits, clock error {err:.3f}"
    wf.write(f"{line}\n# {trailer}\n".encode())
    wf.flush()
    return RunStats(
        samples_in=src.length,
        windows_out=n_out,
        seconds=time.perf_counter() - t0,
    )


def _serve_connection(
    conn, model, cmd: argmod.ServeCmd, sample_rate: int, mesh=None
) -> RunStats:
    """One client session: raw IQ bytes in, results streamed back over
    the same socket as each chunk completes.

    The client sends its capture, half-closes its write side
    (``shutdown(SHUT_WR)``) to mark EOF, and reads to the server's
    close — and it must read CONCURRENTLY with sending: results stream
    back as each chunk completes, so once they exceed the in-flight
    socket buffering a non-reading client stalls the server's write,
    which stalls the chunk loop, which stops the server reading — a
    deadlock on both sides.  That bites norms mode almost immediately
    (~width*4/decimate bytes per input sample) and search mode on any
    capture whose CSV outgrows the buffers.  ``-search yes`` returns
    ``window,bin,mag`` CSV text plus a ``# <mode>: ...`` stats
    trailer; otherwise raw f32 norms rows."""
    from quadrs_tpu.sources import PipeSource
    from quadrs_tpu.stream_runner import StreamRunner, WaterfallRunner

    waterfall = cmd.mode in ("waterfall", "scan")
    rf = conn.makefile("rb")
    wf = conn.makefile("wb")
    try:
        src = PipeSource(rf, model.cfg.fmt, sample_rate)
        # a socket is a live pipe: with a mesh the runner wraps it in
        # the sliding facade and time-shards each chunk (the sharded
        # steps are memoized on the model, so connections share one
        # compiled program)
        if waterfall:
            runner = WaterfallRunner(
                [src], model, chunk_windows=cmd.chunk, mesh=mesh
            )
        else:
            runner = StreamRunner(src, model, chunk_samples=cmd.chunk, mesh=mesh)
        if cmd.mode == "scan":
            # band survey: the reduction streams on device; the reply is
            # one small CSV at EOF (bin,freq_hz,avg,max,above,occupancy)
            result = runner.run_scan(threshold=cmd.threshold)
            width = model.cfg.fft_width
            freq = (np.arange(width) - width // 2) * (sample_rate / width)
            wf.writelines(
                ln.encode() for ln in _scan_csv_lines(result, 0, freq)
            )
            stats = result.stats
            wf.write(
                f"# {_stats_line('scan', stats)} "
                f"({result.windows} windows, threshold {cmd.threshold:g})\n".encode()
            )
        elif cmd.search:
            wf.write(b"window,bin,mag\n")

            def on_peaks(w0, out):
                idx, val = out
                if waterfall:  # (1, nw) bank shapes -> flat
                    idx, val = idx[0], val[0]
                wf.write(
                    "".join(
                        f"{w0 + i},{int(idx[i])},{float(val[i]):.9g}\n"
                        for i in range(len(idx))
                    ).encode()
                )
                wf.flush()

            stats = runner.run_search(on_peaks)
            wf.write(f"# {_stats_line(cmd.mode, stats)}\n".encode())
        else:

            def on_windows(w0, norms):
                if waterfall:
                    norms = norms[0]
                wf.write(np.ascontiguousarray(norms, dtype=np.float32).tobytes())
                wf.flush()

            stats = runner.run(on_windows)
        wf.flush()
    finally:
        # a client gone before the final flush shouldn't mask a
        # completed run or leak the read half
        try:
            wf.close()
        except OSError:
            pass
        finally:
            rf.close()
    return stats


def _find_connection(
    conn, patterns, cmd: argmod.ServeCmd, fmt, sample_rate: int, mesh=None
) -> RunStats:
    """One matched-filter session: the connection's byte stream runs
    through :func:`quadrs_tpu.sinks.find_pattern` as a live pipe
    (O(chunk) memory — no whole-burst buffering), and the matches come
    back at EOF as exactly the lines ``find -stdin`` prints.

    With ``-mesh Tx1`` the burst is buffered whole instead (the demod
    modes' 1 GiB cap) and the correlation time-shards across the device
    mesh with the ``l-1`` halo over the interconnect (``find_pattern(mesh=...)``)."""
    import time

    from quadrs_tpu import sinks
    from quadrs_tpu.sources import LivePipeStream, PipeSource, SampleSource

    rf = conn.makefile("rb")
    wf = conn.makefile("wb")
    t0 = time.perf_counter()
    try:
        if mesh is not None:
            data = rf.read(_STDIN_BUFFER_CAP + 1)
            if len(data) > _STDIN_BUFFER_CAP:
                msg = (
                    "connection burst exceeds the buffer cap (1 GiB); "
                    "find -mesh buffers the whole burst — drop -mesh "
                    "for unbounded streams"
                )
                try:
                    wf.write(f"# error: {msg}\n".encode())
                    wf.flush()
                except OSError:
                    pass
                raise ValueError(msg)
            stream = SampleSource(
                np.frombuffer(data, dtype=np.uint8), fmt, sample_rate
            )
        else:
            stream = LivePipeStream(PipeSource(rf, fmt, sample_rate))
        try:
            res = sinks.find_pattern(
                stream,
                patterns if len(patterns) > 1 else patterns[0],
                threshold=cmd.threshold,
                chunk=cmd.chunk,
                max_matches=cmd.top if cmd.top else None,
                min_distance=cmd.distance,
                freq_tol=cmd.freq_tol,
                freq_step=cmd.freq_step,
                mesh=mesh,
            )
        except ValueError as e:
            # a bad burst (shorter than the template, degenerate
            # threshold) answers with the error, like the demod modes
            wf.write(f"# error: {e}\n".encode())
            wf.flush()
            return RunStats(
                samples_in=0, windows_out=0,
                seconds=time.perf_counter() - t0,
            )
        bank = len(patterns) > 1
        for o, s, a, f, w in zip(
            res.offsets, res.scores, res.scales, res.freqs, res.which
        ):
            line = f"{int(o)},{float(s):.4f},{float(a):.6g},{float(f):+g}"
            if bank:
                line += f",{int(w)}"
            wf.write((line + "\n").encode())
        wf.write(
            f"# find: {len(res.offsets)} matches, pattern "
            f"{res.pattern_len} samples, {res.scanned} scanned\n".encode()
        )
        wf.flush()
        return RunStats(
            samples_in=res.scanned,
            windows_out=len(res.offsets),
            seconds=time.perf_counter() - t0,
        )
    finally:
        try:
            wf.close()
        except OSError:
            pass
        finally:
            rf.close()


def run_serve(cmd: argmod.ServeCmd, ready=None, max_connections=None) -> int:
    """The persistent TCP service: compile once, serve many connections
    (sequentially by default; ``-parallel N`` runs up to N sessions
    concurrently on the shared compiled chain, and ``-mesh TxS`` shards
    each session's chunks across the device mesh — the socket is a live
    pipe, so it time-shards like ``stream -stdin -mesh``).  ``-mode
    ook|fsk`` serves the demodulators instead: each connection's burst
    is buffered whole (1 GiB cap) and answered with the bits text the
    ``ook``/``fsk`` commands print.
    ``-timeout S`` arms a per-socket-operation idle timeout on every
    accepted connection: a peer that stalls (stops sending before its
    half-close, or stops draining results) for S seconds gets its
    session dropped and logged like any other failed connection, so it
    cannot starve a ``-parallel`` slot or the sequential loop.
    ``ready(port)`` is called with the bound port once listening —
    tests bind port 0 and read it back.  A failing connection (client
    gone, bad bytes) is logged and the accept loop continues;
    ``-once yes`` exits after one connection (``max_connections``
    generalizes that for embedders/tests — the CLI itself runs until
    killed, like any daemon)."""
    import socket

    from quadrs_tpu.utils.sniff import guess_details

    details = guess_details("-", cmd.sample_rate, cmd.format)
    demod = cmd.mode in ("ook", "fsk", "psk", "fm", "am", "ssb")
    if demod:
        model = _make_serve_demod(cmd)
    elif cmd.mode == "find":
        # load the template bank once at startup; each connection's
        # socket then streams through the matched filter like a pipe
        from quadrs_tpu.sources import SampleSource
        from quadrs_tpu.utils.sniff import guess_details as sniff

        model = []
        for fname in cmd.patterns:
            psrc = SampleSource.from_file(fname, sniff(fname, None, None))
            if psrc.sample_rate != details.sample_rate:
                raise ValueError(
                    f"pattern rate {psrc.sample_rate} != -sr "
                    f"{details.sample_rate}: resample one side first"
                )
            pat, valid = psrc.read_at(0, psrc.length)
            if valid != psrc.length:
                raise RuntimeError("short read loading the pattern capture")
            model.append(pat)
    elif cmd.mode in ("waterfall", "scan"):
        from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel

        model = WaterfallModel(
            WaterfallConfig(
                n_streams=1,
                fft_width=cmd.fft_width,
                stride=cmd.stride if cmd.stride is not None else cmd.fft_width,
                fmt=details.format,
            )
        )
    else:
        from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel

        model = PipelineModel(
            PipelineConfig(
                sample_rate=details.sample_rate,
                shift_freq=cmd.shift,
                lp_freq=cmd.lowpass,
                decimate=cmd.decimate,
                taps=cmd.size,
                fft_width=cmd.fft_width,
                fmt=details.format,
            )
        )

    mesh = _make_mesh(cmd.mesh)
    srv = socket.create_server((cmd.host, cmd.port))
    port = srv.getsockname()[1]
    print(
        f"serve: listening on {cmd.host}:{port} "
        f"({details.format.name.lower()}, sr {details.sample_rate}, "
        f"{cmd.mode} "
        + ("audio" if cmd.mode in ("fm", "am", "ssb")
           else "bits" if demod
           else "survey" if cmd.mode == "scan"
           else "matches" if cmd.mode == "find"
           else "search" if cmd.search else "norms")
        + (f", mesh {cmd.mesh[0]}x{cmd.mesh[1]}" if cmd.mesh else "")
        + (f", parallel {cmd.parallel}" if cmd.parallel > 1 else "")
        + (f", timeout {cmd.timeout:g}s" if cmd.timeout > 0 else "")
        + ")",
        flush=True,
    )
    if ready is not None:
        ready(port)
    if cmd.once:
        max_connections = 1

    def handle(n_conn: int, conn, peer) -> None:
        try:
            if cmd.timeout > 0:
                # idle timeout: any single blocked recv/send past this
                # raises TimeoutError, which the catch-all below turns
                # into a logged failure + close — a stalled client
                # (sends nothing, or stops draining its results) frees
                # its -parallel slot (or the sequential accept loop)
                # instead of holding it forever.  The clock is per
                # socket operation, so a slow-but-flowing client is
                # never killed.
                conn.settimeout(cmd.timeout)
            if demod:
                stats = _demod_connection(
                    conn, model, cmd, details.format, details.sample_rate,
                    mesh,
                )
            elif cmd.mode == "find":
                stats = _find_connection(
                    conn, model, cmd, details.format, details.sample_rate,
                    mesh,
                )
            else:
                stats = _serve_connection(
                    conn, model, cmd, details.sample_rate, mesh
                )
            print(
                f"serve: conn {n_conn} {peer[0]}:{peer[1]} "
                + _stats_line("done", stats),
                flush=True,
            )
        except Exception as e:  # a daemon survives any one session:
            # client gone, bad bytes, even a transient device error
            # (XlaRuntimeError) must not drop future connections
            print(f"serve: conn {n_conn} failed: {type(e).__name__}: {e}", flush=True)
        finally:
            conn.close()

    n_conn = 0
    try:
        if cmd.parallel > 1:
            # concurrent sessions: each connection runs on a pool
            # thread (its runner stages on its own background thread;
            # jitted dispatch is thread-safe and the compiled chain is
            # shared, so sessions interleave on the device)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=cmd.parallel) as pool:
                while True:
                    conn, peer = srv.accept()
                    n_conn += 1
                    pool.submit(handle, n_conn, conn, peer)
                    if max_connections is not None and n_conn >= max_connections:
                        break
                # the with-block joins: every dispatched session finishes
        else:
            while True:
                conn, peer = srv.accept()
                n_conn += 1
                handle(n_conn, conn, peer)
                if max_connections is not None and n_conn >= max_connections:
                    break
    finally:
        srv.close()
    return 0


RUNNERS = {
    argmod.StreamCmd: run_stream,
    argmod.WaterfallCmd: run_waterfall,
    argmod.ScanCmd: run_scan,
    argmod.OokCmd: run_ook,
    argmod.FskCmd: run_fsk,
    argmod.PskCmd: run_psk,
    argmod.FmCmd: run_fm,
    argmod.AmCmd: run_am,
    argmod.SsbCmd: run_ssb,
    argmod.ChannelizeCmd: run_channelize,
    argmod.InfoCmd: run_info,
    argmod.ReplayCmd: run_replay,
    argmod.ServeCmd: run_serve,
}
