"""Command-line entry point: ``quadjax`` / ``python -m quadrs_tpu``.

Mirrors ``src/bin/quadrs.rs``: parse argv into commands, print usage on
error or when empty, then fold the commands over the stream accumulator.
The ``ui``/``eui`` commands render waterfall images to files instead of
opening OpenGL windows (an accelerator host has no display; the
renderers reproduce the reference GUIs' colormaps — see
:mod:`quadrs_tpu.viz`).
"""

from __future__ import annotations

import sys

from quadrs_tpu import args as argmod
from quadrs_tpu.pipeline import exec_operation

USAGE = """\
usage: {us} \\
    from [-sr SAMPLE_RATE] [-format cf32|cs8|cu8|cs16] FILENAME.sr32k.cf32 \\
   shift [-]FREQUENCY \\
 lowpass [-power 20] [-decimate 8] FREQUENCY \\
resample [-power 8] [-size N] UP/DOWN [rational rate conversion, e.g. 3/2 or 147/160] \\
 dcblock [-window 32k] [subtract the trailing-window mean: kills a tuner's DC spike] \\
     agc [-target 1] [-window 4k] [-max-gain 1k] [normalize trailing-window RMS to target] \\
   iqbal [-c RE:IM] [-est 256k] [IQ-imbalance image cancel; -c explicit, else blind-estimated] \\
sparkfft [-width 128] [-stride =width] [-range LOW:HIGH] \\
  bucket [-width 128] [-stride =width] [-by freq] COUNT \\
    find [-pattern FILE.srR.cf32]+ [-threshold 0.5] [-top 0 (all)] [-distance =patlen] \\
         [-freq-tol HZ (also search a carrier-offset grid)] [-freq-step =0.4*sr/patlen] \\
         [matched filter: find every occurrence of the pattern(s) in the stream by \\
          gain/phase-invariant normalized correlation; prints offset,score,scale,freq \\
          (repeated -pattern = a sync-word bank; lines then add the winning template)] \\
         [-stdin no] [-sr R] [-format F] [search a live pipe with O(chunk) memory: \\
          rtl_sdr - | {us} find -pattern sync.sr2M.cf32 -stdin yes -sr 2M -format cu8] \\
         [-write PREFIX] [-pre 0] [-post 0] [-overwrite no] [save each match as a \\
          re-from-able slice of the ORIGINAL capture, widened by pre/post samples — \\
          preamble-triggered packet extraction, span-mapped through the chain] \\
   write [-overwrite no] [-format cf32|cs8|cu8|cs16 (quantize; default cf32)] FILENAME_PREFIX \\
     gen [-cos FREQUENCY]* [-len 1 (second)] [-noise 0 (sigma/component, seeded)] [-seed 0] SAMPLE_RATE \\
      ui [-fft 8] [-stretch 4] [-stride 4] [-frames 1] [renders waterfall to ui.png] \\
         [-live no] [-rows N] [-cols N] [live: stream ANSI waterfall to the terminal; \\
          keys: +/- fft width, [/] stride, q quit] \\
         [-stdin no] [-sr R] [-format F] [live waterfall off a pipe, like eui] \\
     eui [-start 46] [-end 46.3] [-fft 512] [-frames 1] [FILENAME] [renders to eui.png] \\
         [-live no] [-stride =fft] [-rows N] [-cols N] [live: blue ANSI waterfall] \\
         [-stdin no] [-sr R] [-format F] [live waterfall off a pipe: rtl_sdr - | {us} eui -live yes -stdin yes ...] \\
  stream [-shift 0] [-lowpass 200k] [-power 200] [-decimate 32] [-width 64] \\
         [-chunk 4M] [-chunks N] [-search no] [-out PREFIX] [-mesh TxS] \\
         [-scan no] [-threshold 0] [-top 20] [-db no] [scan: band survey of the \\
          decimated channel — per-bin avg/max power + occupancy, absolute Hz] \\
         [-trigger LEVEL] [-pre 1] [-post 1] [burst recorder: write each span where \\
          the channel peak exceeds LEVEL as a re-from-able slice of the capture; \\
          works on live pipes too (-stdin): a rolling raw-byte ring writes each \\
          burst as it resolves, byte-identical to the file run] \\
         [-stdin no] FILENAME [live pipe: rtl_sdr - | {us} stream -stdin yes -sr 2M -format cu8] \\
waterfall [-width 1024] [-stride =width] [-window rectangular] [-chunk 2k] \\
         [-chunks N] [-search no] [-out PREFIX] [-mesh TxS] [-stdin no] FILENAME... \\
  replay [-speed 1 (0 = unthrottled)] [-loop 1] [-chunk 64k] [-sr R] [-format F] FILENAME \\
         [stream the raw capture bytes to stdout paced at the sample rate — a recorded \\
          stand-in for the radio: {us} replay cap.sr2M.cu8 | {us} stream -stdin yes ...] \\
    info [-chunk 4M] [-limit N] [-sr R] [-format F] FILENAME... [capture statistics: \\
         format/rate/length + device-reduced dc offset, rms/peak/crest, IQ-image \\
         level (what iqbal corrects), raw-code clipping fraction] \\
    scan [-width 1024] [-stride =width] [-window rectangular] [-chunk 2k] [-chunks N] \\
         [-threshold 0 (occupancy level)] [-top 20] [-db no] [-out PREFIX (full \\
         per-bin CSV)] [-plot no (render .sK.png survey plots)] [-overwrite no] \\
         [-mesh TxS] [-stdin no] FILENAME... \\
         [band survey: per-bin avg/max power + occupancy over every window] \\
   serve [-port 7373] [-host 127.0.0.1] [-once no] [-search no] [-shift 0] [-lowpass 200k] \\
         [-power 200] [-decimate 32] [-width 64] [-chunk 4M] -sr R -format F \\
         [-mode stream|waterfall|scan|ook|fsk|psk|fm|am|ssb|find] [-stride =width] [waterfall: \\
          the raw fused spectrogram; scan: the per-bin band-survey CSV, -threshold as in scan; \\
          find: stream the connection through the matched filter ([-pattern FILE]+, \\
          -threshold/-top/-distance/-freq-tol as in find; matches back at EOF)] \\
         [ook/fsk/psk/fm/am: demod-as-a-service — send the burst, read back the bits (or, \\
          fm/am: a "# MODE N RATE" header + N f32 audio samples); -threshold/-bit/-raw/ \\
          -deviation/-audio-*/-sideband/-bandwidth/-symbol-rate/-order as in the matching \\
          demod commands] \\
         [-mesh TxS] [-parallel 1] [-timeout 0 (seconds; drop a connection idle \\
          that long — stalled peers can't hold a slot)] [mesh: shard each connection \\
          across chips; parallel: serve N connections concurrently on the shared chain] \\
         [TCP service: compile once, then each connection streams IQ in, results out] \\
     ook [-width 4] [-stride 2] [-threshold 0.001] [-bit 8] [-raw no] [-stdin no] [-mesh T] FILENAME \\
     fsk [-shift 0] [-lowpass 200k] [-power 200] [-decimate 32] [-width 64] [-stride S] [-bit N] [-stdin no] [-mesh T] FILENAME \\
     psk [-shift 0] [-lowpass 200k] [-power 200] [-decimate 32] -symbol-rate HZ \\
         [-order 2 (BPSK; 4 = QPSK, Gray 00 01 11 10)] [-differential yes] \\
         [-block 0 (re-estimate the carrier every N baseband samples: \\
          tracks drifting crystals; 0 = one whole-burst estimate)] \\
         [-plot FILE.png (render the synchronized constellation)] [-overwrite no] \\
         [-stdin no] [-mesh T] FILENAME [block-coherent: per-burst carrier + timing, no PLL] \\
      fm [-shift 0] [-lowpass 100k] [-power 200] [-decimate 8] [-deviation 75k] \\
         [-audio-lowpass HZ] [-audio-decimate 1] [-audio-power 32] [-audio-rate HZ] \\
         [-out PREFIX (writes PREFIX.srR.f32 mono audio; '-': stream to stdout, e.g. | aplay)] \\
         [-wav no (write PREFIX.wav instead)] \\
         [-overwrite no] [-stdin no] [-mesh T (time-shard the channel chain over the \\
          device mesh; all demods take it)] FILENAME \\
      am [-shift 0] [-lowpass 10k] [-power 200] [-decimate 8] \\
         [-audio-lowpass HZ] [-audio-decimate 1] [-audio-power 32] [-audio-rate HZ] \\
         [-out PREFIX] [-wav no] [-overwrite no] [-stdin no] [-mesh T] FILENAME [audio = envelope/carrier - 1] \\
     ssb [-shift 0] [-sideband usb|lsb] [-bandwidth 3k] [-power 200] [-decimate 8] \\
         [-audio-lowpass HZ] [-audio-decimate 1] [-audio-power 32] [-audio-rate HZ] \\
         [-out PREFIX|-] [-wav no] [-overwrite no] [-stdin no] [-mesh T] FILENAME \\
         [single-sideband to audio; -shift -CARRIER_OFFSET brings the carrier to DC] \\
channelize [-channels 8] [-power 20] [-freq =sr/2K] [-chunk 256k] [-select 0,3,..] \\
         [-out PREFIX (writes PREFIX.chK.srR.cf32 per channel)] [-overwrite no] \\
         [-stdin no] [-mesh T] FILENAME [polyphase filter bank: every channel in \\
          one pass; channel k = shift -k*sr/K + lowpass -decimate K] \\


Formats:

 * cf32: complex (little endian) floats, 32-bit (GNU-Radio, gqrx)
 *  cs8: complex      signed (integers),  8-bit (HackRF)
 *  cu8: complex    unsigned (integers),  8-bit (RTL-SDR)
 * cs16: complex      signed (integers), 16-bit (Fancy)
"""


def _serve_types() -> tuple:
    return (
        argmod.StreamCmd,
        argmod.WaterfallCmd,
        argmod.ScanCmd,
        argmod.OokCmd,
        argmod.FskCmd,
        argmod.PskCmd,
        argmod.FmCmd,
        argmod.AmCmd,
        argmod.SsbCmd,
        argmod.ChannelizeCmd,
        argmod.InfoCmd,
        argmod.ReplayCmd,
        argmod.ServeCmd,
    )


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    us = "quadjax"
    from quadrs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    try:
        commands = argmod.parse(argv)
    except ValueError as e:
        print(USAGE.format(us=us))
        print(f"Error: {e}", file=sys.stderr)
        return 1

    if not commands:
        print(USAGE.format(us=us))
        print("Error: no commands provided", file=sys.stderr)
        return 1

    stream = None
    try:
        for command in commands:
            if type(command) in _serve_types():
                from quadrs_tpu import serve

                rc = serve.RUNNERS[type(command)](command)
                if rc:
                    return rc
            elif isinstance(command, argmod.Octagon):
                from quadrs_tpu.pipeline import FindOp

                if isinstance(command.op, FindOp) and command.op.stdin:
                    # find -stdin searches a live pipe directly (the
                    # accumulator, if any, is untouched — like ui/eui
                    # -live -stdin); matches print at EOF
                    from quadrs_tpu.serve import _stdin_pipe_source
                    from quadrs_tpu.sources import LivePipeStream

                    exec_operation(
                        command.op,
                        LivePipeStream(_stdin_pipe_source(command.op)),
                    )
                else:
                    stream = exec_operation(command.op, stream)
            elif isinstance(command, argmod.Ui):
                from quadrs_tpu.viz.waterfall import (
                    UiParams,
                    ui_render_file,
                    ui_render_frames,
                )

                if command.live and command.stdin:
                    # live pipe directly (mirrors eui -live -stdin); the
                    # accumulator, if any, is untouched
                    from quadrs_tpu.serve import _stdin_pipe_source
                    from quadrs_tpu.sources import LivePipeStream

                    ui_input = LivePipeStream(_stdin_pipe_source(command))
                elif stream is None:
                    print("Error: ui requires an input", file=sys.stderr)
                    return 1
                else:
                    ui_input = stream
                if command.live:
                    from quadrs_tpu.viz.live import LiveParams, live_waterfall

                    stats = live_waterfall(
                        ui_input,
                        LiveParams(
                            fft_width=command.fft_width,
                            stride=command.stride,
                            cols=command.cols,
                            max_rows=command.rows,
                        ),
                    )
                    print(
                        f"live: {stats['rows']} rows, fft {stats['fft_width']}, "
                        f"stride {stats['stride']}"
                    )
                    if not command.stdin:
                        stream = None  # ui takes the samples (samples.take())
                    continue
                params = UiParams(
                    fft_width=command.fft_width,
                    stretch=command.stretch,
                    stride=command.stride,
                )
                if command.frames > 1:
                    for path in ui_render_frames(stream, command.frames, params=params):
                        print(f"wrote {path}")
                else:
                    path = ui_render_file(stream, params=params)
                    print(f"wrote {path}")
                stream = None  # the reference's ui takes the samples (samples.take())
            elif isinstance(command, argmod.Eui):
                from quadrs_tpu.viz.waterfall import (
                    EuiParams,
                    eui_render_file,
                    eui_render_frames,
                )

                if command.live:
                    from quadrs_tpu.sources import SampleSource
                    from quadrs_tpu.utils.sniff import guess_details
                    from quadrs_tpu.viz.live import LiveParams, live_waterfall

                    if command.stdin:
                        # live waterfall straight off a pipe: rtl_sdr - |
                        # quadjax eui -live yes -stdin yes -sr 2M -format cu8
                        from quadrs_tpu.serve import _stdin_pipe_source
                        from quadrs_tpu.sources import LivePipeStream

                        src = LivePipeStream(_stdin_pipe_source(command))
                    elif command.filename is None:
                        print("Error: eui -live requires a filename", file=sys.stderr)
                        return 1
                    else:
                        src = SampleSource.from_file(
                            str(command.filename), guess_details(str(command.filename))
                        )
                    stats = live_waterfall(
                        src,
                        LiveParams(
                            fft_width=command.fft_width,
                            stride=command.stride or command.fft_width,
                            cols=command.cols,
                            max_rows=command.rows,
                            windowing="blackman-harris",
                            colormap="blue",
                        ),
                    )
                    print(
                        f"live: {stats['rows']} rows, fft {stats['fft_width']}, "
                        f"stride {stats['stride']}"
                    )
                    continue
                params = EuiParams(
                    start_pct=command.start_pct,
                    end_pct=command.end_pct,
                    fft_width=command.fft_width,
                )
                if command.frames > 1:
                    for path in eui_render_frames(
                        command.filename, command.frames, params=params
                    ):
                        print(f"wrote {path}")
                else:
                    path = eui_render_file(command.filename, params=params)
                    print(f"wrote {path}")
    except (ValueError, RuntimeError, OSError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
