#!/usr/bin/env python3
"""On-card smoke test: drive quadjax's main paths once, at capture sizes
users record, on one NVIDIA GPU, and hold every result to float64 numpy.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # 4 cards: stream -mesh 4x1 vs one card

Phases (one line each: name, sizes, wall time, the CLI's stats line):

* device     — the card, its power limit, the native loader
* stream     — ``quadjax stream`` over a 2^28-sample cs8 capture
               (512 MiB, 12.8 s at 21 Msps) with a planted tone
* long-fir   — the same capture through 4000 taps (spectral FIR)
* waterfall  — ``quadjax waterfall -search`` over 64 cs8 files of 2^22
               samples, then ``quadjax scan`` over one of them
* examples   — ``quadjax ook`` / ``fsk`` on the bundled captures
* precision  — the card-only float64 checks (quadrs_tpu.selfcheck)
* memory     — peak device memory of the run

Every capture is synthesized from ``--seed`` into a scratch directory.
Any failed phase raises and the script exits non-zero; the last line of
a passing run is one JSON object naming the device.  Without a GPU it
exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

RTOL = 1e-4  # |got - float64| over the peak norm of the checked windows
SR = 21_000_000  # the headline capture's rate
SHIFT = 280_000
WIDTH = 64
DECIMATE = 32
TONE_BIN = 5  # planted tone: bins above the channel centre after the shift
BANK_SR = 2_000_000
BANK_WIDTH, BANK_STRIDE = 1024, 256
SCAN_THRESHOLD = 100.0  # between the noise floor and the planted tones


@dataclasses.dataclass(frozen=True)
class Sizes:
    stream_samples: int = 1 << 28
    chunk: int = 4_000_000  # the CLI default, "4M"
    long_fir_chunks: int = 16
    bank_streams: int = 64
    bank_samples: int = 1 << 22
    precision_chunk: int = 4_000_000
    precision_bank: int = 1 << 16
    bank_chunk_windows: int = 2048  # the CLI default, "2k"


# small enough for the CPU test suite; the phases are the same code
TINY = Sizes(
    stream_samples=1 << 17,
    chunk=1 << 15,
    long_fir_chunks=2,
    bank_streams=3,
    bank_samples=1 << 13,
    precision_chunk=1 << 15,
    precision_bank=1 << 12,
    bank_chunk_windows=16,
)


def require_gpu(count: int = 1):
    """JAX's devices, if the first is a GPU and there are ``count`` of
    them; otherwise exit non-zero before any phase runs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        sys.exit(
            f"chip_smoke: needs {count} NVIDIA GPU(s); JAX found "
            f"{len(devs)} {devs[0].platform} device(s)"
        )
    return devs


def run_cli(argv: list[str]) -> list[str]:
    """``quadjax argv`` in this process; its stdout lines.  A non-zero
    exit raises with the output's tail."""
    from quadrs_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = main(argv)
    lines = buf.getvalue().splitlines()
    if rc != 0:
        tail = "\n".join(lines[-20:])
        raise RuntimeError(f"quadjax {' '.join(argv)} exited {rc}:\n{tail}")
    return lines


def stats_line(lines: list[str], cmd: str) -> str:
    return next(x for x in reversed(lines) if x.startswith(f"{cmd}: "))


def write_cs8(path: str, n: int, tone_hz: float, sr: int, amp: float, seed: int) -> None:
    """A cs8 capture of ``n`` samples: a tone of ``amp`` full scale at
    ``tone_hz`` plus uniform noise of +-30 codes, written in blocks."""
    rng = np.random.default_rng(seed)
    block = 1 << 22
    table = np.exp(2j * np.pi * tone_hz * np.arange(block) / sr)
    with open(path, "wb") as fh:
        for start in range(0, n, block):
            m = min(block, n - start)
            x = np.exp(2j * np.pi * tone_hz * start / sr) * table[:m]
            iq = np.empty((m, 2), np.float64)
            iq[:, 0], iq[:, 1] = x.real, x.imag
            codes = np.rint(127.0 * amp * iq) + rng.integers(-30, 31, (m, 2))
            fh.write(np.clip(codes, -127, 127).astype(np.int8).tobytes())


def read_planes(path: str) -> np.ndarray:
    """(2, n) int8 planes of a cs8 file, memory-mapped."""
    return np.memmap(path, dtype=np.int8, mode="r").reshape(-1, 2).T


def device_step_ms(fn, *args, reps: int = 20) -> float:
    """Median wall time of ``fn(*args)`` through ``block_until_ready``,
    after a warm-up call: the device time of one step when the device
    is the bottleneck."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def report(name: str, seconds: float, **fields) -> None:
    detail = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"phase {name}: ok {seconds:.2f}s {detail}", flush=True)


# -- phases -----------------------------------------------------------------


def phase_device(devs) -> dict:
    from quadrs_tpu.native.loader import native_available

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "not available"
    for line in smi.splitlines() or [smi]:
        print(f"nvidia-smi: {line}", flush=True)
    return {
        "platform": devs[0].platform,
        "kind": repr(devs[0].device_kind),
        "count": len(devs),
        "native_loader": "built" if native_available() else "numpy fallback",
    }


def _stream_windows(n_windows: int, per_chunk: int, rng) -> np.ndarray:
    """Every window on either side of a chunk boundary, the last window,
    and a spread of others."""
    edges = np.arange(per_chunk, n_windows, per_chunk)
    picks = np.concatenate(
        [[0, n_windows - 1], edges - 1, edges, rng.integers(0, n_windows, 64)]
    )
    return np.unique(picks)


def _check_stream(cap: str, out: str, taps: int, lines, sizes: Sizes, seed: int) -> dict:
    from quadrs_tpu.ops.fir import lowpass_taps
    from quadrs_tpu.selfcheck import stream_norms_ref
    from quadrs_tpu.formats import FileFormat

    norms = np.fromfile(f"{out}.norms.f32", dtype=np.float32).reshape(-1, WIDTH)
    planes = read_planes(cap)
    win_raw = WIDTH * DECIMATE
    per_chunk = sizes.chunk // win_raw
    windows = _stream_windows(norms.shape[0], per_chunk, np.random.default_rng(seed))
    want = stream_norms_ref(
        planes, FileFormat.COMPLEX_INT8, SR, SHIFT,
        lowpass_taps(200_000 / SR, taps), DECIMATE, WIDTH, windows,
    )
    err = float(np.max(np.abs(norms[windows] - want)) / want.max())
    if not err <= RTOL:
        raise AssertionError(f"{taps}-tap stream off float64 by {err:.3g} of peak")
    peak = int(np.argmax(norms.mean(axis=0)))
    if peak != WIDTH // 2 + TONE_BIN:
        want_bin = WIDTH // 2 + TONE_BIN
        raise AssertionError(f"planted tone at bin {want_bin}, peak at {peak}")
    return {
        "windows": norms.shape[0],
        "checked": len(windows),
        "rel_err": f"{err:.3g}",
        "peak_bin": peak,
        "stats": repr(stats_line(lines, "stream")),
    }


def phase_stream(work: str, sizes: Sizes, seed: int) -> dict:
    import jax

    from quadrs_tpu.formats import FileFormat
    from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel

    cap = os.path.join(work, "capture.sr21M.cs8")
    # after `shift 280k` the tone sits TONE_BIN bins above the centre
    tone = -SHIFT + TONE_BIN * SR / DECIMATE / WIDTH
    write_cs8(cap, sizes.stream_samples, tone, SR, 0.5, seed)
    out = os.path.join(work, "stream")
    lines = run_cli(
        ["stream", "-shift", "280k", "-lowpass", "200k", "-power", "200",
         "-decimate", "32", "-width", "64", "-chunk", str(sizes.chunk),
         "-out", out, cap]
    )
    fields = {"samples": sizes.stream_samples, "chunk": sizes.chunk}
    fields.update(_check_stream(cap, out, 400, lines, sizes, seed))

    # the two numbers that decide the fused-frontend question: the XLA
    # chain's device time per chunk and the host->device copy rate
    model = PipelineModel(PipelineConfig(fmt=FileFormat.COMPLEX_INT8))
    n = sizes.chunk // (WIDTH * DECIMATE) * WIDTH * DECIMATE + 600  # + lookahead
    host = np.ascontiguousarray(read_planes(cap)[:, :n])
    dev = jax.device_put(host)
    chunk_ms = device_step_ms(model.jit_step_stream, dev, np.float32(0.0))
    fields["xla_chunk_ms"] = f"{chunk_ms:.3f}"
    h2d = device_step_ms(jax.device_put, host, reps=10)
    fields["h2d_gbps"] = f"{host.nbytes / h2d / 1e6:.2f}"
    return fields


def phase_long_fir(work: str, sizes: Sizes, seed: int) -> dict:
    cap = os.path.join(work, "capture.sr21M.cs8")
    out = os.path.join(work, "longfir")
    lines = run_cli(
        ["stream", "-shift", "280k", "-lowpass", "200k", "-power", "2000",
         "-decimate", "32", "-width", "64", "-chunk", str(sizes.chunk),
         "-chunks", str(sizes.long_fir_chunks), "-out", out, cap]
    )
    fields = {"taps": 4000, "chunks": sizes.long_fir_chunks}
    fields.update(_check_stream(cap, out, 4000, lines, sizes, seed))
    return fields


def _bank_bin(s: int) -> int:
    return 100 + 13 * s  # distinct, away from DC (bin 512)


def phase_waterfall(work: str, sizes: Sizes, seed: int) -> dict:
    import jax

    from quadrs_tpu.formats import FileFormat
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.selfcheck import scan_ref, waterfall_norms_ref

    files = []
    for s in range(sizes.bank_streams):
        path = os.path.join(work, f"bank{s:02d}.sr2M.cs8")
        tone = (_bank_bin(s) - BANK_WIDTH // 2) * BANK_SR / BANK_WIDTH
        write_cs8(path, sizes.bank_samples, tone, BANK_SR, 0.3, seed + 1 + s)
        files.append(path)
    out = os.path.join(work, "bank")
    lines = run_cli(
        ["waterfall", "-width", str(BANK_WIDTH), "-stride", str(BANK_STRIDE),
         "-search", "yes", "-out", out, *files]
    )
    rows = np.loadtxt(f"{out}.peaks.csv", delimiter=",", skiprows=1)
    nw = (sizes.bank_samples - BANK_WIDTH) // BANK_STRIDE + 1
    if rows.shape != (sizes.bank_streams * nw, 4):
        raise AssertionError(f"peaks csv has shape {rows.shape}, want {nw} windows x streams")
    rng = np.random.default_rng(seed)
    err = 0.0
    for s, path in enumerate(files):
        mine = rows[rows[:, 0] == s]
        mine = mine[np.argsort(mine[:, 1])]
        windows = np.unique(np.concatenate([[0, nw - 1], rng.integers(0, nw, 16)]))
        want = waterfall_norms_ref(
            read_planes(path), FileFormat.COMPLEX_INT8, BANK_WIDTH, BANK_STRIDE, windows
        )
        got_bin = mine[windows, 2].astype(int)
        if not np.array_equal(got_bin, np.argmax(want, axis=-1)):
            raise AssertionError(f"stream {s}: peak bins {got_bin} != float64's")
        if not np.all(got_bin == _bank_bin(s)):
            raise AssertionError(f"stream {s}: planted tone at bin {_bank_bin(s)}")
        top = want.max(axis=-1)
        err = max(err, float(np.max(np.abs(mine[windows, 3] - top)) / top.max()))
    if not err <= RTOL:
        raise AssertionError(f"waterfall peaks off float64 by {err:.3g} of peak")
    fields = {
        "streams": sizes.bank_streams,
        "samples_per_stream": sizes.bank_samples,
        "windows_per_stream": nw,
        "rel_err": f"{err:.3g}",
        "stats": repr(stats_line(lines, "waterfall")),
    }

    # band survey of one file: avg/max/occupancy per bin vs float64
    lines = run_cli(
        ["scan", "-width", str(BANK_WIDTH), "-threshold", str(SCAN_THRESHOLD),
         "-out", os.path.join(work, "scan"), files[0]]
    )
    got = np.loadtxt(os.path.join(work, "scan.s0.scan.csv"), delimiter=",", skiprows=1)
    avg, mx, occ = scan_ref(
        read_planes(files[0]), FileFormat.COMPLEX_INT8, BANK_WIDTH, BANK_WIDTH,
        SCAN_THRESHOLD,
    )
    scan_err = max(
        float(np.max(np.abs(got[:, 2] - avg)) / avg.max()),
        float(np.max(np.abs(got[:, 3] - mx)) / mx.max()),
    )
    if not scan_err <= RTOL or not np.array_equal(got[:, 5], occ):
        raise AssertionError(f"scan off float64: rel {scan_err:.3g}, occupancy differs")
    fields["scan_rel_err"] = f"{scan_err:.3g}"
    fields["scan_stats"] = repr(stats_line(lines, "scan"))

    # the bank step's device time at one CLI chunk
    model = WaterfallModel(
        WaterfallConfig(
            n_streams=sizes.bank_streams, fft_width=BANK_WIDTH, stride=BANK_STRIDE
        )
    )
    n = sizes.bank_chunk_windows * BANK_STRIDE + BANK_WIDTH - BANK_STRIDE
    dev = jax.device_put(model.synth_raw(n, seed=seed))
    fields["xla_bank_step_ms"] = f"{device_step_ms(model.jit_step(), dev):.3f}"
    fields["xla_bank_search_ms"] = f"{device_step_ms(model.jit_search(), dev):.3f}"
    return fields


def phase_examples(root: str) -> dict:
    examples = os.path.join(root, "examples")
    ook = run_cli(["ook", "-bit", "16", os.path.join(examples, "ook-sim.sr400.cf32")])
    # Manchester preamble 00011 then the payload byte 0x18
    if "0001100011000" not in ook[0]:
        raise AssertionError(f"ook decoded {ook[0]!r}, want preamble 00011 + 0x18")
    fsk = run_cli(
        ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4", "-stride", "600",
         os.path.join(examples, "fsk-sim.sr48k.cf32")]
    )
    syms = fsk[0]
    if len(syms) < 8 or any(a == b for a, b in zip(syms, syms[1:])):
        raise AssertionError(f"fsk symbols {syms!r} do not alternate")
    return {"ook_bits": ook[0], "fsk_symbols": syms}


def phase_precision(sizes: Sizes, seed: int) -> dict:
    """The card-only float64 checks at the phase sizes, and a control: a
    plain f32 matmul left at JAX's default precision, which on a GPU
    may run as TF32 and would then miss by far more than the chains."""
    import jax
    import jax.numpy as jnp

    from quadrs_tpu.selfcheck import (
        PRECISION_RTOL,
        check_stream_precision,
        check_waterfall_precision,
        rel_err,
    )

    errs = {
        "stream": check_stream_precision(sizes.precision_chunk, seed=seed),
        "long_fir": check_stream_precision(sizes.precision_chunk, taps=4000, seed=seed),
        "waterfall": check_waterfall_precision(
            sizes.bank_streams, sizes.precision_bank, seed=seed
        ),
    }
    fields = {"rtol": PRECISION_RTOL, **{k: f"{v:.3g}" for k, v in errs.items()}}
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((512, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 1024)).astype(np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(a, b))
    fields["default_matmul_control"] = f"{rel_err(got, a.astype(np.float64) @ b):.3g}"
    return fields


def phase_memory(devs) -> dict:
    stats = devs[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return {"peak_bytes_in_use": peak if peak is not None else "not available"}


def phase_four_cards(work: str, sizes: Sizes, seed: int) -> dict:
    """``stream -mesh 4x1`` (time-sharded, halo over the interconnect)
    against the single-card run on device 0, within the CPU mesh
    tests' tolerance."""
    cap = os.path.join(work, "capture.sr21M.cs8")
    tone = -SHIFT + TONE_BIN * SR / DECIMATE / WIDTH
    write_cs8(cap, sizes.stream_samples, tone, SR, 0.5, seed)
    common = ["-shift", "280k", "-lowpass", "200k", "-power", "200", "-decimate", "32",
              "-width", "64", "-chunk", str(sizes.chunk)]
    t0 = time.perf_counter()
    mesh_out = os.path.join(work, "mesh")
    mesh_lines = run_cli(["stream", *common, "-mesh", "4x1", "-out", mesh_out, cap])
    t_mesh = time.perf_counter() - t0
    one_lines = run_cli(["stream", *common, "-out", os.path.join(work, "one"), cap])
    mesh = np.fromfile(os.path.join(work, "mesh.norms.f32"), dtype=np.float32)
    one = np.fromfile(os.path.join(work, "one.norms.f32"), dtype=np.float32)
    if mesh.shape != one.shape:
        raise AssertionError(f"mesh wrote {mesh.shape} values, one card {one.shape}")
    np.testing.assert_allclose(mesh, one, rtol=3e-4, atol=3e-4 * float(one.max()))
    return {
        "samples": sizes.stream_samples,
        "mesh_seconds": f"{t_mesh:.2f}",
        "rel_err": f"{float(np.max(np.abs(mesh - one)) / one.max()):.3g}",
        "mesh_stats": repr(stats_line(mesh_lines, "stream")),
        "one_card_stats": repr(stats_line(one_lines, "stream")),
    }


def run_phases(devs, work: str, sizes: Sizes, seed: int, four_cards: bool) -> None:
    root = os.path.dirname(os.path.abspath(__file__))
    timed = [("device", lambda: phase_device(devs))]
    if four_cards:
        timed.append(("stream-mesh-4x1", lambda: phase_four_cards(work, sizes, seed)))
    else:
        timed += [
            ("stream", lambda: phase_stream(work, sizes, seed)),
            ("long-fir", lambda: phase_long_fir(work, sizes, seed)),
            ("waterfall", lambda: phase_waterfall(work, sizes, seed)),
            ("examples", lambda: phase_examples(root)),
            ("precision", lambda: phase_precision(sizes, seed)),
            ("memory", lambda: phase_memory(devs)),
        ]
    for name, fn in timed:
        t0 = time.perf_counter()
        fields = fn()
        report(name, time.perf_counter() - t0, **fields)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run stream -mesh 4x1 against one card, and nothing else")
    ap.add_argument("--seed", type=int, default=0, help="seed of every synthesized capture")
    args = ap.parse_args(argv)

    devs = require_gpu(4 if args.four_cards else 1)
    from quadrs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    work = tempfile.mkdtemp(prefix="quadrs-smoke-")
    try:
        run_phases(devs, work, Sizes(), args.seed, args.four_cards)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
