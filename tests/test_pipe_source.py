"""Live pipe input: ``PipeSource`` + ``StreamRunner`` sequential chunks.

The pipe path must be byte-for-byte identical to the file path on the
same capture bytes — same window floor, same EOF tail handling, same
absolute-offset NCO phases — with the only difference being that the
capture's length is discovered at EOF instead of from the file size.
"""

import io
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat, planes_from_bytes
from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu.sources import PipeSource, SampleSource
from quadrs_tpu.stream_runner import StreamRunner


def _capture_bytes(n_samples: int, fmt=FileFormat.COMPLEX_INT8, seed=7) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, n_samples * fmt.pair_bytes, dtype=np.int64).astype(
        np.uint8
    ).tobytes()


class _Dribble(io.RawIOBase):
    """A reader that returns at most ``k`` bytes per read call —
    exercises the partial-pair carry (pipes deliver arbitrary
    boundaries, not sample-aligned ones)."""

    def __init__(self, data: bytes, k: int):
        self._data = data
        self._pos = 0
        self._k = k

    def read(self, n=-1):
        if self._pos >= len(self._data):
            return b""
        n = len(self._data) if n is None or n < 0 else n
        take = min(n, self._k, len(self._data) - self._pos)
        out = self._data[self._pos : self._pos + take]
        self._pos += take
        return out


@pytest.mark.parametrize("fmt", [FileFormat.COMPLEX_INT8, FileFormat.COMPLEX_INT16])
def test_pipe_planes_match_file_decode(fmt):
    """Reads at hostile (3-byte) boundaries reassemble the exact same
    planes as a one-shot decode, and the trailing partial pair drops."""
    data = _capture_bytes(501, fmt) + b"\x55"  # 501 samples + partial pair
    want = planes_from_bytes(np.frombuffer(data, dtype=np.uint8), fmt)
    src = PipeSource(_Dribble(data, 3), fmt, 48_000)
    parts = []
    while True:
        p = src.read_planes(97)
        if p.shape[1] == 0:
            break
        parts.append(p)
    got = np.concatenate(parts, axis=1)
    assert got.shape == want.shape == (2, 501)
    np.testing.assert_array_equal(got, want)
    assert src.eof


def _cfg(fmt) -> PipelineConfig:
    return PipelineConfig(
        sample_rate=48_000, shift_freq=1_000, lp_freq=8_000,
        decimate=4, taps=40, fft_width=32, fmt=fmt,
    )


def _collect(runner, search=False, **kw):
    rows = []

    def emit(w0, out):
        rows.append((w0, out))

    stats = (runner.run_search if search else runner.run)(emit, **kw)
    return rows, stats


@pytest.mark.parametrize("n_samples", [40_000, 39_781])
def test_pipe_runner_matches_file(n_samples):
    """Multi-chunk pipe run == in-memory file run, bit for bit, on
    chunk-aligned and ragged capture lengths."""
    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(n_samples, fmt)
    model = PipelineModel(_cfg(fmt))
    chunk = 10_000  # rounds down to a whole number of 128-sample windows

    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, fstats = _collect(StreamRunner(fsrc, model, chunk_samples=chunk))

    psrc = PipeSource(io.BytesIO(data), fmt, 48_000)
    prows, pstats = _collect(StreamRunner(psrc, model, chunk_samples=chunk))

    assert len(prows) == len(frows) > 1
    for (fw, fn), (pw, pn) in zip(frows, prows):
        assert fw == pw
        np.testing.assert_array_equal(fn, pn)
    assert pstats.samples_in == fstats.samples_in
    assert pstats.windows_out == fstats.windows_out


def test_pipe_runner_search_matches_file():
    fmt = FileFormat.COMPLEX_INT16
    data = _capture_bytes(30_011, fmt)
    model = PipelineModel(_cfg(fmt))
    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, _ = _collect(StreamRunner(fsrc, model, chunk_samples=8_000), search=True)
    psrc = PipeSource(io.BytesIO(data), fmt, 48_000)
    prows, _ = _collect(StreamRunner(psrc, model, chunk_samples=8_000), search=True)
    assert len(prows) == len(frows) > 1
    for (fw, (fi, fv)), (pw, (pi, pv)) in zip(frows, prows):
        assert fw == pw
        np.testing.assert_array_equal(fi, pi)
        np.testing.assert_array_equal(fv, pv)


def test_pipe_resume_drains_to_exact_offset():
    """start_window on a pipe drains (reads and discards) the skipped
    samples; the rows that follow are identical to the same windows of
    a full file run (absolute-offset phases)."""
    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(25_000, fmt)
    model = PipelineModel(_cfg(fmt))
    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, _ = _collect(StreamRunner(fsrc, model, chunk_samples=8_000))
    full = np.concatenate([n for _, n in frows])

    start = frows[1][0]  # second chunk's first window index
    psrc = PipeSource(io.BytesIO(data), fmt, 48_000)
    prows, _ = _collect(
        StreamRunner(psrc, model, chunk_samples=8_000), start_window=start
    )
    assert prows[0][0] == start
    resumed = np.concatenate([n for _, n in prows])
    np.testing.assert_array_equal(resumed, full[start:])


def test_pipe_short_capture_emits_nothing():
    """A pipe shorter than one window (or than the taps span) produces
    zero windows and a clean exit, like the file path."""
    fmt = FileFormat.COMPLEX_INT8
    model = PipelineModel(_cfg(fmt))
    for n in (0, 10, 100):
        psrc = PipeSource(io.BytesIO(_capture_bytes(n, fmt)), fmt, 48_000)
        rows, stats = _collect(StreamRunner(psrc, model))
        assert rows == [] and stats.windows_out == 0


def test_pipe_guards():
    fmt = FileFormat.COMPLEX_INT8
    model = PipelineModel(_cfg(fmt))
    mk = lambda: PipeSource(io.BytesIO(b""), fmt, 48_000)
    with pytest.raises(ValueError, match="bank"):
        StreamRunner([mk(), mk()], model)
    with pytest.raises(ValueError, match="positive"):
        PipeSource(io.BytesIO(b""), fmt, 0)


def test_pipe_mesh_stream_matches_file_mesh():
    """A live pipe shards over the 'time' mesh axis: StreamRunner wraps
    it in a LivePipeStream whose forward reads back the sharded staging
    (halo + true tail), EOF turns the sentinel length real, and the
    ragged tail runs as on files — rows identical to the file-mesh run
    and to the single-device run."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    from quadrs_tpu.parallel.sharding import make_mesh

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(60_011, fmt, seed=26)
    model = PipelineModel(_cfg(fmt))
    mesh = make_mesh(n_time=4, n_stream=1)

    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows, fstats = _collect(
        StreamRunner(fsrc, model, chunk_samples=16_000, mesh=mesh)
    )
    psrc = PipeSource(io.BytesIO(data), fmt, 48_000)
    prows, pstats = _collect(
        StreamRunner(psrc, model, chunk_samples=16_000, mesh=mesh)
    )
    assert len(prows) == len(frows) > 1
    for (fw, fn), (pw, pn) in zip(frows, prows):
        assert fw == pw
        np.testing.assert_array_equal(fn, pn)
    assert pstats.samples_in == fstats.samples_in
    assert pstats.windows_out == fstats.windows_out

    # search over a fresh pipe on the mesh
    fpk, _ = _collect(
        StreamRunner(fsrc, model, chunk_samples=16_000, mesh=mesh), search=True
    )
    ppk, _ = _collect(
        StreamRunner(
            PipeSource(io.BytesIO(data), fmt, 48_000), model,
            chunk_samples=16_000, mesh=mesh,
        ),
        search=True,
    )
    for (fw, (fi, fv)), (pw, (pi, pv)) in zip(fpk, ppk):
        assert fw == pw
        np.testing.assert_array_equal(fi, pi)
        np.testing.assert_array_equal(fv, pv)

    # bounded live mesh run: stops at the bound, no tail, no hang on
    # the still-sentinel length
    brows, bstats = _collect(
        StreamRunner(
            PipeSource(io.BytesIO(data), fmt, 48_000), model,
            chunk_samples=16_000, mesh=mesh,
        ),
        max_chunks=1,
    )
    assert len(brows) == 1
    np.testing.assert_array_equal(brows[0][1], frows[0][1])


def test_cli_stream_stdin_matches_file(tmp_path, capsys, monkeypatch):
    """``quadjax stream -stdin yes`` over a pipe == the same command
    over the capture file."""
    from quadrs_tpu.cli import main

    fmt = FileFormat.COMPLEX_UINT8
    data = _capture_bytes(20_000, fmt)
    path = tmp_path / "live.cu8"
    path.write_bytes(data)

    flags = ["-shift", "1k", "-lowpass", "8k", "-power", "20",
             "-decimate", "4", "-width", "32", "-chunk", "8000"]
    out_f = tmp_path / "file"
    rc = main(["stream", *flags, "-sr", "48k", "-out", str(out_f), str(path)])
    assert rc == 0
    file_out = capsys.readouterr().out

    out_p = tmp_path / "pipe"
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(data)))
    rc = main(["stream", *flags, "-stdin", "yes", "-sr", "48k",
               "-format", "cu8", "-out", str(out_p)])
    assert rc == 0
    pipe_out = capsys.readouterr().out

    fn = np.fromfile(f"{out_f}.norms.f32", dtype=np.float32)
    pn = np.fromfile(f"{out_p}.norms.f32", dtype=np.float32)
    np.testing.assert_array_equal(fn, pn)
    # identical peak line; stats line differs only in timing
    assert file_out.splitlines()[0] == pipe_out.splitlines()[0]


@pytest.mark.parametrize(
    "width,stride,n_samples",
    [
        (128, 64, 20_000),   # overlapped: width-stride carry between chunks
        (128, 128, 20_011),  # tiled, ragged EOF
        (128, 300, 30_000),  # skipping: inter-chunk gaps read and discarded
    ],
)
def test_waterfall_pipe_matches_file(width, stride, n_samples):
    """WaterfallRunner over a pipe == over the same bytes in memory, at
    overlapped, tiled, and skipping strides."""
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.stream_runner import WaterfallRunner

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(n_samples, fmt, seed=11)
    cfg = WaterfallConfig(
        n_streams=1, fft_width=width, stride=stride, fmt=fmt
    )
    model = WaterfallModel(cfg)

    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows = []
    fstats = WaterfallRunner([fsrc], model, chunk_windows=37).run(
        lambda w, n: frows.append((w, n))
    )

    psrc = PipeSource(io.BytesIO(data), fmt, 48_000)
    prows = []
    pstats = WaterfallRunner([psrc], model, chunk_windows=37).run(
        lambda w, n: prows.append((w, n))
    )
    assert len(prows) == len(frows) > 1
    for (fw, fn), (pw, pn) in zip(frows, prows):
        assert fw == pw
        np.testing.assert_array_equal(fn, pn)
    assert pstats.samples_in == fstats.samples_in
    assert pstats.windows_out == fstats.windows_out

    # search over a fresh pipe matches the file search
    fpk, ppk = [], []
    WaterfallRunner([fsrc], model, chunk_windows=37).run_search(
        lambda w, o: fpk.append((w, o))
    )
    WaterfallRunner(
        [PipeSource(io.BytesIO(data), fmt, 48_000)], model, chunk_windows=37
    ).run_search(lambda w, o: ppk.append((w, o)))
    for (fw, (fi, fv)), (pw, (pi, pv)) in zip(fpk, ppk):
        assert fw == pw
        np.testing.assert_array_equal(fi, pi)
        np.testing.assert_array_equal(fv, pv)


def test_waterfall_pipe_resume_and_guards():
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.stream_runner import WaterfallRunner

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(15_000, fmt, seed=12)
    cfg = WaterfallConfig(n_streams=1, fft_width=128, stride=64, fmt=fmt)
    model = WaterfallModel(cfg)

    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows = []
    WaterfallRunner([fsrc], model, chunk_windows=50).run(
        lambda w, n: frows.append((w, n))
    )
    start = frows[1][0]
    prows = []
    WaterfallRunner(
        [PipeSource(io.BytesIO(data), fmt, 48_000)], model, chunk_windows=50
    ).run(lambda w, n: prows.append((w, n)), start_window=start)
    assert prows[0][0] == start
    np.testing.assert_array_equal(
        np.concatenate([n for _, n in prows], axis=1),
        np.concatenate([n for _, n in frows[1:]], axis=1),
    )

    mk = lambda: PipeSource(io.BytesIO(b""), fmt, 48_000)
    cfg2 = WaterfallConfig(n_streams=2, fft_width=128, stride=64, fmt=fmt)
    with pytest.raises(ValueError, match="bank"):
        WaterfallRunner([mk(), mk()], WaterfallModel(cfg2))
    # an empty pipe produces no windows and a clean exit
    rows = []
    stats = WaterfallRunner([mk()], model).run(lambda w, n: rows.append(n))
    assert rows == [] and stats.windows_out == 0


@pytest.mark.parametrize(
    "width,stride,n_samples",
    [
        (128, 64, 40_000),   # overlapped: the window halo crosses the interconnect
        (128, 128, 40_011),  # tiled, ragged EOF
        (128, 300, 60_000),  # skipping: whole stride cells staged
    ],
)
def test_waterfall_pipe_mesh_matches_file_mesh(width, stride, n_samples):
    """A live pipe shards over the waterfall mesh: WaterfallRunner wraps
    it in LivePipeStream, whose strictly-forward reads back the sharded
    staging (stride cells + halo tail); EOF turns the sentinel length
    real mid-staging and clips the final chunk — rows and peaks
    identical to the file-mesh run at every stride class."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.parallel.sharding import make_mesh
    from quadrs_tpu.stream_runner import WaterfallRunner

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(n_samples, fmt, seed=31)
    cfg = WaterfallConfig(
        n_streams=1, fft_width=width, stride=stride, fmt=fmt
    )
    model = WaterfallModel(cfg)
    mesh = make_mesh(n_time=4, n_stream=1)

    fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    frows = []
    fstats = WaterfallRunner([fsrc], model, chunk_windows=37, mesh=mesh).run(
        lambda w, n: frows.append((w, n))
    )
    prows = []
    pstats = WaterfallRunner(
        [PipeSource(io.BytesIO(data), fmt, 48_000)], model,
        chunk_windows=37, mesh=mesh,
    ).run(lambda w, n: prows.append((w, n)))
    assert len(prows) == len(frows) > 1
    for (fw, fn), (pw, pn) in zip(frows, prows):
        assert fw == pw
        np.testing.assert_array_equal(fn, pn)
    assert pstats.samples_in == fstats.samples_in
    assert pstats.windows_out == fstats.windows_out

    # in-shard peak search over a fresh pipe
    fpk, ppk = [], []
    WaterfallRunner([fsrc], model, chunk_windows=37, mesh=mesh).run_search(
        lambda w, o: fpk.append((w, o))
    )
    WaterfallRunner(
        [PipeSource(io.BytesIO(data), fmt, 48_000)], model,
        chunk_windows=37, mesh=mesh,
    ).run_search(lambda w, o: ppk.append((w, o)))
    assert len(ppk) == len(fpk)
    for (fw, (fi, fv)), (pw, (pi, pv)) in zip(fpk, ppk):
        assert fw == pw
        np.testing.assert_array_equal(fi, pi)
        np.testing.assert_array_equal(fv, pv)

    # bounded live mesh run stops at the bound without touching the
    # still-sentinel length; an empty pipe exits cleanly
    brows = []
    WaterfallRunner(
        [PipeSource(io.BytesIO(data), fmt, 48_000)], model,
        chunk_windows=37, mesh=mesh,
    ).run(lambda w, n: brows.append((w, n)), max_chunks=1)
    assert len(brows) == 1
    np.testing.assert_array_equal(brows[0][1], frows[0][1])
    empty = []
    stats = WaterfallRunner(
        [PipeSource(io.BytesIO(b""), fmt, 48_000)], model, mesh=mesh
    ).run(lambda w, n: empty.append(n))
    assert empty == [] and stats.windows_out == 0


def test_live_pipe_stream_stages_and_slides():
    """LivePipeStream serves forward-moving random access over a pipe:
    staged planes match the in-memory source, discarded data cannot be
    rewound to, and length flips from sentinel to real at EOF."""
    from quadrs_tpu.sources import LivePipeStream

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(5_000, fmt, seed=21)
    ref = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
    live = LivePipeStream(PipeSource(_Dribble(data, 997), fmt, 48_000))
    assert live.length > 5_000  # sentinel until EOF

    for lo, hi in [(0, 700), (512, 1400), (1400, 3000), (2900, 5000)]:
        np.testing.assert_array_equal(live.stage(lo, hi), ref.stage(lo, hi))
    with pytest.raises(ValueError, match="rewind"):
        live.stage(100, 700)
    # read past EOF: short return and the real length appears
    got = live.stage(4000, 6000)
    np.testing.assert_array_equal(got, ref.stage(4000, 5000))
    assert live.length == 5_000


def test_live_waterfall_over_pipe_matches_file():
    """The live terminal waterfall renders identical rows from a pipe
    and from the capture file — including a mid-stream fft retune — and
    ends cleanly at pipe EOF (no sentinel-length crash)."""
    import io as _io

    from quadrs_tpu.sources import LivePipeStream
    from quadrs_tpu.viz.live import LiveParams, live_waterfall

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(40_000, fmt, seed=22)
    params = LiveParams(fft_width=64, stride=256, cols=40, batch=16)
    keys = [(5, "+"), (20, "]")]

    fout = _io.StringIO()
    fstats = live_waterfall(
        SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000),
        params, out=fout, keys=list(keys),
    )
    pout = _io.StringIO()
    pstats = live_waterfall(
        LivePipeStream(PipeSource(io.BytesIO(data), fmt, 48_000)),
        params, out=pout, keys=list(keys),
    )
    assert pstats == fstats and pstats["rows"] > 20
    assert pout.getvalue() == fout.getvalue()


def test_cli_eui_live_stdin(capsys, monkeypatch):
    """``eui -live yes -stdin yes`` scrolls a piped capture and exits at
    EOF; -stdin without -live or without -sr/-format is rejected."""
    from quadrs_tpu.cli import main

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(30_000, fmt, seed=23)
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(data)))
    rc = main(["eui", "-live", "yes", "-stdin", "yes", "-sr", "48k",
               "-format", "cs8", "-cols", "40", "-rows", "10"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "live: 10 rows" in out

    assert main(["eui", "-stdin", "yes", "-sr", "48k", "-format", "cs8"]) == 1
    assert "requires -live yes" in capsys.readouterr().err
    assert main(["eui", "-live", "yes", "-stdin", "yes", "-sr", "48k"]) == 1
    assert "requires -sr and -format" in capsys.readouterr().err


def test_pipe_fuzz_random_boundaries_and_chunks():
    """Randomized soak: hostile read boundaries, random capture lengths
    and chunk sizes, every format — the pipe run must stay bit-identical
    to the file run."""
    rng = np.random.default_rng(31)
    fmts = [FileFormat.COMPLEX_INT8, FileFormat.COMPLEX_UINT8,
            FileFormat.COMPLEX_INT16, FileFormat.COMPLEX_FLOAT32]
    for trial in range(6):
        fmt = fmts[trial % len(fmts)]
        n = int(rng.integers(5_000, 30_000))
        k = int(rng.integers(1, 4096))  # dribble size
        chunk = int(rng.integers(2_000, 12_000))
        data = _capture_bytes(n, fmt, seed=100 + trial)
        model = PipelineModel(_cfg(fmt))

        fsrc = SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000)
        frows, fstats = _collect(StreamRunner(fsrc, model, chunk_samples=chunk))
        psrc = PipeSource(_Dribble(data, k), fmt, 48_000)
        prows, pstats = _collect(StreamRunner(psrc, model, chunk_samples=chunk))

        assert len(prows) == len(frows), (trial, fmt, n, k, chunk)
        for (fw, fn), (pw, pn) in zip(frows, prows):
            assert fw == pw
            np.testing.assert_array_equal(fn, pn)
        assert (pstats.samples_in, pstats.windows_out) == (
            fstats.samples_in, fstats.windows_out
        ), (trial, fmt, n, k, chunk)


def test_live_waterfall_over_composed_live_stream():
    """A LivePipeStream wrapped in a transform stage (Shift) still ends
    cleanly at EOF — the live-stream flag is read off the chain's root,
    not the top-level node."""
    import io as _io

    from quadrs_tpu.sources import LivePipeStream
    from quadrs_tpu.stream import Shift
    from quadrs_tpu.viz.live import LiveParams, live_waterfall

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(20_000, fmt, seed=25)
    params = LiveParams(fft_width=64, stride=256, cols=32, batch=16)

    fout = _io.StringIO()
    fstats = live_waterfall(
        Shift(SampleSource(np.frombuffer(data, dtype=np.uint8), fmt, 48_000),
              1_000),
        params, out=fout,
    )
    pout = _io.StringIO()
    pstats = live_waterfall(
        Shift(LivePipeStream(PipeSource(io.BytesIO(data), fmt, 48_000)),
              1_000),
        params, out=pout,
    )
    assert pstats == fstats and pstats["rows"] > 10
    assert pout.getvalue() == fout.getvalue()


def test_cli_ui_live_stdin(capsys, monkeypatch):
    """``ui -live yes -stdin yes`` mirrors eui: the HSV live waterfall
    scrolls a piped capture without needing a `from` accumulator."""
    from quadrs_tpu.cli import main

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(20_000, fmt, seed=24)
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(data)))
    rc = main(["ui", "-live", "yes", "-stdin", "yes", "-sr", "48k",
               "-format", "cs8", "-fft", "64", "-stride", "256",
               "-cols", "40", "-rows", "8"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "live: 8 rows" in out

    assert main(["ui", "-stdin", "yes", "-sr", "48k", "-format", "cs8"]) == 1
    assert "requires -live yes" in capsys.readouterr().err
    assert main(["ui", "-live", "yes", "-stdin", "yes", "-format", "cs8"]) == 1
    assert "requires -sr and -format" in capsys.readouterr().err


def test_cli_waterfall_stdin_matches_file(tmp_path, capsys, monkeypatch):
    from quadrs_tpu.cli import main

    fmt = FileFormat.COMPLEX_INT8
    data = _capture_bytes(20_000, fmt, seed=13)
    path = tmp_path / "live.cs8"
    path.write_bytes(data)

    flags = ["-width", "128", "-stride", "64", "-search", "yes", "-sr", "48k"]
    rc = main(["waterfall", *flags, str(path)])
    assert rc == 0
    file_out = capsys.readouterr().out

    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=io.BytesIO(data)))
    rc = main(["waterfall", *flags, "-stdin", "yes", "-format", "cs8"])
    assert rc == 0
    pipe_out = capsys.readouterr().out
    assert file_out.splitlines()[0] == pipe_out.splitlines()[0]  # same peak


def test_cli_ook_stdin_matches_file(capsys, monkeypatch):
    """``quadjax ook -stdin yes`` over the piped fixture bytes decodes
    the same payload as the file run (demod commands buffer stdin)."""
    import pathlib

    from quadrs_tpu.cli import main

    path = pathlib.Path(__file__).parent.parent / "examples" / "ook-sim.sr400.cf32"
    rc = main(["ook", "-bit", "16", str(path)])
    file_out = capsys.readouterr().out
    assert rc == 0

    monkeypatch.setattr(
        sys, "stdin", SimpleNamespace(buffer=io.BytesIO(path.read_bytes()))
    )
    rc = main(["ook", "-bit", "16", "-stdin", "yes", "-sr", "400",
               "-format", "cf32"])
    pipe_out = capsys.readouterr().out
    assert rc == 0
    assert pipe_out == file_out


def test_cli_stream_stdin_requires_sr_and_format(capsys):
    from quadrs_tpu.cli import main

    assert main(["stream", "-stdin", "yes", "-format", "cu8"]) == 1
    assert "requires -sr and -format" in capsys.readouterr().err
    assert main(["stream", "-stdin", "yes", "-sr", "48k"]) == 1
    assert "requires -sr and -format" in capsys.readouterr().err
    # -stdin + -mesh is legal: the live pipe shards over the time axis
    # (see test_pipe_mesh_stream_matches_file_mesh)
    # the demod commands share the sr/format rule
    assert main(["ook", "-stdin", "yes", "-sr", "400"]) == 1
    assert "requires -sr and -format" in capsys.readouterr().err
    assert main(["fsk", "-stdin", "yes", "-format", "cf32"]) == 1
    assert "requires -sr and -format" in capsys.readouterr().err
