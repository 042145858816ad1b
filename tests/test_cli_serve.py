"""End-to-end CLI tests for the serving commands
(``stream``/``waterfall``/``ook``/``fsk``): the runner products driven
from the shell, compared against direct library runs."""

import pathlib

import numpy as np
import pytest

from quadrs_tpu.cli import USAGE, main
from quadrs_tpu.formats import FileFormat
from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu.sources import open_capture
from quadrs_tpu.stream_runner import StreamRunner

EXAMPLES = pathlib.Path(__file__).parent.parent / "examples"


@pytest.fixture(scope="module")
def capture(tmp_path_factory) -> pathlib.Path:
    """A small generated cf32 capture, made through the CLI itself."""
    d = tmp_path_factory.mktemp("serve")
    prefix = d / "cap"
    rc = main(
        ["gen", "-cos", "2k", "-cos", "-5k", "-len", "0.1", "48k",
         "write", str(prefix)]
    )
    assert rc == 0
    path = d / "cap.sr48000.cf32"
    assert path.exists()
    return path


STREAM_FLAGS = [
    "-shift", "1k", "-lowpass", "8k", "-power", "20", "-decimate", "4",
    "-width", "32",
]


def _stream_cfg(src) -> PipelineConfig:
    return PipelineConfig(
        sample_rate=src.sample_rate, shift_freq=1000, lp_freq=8000,
        decimate=4, taps=40, fft_width=32, fmt=src.format,
    )


def test_cli_stream_norms_match_runner(capture, tmp_path, capsys):
    out = tmp_path / "s"
    rc = main(["stream", *STREAM_FLAGS, "-out", str(out), str(capture)])
    captured = capsys.readouterr().out
    assert rc == 0
    lines = captured.strip().splitlines()
    assert lines[0].startswith("stream peak window=")
    assert f"wrote {out}.norms.f32" in captured
    assert lines[-1].startswith("stream: ") and "Msps" in lines[-1]

    got = np.fromfile(f"{out}.norms.f32", dtype=np.float32).reshape(-1, 32)

    src = open_capture(str(capture))
    rows = []
    StreamRunner(src, PipelineModel(_stream_cfg(src))).run(
        lambda w0, norms: rows.append(norms)
    )
    want = np.concatenate(rows)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the printed peak is the global argmax of those rows
    w, b = np.divmod(np.argmax(want), want.shape[1])
    assert f"stream peak window={w} bin={b} " in lines[0]


def test_cli_stream_search_csv(capture, tmp_path, capsys):
    out = tmp_path / "p"
    rc = main(
        ["stream", *STREAM_FLAGS, "-search", "yes", "-out", str(out), str(capture)]
    )
    assert rc == 0
    assert "wrote" in capsys.readouterr().out
    rows = np.genfromtxt(
        f"{out}.peaks.csv", delimiter=",", names=True, dtype=None
    )
    src = open_capture(str(capture))
    norms = []
    StreamRunner(src, PipelineModel(_stream_cfg(src))).run(
        lambda w0, n: norms.append(n)
    )
    want = np.concatenate(norms)
    assert len(np.atleast_1d(rows)) == want.shape[0]
    for r in np.atleast_1d(rows):
        assert int(r["bin"]) == int(np.argmax(want[int(r["window"])]))
        np.testing.assert_allclose(
            float(r["mag"]), want[int(r["window"])].max(), rtol=1e-5
        )


def test_cli_waterfall_bank(capture, tmp_path, capsys):
    import shutil

    second = tmp_path / "cap2.sr48000.cf32"
    shutil.copy(capture, second)
    out = tmp_path / "w"
    rc = main(
        ["waterfall", "-width", "256", "-stride", "128", "-chunk", "8",
         "-out", str(out), str(capture), str(second)]
    )
    captured = capsys.readouterr().out
    assert rc == 0
    assert "waterfall peak stream=0 " in captured
    assert "waterfall peak stream=1 " in captured
    assert captured.strip().splitlines()[-1].startswith("waterfall: ")

    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel

    src = open_capture(str(capture))
    model = WaterfallModel(
        WaterfallConfig(
            n_streams=2, fft_width=256, stride=128, fmt=src.format,
        )
    )
    import jax.numpy as jnp

    raw = np.stack([src.stage(0, src.length)] * 2)
    want = np.asarray(model.jit_step()(jnp.asarray(raw)))
    for s in range(2):
        got = np.fromfile(f"{out}.s{s}.norms.f32", dtype=np.float32).reshape(-1, 256)
        np.testing.assert_allclose(got, want[s], atol=1e-4)


def test_cli_waterfall_search(capture, tmp_path, capsys):
    out = tmp_path / "ws"
    rc = main(
        ["waterfall", "-width", "256", "-search", "yes", "-out", str(out),
         str(capture)]
    )
    assert rc == 0
    capsys.readouterr()
    rows = np.genfromtxt(
        f"{out}.peaks.csv", delimiter=",", names=True, dtype=None
    )
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel

    src = open_capture(str(capture))
    model = WaterfallModel(
        WaterfallConfig(n_streams=1, fft_width=256, stride=256, fmt=src.format)
    )
    import jax.numpy as jnp

    want = np.asarray(
        model.jit_step()(jnp.asarray(src.stage(0, src.length)[None]))
    )[0]
    assert len(np.atleast_1d(rows)) == want.shape[0]
    for r in np.atleast_1d(rows):
        assert int(r["bin"]) == int(np.argmax(want[int(r["window"])]))


def test_cli_ook_decodes_payload(capsys):
    rc = main(["ook", "-bit", "16", str(EXAMPLES / "ook-sim.sr400.cf32")])
    captured = capsys.readouterr().out
    assert rc == 0
    bits, stats = captured.strip().splitlines()
    # preamble 00011 then payload byte 00011000 (0x18), as in test_demod
    assert "00011" + "00011000" in bits
    assert stats.startswith("ook: ") and "clock error" in stats


def test_cli_fsk_emits_symbols(capsys):
    rc = main(
        ["fsk", "-lowpass", "8k", "-power", "10", "-decimate", "4",
         "-width", "64", "-stride", "600", str(EXAMPLES / "fsk-sim.sr48k.cf32")]
    )
    captured = capsys.readouterr().out
    assert rc == 0
    syms, stats = captured.strip().splitlines()
    assert len(syms) > 8 and set(syms) <= {"0", "1"}
    # the simulated capture alternates tones
    flips = sum(a != b for a, b in zip(syms, syms[1:]))
    assert flips >= len(syms) // 3
    assert stats.startswith("fsk: ") and "symbols" in stats


def test_usage_lists_serve_commands():
    for cmd in ("stream", "waterfall", "ook", "fsk"):
        assert cmd in USAGE


def test_serve_parse_errors(capsys):
    assert main(["stream"]) == 1  # missing filename
    assert "Error" in capsys.readouterr().err
    assert main(["waterfall", "-width", "256"]) == 1  # no files
    capsys.readouterr()
    assert main(["ook", "-bogus", "x", "file"]) == 1
    capsys.readouterr()


def test_cli_stream_mesh_matches_single(capture, tmp_path, capsys):
    """``stream -mesh 4x1`` shards each chunk over the virtual device
    mesh and must write the same norms as the single-device run."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    solo, meshed = tmp_path / "solo", tmp_path / "mesh"
    rc = main(
        ["stream", *STREAM_FLAGS, "-chunk", "2048", "-out", str(solo), str(capture)]
    )
    assert rc == 0
    rc = main(
        ["stream", *STREAM_FLAGS, "-chunk", "2048", "-mesh", "4x1",
         "-out", str(meshed), str(capture)]
    )
    assert rc == 0
    capsys.readouterr()
    a = np.fromfile(f"{solo}.norms.f32", dtype=np.float32)
    b = np.fromfile(f"{meshed}.norms.f32", dtype=np.float32)
    assert a.shape == b.shape and a.size > 0
    np.testing.assert_allclose(b, a, atol=1e-5)


def test_cli_waterfall_mesh_bank(capture, tmp_path, capsys):
    """``waterfall -mesh 2x2`` (time x stream) over a two-file bank
    must reproduce the single-device bank's per-stream norms files."""
    import shutil

    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    second = tmp_path / "cap2.sr48000.cf32"
    shutil.copy(capture, second)
    solo, meshed = tmp_path / "solo", tmp_path / "mesh"
    base = ["waterfall", "-width", "256", "-stride", "128", "-chunk", "8"]
    assert main([*base, "-out", str(solo), str(capture), str(second)]) == 0
    assert (
        main([*base, "-mesh", "2x2", "-out", str(meshed), str(capture), str(second)])
        == 0
    )
    capsys.readouterr()
    for s in range(2):
        a = np.fromfile(f"{solo}.s{s}.norms.f32", dtype=np.float32)
        b = np.fromfile(f"{meshed}.s{s}.norms.f32", dtype=np.float32)
        assert a.shape == b.shape and a.size > 0
        np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f"stream {s}")


def test_cli_stream_max_chunks(capture, capsys):
    rc = main(["stream", *STREAM_FLAGS, "-chunk", "256", "-chunks", "2", str(capture)])
    captured = capsys.readouterr().out
    assert rc == 0
    stats = captured.strip().splitlines()[-1]
    # 2 chunks of 256 samples -> 2 * (256/128) windows
    assert " 4 windows, " in stats
