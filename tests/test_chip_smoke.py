"""chip_smoke.py, the benchmark's device gate and peak table, the
compile-cache helper, and the precision audit — everything around the
on-card run that the CPU can check.  The phases run here at a tiny size
(``chip_smoke.TINY``); on the card they run at full size."""

import ast
import importlib.util
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).parent.parent


def _load(name: str):
    """A top-level script of the repo as a module (imported once)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


smoke = _load("chip_smoke")


# -- compile cache --------------------------------------------------------


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    from quadrs_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.update({k: v}))
    path = compile_cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert seen == {"jax_compilation_cache_dir": path}
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from quadrs_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: seen.update({k: v}))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert seen == {}  # JAX reads the variable itself


# -- the benchmark's device facts -----------------------------------------


def test_peak_table_knows_the_h100():
    bench_suite = _load("bench_suite")
    peaks = bench_suite.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_gbps"] == 3350.0 and peaks["f32_tflops"] == 67.0
    assert peaks["tf32_tflops"] == 495.0 and peaks["bf16_tflops"] == 989.0


def test_peak_table_refuses_an_unknown_kind():
    bench_suite = _load("bench_suite")
    with pytest.raises(KeyError, match="no published peaks"):
        bench_suite.device_peaks("cpu")


def test_bench_refuses_to_run_without_a_gpu():
    bench_suite = _load("bench_suite")
    with pytest.raises(SystemExit) as e:
        bench_suite.suite()
    assert "needs an NVIDIA GPU" in str(e.value.code)


# -- the device gate -------------------------------------------------------


def test_smoke_refuses_a_cpu_run(capsys):
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_alone_fails_without_a_result(tmp_path):
    """chip_smoke.py copied away from the repo exits non-zero and prints
    no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# -- phases at a tiny size --------------------------------------------------


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """One scratch directory; the stream phase writes the capture the
    long-fir phase reads."""
    path = tmp_path_factory.mktemp("smoke")
    smoke.phase_stream(str(path), smoke.TINY, 0)
    return str(path)


def test_phase_stream(work):
    fields = smoke.phase_stream(work, smoke.TINY, 1)
    assert fields["peak_bin"] == smoke.WIDTH // 2 + smoke.TONE_BIN
    assert fields["windows"] == smoke.TINY.stream_samples // (smoke.WIDTH * smoke.DECIMATE)
    assert float(fields["rel_err"]) <= smoke.RTOL
    assert fields["stats"].startswith("'stream: ")


def test_phase_long_fir(work):
    fields = smoke.phase_long_fir(work, smoke.TINY, 0)
    per_chunk = smoke.TINY.chunk // (smoke.WIDTH * smoke.DECIMATE)
    assert fields["windows"] == smoke.TINY.long_fir_chunks * per_chunk
    assert float(fields["rel_err"]) <= smoke.RTOL


def test_phase_waterfall(tmp_path):
    fields = smoke.phase_waterfall(str(tmp_path), smoke.TINY, 0)
    assert fields["streams"] == smoke.TINY.bank_streams
    assert float(fields["rel_err"]) <= smoke.RTOL
    assert float(fields["scan_rel_err"]) <= smoke.RTOL


def test_phase_examples():
    fields = smoke.phase_examples(str(ROOT))
    assert fields["ook_bits"] == "0001100011000"
    assert fields["fsk_symbols"].startswith("1010")


def test_phase_precision():
    from quadrs_tpu.selfcheck import PRECISION_RTOL

    fields = smoke.phase_precision(smoke.TINY, 0)
    for key in ("stream", "long_fir", "waterfall"):
        assert float(fields[key]) <= PRECISION_RTOL


def test_phase_memory_and_device():
    assert "peak_bytes_in_use" in smoke.phase_memory(jax.devices())
    fields = smoke.phase_device(jax.devices())
    assert fields["platform"] == jax.devices()[0].platform


def test_phase_four_cards(tmp_path):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    fields = smoke.phase_four_cards(str(tmp_path), smoke.TINY, 0)
    assert float(fields["rel_err"]) <= 3e-4


def test_a_failed_phase_fails_the_run(tmp_path, monkeypatch):
    """No phase's exception is swallowed."""

    def broken(*a):
        raise AssertionError("planted failure")

    monkeypatch.setattr(smoke, "phase_examples", broken)
    with pytest.raises(AssertionError, match="planted failure"):
        smoke.run_phases(jax.devices(), str(tmp_path), smoke.TINY, 0, False)


# -- precision ---------------------------------------------------------------


def test_every_matmul_names_its_precision():
    """On a GPU an f32 matmul left at the default precision runs as TF32;
    every dot/matmul/einsum in the package must say which it wants."""
    names = {"dot", "matmul", "einsum", "dot_general", "tensordot", "inner", "vdot",
             "conv_general_dilated", "convolve"}
    missing = []
    for path in (ROOT / "quadrs_tpu").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
                missing.append(f"{path}:{node.lineno} @")
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            base = ast.unparse(node.func.value)
            if node.func.attr in names and base not in ("np", "numpy"):
                if not any(k.arg == "precision" for k in node.keywords):
                    missing.append(f"{path}:{node.lineno} {ast.unparse(node.func)}")
    assert missing == []


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round f32 values to TF32's 10-bit mantissa."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + 0x1000) & 0xFFFFE000).view(np.float32)


def test_precision_tolerance_rejects_tf32():
    """The precision checks' tolerance passes f32 and fails a DFT whose
    operands were rounded to TF32, as a TF32 matmul would."""
    from quadrs_tpu.selfcheck import PRECISION_RTOL, rel_err

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((256, 64)) + 1j * rng.standard_normal((256, 64))).astype(np.complex64)
    f = np.exp(-2j * np.pi * np.outer(np.arange(64), np.arange(64)) / 64)
    want = np.abs(x.astype(np.complex128) @ f)
    fr, fi = _tf32(f.real), _tf32(f.imag)
    xr, xi = _tf32(x.real), _tf32(x.imag)
    tf32 = np.abs((xr @ fr - xi @ fi) + 1j * (xr @ fi + xi @ fr))
    f32 = np.abs(x @ f.astype(np.complex64))
    assert rel_err(f32, want) <= PRECISION_RTOL < rel_err(tf32, want)


def test_stream_reference_agrees_with_the_oracle():
    """selfcheck's vectorized stream reference equals the sequential
    oracle read in one pull (so the reference's per-read truncation
    touches none of the checked windows)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from oracle import OracleArray, OracleLowPass, OracleShift, oracle_fft_norms

    from quadrs_tpu.formats import FileFormat
    from quadrs_tpu.ops.fir import lowpass_taps
    from quadrs_tpu.selfcheck import decode_ref, stream_norms_ref

    rng = np.random.default_rng(8)
    sr, shift, d, taps, width = 48_000, 3_000, 4, 32, 16
    planes = rng.integers(-127, 128, (2, 4096), dtype=np.int64).astype(np.int8)
    x = decode_ref(planes, FileFormat.COMPLEX_INT8).astype(np.complex64)
    chain = OracleLowPass(OracleShift(OracleArray(x, sr), shift, sr), 4_000, d, taps)
    y = chain.read_at(0, chain.length)
    windows = np.arange(10)
    want = np.stack([oracle_fft_norms(y[w * width : (w + 1) * width]) for w in windows])
    got = stream_norms_ref(
        planes, FileFormat.COMPLEX_INT8, sr, shift, lowpass_taps(4_000 / sr, taps),
        d, width, windows,
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
