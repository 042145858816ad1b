import jax
import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat, decode_bytes
from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu.parallel.sharding import (
    halo_samples,
    make_mesh,
    make_sharded_stream_step,
    plan_shard_phases,
    replicate_tail,
    shard_chunk,
)

CFG = PipelineConfig(
    sample_rate=1_000_000,
    shift_freq=12_500,
    lp_freq=50_000,
    decimate=8,
    taps=64,
    fft_width=32,
    fmt=FileFormat.COMPLEX_INT8,
)


def _reference_stream(model, raw, n_windows):
    """Decode+mix+fir+stft via plain numpy/f64 for cross-checking."""
    from quadrs_tpu.formats import decode_plane

    cfg = model.cfg
    re = decode_plane(raw[0], cfg.fmt, xp=np).astype(np.float64)
    im = decode_plane(raw[1], cfg.fmt, xp=np).astype(np.float64)
    x = re + 1j * im
    n = len(x)
    m = np.arange(n, dtype=np.float64)
    x = x * np.exp(2j * np.pi * cfg.shift_freq * m / cfg.sample_rate)
    h = model.taps.astype(np.float64)
    n_dec = (n - cfg.taps) // cfg.decimate
    x = np.concatenate([x, np.zeros(cfg.taps, dtype=np.complex128)])
    y = np.empty(n_dec, dtype=np.complex128)
    for i in range(n_dec):
        lo = i * cfg.decimate + cfg.taps // 2
        y[i] = np.dot(x[lo : lo + cfg.taps], h)
    wins = y[: n_windows * cfg.fft_width].reshape(n_windows, cfg.fft_width)
    spec = np.fft.fft(wins)
    spec = np.concatenate([spec[:, cfg.fft_width // 2 :], spec[:, : cfg.fft_width // 2]], axis=1)
    return np.abs(spec).astype(np.float32)


def test_stream_step_matches_reference_math():
    model = PipelineModel(CFG)
    n_local = CFG.decimate * CFG.fft_width * 4
    raw = model.synth_raw(n_local + CFG.taps)
    got = np.asarray(model.jit_step_stream(raw, np.float32(0.0)))
    want = _reference_stream(model, raw, got.shape[0])
    assert got.shape == (4, CFG.fft_width)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * want.max())


def test_window_mode_matches_stream_graph_path():
    """step_windows must reproduce the conformance stream-graph pull
    (SampleSource -> Shift -> LowPass -> stft), including the reference's
    per-window zero-padded convolution tails."""
    from quadrs_tpu.ops.stft import stft_norms
    from quadrs_tpu.runtime import Executor
    from quadrs_tpu.sources import SampleSource
    from quadrs_tpu.stream import LowPass, Shift

    model = PipelineModel(CFG)
    n_windows = 4
    stride_raw = CFG.fft_width * CFG.decimate
    total = stride_raw * n_windows + CFG.window_raw  # plenty of data
    raw = model.synth_raw(total)

    blocks = np.stack(
        [
            raw[:, i * stride_raw : i * stride_raw + CFG.window_raw]
            for i in range(n_windows)
        ]
    )  # (B, 2, window_raw)
    theta0 = model.theta0(np.arange(n_windows, dtype=np.int64) * stride_raw)
    a = np.asarray(model.jit_step_windows(blocks, theta0))

    interleaved = np.ascontiguousarray(raw.T)  # (n, 2) native pairs
    src = SampleSource(interleaved.reshape(-1).view(np.uint8), CFG.fmt, CFG.sample_rate)
    chain = LowPass(
        Shift(src, CFG.shift_freq, CFG.sample_rate),
        CFG.lp_freq,
        CFG.decimate,
        CFG.taps,
    )
    ex = Executor(chain, CFG.fft_width, batch=n_windows, post=stft_norms)
    b, valid = ex.run(np.arange(n_windows, dtype=np.int64) * CFG.fft_width)
    assert np.all(valid == CFG.fft_width)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * b.max())


def test_sharded_step_matches_single_device():
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    model = PipelineModel(CFG)
    halo = halo_samples(CFG)
    n_time, n_stream = 4, 2
    n_local = CFG.decimate * CFG.fft_width * 2
    total = n_time * n_local

    raws = np.stack([model.synth_raw(total + halo, seed=s) for s in range(n_stream)])
    mesh = make_mesh(n_time, n_stream)
    step = make_sharded_stream_step(model, mesh)

    theta0 = plan_shard_phases(model, n_local, n_time, n_stream)
    out = np.asarray(
        step(
            shard_chunk(raws[:, :, :total], mesh),
            shard_chunk(theta0, mesh),
            replicate_tail(raws[:, :, total:], mesh),
        )
    )

    # reference: the unsharded streaming step per stream over the same
    # samples (chunk + true tail) — EVERY window must match, including
    # the last shard's (its halo is the fed tail, not wrapped data)
    want = np.stack(
        [np.asarray(model.jit_step_stream(raws[s], np.float32(0.0))) for s in range(n_stream)]
    )
    assert out.shape == want.shape == (n_stream, 2 * n_time, CFG.fft_width)
    np.testing.assert_allclose(out, want, rtol=3e-4, atol=3e-4 * want.max())


def test_graft_entry():
    import importlib.util, pathlib

    spec = importlib.util.spec_from_file_location(
        "graft_entry", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.shape == (4, 32)
    assert np.isfinite(out).all()
    mod.dryrun_multichip(len(jax.devices()))
    # the multi-process variant is covered by tests/test_distributed.py


def test_sharded_odd_taps_matches_single_device():
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    cfg = PipelineConfig(
        sample_rate=1_000_000,
        shift_freq=12_500,
        lp_freq=50_000,
        decimate=8,
        taps=65,
        fft_width=32,
        fmt=FileFormat.COMPLEX_INT8,
    )
    model = PipelineModel(cfg)
    n_time = 4
    n_local = cfg.decimate * cfg.fft_width * 2
    total = n_time * n_local
    halo = halo_samples(cfg)
    raw = model.synth_raw(total + halo, seed=20)
    mesh = make_mesh(n_time, 1)
    step = make_sharded_stream_step(model, mesh)
    theta0 = plan_shard_phases(model, n_local, n_time, 1)
    out = np.asarray(
        step(
            shard_chunk(raw[None, :, :total], mesh),
            shard_chunk(theta0, mesh),
            replicate_tail(raw[None, :, total:], mesh),
        )
    )[0]
    want = np.asarray(model.jit_step_stream(raw, np.float32(0.0)))
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=3e-4, atol=3e-4 * want.max())


def test_spectral_premixed_stream_matches_reference():
    """Long-taps (overlap-save class) streaming commutes the NCO mix into
    complex band-pass taps plus a decimated-rate output twiddle
    (models/receiver._spectral_fir); it must match the plain f64
    mix-then-filter math and the time-domain production path at a
    non-zero stream offset."""
    import dataclasses

    cfg = dataclasses.replace(CFG, taps=528, lp_freq=20_000, fft_width=16)
    model = PipelineModel(cfg)
    assert model._spectral_fir  # md = ceil(528/8) = 66 > 64
    n_local = cfg.decimate * cfg.fft_width * 4
    raw = model.synth_raw(n_local + cfg.taps)
    got = np.asarray(model.jit_step_stream(raw, np.float32(0.0)))
    want = _reference_stream(model, raw, got.shape[0])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * want.max())

    # at a large absolute offset, against the mix+time-domain path
    td = PipelineModel(dataclasses.replace(cfg, fir_impl="polyphase"))
    assert not td._spectral_fir
    th = np.float32(model.theta0(np.int64(987_654_321)))
    a = np.asarray(model.jit_step_stream(raw, th))
    b = np.asarray(td.jit_step_stream(raw, th))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4 * b.max())


def test_spectral_premixed_random_configs():
    """Property test: for random long-taps configs and stream offsets the
    premixed spectral step matches the mix+time-domain path."""
    import dataclasses

    rng = np.random.default_rng(21)
    for case in range(4):
        d = int(rng.choice([4, 8, 16]))
        taps = int(d * rng.integers(65, 90))  # md in (64, 90]: spectral
        fft_width = int(rng.choice([8, 16]))
        cfg = dataclasses.replace(
            CFG,
            decimate=d,
            taps=taps,
            fft_width=fft_width,
            shift_freq=int(rng.integers(1, 400_000)),
            lp_freq=int(rng.integers(5_000, 60_000)),
        )
        spectral = PipelineModel(cfg)
        timedom = PipelineModel(dataclasses.replace(cfg, fir_impl="polyphase"))
        assert spectral._spectral_fir and not timedom._spectral_fir
        n_local = d * fft_width * 3
        raw = spectral.synth_raw(n_local + taps, seed=100 + case)
        off = int(rng.integers(0, 1 << 40))
        th = np.float32(spectral.theta0(np.int64(off)))
        a = np.asarray(spectral.jit_step_stream(raw, th))
        b = np.asarray(timedom.jit_step_stream(raw, th))
        np.testing.assert_allclose(
            a, b, rtol=3e-4, atol=3e-4 * b.max(),
            err_msg=f"case {case}: d={d} taps={taps} off={off}",
        )
