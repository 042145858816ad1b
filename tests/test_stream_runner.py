import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat
from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel
from quadrs_tpu.sources import SampleSource
from quadrs_tpu.stream_runner import StreamRunner

CFG = PipelineConfig(
    sample_rate=1_000_000,
    shift_freq=12_500,
    lp_freq=50_000,
    decimate=8,
    taps=64,
    fft_width=32,
    fmt=FileFormat.COMPLEX_FLOAT32,
)


def _source(data: np.ndarray) -> SampleSource:
    inter = np.empty((len(data), 2), dtype=np.float32)
    inter[:, 0] = data.real
    inter[:, 1] = data.imag
    return SampleSource(inter.reshape(-1).view(np.uint8), CFG.fmt, CFG.sample_rate)


def test_chunked_equals_single_shot():
    """Chunk boundaries must be invisible: tiny chunks == one big chunk."""
    rng = np.random.default_rng(21)
    n = 8 * CFG.decimate * CFG.fft_width * 4 + CFG.taps
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    model = PipelineModel(CFG)
    src = _source(data)

    rows_small: dict[int, np.ndarray] = {}
    small = StreamRunner(src, model, chunk_samples=CFG.decimate * CFG.fft_width * 2)
    st1 = small.run(lambda w0, norms: rows_small.update(
        {w0 + i: norms[i] for i in range(norms.shape[0])}
    ))

    rows_big: dict[int, np.ndarray] = {}
    big = StreamRunner(src, model, chunk_samples=1 << 20)
    st2 = big.run(lambda w0, norms: rows_big.update(
        {w0 + i: norms[i] for i in range(norms.shape[0])}
    ))

    assert st1.windows_out == len(rows_small)
    assert set(rows_small) == set(rows_big)
    for w in rows_big:
        np.testing.assert_allclose(rows_small[w], rows_big[w], atol=1e-4)


def test_runner_stats_and_tail():
    rng = np.random.default_rng(22)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 5 + 100  # ragged tail that can't fill a window
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    model = PipelineModel(CFG)
    stats = StreamRunner(_source(data), model, chunk_samples=win_raw * 2).run()
    # 5 whole windows minus the lookahead the last partial region can't cover
    assert 3 <= stats.windows_out <= 5
    assert stats.samples_in == stats.windows_out * win_raw
    assert stats.seconds > 0


def test_format_mismatch_rejected():
    import pytest

    model = PipelineModel(CFG)
    src = SampleSource(np.zeros(1024, dtype=np.uint8), FileFormat.COMPLEX_INT8, CFG.sample_rate)
    with pytest.raises(ValueError):
        StreamRunner(src, model)


def test_sharded_runner_matches_single_device():
    import jax
    import pytest

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    from quadrs_tpu.parallel.sharding import make_mesh

    rng = np.random.default_rng(23)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 40 + CFG.taps * 2
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    model = PipelineModel(CFG)
    src = _source(data)

    rows_single: dict[int, np.ndarray] = {}
    StreamRunner(src, model, chunk_samples=win_raw * 8).run(
        lambda w0, norms: rows_single.update(
            {w0 + i: norms[i] for i in range(norms.shape[0])}
        )
    )

    rows_sharded: dict[int, np.ndarray] = {}
    mesh = make_mesh(n_time=4, n_stream=1)
    StreamRunner(src, model, chunk_samples=win_raw * 16, mesh=mesh).run(
        lambda w0, norms: rows_sharded.update(
            {w0 + i: norms[i] for i in range(norms.shape[0])}
        )
    )

    assert set(rows_sharded) == set(rows_single)
    for w in rows_single:
        np.testing.assert_allclose(rows_sharded[w], rows_single[w], atol=2e-4)


def test_native_prefetch_runner_matches_in_memory(tmp_path):
    """A file-backed runner goes through the C++ ring prefetcher
    (_chunks_native); rows must equal the in-memory runner's, including
    the ragged tail and a resumed run."""
    import pytest

    from quadrs_tpu.native import native_available

    if not native_available():
        pytest.skip("no C++ toolchain for the native loader")

    rng = np.random.default_rng(41)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 13 + CFG.taps + 37  # ragged tail
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    path = tmp_path / f"cap.sr{CFG.sample_rate}.cf32"
    inter = np.empty((n, 2), dtype=np.float32)
    inter[:, 0] = data.real
    inter[:, 1] = data.imag
    inter.tofile(path)

    model = PipelineModel(CFG)
    fsrc = SampleSource.from_file(str(path))
    assert fsrc.native is not None  # the point of the test

    mem: dict[int, np.ndarray] = {}
    StreamRunner(_source(data), model, chunk_samples=win_raw * 4).run(
        lambda w0, norms: mem.update({w0 + i: norms[i] for i in range(len(norms))})
    )
    nat: dict[int, np.ndarray] = {}
    stats = StreamRunner(fsrc, model, chunk_samples=win_raw * 4).run(
        lambda w0, norms: nat.update({w0 + i: norms[i] for i in range(len(norms))})
    )
    assert set(nat) == set(mem)
    assert stats.windows_out == len(nat)
    for w in mem:
        np.testing.assert_allclose(nat[w], mem[w], atol=1e-5)

    resumed: dict[int, np.ndarray] = {}
    StreamRunner(fsrc, model, chunk_samples=win_raw * 4).run(
        lambda w0, norms: resumed.update({w0 + i: norms[i] for i in range(len(norms))}),
        start_window=6,
    )
    assert min(resumed) == 6 and max(resumed) == max(mem)
    for w in resumed:
        np.testing.assert_allclose(resumed[w], mem[w], atol=1e-4)


def test_sharded_resume_matches_full_sharded_run():
    """A sharded run resumed at window k reproduces the tail of the full
    sharded run (mirror of the single-device resume test)."""
    import jax
    import pytest

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    from quadrs_tpu.parallel.sharding import make_mesh

    rng = np.random.default_rng(31)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 40 + CFG.taps * 3
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    model = PipelineModel(CFG)
    src = _source(data)
    mesh = make_mesh(n_time=4, n_stream=1)

    full: dict[int, np.ndarray] = {}
    StreamRunner(src, model, chunk_samples=win_raw * 8, mesh=mesh).run(
        lambda w0, norms: full.update({w0 + i: norms[i] for i in range(len(norms))})
    )
    resumed: dict[int, np.ndarray] = {}
    StreamRunner(src, model, chunk_samples=win_raw * 8, mesh=mesh).run(
        lambda w0, norms: resumed.update({w0 + i: norms[i] for i in range(len(norms))}),
        start_window=16,
    )
    assert min(resumed) == 16
    assert max(resumed) == max(full)
    scale = max(float(v.max()) for v in full.values())
    for w in resumed:
        np.testing.assert_allclose(resumed[w], full[w], atol=2e-4 * scale)


def test_sharded_bank_n_stream_2():
    """Two captures as a data-parallel bank over a (2, 2) mesh: each
    stream's rows equal its own single-device run."""
    import jax
    import pytest

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    from quadrs_tpu.parallel.sharding import make_mesh

    rng = np.random.default_rng(37)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 24 + CFG.taps * 2
    model = PipelineModel(CFG)
    srcs = []
    singles = []
    for s in range(2):
        data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
        src = _source(data)
        srcs.append(src)
        rows: dict[int, np.ndarray] = {}
        StreamRunner(src, model, chunk_samples=win_raw * 8).run(
            lambda w0, norms, rows=rows: rows.update(
                {w0 + i: norms[i] for i in range(len(norms))}
            )
        )
        singles.append(rows)

    mesh = make_mesh(n_time=2, n_stream=2)
    bank: dict[int, np.ndarray] = {}
    stats = StreamRunner(srcs, model, chunk_samples=win_raw * 8, mesh=mesh).run(
        lambda w0, norms: bank.update({w0 + i: norms[:, i] for i in range(norms.shape[1])})
    )
    assert stats.windows_out == 2 * len(bank)
    for s in range(2):
        assert set(bank) == set(singles[s])
        scale = max(float(v.max()) for v in singles[s].values())
        for w in bank:
            np.testing.assert_allclose(
                bank[w][s], singles[s][w], atol=2e-4 * scale, err_msg=f"s={s} w={w}"
            )


def test_sharded_runner_halo_wider_than_window():
    """A config whose halo spans multiple STFT windows: the runner must
    widen its chunk quantum so every time-shard covers the halo it
    sends, instead of failing to trace."""
    import jax
    import pytest

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    from quadrs_tpu.parallel.sharding import make_mesh

    cfg = PipelineConfig(
        sample_rate=1_000_000,
        shift_freq=12_500,
        lp_freq=50_000,
        decimate=8,
        taps=192,  # halo = 280 > win_raw = 128
        fft_width=16,
        fmt=FileFormat.COMPLEX_FLOAT32,
    )
    model = PipelineModel(cfg)
    win_raw = cfg.decimate * cfg.fft_width
    rng = np.random.default_rng(43)
    n = win_raw * 64 + cfg.taps * 2
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    inter = np.empty((n, 2), dtype=np.float32)
    inter[:, 0] = data.real
    inter[:, 1] = data.imag
    src = SampleSource(inter.reshape(-1).view(np.uint8), cfg.fmt, cfg.sample_rate)

    single: dict[int, np.ndarray] = {}
    StreamRunner(src, model, chunk_samples=win_raw * 8).run(
        lambda w0, norms: single.update({w0 + i: norms[i] for i in range(len(norms))})
    )
    sharded: dict[int, np.ndarray] = {}
    runner = StreamRunner(
        src, model, chunk_samples=win_raw * 4, mesh=make_mesh(4, 1)
    )  # requested chunk is below the halo quantum; must be widened
    assert runner.chunk_samples // 4 >= 280
    runner.run(
        lambda w0, norms: sharded.update({w0 + i: norms[i] for i in range(len(norms))})
    )
    assert set(sharded) == set(single)
    scale = max(float(v.max()) for v in single.values())
    for w in single:
        np.testing.assert_allclose(sharded[w], single[w], atol=3e-4 * scale)


def test_bank_requires_mesh_and_equal_lengths():
    import pytest

    model = PipelineModel(CFG)
    a = _source(np.zeros(4096, dtype=np.complex64))
    b = _source(np.zeros(8192, dtype=np.complex64))
    with pytest.raises(ValueError, match="needs a mesh"):
        StreamRunner([a, a], model)
    import jax

    if len(jax.devices()) >= 2:
        from quadrs_tpu.parallel.sharding import make_mesh

        with pytest.raises(ValueError, match="equal lengths"):
            StreamRunner([a, b], model, mesh=make_mesh(1, 2))


def test_resume_is_exact():
    """Resuming mid-capture reproduces the tail of a full run exactly
    (absolute-offset phase planning)."""
    rng = np.random.default_rng(29)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 12 + CFG.taps * 2
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    model = PipelineModel(CFG)
    src = _source(data)

    full: dict[int, np.ndarray] = {}
    StreamRunner(src, model, chunk_samples=win_raw * 3).run(
        lambda w0, norms: full.update({w0 + i: norms[i] for i in range(len(norms))})
    )

    resumed: dict[int, np.ndarray] = {}
    StreamRunner(src, model, chunk_samples=win_raw * 3).run(
        lambda w0, norms: resumed.update({w0 + i: norms[i] for i in range(len(norms))}),
        start_window=5,
    )
    assert min(resumed) == 5
    for w in resumed:
        # chunk boundaries shift, so block tails differ within f32 noise
        np.testing.assert_allclose(resumed[w], full[w], atol=1e-4)


def test_cu8_tail_padding_masked_in_decoded_domain():
    """Raw zero-byte padding decodes to -127.5 for cu8; the runner must
    mask past-EOF samples in the decoded domain or the final windows
    convolve a huge DC rail (regression for the review finding)."""
    rng = np.random.default_rng(55)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 3 + CFG.taps // 2  # EOF lands inside the last lookahead
    iq = rng.integers(0, 256, (n, 2), dtype=np.int64).astype(np.uint8)
    src = SampleSource(iq.reshape(-1), FileFormat.COMPLEX_UINT8, CFG.sample_rate)

    cfg8 = PipelineConfig(
        sample_rate=CFG.sample_rate,
        shift_freq=CFG.shift_freq,
        lp_freq=CFG.lp_freq,
        decimate=CFG.decimate,
        taps=CFG.taps,
        fft_width=CFG.fft_width,
        fmt=FileFormat.COMPLEX_UINT8,
    )
    model = PipelineModel(cfg8)

    rows = {}
    StreamRunner(src, model, chunk_samples=win_raw).run(
        lambda w0, norms: rows.update({w0 + i: norms[i] for i in range(len(norms))})
    )

    # reference: decoded-domain computation with explicit zeros past EOF
    from quadrs_tpu.formats import decode_plane

    re = decode_plane(iq[:, 0], FileFormat.COMPLEX_UINT8, xp=np).astype(np.float64)
    im = decode_plane(iq[:, 1], FileFormat.COMPLEX_UINT8, xp=np).astype(np.float64)
    x = np.concatenate([re + 1j * im, np.zeros(2 * CFG.taps, dtype=np.complex128)])
    m = np.arange(len(x), dtype=np.float64)
    x = x * np.exp(2j * np.pi * CFG.shift_freq * m / CFG.sample_rate)
    h = model.taps.astype(np.float64)
    last_w = max(rows)
    for w in (0, last_w):
        want = np.empty(CFG.fft_width, dtype=np.complex128)
        for k in range(CFG.fft_width):
            i = w * CFG.fft_width + k
            lo = i * CFG.decimate + (CFG.taps - CFG.taps // 2)
            want[k] = np.dot(x[lo : lo + CFG.taps], h)
        spec = np.fft.fft(want)
        half = CFG.fft_width // 2
        spec = np.concatenate([spec[half:], spec[:half]])
        np.testing.assert_allclose(
            rows[w], np.abs(spec), atol=5e-3, err_msg=f"window {w}"
        )


def test_waterfall_runner_matches_single_step(tmp_path):
    """Bank-of-files streaming: chunked WaterfallRunner rows equal one
    whole-capture step, for tiling and overlapped strides."""
    import numpy as np

    from quadrs_tpu.formats import FileFormat
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.sources import SampleSource
    from quadrs_tpu.stream_runner import WaterfallRunner

    for stride in (256, 128, 384):
        cfg = WaterfallConfig(
            n_streams=2, fft_width=256, stride=stride, fmt=FileFormat.COMPLEX_INT8
        )
        model = WaterfallModel(cfg)
        n = 5 * 256 + 37
        raw = model.synth_raw(n, seed=9)  # (2, 2, n)
        srcs = []
        for s in range(2):
            p = tmp_path / f"bank{stride}-{s}.sr400.cs8"
            inter = np.stack([raw[s][0], raw[s][1]], axis=1)  # re,im pairs
            p.write_bytes(inter.astype(np.int8).tobytes())
            srcs.append(SampleSource.from_file(str(p)))
        want = np.asarray(model.jit_step()(raw))

        rows = []
        stats = WaterfallRunner(srcs, model, chunk_windows=3).run(
            lambda w, r: rows.append((w, r))
        )
        got = np.concatenate([r for _, r in rows], axis=1)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert stats.windows_out == want.shape[0] * want.shape[1]
        assert rows[0][0] == 0
        if want.shape[1] > 3:
            assert rows[1][0] == 3
        # samples_in counts staged samples exactly: the overlap
        # lookahead once (stride <= width), the per-chunk unread gap
        # subtracted (stride > width)
        n_windows = want.shape[1]
        n_chunks = -(-n_windows // 3)
        delta = 256 - stride
        want_in = n_windows * stride + delta * (1 if delta >= 0 else n_chunks)
        assert stats.samples_in == want_in * 2


def test_waterfall_runner_search_matches_single_shot():
    """Streaming peak search == single-shot model.search over the whole
    capture (BASELINE config 5's spectrogram search, served from chunks)."""
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.sources import SampleSource
    from quadrs_tpu.stream_runner import WaterfallRunner

    for stride in (256, 128):
        cfg = WaterfallConfig(
            n_streams=2, fft_width=256, stride=stride, fmt=FileFormat.COMPLEX_INT8
        )
        model = WaterfallModel(cfg)
        n = 5 * 256 + 37
        raw = model.synth_raw(n, seed=11)
        srcs = [
            SampleSource(
                np.stack([raw[s][0], raw[s][1]], axis=1).astype(np.int8).reshape(-1).view(np.uint8),
                cfg.fmt,
                400,
            )
            for s in range(2)
        ]
        want_idx, want_val = (np.asarray(a) for a in model.search(raw))

        got = []
        stats = WaterfallRunner(srcs, model, chunk_windows=3).run_search(
            lambda w, iv: got.append((w, iv))
        )
        idx = np.concatenate([iv[0] for _, iv in got], axis=1)
        val = np.concatenate([iv[1] for _, iv in got], axis=1)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(val, want_val)
        assert stats.windows_out == want_idx.shape[0] * want_idx.shape[1]


def test_waterfall_runner_sharded_matches_single_device():
    """WaterfallRunner(mesh=...) — the bank streamed across a (stream,
    time) mesh — must reproduce the single-device runner's rows and
    peaks for tiled AND overlapped strides (window halo + true-tail
    feed), including resume."""
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs >=8 virtual devices")
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.parallel.sharding import make_mesh
    from quadrs_tpu.stream_runner import WaterfallRunner

    mesh = make_mesh(n_time=4, n_stream=2)
    for stride in (256, 128):
        cfg = WaterfallConfig(
            n_streams=2, fft_width=256, stride=stride, fmt=FileFormat.COMPLEX_INT8
        )
        model = WaterfallModel(cfg)
        n = 23 * 256 + 91
        raw = model.synth_raw(n, seed=77)
        srcs = [
            SampleSource(
                np.stack([raw[s][0], raw[s][1]], axis=1)
                .astype(np.int8)
                .reshape(-1)
                .view(np.uint8),
                cfg.fmt,
                400,
            )
            for s in range(2)
        ]
        single: list = []
        WaterfallRunner(srcs, model, chunk_windows=8).run(
            lambda w, r: single.append(r)
        )
        want = np.concatenate(single, axis=1)

        sharded: list = []
        st = WaterfallRunner(srcs, model, chunk_windows=8, mesh=mesh).run(
            lambda w, r: sharded.append(r)
        )
        got = np.concatenate(sharded, axis=1)
        assert got.shape == want.shape, (stride, got.shape, want.shape)
        np.testing.assert_allclose(
            got, want, rtol=2e-5, atol=2e-5 * want.max(), err_msg=f"stride={stride}"
        )
        assert st.windows_out == want.shape[0] * want.shape[1]

        # streamed sharded search == single-device search
        s_single: list = []
        WaterfallRunner(srcs, model, chunk_windows=8).run_search(
            lambda w, iv: s_single.append(iv)
        )
        s_sharded: list = []
        WaterfallRunner(srcs, model, chunk_windows=8, mesh=mesh).run_search(
            lambda w, iv: s_sharded.append(iv)
        )
        wi = np.concatenate([iv[0] for iv in s_single], axis=1)
        gi = np.concatenate([iv[0] for iv in s_sharded], axis=1)
        wv = np.concatenate([iv[1] for iv in s_single], axis=1)
        gv = np.concatenate([iv[1] for iv in s_sharded], axis=1)
        assert gi.shape == wi.shape
        # indices must match exactly (same reduction semantics per
        # window on both paths), magnitudes to f32 tolerance
        np.testing.assert_array_equal(gi, wi, err_msg=f"stride={stride}")
        np.testing.assert_allclose(gv, wv, rtol=2e-5, err_msg=f"stride={stride}")

        # resume mid-capture
        resumed: list = []
        WaterfallRunner(srcs, model, chunk_windows=8, mesh=mesh).run(
            lambda w, r: resumed.append((w, r)), start_window=8
        )
        assert resumed[0][0] == 8
        got_r = np.concatenate([r for _, r in resumed], axis=1)
        np.testing.assert_allclose(
            got_r, want[:, 8:], rtol=2e-5, atol=2e-5 * want.max()
        )


@pytest.mark.slow
def test_sharded_runner_fuzz_matches_single_device():
    """Randomized property test: StreamRunner(mesh) == single-device
    across random (taps, decimate, fft_width, chunk, n_stream) draws."""
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs >=8 virtual devices")
    from quadrs_tpu.parallel.sharding import make_mesh

    rng = np.random.default_rng(0xF022)
    for trial in range(5):
        decimate = int(rng.choice([2, 3, 5, 8, 16]))
        taps = int(rng.integers(3, 40)) * decimate // 2 * 2 + 2  # even-ish, > decimate
        fft_width = int(rng.choice([16, 32, 64]))
        while taps // 2 // decimate >= fft_width:
            fft_width *= 2
        n_stream = int(rng.choice([1, 2]))
        n_time = int(rng.choice([2, 4]))
        cfg = PipelineConfig(
            sample_rate=1_000_000,
            shift_freq=int(rng.integers(1_000, 400_000)),
            lp_freq=50_000,
            decimate=decimate,
            taps=taps,
            fft_width=fft_width,
            fmt=FileFormat.COMPLEX_FLOAT32,
        )
        model = PipelineModel(cfg)
        win_raw = decimate * fft_width
        n = win_raw * int(rng.integers(16, 40)) + int(rng.integers(0, 2 * taps))
        chunk = win_raw * int(rng.integers(2, 10))
        label = f"trial {trial}: d={decimate} taps={taps} w={fft_width} s={n_stream}x{n_time} chunk={chunk} n={n}"

        srcs, singles = [], []
        for _s in range(n_stream):
            data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
            inter = np.empty((n, 2), dtype=np.float32)
            inter[:, 0] = data.real
            inter[:, 1] = data.imag
            src = SampleSource(inter.reshape(-1).view(np.uint8), cfg.fmt, cfg.sample_rate)
            srcs.append(src)
            rows: dict[int, np.ndarray] = {}
            StreamRunner(src, model, chunk_samples=chunk).run(
                lambda w0, norms, rows=rows: rows.update(
                    {w0 + i: norms[i] for i in range(len(norms))}
                )
            )
            singles.append(rows)

        mesh = make_mesh(n_time=n_time, n_stream=n_stream)
        bank: dict[int, np.ndarray] = {}

        def on_rows(w0, norms):
            if n_stream == 1:
                norms = norms[None] if norms.ndim == 2 else norms
            for i in range(norms.shape[1]):
                bank[w0 + i] = norms[:, i]

        StreamRunner(
            srcs if n_stream > 1 else srcs[0], model, chunk_samples=chunk, mesh=mesh
        ).run(on_rows)
        for s in range(n_stream):
            assert set(bank) == set(singles[s]), label
            scale = max(float(v.max()) for v in singles[s].values()) or 1.0
            for w in bank:
                np.testing.assert_allclose(
                    bank[w][s],
                    singles[s][w],
                    atol=3e-4 * scale,
                    err_msg=f"{label} s={s} w={w}",
                )


def test_waterfall_runner_empty_and_past_end():
    """Captures shorter than one window yield zero windows; resuming at
    or past the last window is a clean no-op (stats all zero)."""
    from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
    from quadrs_tpu.stream_runner import WaterfallRunner

    cfg = WaterfallConfig(n_streams=1, fft_width=256, stride=128, fmt=FileFormat.COMPLEX_INT8)
    model = WaterfallModel(cfg)
    short = SampleSource(np.zeros(2 * 100, dtype=np.uint8), cfg.fmt, 400)
    st = WaterfallRunner([short], model).run(lambda w, r: (_ for _ in ()).throw(AssertionError))
    assert st.windows_out == 0 and st.samples_in == 0

    ok = SampleSource(np.zeros(2 * 1024, dtype=np.uint8), cfg.fmt, 400)
    total = (1024 - 256) // 128 + 1
    st2 = WaterfallRunner([ok], model).run(
        lambda w, r: (_ for _ in ()).throw(AssertionError), start_window=total
    )
    assert st2.windows_out == 0
    # no-callback run still computes (honesty accumulator) and counts
    st3 = WaterfallRunner([ok], model).run()
    assert st3.windows_out == total


def test_stream_runner_search_matches_run():
    """run_search == argmax/max over run()'s rows, chunking invisible
    (the StreamRunner counterpart of WaterfallRunner.run_search)."""
    rng = np.random.default_rng(77)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 9 + CFG.taps
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    model = PipelineModel(CFG)
    src = _source(data)

    rows: dict[int, np.ndarray] = {}
    StreamRunner(src, model, chunk_samples=1 << 20).run(
        lambda w0, norms: rows.update({w0 + i: norms[i] for i in range(norms.shape[0])})
    )

    peaks: dict[int, tuple[int, float]] = {}

    def on_peaks(w0, out):
        idx, val = out
        peaks.update({w0 + i: (int(idx[i]), float(val[i])) for i in range(len(idx))})

    st = StreamRunner(src, model, chunk_samples=win_raw * 2).run_search(on_peaks)
    assert st.windows_out == len(peaks) == len(rows)
    for w, norms in rows.items():
        i, v = peaks[w]
        assert i == int(np.argmax(norms)), w
        np.testing.assert_allclose(v, norms.max(), rtol=1e-5)
    # callback-less run still touches every chunk (honest accumulator)
    st2 = StreamRunner(src, model, chunk_samples=win_raw * 2).run_search()
    assert st2.windows_out == st.windows_out


def test_sharded_stream_runner_search_matches_single_device():
    import jax
    import pytest

    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 virtual devices")
    from quadrs_tpu.parallel.sharding import make_mesh

    rng = np.random.default_rng(78)
    win_raw = CFG.decimate * CFG.fft_width
    n = win_raw * 40 + CFG.taps * 2
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    model = PipelineModel(CFG)
    src = _source(data)

    single: dict[int, tuple[int, float]] = {}
    StreamRunner(src, model, chunk_samples=win_raw * 8).run_search(
        lambda w0, out: single.update(
            {w0 + i: (int(out[0][i]), float(out[1][i])) for i in range(len(out[0]))}
        )
    )

    sharded: dict[int, tuple[int, float]] = {}
    mesh = make_mesh(n_time=4, n_stream=1)
    StreamRunner(src, model, chunk_samples=win_raw * 16, mesh=mesh).run_search(
        lambda w0, out: sharded.update(
            {w0 + i: (int(out[0][i]), float(out[1][i])) for i in range(len(out[0]))}
        )
    )

    assert set(sharded) == set(single)
    for w, (i, v) in single.items():
        si, sv = sharded[w]
        np.testing.assert_allclose(sv, v, rtol=2e-4)
        # different reduction orders may pick a different bin only on a
        # near-exact tie
        assert si == i or abs(sv - v) <= 2e-4 * max(abs(v), 1e-9), w
