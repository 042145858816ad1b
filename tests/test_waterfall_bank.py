"""The waterfall bank (``WaterfallModel.step/search/jit_scan``) against
an independent float64 numpy reference, across widths, strides, formats,
window counts and windowing, plus the sharded bank against one device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quadrs_tpu.formats import FileFormat
from quadrs_tpu.models.waterfall import WaterfallConfig, WaterfallModel
from quadrs_tpu.ops.stft import blackman_harris_window
from quadrs_tpu.selfcheck import waterfall_norms_ref


def _model(**kw) -> WaterfallModel:
    return WaterfallModel(WaterfallConfig(**kw))


def _ref(model: WaterfallModel, raw) -> np.ndarray:
    cfg = model.cfg
    taper = None
    if cfg.windowing == "blackman-harris":
        taper = blackman_harris_window(cfg.fft_width)
    return waterfall_norms_ref(raw, cfg.fmt, cfg.fft_width, cfg.stride, window=taper)


def _check_norms(model, raw, rtol=2e-5):
    got = np.asarray(model.jit_step()(jnp.asarray(raw)))
    want = _ref(model, raw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * want.max())
    return got, want


def _check_search(model, raw, rtol=2e-5):
    """Peak bins equal float64's argmax, except where the picked bin's
    magnitude ties the top within f32 rounding; magnitudes match."""
    gi, gm = (np.asarray(a) for a in model.search(jnp.asarray(raw)))
    want = _ref(model, raw)
    top = want.max(axis=-1)
    picked = np.take_along_axis(want, gi[..., None], axis=-1)[..., 0]
    same = gi == np.argmax(want, axis=-1)
    near_tie = np.abs(picked - top) <= rtol * np.maximum(top, 1e-9)
    assert np.all(same | near_tie)
    np.testing.assert_allclose(gm, top, rtol=rtol, atol=rtol * top.max())


def _check_scan(model, raw, thr, rtol=3e-5):
    """(sum, max, above) per bin vs the float64 norms; counts are exact
    except where a norm sits within f32 noise of the threshold."""
    ssum, smax, sabove = (
        np.asarray(a) for a in model.jit_scan()(jnp.asarray(raw), jnp.float32(thr))
    )
    norms = _ref(model, raw)
    nw = norms.shape[1]
    peak = max(norms.max(), 1e-6)
    np.testing.assert_allclose(ssum, norms.sum(axis=1), rtol=rtol, atol=nw * rtol * peak)
    np.testing.assert_allclose(smax, norms.max(axis=1), rtol=rtol, atol=rtol * peak)
    noise = rtol * peak
    lo = (norms > thr + noise).sum(axis=1)
    hi = (norms > thr - noise).sum(axis=1)
    got = sabove.astype(np.int64)
    assert np.all(got >= lo) and np.all(got <= hi)


@pytest.mark.parametrize(
    "width,fmt,windowing",
    [
        (1024, FileFormat.COMPLEX_INT8, "rectangular"),
        (1024, FileFormat.COMPLEX_INT8, "blackman-harris"),
        (256, FileFormat.COMPLEX_UINT8, "rectangular"),
        (512, FileFormat.COMPLEX_INT16, "blackman-harris"),
        (2048, FileFormat.COMPLEX_FLOAT32, "rectangular"),
        (4096, FileFormat.COMPLEX_INT8, "blackman-harris"),
        (8192, FileFormat.COMPLEX_INT8, "rectangular"),
    ],
)
def test_tiled_bank_matches_float64(width, fmt, windowing):
    model = _model(
        n_streams=3 if width < 4096 else 2, fft_width=width, stride=width, fmt=fmt,
        windowing=windowing,
    )
    nw = 5 if width < 4096 else 3
    got, _ = _check_norms(model, model.synth_raw(nw * width + 17, seed=2))
    assert got.shape == (model.cfg.n_streams, nw, width)  # partial tail dropped


@pytest.mark.parametrize("nw", [1, 127, 128, 200])
def test_window_counts(nw):
    model = _model(n_streams=2, fft_width=256, stride=256)
    got, _ = _check_norms(model, model.synth_raw(nw * 256, seed=3))
    assert got.shape == (2, nw, 256)


@pytest.mark.parametrize("stride", [128, 256, 769, 1024, 1536])
def test_strided_bank_matches_float64(stride):
    """Overlapped (stride < width), tiling and skipping strides."""
    model = _model(n_streams=2, fft_width=1024, stride=stride, windowing="blackman-harris")
    n = 6 * 1024 + 11
    got, _ = _check_norms(model, model.synth_raw(n, seed=6))
    assert got.shape == (2, (n - 1024) // stride + 1, 1024)


@pytest.mark.parametrize(
    "fmt",
    [FileFormat.COMPLEX_UINT8, FileFormat.COMPLEX_INT16, FileFormat.COMPLEX_FLOAT32],
)
def test_strided_formats(fmt):
    """Every format decodes correctly (cu8/cs16 offsets included) at an
    overlapped stride."""
    model = _model(n_streams=2, fft_width=512, stride=128, fmt=fmt)
    _check_norms(model, model.synth_raw(4 * 512 + 99, seed=13))


@pytest.mark.parametrize(
    "width,stride,fmt",
    [
        (1024, 1024, FileFormat.COMPLEX_INT8),
        (256, 128, FileFormat.COMPLEX_INT16),
        (512, 512, FileFormat.COMPLEX_FLOAT32),
        (1024, 256, FileFormat.COMPLEX_INT8),
        (256, 384, FileFormat.COMPLEX_UINT8),
        (512, 257, FileFormat.COMPLEX_INT8),
    ],
)
def test_search_matches_float64(width, stride, fmt):
    model = _model(n_streams=3, fft_width=width, stride=stride, fmt=fmt)
    _check_search(model, model.synth_raw(5 * width + 13, seed=11))


def test_search_ties_go_to_the_lowest_bin():
    """All-zero windows: every bin ties at 0 and the peak is bin 0, like
    jnp.argmax."""
    model = _model(n_streams=1, fft_width=256, stride=256)
    gi, gm = model.search(jnp.zeros((1, 2, 512), jnp.int8))
    assert np.all(np.asarray(gi) == 0) and np.all(np.asarray(gm) == 0)


def test_search_is_argmax_of_step():
    model = _model(n_streams=2)
    raw = jnp.asarray(model.synth_raw(3 * 1024, seed=4))
    norms = np.asarray(model.jit_step()(raw))
    gi, gm = model.search(raw)
    np.testing.assert_array_equal(np.asarray(gi), np.argmax(norms, axis=-1))
    np.testing.assert_array_equal(np.asarray(gm), norms.max(axis=-1))


def test_wide_width_nontiled_strides():
    """A wide width with skipping and non-aligned overlapped strides:
    windows stay stride-faithful, norms and search."""
    for stride in (5000, 1000):
        model = _model(n_streams=1, fft_width=4096, stride=stride)
        raw = model.synth_raw(2 * 4096 + stride + 3, seed=33)
        _check_norms(model, raw)
        _check_search(model, raw)


@pytest.mark.parametrize(
    "width,stride,fmt,windowing",
    [
        (256, 256, FileFormat.COMPLEX_INT8, "rectangular"),
        (1024, 1024, FileFormat.COMPLEX_INT8, "blackman-harris"),
        (1024, 256, FileFormat.COMPLEX_UINT8, "rectangular"),
        (512, 640, FileFormat.COMPLEX_FLOAT32, "rectangular"),
        (512, 320, FileFormat.COMPLEX_INT16, "rectangular"),
        (1024, 96, FileFormat.COMPLEX_INT8, "rectangular"),
        (1024, 48, FileFormat.COMPLEX_UINT8, "blackman-harris"),
        (4096, 1024, FileFormat.COMPLEX_INT8, "rectangular"),
    ],
)
def test_scan_matches_float64(width, stride, fmt, windowing):
    """Band survey per bin; the threshold sits mid-gap near the median so
    f32 noise cannot move a count."""
    model = _model(n_streams=2, fft_width=width, stride=stride, fmt=fmt, windowing=windowing)
    nw = 7 if width < 4096 else 3
    raw = model.synth_raw((nw - 1) * stride + width + 13, seed=4)
    flat = np.unique(_ref(model, raw).ravel())
    k = len(flat) // 2
    gaps = np.diff(flat[max(0, k - 200) : k + 200])
    j = int(np.argmax(gaps)) + max(0, k - 200)
    _check_scan(model, raw, float((flat[j] + flat[j + 1]) / 2))


@pytest.mark.parametrize("nw", [1, 31, 32, 127, 128, 129, 300])
def test_scan_window_counts(nw):
    """sum/max/above see exactly the real windows, for counts on either
    side of power-of-two boundaries."""
    model = _model(n_streams=1, fft_width=256, stride=256)
    _check_scan(model, model.synth_raw(nw * 256 + 64, seed=nw), 8.0)


def test_scan_fuzz():
    """Random (width, stride, format, windowing, stream count) surveys."""
    rng = np.random.default_rng(0x5CAB)
    for case in range(6):
        width = 128 * int(rng.choice([2, 4, 8, 16]))
        stride = int(
            rng.choice(
                [width, width // 2, width + 64, 3 * width // 4, width // 8,
                 max(32, width // 16) + (16 if case % 2 else 0)]
            )
        )
        model = _model(
            n_streams=int(rng.integers(1, 4)), fft_width=width, stride=stride,
            fmt=rng.choice(list(FileFormat)),
            windowing=str(rng.choice(["rectangular", "blackman-harris"])),
        )
        raw = model.synth_raw(int(rng.integers(width + stride, 3 * width + 4 * stride)), seed=90 + case)
        _check_scan(model, raw, float(np.median(_ref(model, raw))))


def test_bank_fuzz():
    """Random (width, stride, format, windowing, stream count) banks:
    norms and search."""
    rng = np.random.default_rng(31)
    for case in range(6):
        width = 128 * int(rng.choice([2, 3, 4, 8, 16]))
        model = _model(
            n_streams=int(rng.integers(1, 5)), fft_width=width,
            stride=int(rng.choice([width, width // 2, width + 64, 3 * width // 4])),
            fmt=rng.choice(list(FileFormat)),
            windowing=str(rng.choice(["rectangular", "blackman-harris"])),
        )
        raw = model.synth_raw(int(rng.integers(width, 4 * width + 200)), seed=40 + case)
        _check_norms(model, raw, rtol=3e-5)
        _check_search(model, raw, rtol=3e-5)


def test_sharded_waterfall_matches_single_device():
    """(stream, time)-sharded bank equals the single-device step — no
    halo: windows tile shard boundaries exactly."""
    from quadrs_tpu.parallel.sharding import make_mesh, make_sharded_waterfall_step, shard_chunk

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh(n_time=4, n_stream=2)
    model = _model(n_streams=2, fft_width=256, stride=256)
    raw = model.synth_raw(4 * 3 * 256, seed=5)  # (2, 2, 4*n_local)
    want = np.asarray(model.jit_step()(jnp.asarray(raw)))

    step = make_sharded_waterfall_step(model, mesh)
    out = np.asarray(step(shard_chunk(raw, mesh)))
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5 * want.max())


@pytest.mark.parametrize("stride", [128, 384])
def test_sharded_waterfall_strided(stride):
    """Overlapped strides shard with a halo of width-stride samples (true
    continuation fed to the last shard); skipping strides shard
    zero-halo.  Both must equal the single-device step over the same
    span."""
    from quadrs_tpu.parallel.sharding import (
        make_mesh,
        make_sharded_waterfall_step,
        replicate_tail,
        shard_chunk,
        waterfall_halo,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    mesh = make_mesh(n_time=4, n_stream=2)
    model = _model(n_streams=2, fft_width=256, stride=stride)
    halo = waterfall_halo(model.cfg)
    n = 4 * 3 * stride
    full = model.synth_raw(n + halo, seed=15)  # (2, 2, n + halo)
    raw, tail = full[:, :, :n], full[:, :, n:]

    # single-device reference over the same extended span, then keep
    # the n // stride windows the sharded step emits
    want = np.asarray(model.jit_step()(jnp.asarray(full)))[:, : n // stride]

    step = make_sharded_waterfall_step(model, mesh)
    if halo:
        out = np.asarray(step(shard_chunk(raw, mesh), replicate_tail(tail, mesh)))
    else:
        out = np.asarray(step(shard_chunk(raw, mesh)))
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5 * want.max())


def test_sharded_waterfall_rejects_ragged_shards():
    from quadrs_tpu.parallel.sharding import make_mesh, make_sharded_waterfall_step, shard_chunk

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    model = _model(n_streams=2, fft_width=1024, stride=1024)
    step = make_sharded_waterfall_step(model, make_mesh(n_time=4, n_stream=2))
    bad = model.synth_raw(4 * (1024 + 512), seed=3)  # shards not whole strides
    with pytest.raises(ValueError, match="stride"):
        step(shard_chunk(bad, make_mesh(n_time=4, n_stream=2)))
