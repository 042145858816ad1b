import numpy as np
import pytest

from oracle import OracleArray, OracleLowPass, oracle_lowpass_taps
from quadrs_tpu.formats import FileFormat
from quadrs_tpu.ops.fir import fir_decimate, lowpass_taps
from quadrs_tpu.sources import SampleSource
from quadrs_tpu.stream import LowPass

import jax
import jax.numpy as jnp

from util import to_device_complex


def _run_fir(xd, taps, d, n_out, impl):
    # jit the call: it is the production shape
    fn = jax.jit(
        lambda xx: fir_decimate(xx, taps, d, n_out, impl=impl), static_argnames=()
    )
    out = fn(xd)
    return np.asarray(jnp.real(out)) + 1j * np.asarray(jnp.imag(out))


def _capture(n=8192, sr=48_000, seed=5):
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    src = SampleSource(
        np.ascontiguousarray(data).view(np.uint8), FileFormat.COMPLEX_FLOAT32, sr
    )
    return src, OracleArray(data, sr)


def test_taps_formula():
    taps = lowpass_taps(0.1, 40)
    assert taps.dtype == np.float32
    np.testing.assert_allclose(taps.sum(), 1.0, atol=1e-6)
    # symmetric for even sizes
    np.testing.assert_allclose(taps, taps[::-1], atol=1e-7)
    # matches the independently transcribed formula bit-for-bit
    assert taps.tobytes() == oracle_lowpass_taps(0.1, 40).tobytes()
    assert lowpass_taps(200_000 / 21_000_000, 400).tobytes() == oracle_lowpass_taps(
        200_000 / 21_000_000, 400
    ).tobytes()


def test_length_and_rate_formulas():
    src, _ = _capture(n=8192)
    lp = LowPass(src, 2000, 8, 40)
    # reference src/filter.rs:45-52
    assert lp.length == 1 + (8192 - 40) // 8
    assert lp.sample_rate == 48_000 // 8


@pytest.mark.parametrize("impl", ["direct", "polyphase"])
def test_lowpass_matches_oracle(impl):
    src, osrc = _capture()
    lp = LowPass(src, 2000, 8, 40, fir_impl=impl)
    olp = OracleLowPass(osrc, 2000, 8, 40)
    got, valid = lp.read_at(0, 64)
    want = olp.read_at(0, 64)
    assert valid == len(want) == 64
    np.testing.assert_allclose(got[:valid], want, atol=1e-5)


@pytest.mark.parametrize("impl", ["direct", "polyphase"])
def test_lowpass_offset_reads(impl):
    src, osrc = _capture()
    lp = LowPass(src, 1500, 4, 64, fir_impl=impl)
    olp = OracleLowPass(osrc, 1500, 4, 64)
    got, valid = lp.read_at(100, 128)
    want = olp.read_at(100, 128)
    assert valid == len(want)
    np.testing.assert_allclose(got[:valid], want, atol=1e-5)


def test_lowpass_truncated_tail_semantics():
    """Near EOF the read comes up short and the last outputs convolve a
    zero-padded block — the reference's exact behavior."""
    src, osrc = _capture(n=1000)
    lp = LowPass(src, 2000, 8, 40)
    olp = OracleLowPass(osrc, 2000, 8, 40)
    # claimed length 1 + (1000-40)/8 = 121, but a read of 121 pulls
    # 121*8+40 = 1008 raw > 1000 so valid = (1000-40)/8 = 120
    got, valid = lp.read_at(0, 121)
    want = olp.read_at(0, 121)
    assert valid == len(want) == 120
    np.testing.assert_allclose(got[:valid], want, atol=1e-5)


def test_lowpass_block_boundary_truncation():
    """Outputs near the end of *each pull* see zeros past the block even
    when the stream continues: pulling 32 then 32 differs from pulling 64
    in the overlap region exactly as the reference's per-read convolve."""
    src, osrc = _capture(n=4096)
    lp = LowPass(src, 2000, 8, 64)
    olp = OracleLowPass(osrc, 2000, 8, 64)
    a_got, a_valid = lp.read_at(0, 32)
    b_got, b_valid = lp.read_at(32, 32)
    np.testing.assert_allclose(a_got[:a_valid], olp.read_at(0, 32), atol=1e-5)
    np.testing.assert_allclose(b_got[:b_valid], olp.read_at(32, 32), atol=1e-5)


def test_lowpass_rejects_short_input():
    src, _ = _capture(n=30)
    with pytest.raises(ValueError):
        LowPass(src, 2000, 8, 40)


def test_fir_decimate_impls_agree():
    rng = np.random.default_rng(7)
    n_out, d, size = 50, 8, 40
    n_in = n_out * d + size
    x = (rng.normal(size=(3, n_in)) + 1j * rng.normal(size=(3, n_in))).astype(
        np.complex64
    )
    taps = lowpass_taps(0.05, size)
    xd = to_device_complex(x)
    a = _run_fir(xd, taps, d, n_out, "direct")
    b = _run_fir(xd, taps, d, n_out, "polyphase")
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_fir_overlap_save_matches_direct():
    rng = np.random.default_rng(8)
    n_out, d, size = 64, 32, 400
    n_in = n_out * d + size
    x = (rng.normal(size=(2, n_in)) + 1j * rng.normal(size=(2, n_in))).astype(
        np.complex64
    )
    taps = lowpass_taps(0.01, size)
    xd = to_device_complex(x)
    a = _run_fir(xd, taps, d, n_out, "direct")
    b = _run_fir(xd, taps, d, n_out, "overlap_save")
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_fir_overlap_save_long_filter():
    """BASELINE config 4 class: power=2000 -> 4000 taps."""
    rng = np.random.default_rng(9)
    n_out, d, size = 32, 32, 4000
    n_in = n_out * d + size
    x = (rng.normal(size=(1, n_in)) + 1j * rng.normal(size=(1, n_in))).astype(
        np.complex64
    )
    taps = lowpass_taps(0.001, size)
    xd = to_device_complex(x)
    a = _run_fir(xd, taps, d, n_out, "direct")
    scale = np.abs(a).max()
    for impl in ("overlap_save", "os_poly"):
        b = _run_fir(xd, taps, d, n_out, impl)
        np.testing.assert_allclose(b, a, atol=3e-5 * max(scale, 1.0), err_msg=impl)
    # auto selection picks the polyphase overlap-save for long filters
    c = _run_fir(xd, taps, d, n_out, "auto")
    np.testing.assert_allclose(
        c, _run_fir(xd, taps, d, n_out, "os_poly"), atol=1e-7
    )


@pytest.mark.parametrize("n_out", [1, 64, 128, 200, 300])
def test_fir_banded_matches_direct(n_out):
    """`banded` is auto-selected only at fat dispatches (B*n_out >= 2^17),
    so pin it against `direct` explicitly at small sizes, including
    non-multiples of its 128-output group."""
    rng = np.random.default_rng(10)
    d, size = 8, 96
    n_in = n_out * d + size
    x = (rng.normal(size=(2, n_in)) + 1j * rng.normal(size=(2, n_in))).astype(
        np.complex64
    )
    taps = lowpass_taps(0.03, size)
    xd = to_device_complex(x)
    a = _run_fir(xd, taps, d, n_out, "direct")
    b = _run_fir(xd, taps, d, n_out, "banded")
    np.testing.assert_allclose(b, a, atol=1e-5)


def test_fir_all_impls_agree_random():
    """Property test: every implementation computes the same decimating
    FIR on random (taps, decimate, n_out) configurations."""
    rng = np.random.default_rng(11)
    for case in range(6):
        d = int(rng.choice([1, 2, 3, 4, 8, 16]))
        size = int(rng.integers(2, 12)) * max(d, 2)
        n_out = int(rng.integers(1, 257))
        n_in = n_out * d + size
        x = (rng.normal(size=(1, n_in)) + 1j * rng.normal(size=(1, n_in))).astype(
            np.complex64
        )
        taps = lowpass_taps(float(rng.uniform(0.005, 0.2)), size)
        xd = to_device_complex(x)
        ref = _run_fir(xd, taps, d, n_out, "direct")
        for impl in ("polyphase", "banded", "overlap_save", "os_poly"):
            got = _run_fir(xd, taps, d, n_out, impl)
            np.testing.assert_allclose(
                got,
                ref,
                atol=3e-5,
                err_msg=f"case {case}: impl={impl} d={d} size={size} n_out={n_out}",
            )


def test_fir_auto_crossover_boundaries():
    """`auto` routing is an internal perf decision; whatever it picks at
    each crossover boundary must agree with the reference impl.
    Boundaries from ops/fir.py: m>64 -> overlap_save; d>=4 and
    B*n_out>=2^17 (TOTAL outputs across the batch) -> banded;
    d>=4 -> polyphase; else direct."""
    rng = np.random.default_rng(12)

    def check(d, size, n_out, ref_impl, atol=3e-5, batch=1):
        n_in = n_out * d + size
        x = (
            rng.normal(size=(batch, n_in)) + 1j * rng.normal(size=(batch, n_in))
        ).astype(np.complex64)
        taps = lowpass_taps(0.02, size)
        xd = to_device_complex(x)
        a = _run_fir(xd, taps, d, n_out, "auto")
        b = _run_fir(xd, taps, d, n_out, ref_impl)
        np.testing.assert_allclose(
            a, b, atol=atol, err_msg=f"d={d} size={size} n_out={n_out}"
        )

    # m = ceil(size/d) crossing 64: 64*8=512 taps is polyphase-class,
    # 65*8 goes spectral (polyphase overlap-save) — check both sides
    check(8, 512, 64, "polyphase")
    check(8, 528, 64, "os_poly")
    # banded kicks in at B*n_out = 2^17 total outputs with d >= 4
    # (fat-dispatch rule; compare against polyphase — direct would blow
    # memory here), including when only the BATCH crosses the line
    check(8, 32, 1 << 17, "banded")
    check(8, 32, (1 << 17) - 1, "polyphase")
    check(4, 32, 1 << 13, "banded", batch=16)
    check(4, 32, 1 << 13, "polyphase", batch=15)
    # short-decimation path stays direct
    check(2, 40, 128, "direct")


def test_lowpass_long_taps_stream_matches_oracle():
    src, osrc = _capture(n=16384)
    lp = LowPass(src, 500, 8, 2000)  # auto -> overlap_save (m = 250 subfilters)
    olp = OracleLowPass(osrc, 500, 8, 2000)
    got, valid = lp.read_at(0, 256)
    want = olp.read_at(0, 256)
    assert valid == len(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[:valid], want, atol=5e-5 * max(scale, 1e-6))
