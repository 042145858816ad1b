"""Bit-exactness of the integer decode formulas (acceptance criterion:
decode must match the reference's ``src/lib.rs:248-253`` exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest

from quadrs_tpu.formats import (
    FileFormat,
    decode_bytes,
    decode_to_complex64,
    encode_cf32,
    view_raw,
)


def _all_u8_pairs():
    vals = np.arange(256, dtype=np.uint8)
    return np.stack([vals, vals[::-1]], axis=1).reshape(-1)


def test_cs8_bit_exact():
    raw = _all_u8_pairs()
    got = decode_bytes(raw.tobytes(), FileFormat.COMPLEX_INT8)
    comps = raw.view(np.int8)
    want_re = comps[0::2].astype(np.float32) / np.float32(127.0)
    want_im = comps[1::2].astype(np.float32) / np.float32(127.0)
    assert got.real.tobytes() == want_re.tobytes()
    assert got.imag.tobytes() == want_im.tobytes()


def test_cu8_bit_exact():
    raw = _all_u8_pairs()
    got = decode_bytes(raw.tobytes(), FileFormat.COMPLEX_UINT8)
    want = raw.astype(np.float32) / np.float32(255.0) - np.float32(127.5)
    assert got.real.tobytes() == want[0::2].tobytes()
    assert got.imag.tobytes() == want[1::2].tobytes()
    # the reference's odd offset: values live near -127.5, not around 0
    assert got.real.min() >= np.float32(-127.5)
    assert got.real.max() <= np.float32(-126.5)


def test_cs16_bit_exact():
    comps = np.concatenate(
        [
            np.array([-32768, -32767, -1, 0, 1, 32766, 32767], dtype=np.int16),
            np.random.default_rng(0).integers(-32768, 32768, 512).astype(np.int16),
        ]
    )
    if len(comps) % 2:
        comps = comps[:-1]
    got = decode_bytes(comps.astype("<i2").tobytes(), FileFormat.COMPLEX_INT16)
    want = comps.astype(np.float32) / np.float32(65535.0) - np.float32(32767.5)
    assert got.real.tobytes() == want[0::2].tobytes()
    assert got.imag.tobytes() == want[1::2].tobytes()


def test_cf32_roundtrip():
    rng = np.random.default_rng(1)
    samples = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    raw = encode_cf32(samples)
    back = decode_bytes(raw, FileFormat.COMPLEX_FLOAT32)
    assert back.tobytes() == samples.tobytes()


def test_partial_pair_truncated():
    # trailing partial sample pair is dropped (src/samples.rs:84)
    raw = bytes(10)  # 1.25 cu8 samples... 10 bytes = 5 pairs for cu8
    got = decode_bytes(raw[:3], FileFormat.COMPLEX_UINT8)
    assert len(got) == 1


@pytest.mark.parametrize("fmt", list(FileFormat))
def test_device_decode_matches_host(fmt):
    from quadrs_tpu.formats import pack_complex

    rng = np.random.default_rng(2)
    raw_bytes = rng.integers(0, 256, 4096 * fmt.pair_bytes, dtype=np.uint8).tobytes()
    buf = np.frombuffer(raw_bytes, dtype=np.uint8)
    host = decode_bytes(buf, fmt)
    dev = decode_to_complex64(jnp.asarray(view_raw(buf, fmt)), fmt, xp=jnp)
    dev_np = pack_complex(np.asarray(jnp.real(dev)), np.asarray(jnp.imag(dev)), xp=np)
    import jax

    if jax.devices()[0].platform == "cpu":
        assert host.tobytes() == dev_np.tobytes()
    else:
        # an accelerator may divide via a reciprocal approximation:
        # cs8/cu8 decode can differ by 1 ulp from IEEE division
        # (documented in formats.py);
        # the CPU backend — the conformance rig — is bit-exact
        ulp = np.abs(
            host.view(np.float32).view(np.int32).astype(np.int64)
            - dev_np.view(np.float32).view(np.int32).astype(np.int64)
        )
        assert ulp.max() <= 1, f"max ulp diff {ulp.max()}"
