"""IQ capture formats and bit-exact sample codecs.

The four wire formats and their decode formulas mirror the reference
(``src/lib.rs:61-74`` for the enum, ``src/lib.rs:215-256`` for the byte
widths and decode math) exactly, including the mathematically odd cu8 /
cs16 offsets, which are a stated bit-exactness acceptance criterion:

    cf32:  little-endian IEEE f32 pairs            (GNU-Radio, gqrx)
    cs8 :  f32(int8)  / 127.0                      (HackRF)
    cu8 :  f32(uint8) / 255.0 - 127.5              (RTL-SDR)
    cs16:  f32(int16) / 65535.0 - 32767.5          (Fancy)

Every decode is a pure sequence of IEEE-754 f32 ops in a fixed order, so
the numpy (host) and jnp (device) paths produce identical bits on the
CPU backend (the conformance rig).  One hardware nuance: an accelerator
may lower f32 division through a reciprocal refinement, so the cs8/cu8
divisions can land 1 ulp off IEEE on device — far inside the float32
tolerance of every downstream stage.

Decode is designed to run **on chip**: the host stages the raw capture
bytes as zero-copy numpy views in their native narrow dtype (int8 /
uint8 / int16 / complex64) so integer formats transfer 4-8x fewer bytes
over PCIe, and the widening to complex64 happens inside the jitted XLA
program (fused into whatever consumes it).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


class FileFormat(enum.Enum):
    """Wire format of a raw IQ capture (reference ``src/lib.rs:61-74``)."""

    COMPLEX_FLOAT32 = "cf32"
    COMPLEX_INT8 = "cs8"
    COMPLEX_UINT8 = "cu8"
    COMPLEX_INT16 = "cs16"

    @property
    def type_bytes(self) -> int:
        # reference src/lib.rs:217-224
        return {
            FileFormat.COMPLEX_FLOAT32: 4,
            FileFormat.COMPLEX_INT8: 1,
            FileFormat.COMPLEX_UINT8: 1,
            FileFormat.COMPLEX_INT16: 2,
        }[self]

    @property
    def pair_bytes(self) -> int:
        # reference src/lib.rs:226-229
        return self.type_bytes * 2

    @property
    def raw_dtype(self) -> np.dtype:
        """Native numpy dtype for zero-copy staging of one scalar component."""
        return {
            FileFormat.COMPLEX_FLOAT32: np.dtype("<f4"),
            FileFormat.COMPLEX_INT8: np.dtype("i1"),
            FileFormat.COMPLEX_UINT8: np.dtype("u1"),
            FileFormat.COMPLEX_INT16: np.dtype("<i2"),
        }[self]


# Extension spellings accepted by the reference (src/args.rs:392-402).
_EXTENSIONS = {
    "cf32": FileFormat.COMPLEX_FLOAT32,
    "fc32": FileFormat.COMPLEX_FLOAT32,
    "cs8": FileFormat.COMPLEX_INT8,
    "sc8": FileFormat.COMPLEX_INT8,
    "c8": FileFormat.COMPLEX_INT8,
    "cu8": FileFormat.COMPLEX_UINT8,
    "su8": FileFormat.COMPLEX_UINT8,
    "cs16": FileFormat.COMPLEX_INT16,
    "sc16": FileFormat.COMPLEX_INT16,
    "c16": FileFormat.COMPLEX_INT16,
}


def format_from_extension(ext: str) -> FileFormat | None:
    """Map a filename extension to a format (reference ``src/args.rs:392-402``)."""
    return _EXTENSIONS.get(ext)


@dataclass(frozen=True)
class FileDetails:
    """Resolved capture metadata (reference ``src/lib.rs:76-80``)."""

    format: FileFormat
    sample_rate: int


# ---------------------------------------------------------------------------
# Decoding: raw component values -> f32, then (re, im) -> complex64.
#
# Each formula is the literal reference op sequence (src/lib.rs:248-253):
# a widening to f32 followed by f32 division / subtraction.  `xp` is
# either numpy (host path) or jax.numpy (on-chip path): the ops are
# IEEE-identical.
# ---------------------------------------------------------------------------


def _decode_components(raw, fmt: FileFormat, xp):
    if fmt is FileFormat.COMPLEX_FLOAT32:
        return raw.astype(xp.float32) if raw.dtype != xp.float32 else raw
    if fmt is FileFormat.COMPLEX_INT8:
        return raw.astype(xp.float32) / xp.float32(127.0)
    if fmt is FileFormat.COMPLEX_UINT8:
        return raw.astype(xp.float32) / xp.float32(255.0) - xp.float32(127.5)
    if fmt is FileFormat.COMPLEX_INT16:
        return raw.astype(xp.float32) / xp.float32(65535.0) - xp.float32(32767.5)
    raise ValueError(f"unknown format: {fmt}")


def pack_complex(re, im, xp=jnp):
    """Bit-preserving (re, im) -> complex64 pack (no arithmetic, so NaN
    payloads in cf32 captures survive exactly)."""
    if xp is np:
        out = np.empty(np.broadcast(re, im).shape, dtype=np.complex64)
        out.real = re
        out.imag = im
        return out
    import jax

    return jax.lax.complex(
        xp.asarray(re, dtype=xp.float32), xp.asarray(im, dtype=xp.float32)
    )


def decode_to_complex64(raw, fmt: FileFormat, xp=jnp):
    """Decode interleaved raw component values to complex64.

    ``raw`` has shape ``(..., 2*n)`` of the format's native dtype
    (interleaved re, im).  Returns ``(..., n)`` complex64.  With ``xp=jnp``
    this traces into the surrounding jit program, i.e. the unpack runs on
    the device and XLA fuses it into the consumer.
    """
    comps = _decode_components(raw, fmt, xp)
    return pack_complex(comps[..., 0::2], comps[..., 1::2], xp)


def decode_to_planes(raw, fmt: FileFormat, xp=jnp):
    """Like :func:`decode_to_complex64` but returns ``(re, im)`` f32 planes.

    Preferred on the hot path: the FIR and DFT matmuls run on real
    planes; keeping them separate avoids complex<->planar shuffles.
    """
    comps = _decode_components(raw, fmt, xp)
    return comps[..., 0::2], comps[..., 1::2]


def decode_bytes(buf: bytes | np.ndarray, fmt: FileFormat) -> np.ndarray:
    """Host-side decode of raw capture bytes to complex64 (numpy).

    Trailing partial sample pairs are truncated, as the reference does
    (``src/samples.rs:84``).
    """
    flat = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    pair = fmt.pair_bytes
    n = len(flat) // pair
    flat = flat[: n * pair]
    raw = flat.view(fmt.raw_dtype)
    return np.asarray(decode_to_complex64(raw, fmt, xp=np), dtype=np.complex64)


def view_raw(buf: np.ndarray, fmt: FileFormat) -> np.ndarray:
    """Zero-copy view of a uint8 byte buffer as the format's native dtype."""
    pair = fmt.pair_bytes
    n = len(buf) // pair
    return buf[: n * pair].view(fmt.raw_dtype)


def decode_plane(raw, fmt: FileFormat, xp=jnp):
    """Decode one already-deinterleaved component plane to f32.

    Same bit-exact formulas as :func:`decode_to_complex64`, applied to a
    contiguous plane.  This is the on-device decode path: captures are
    staged as ``(2, n)`` planes — deinterleaved once on the host (or by
    the native loader during the disk read) — so all device access is
    contiguous instead of stride-2.
    """
    return _decode_components(raw, fmt, xp)


def planes_from_bytes(buf: np.ndarray, fmt: FileFormat) -> np.ndarray:
    """Host-side deinterleave: uint8 capture bytes -> (2, n) native-dtype
    planes (one memory pass, contiguous output)."""
    comps = view_raw(np.asarray(buf), fmt)
    n = len(comps) // 2
    return np.ascontiguousarray(comps[: 2 * n].reshape(n, 2).T)


def encode_cf32(samples: np.ndarray) -> bytes:
    """Encode complex64 samples as little-endian interleaved f32 pairs.

    The writer's wire format (reference ``src/lib.rs:197-209``).
    """
    samples = np.ascontiguousarray(samples, dtype=np.complex64)
    return samples.view(np.float32).astype("<f4", copy=False).tobytes()


def encode_samples(samples: np.ndarray, fmt: FileFormat) -> bytes:
    """Encode complex64 samples as a format's interleaved wire bytes —
    the exact INVERSE of the house decode formulas (round to the
    nearest representable code, clamped to the dtype's range), so
    decode(encode(decode(bytes))) round-trips cs8/cu8 captures
    byte-exactly; cs16's own decode is NOT injective (the f32 ulp at
    magnitude ~32767 is 2^-9 vs the 1/65535 code step, so ~128 codes
    collapse per decoded value — a property of the reference formula),
    so cs16 round-trips to re-decode equality instead, with the inverse
    computed in f64 to add no loss of its own.  cu8/cs16 inherit the
    reference decode's DC offsets, so values outside those narrow
    representable bands SATURATE; encode warns when a significant
    fraction of samples clip (a pipeline that removed the offset —
    any shift/filter chain — cannot be stored in cu8/cs16 losslessly).  An addition:
    the reference writer emits cf32 only (``src/lib.rs:197-209``);
    ``write -format`` uses this to quantize converted captures (cs8's
    representable range is the sane [-128/127, 1]; cu8/cs16 inherit the
    reference's odd decode offsets, so their ranges sit where those
    formulas put them)."""
    if fmt is FileFormat.COMPLEX_FLOAT32:
        return encode_cf32(samples)
    samples = np.ascontiguousarray(samples, dtype=np.complex64)
    comps = samples.view(np.float32)
    if fmt is FileFormat.COMPLEX_INT8:
        raw = np.rint(comps * np.float32(127.0))
        lo, hi, dtype = -128, 127, "<i1"
    elif fmt is FileFormat.COMPLEX_UINT8:
        raw = np.rint((comps + np.float32(127.5)) * np.float32(255.0))
        lo, hi, dtype = 0, 255, "u1"
    elif fmt is FileFormat.COMPLEX_INT16:
        raw = np.rint((comps.astype(np.float64) + 32767.5) * 65535.0)
        lo, hi, dtype = -32768, 32767, "<i2"
    else:
        raise ValueError(f"unknown format: {fmt}")
    q = np.clip(raw, lo, hi)
    clipped = float(np.mean(raw != q)) if raw.size else 0.0
    if clipped > 0.001:
        import warnings

        warnings.warn(
            f"{clipped:.1%} of samples saturate {fmt.value}'s representable "
            f"range — cu8/cs16 carry the reference decode's DC offset, so "
            f"offset-free (shifted/filtered) signals cannot be stored in "
            f"them losslessly",
            stacklevel=2,
        )
    return q.astype(dtype).tobytes()


def synth_planes(fmt: FileFormat, n_samples: int, seed: int = 0, n_streams: int | None = None) -> np.ndarray:
    """Deterministic synthetic capture planes in a format's native dtype:
    shape (2, n) or (n_streams, 2, n)."""
    rng = np.random.default_rng(seed)
    shape = (2, n_samples) if n_streams is None else (n_streams, 2, n_samples)
    if fmt is FileFormat.COMPLEX_FLOAT32:
        return rng.normal(scale=0.3, size=shape).astype(np.float32)
    if fmt is FileFormat.COMPLEX_INT8:
        return rng.integers(-127, 128, shape, dtype=np.int64).astype(np.int8)
    if fmt is FileFormat.COMPLEX_UINT8:
        return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)
    return rng.integers(-32768, 32768, shape, dtype=np.int64).astype(np.int16)
