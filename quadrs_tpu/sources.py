"""Stream sources: file-backed captures and the multi-tone generator.

``SampleSource`` is the counterpart of the reference's ``SampleFile``
(``src/samples.rs:44-94``): length is derived from the byte length over
the pair width, reads decode on demand, and trailing partial pairs are
truncated.  Here the raw bytes are staged to the device in their native
narrow dtype and decoded *on chip* (see :mod:`quadrs_tpu.formats`).

``ToneGen`` is the counterpart of ``Gen`` (``src/gen.rs``): sample ``m``
is ``sum_f e^(j*2π*f*m/sr)``, evaluated with exact host-side phase
reduction and f32 trig on device.  Like the reference (``src/gen.rs:35``),
it fills every requested buffer completely — reads never come up short,
even past the nominal length.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp
import numpy as np

from quadrs_tpu.formats import FileDetails, FileFormat, decode_plane, pack_complex
from quadrs_tpu.stream import Plan, Stream
from quadrs_tpu.utils.sniff import guess_details


class SampleSource(Stream):
    """A raw IQ capture, staged lazily and decoded on device."""

    has_staging = True

    def __init__(self, data: np.ndarray, fmt: FileFormat, sample_rate: int):
        """``data``: 1-D uint8 byte buffer (memmap or array) of the capture."""
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        self._bytes = data
        self._native = None
        self.format = fmt
        self.sample_rate = int(sample_rate)
        # reference src/samples.rs:64-66
        self.length = len(data) // fmt.pair_bytes

    @classmethod
    def from_file(cls, path: str, details: FileDetails | None = None) -> "SampleSource":
        if details is None:
            details = guess_details(str(path))
        data = np.memmap(path, dtype=np.uint8, mode="r")
        src = cls(data, details.format, details.sample_rate)
        # byte path through the native loader when available: C++ pread +
        # deinterleave (and background readahead for streaming sinks)
        try:
            from quadrs_tpu.native import NativeCapture, native_available

            if native_available():
                src._native = NativeCapture(path, details.format)
        except Exception:
            src._native = None
        return src

    @property
    def native(self):
        """The :class:`~quadrs_tpu.native.NativeCapture` behind this
        source (C++ pread + deinterleave + ring readahead), or None when
        the source is in-memory or the native loader is unavailable."""
        return self._native

    def raw_bytes(self, lo: int, hi: int) -> bytes:
        """The capture's original interleaved bytes for samples
        [lo, hi) — byte-exact extraction (the burst recorder's write
        path: a re-``from``-able slice of the file, no decode)."""
        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        pair = self.format.pair_bytes
        return bytes(self._bytes[lo * pair : hi * pair])

    # -- staging ----------------------------------------------------------
    def stage(self, lo: int, hi: int) -> np.ndarray:
        """Materialize samples [lo, hi) as (2, hi-lo) native-dtype planes.

        Deinterleaving happens here, on the host, in one pass, so the
        device only ever reads contiguous per-component planes instead
        of stride-2 pairs.
        """
        from quadrs_tpu.formats import planes_from_bytes

        lo = max(0, min(lo, self.length))
        hi = max(lo, min(hi, self.length))
        if self._native is not None:
            return self._native.read_planes(lo, hi - lo)
        pair = self.format.pair_bytes
        return planes_from_bytes(self._bytes[lo * pair : hi * pair], self.format)

    # -- Stream interface -------------------------------------------------
    def span(self, off: int, n: int) -> tuple[int, int]:
        return off, n

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        valid = np.clip(self.length - offs, 0, n)
        prep = {
            "off_rel": (offs - base).astype(np.int32),
            "valid": valid.astype(np.int32),
        }
        return Plan(prep=prep, valid=valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        buf = ctx["buf"]  # (2, staged) native-dtype planes
        idx = prep["off_rel"][:, None] + jnp.arange(n, dtype=jnp.int32)[None, :]
        re = decode_plane(jnp.take(buf[0], idx, mode="clip"), self.format, xp=jnp)
        im = decode_plane(jnp.take(buf[1], idx, mode="clip"), self.format, xp=jnp)
        samples = pack_complex(re, im, xp=jnp)
        mask = jnp.arange(n, dtype=jnp.int32)[None, :] < prep["valid"][:, None]
        return jnp.where(mask, samples, 0)


class PipeSource:
    """A live sequential capture: interleaved IQ bytes from a pipe,
    FIFO, or socket (e.g. ``rtl_sdr - | quadjax stream -stdin yes``).

    Unlike :class:`SampleSource` there is no length up front and no
    random access — only :class:`~quadrs_tpu.stream_runner.StreamRunner`'s
    sequential chunk loop can drive it (the effective capture length is
    discovered at EOF).  Reads block until a full chunk arrives or the
    writer closes, so a slow producer throttles the pipeline instead of
    dropping samples.  A trailing partial sample pair at EOF is
    truncated, matching ``SampleFile``'s length rule (reference
    ``src/samples.rs:64-66``); pipes deliver arbitrary byte boundaries
    mid-stream, so partial pairs are carried between reads.
    """

    is_pipe = True
    native = None
    length = None  # unknown until EOF

    def __init__(self, fileobj, fmt: FileFormat, sample_rate: int):
        """``fileobj``: a binary file object (``sys.stdin.buffer``, a
        socket ``makefile('rb')``, an ``os.fdopen`` of a pipe)."""
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        self._f = fileobj
        self.format = fmt
        self.sample_rate = int(sample_rate)
        self._tail = b""
        self.eof = False
        # optional rolling raw-byte history (the live burst recorder
        # slices closed spans out of it); every consumed sample's bytes
        # enter exactly once, in stream order
        self.byte_ring: RawRing | None = None

    def read_planes(self, n: int) -> np.ndarray:
        """Read up to ``n`` samples as (2, m) native-dtype planes;
        ``m < n`` only at EOF (reads loop until satisfied)."""
        from quadrs_tpu.formats import planes_from_bytes

        pair = self.format.pair_bytes
        want = n * pair
        parts = [self._tail]
        got = len(self._tail)
        while got < want and not self.eof:
            b = self._f.read(want - got)
            if b is None:
                # a non-blocking source (O_NONBLOCK pipe, non-blocking
                # socket) signals "no data yet" with None — wait, don't
                # mistake a momentary gap for end-of-stream
                import time

                time.sleep(0.001)
                continue
            if not b:
                self.eof = True
                break
            parts.append(b)
            got += len(b)
        buf = b"".join(parts)
        m = len(buf) // pair
        self._tail = buf[m * pair :]
        if self.byte_ring is not None and m:
            # the previous tail was never appended (it held no full
            # sample), so this is each byte's single entry
            self.byte_ring.append(buf[: m * pair])
        return planes_from_bytes(
            np.frombuffer(buf[: m * pair], dtype=np.uint8), self.format
        )


class RawRing:
    """Rolling raw-byte history of a live pipe, addressed in absolute
    SAMPLE positions: the burst recorder slices closed spans out of it
    and prunes everything below the earliest still-needed sample, so
    memory stays O(open burst + context) on an endless stream.

    ``cap_bytes`` bounds the retained history — a trigger level below
    the noise floor would otherwise hold the whole stream; exceeding it
    raises with guidance rather than growing without bound (the same
    stance as the demod modes' 1 GiB burst cap).
    """

    def __init__(self, pair_bytes: int, cap_bytes: int = 1 << 30):
        import threading

        self.pair = int(pair_bytes)
        self.cap = int(cap_bytes)
        self.base = 0  # absolute sample index of the first retained byte
        self._chunks: list[bytes] = []
        self._nbytes = 0
        # the runner's staging thread appends while the consumer
        # thread slices/prunes resolved spans
        self._lock = threading.Lock()

    @property
    def end(self) -> int:
        """Absolute sample index one past the retained history."""
        with self._lock:
            return self.base + self._nbytes // self.pair

    def append(self, b: bytes) -> None:
        if not b:
            return
        with self._lock:
            self._chunks.append(b)
            self._nbytes += len(b)
            over = self._nbytes > self.cap
        if over:
            raise ValueError(
                f"burst history exceeds {self.cap} bytes: the trigger "
                "level holds a span open indefinitely — raise -trigger "
                "or lower -pre/-post"
            )

    def slice(self, s0: int, s1: int) -> bytes:
        """Bytes of samples [s0, s1) — absolute positions, clipped to
        the retained end; rewinding below the pruned base raises."""
        with self._lock:
            if s0 < self.base:
                raise ValueError(
                    f"burst slice at sample {s0} was pruned (ring base "
                    f"{self.base})"
                )
            s1 = min(s1, self.base + self._nbytes // self.pair)
            if s1 <= s0:
                return b""
            buf = b"".join(self._chunks)
            self._chunks = [buf]  # keep the coalescing work
            a = (s0 - self.base) * self.pair
            b_ = (s1 - self.base) * self.pair
            return buf[a:b_]

    def prune(self, keep_from_sample: int) -> None:
        """Discard history below ``keep_from_sample`` (absolute)."""
        with self._lock:
            end = self.base + self._nbytes // self.pair
            drop = max(0, min(keep_from_sample, end) - self.base)
            if drop == 0:
                return
            buf = b"".join(self._chunks)
            self._chunks = [buf[drop * self.pair :]]
            self._nbytes -= drop * self.pair
            self.base += drop


class LivePipeStream(SampleSource):
    """Random-access facade over a :class:`PipeSource` for
    forward-moving consumers (the live terminal waterfall): a sliding
    planes buffer grows by reading the pipe on demand and discards
    everything below the last staged ``lo``, so memory stays O(batch
    span) on an endless stream.  ``length`` reads as a huge sentinel
    until EOF, then becomes the real capture length — downstream valid
    clipping works unchanged.  Rewinding below discarded data raises
    (pipes cannot seek)."""

    is_live = True

    def __init__(self, pipe: PipeSource):
        # deliberately not calling SampleSource.__init__: there is no
        # backing byte buffer, and length is a property here
        from quadrs_tpu.formats import planes_from_bytes

        self._pipe = pipe
        self._native = None
        self.format = pipe.format
        self.sample_rate = pipe.sample_rate
        self._base = 0
        self._buf = planes_from_bytes(np.zeros(0, dtype=np.uint8), pipe.format)
        self._eof_len: int | None = None

    @property
    def length(self) -> int:
        return self._eof_len if self._eof_len is not None else (1 << 60)

    def stage(self, lo: int, hi: int) -> np.ndarray:
        if lo < self._base:
            raise ValueError(
                f"live pipe stream cannot rewind to {lo} "
                f"(discarded below {self._base})"
            )
        have_hi = self._base + self._buf.shape[1]
        if hi > have_hi and self._eof_len is None:
            new = self._pipe.read_planes(hi - have_hi)
            self._buf = np.concatenate([self._buf, new], axis=1)
            if new.shape[1] < hi - have_hi:
                self._eof_len = self._base + self._buf.shape[1]
        if lo > self._base:
            self._buf = self._buf[:, lo - self._base :]
            self._base = lo
        hi_eff = min(hi, self._base + self._buf.shape[1])
        return self._buf[:, : max(0, hi_eff - lo)]


_SM_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_C2 = np.uint64(0x94D049BB133111EB)
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: a stateless uint64 hash, so a
    noise value depends only on (seed, absolute index) and random
    access stays coherent at any offset.  uint64 wraparound is the
    algorithm; silence numpy's overflow warnings so -W error / pytest
    filterwarnings=error environments don't trip on it."""
    with np.errstate(over="ignore"):
        z = (np.asarray(x, dtype=np.uint64) + _SM_GAMMA).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * _SM_C1
        z = (z ^ (z >> np.uint64(27))) * _SM_C2
        return z ^ (z >> np.uint64(31))


class ToneGen(Stream):
    """Multi-tone complex exponential generator (``src/gen.rs``), plus a
    An addition the reference lacks: seeded complex Gaussian
    noise (``noise`` = per-component standard deviation) for realistic
    test captures.  The noise is COUNTER-BASED (a splitmix64 hash of
    the absolute sample index through an exact two-uniform Box-Muller),
    so it is deterministic per (seed, index) and random-access
    coherent like the tones — the same sample always gets the same
    noise regardless of pull size or order."""

    has_staging = False

    def __init__(
        self,
        cos: Sequence[int],
        sample_rate: int,
        seconds: float,
        noise: float = 0.0,
        seed: int = 0,
    ):
        # reference src/gen.rs:17-27
        if not cos:
            raise ValueError("cos cannot be empty")
        if sample_rate == 0:
            raise ValueError("sample rate may not be zero")
        if not seconds > 0.0:
            raise ValueError("seconds may not be <= 0")
        if noise < 0.0:
            raise ValueError("noise must be >= 0")
        self.cos = [int(f) for f in cos]
        self.sample_rate = int(sample_rate)
        self.seconds = float(seconds)
        self.noise = float(noise)
        self.seed = int(seed)
        # reference src/gen.rs:31-33 (f64 multiply, truncate)
        self.length = int(self.seconds * float(self.sample_rate))
        from quadrs_tpu.ops.nco import ExactNCO

        self._ncos = [ExactNCO(f, self.sample_rate) for f in self.cos]

    def span(self, off: int, n: int) -> tuple[int, int]:
        return 0, 0

    def _theta0(self, offs: np.ndarray) -> np.ndarray:
        return np.stack([n.angles(offs) for n in self._ncos], axis=1)  # (B, F)

    def _delta(self, n: int) -> np.ndarray:
        i = np.arange(n, dtype=np.int64)
        return np.stack([nc.angles(i) for nc in self._ncos], axis=0)  # (F, n)

    def _noise_planes(self, offs: np.ndarray, n: int):
        """(B, n) f32 (re, im) noise planes for absolute sample indices
        ``offs[b] + j``: two hashed uniforms -> Box-Muller (exactly two
        draws per sample, so the mapping index -> noise is total)."""
        with np.errstate(over="ignore"):
            idx = (
                offs[:, None].astype(np.uint64) + np.arange(n, dtype=np.uint64)
            ) * np.uint64(2)
            key = _splitmix64(
                np.uint64(self.seed) ^ np.uint64(0xA5A5A5A55A5A5A5A)
            )
            h1 = _splitmix64(idx ^ key)
            h2 = _splitmix64((idx + np.uint64(1)) ^ key)
        # (0, 1] / [0, 1) uniforms from the top 53 bits
        u1 = ((h1 >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0**-53
        u2 = (h2 >> np.uint64(11)).astype(np.float64) * 2.0**-53
        r = self.noise * np.sqrt(-2.0 * np.log(u1))
        ang = 2.0 * np.pi * u2
        return (
            (r * np.cos(ang)).astype(np.float32),
            (r * np.sin(ang)).astype(np.float32),
        )

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        # Gen always fills the whole buffer (src/gen.rs:35-47).
        valid = np.full(len(offs), n, dtype=np.int64)
        prep = {"theta0": self._theta0(offs)}
        if self.noise:
            prep["noise_re"], prep["noise_im"] = self._noise_planes(offs, n)
        return Plan(prep=prep, valid=valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        delta = jnp.asarray(self._delta(n))  # (F, n) trace-time constant
        theta = prep["theta0"][:, :, None] + delta[None, :, :]  # (B, F, n)
        tones = jnp.cos(theta) + 1j * jnp.sin(theta)
        out = jnp.sum(tones.astype(jnp.complex64), axis=1)
        if self.noise:
            import jax

            out = out + jax.lax.complex(prep["noise_re"], prep["noise_im"])
        return out


def open_capture(
    path: str,
    sample_rate: str | int | None = None,
    fmt: str | None = None,
) -> SampleSource:
    """Open a capture with filename sniffing and optional overrides."""
    details = guess_details(
        str(path),
        override_sample_rate=None if sample_rate is None else str(sample_rate),
        override_format=fmt,
    )
    return SampleSource.from_file(path, details)
