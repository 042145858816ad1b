"""Channelizer model: split a capture into K channel streams at once.

Addition (no reference counterpart — quadrs runs one
``shift`` -> ``lowpass`` chain per channel, README.md:89-95).  The
:class:`Channelize` node plugs into the same lazy stream graph as the
reference-parity stages: host planning keeps the exact span/valid
arithmetic of :class:`~quadrs_tpu.stream.LowPass` (decimation = the
channel count), and the device side computes every channel in one fused
program (:func:`quadrs_tpu.ops.channelizer.channelize_block`).

``read_batch`` returns ``(B, n, K)`` — one trailing channel axis — so
the node is terminal: it is consumed by :func:`run_channelize` /
:class:`~quadrs_tpu.runtime.Executor`, not wrapped by scalar-stream
sinks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import jax.numpy as jnp
import numpy as np

from quadrs_tpu.stream import Plan, Stream


class Channelize(Stream):
    """K-channel polyphase filter bank over ``inner``.

    Channel ``ch`` equals ``Shift(inner, -ch*sr/K) -> LowPass(frequency,
    decimate=K, size)`` within f32 commutation (pinned by tests); the
    length/valid arithmetic is exactly LowPass's with ``decimate = K``
    (reference ``src/filter.rs:45-48,76``).  ``frequency`` defaults to
    the alias-free cutoff ``sr/(2K)``; ``size`` to the reference
    lowpass's default 40 taps (``2*power``, power 20).
    """

    def __init__(
        self,
        inner: Stream,
        channels: int,
        *,
        frequency: int | None = None,
        size: int = 40,
    ):
        from quadrs_tpu.ops.fir import lowpass_taps

        if channels < 2:
            raise ValueError("channelize needs at least 2 channels")
        self.inner = inner
        self.channels = int(channels)
        self.frequency = (
            int(frequency)
            if frequency is not None
            else inner.sample_rate // (2 * self.channels)
        )
        if self.frequency <= 0:
            raise ValueError("channel cutoff must be positive")
        self.size = int(size)
        self.sample_rate = inner.sample_rate // self.channels
        if inner.length < self.size:
            raise ValueError("input shorter than the filter")
        self.length = 1 + (inner.length - self.size) // self.channels
        self.taps = lowpass_taps(self.frequency / inner.sample_rate, self.size)

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(off * self.channels, n * self.channels + self.size)

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        n_in = n * self.channels + self.size
        inner = self.inner.plan(offs * self.channels, n_in, base)
        valid_in = inner.valid
        valid_out = np.maximum(valid_in - self.size, 0) // self.channels
        prep = {"inner": inner.prep, "valid_in": valid_in.astype(np.int32)}
        return Plan(prep=prep, valid=valid_out)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        from quadrs_tpu.ops.channelizer import channelize_block

        n_in = n * self.channels + self.size
        x = self.inner.read_batch(ctx, prep["inner"], n_in)
        mask = jnp.arange(n_in, dtype=jnp.int32)[None, :] < prep["valid_in"][:, None]
        x = jnp.where(mask, x, 0)
        return channelize_block(x, self.taps, self.channels, n)


@dataclass
class ChannelChunk:
    """One chunk of channelized output: ``data[ch, i]`` is output sample
    ``start + i`` of channel ``ch`` (complex64, valid samples only)."""

    start: int  # absolute output-sample offset (per channel)
    data: np.ndarray  # (K, n_valid) complex64


def run_channelize(
    chan: Channelize,
    *,
    chunk: int = 1 << 18,
    max_out: int | None = None,
    progress: Callable[[int], None] | None = None,
    mesh=None,
) -> Iterator[ChannelChunk]:
    """Stream the whole capture through the bank in executor chunks.

    Pull boundaries fall every ``chunk`` output samples, so edge
    truncation matches a reference chain pulled at the same size (only
    the capture tail differs from a single-shot run, exactly like
    LowPass's per-read truncation).

    ``mesh``: an optional Tx1
    :func:`quadrs_tpu.parallel.sharding.make_mesh` — the capture's
    sample axis time-shards across the chips, each exchanging the
    ``size``-sample FIR halo with its right neighbor over the interconnect
    (:func:`~quadrs_tpu.parallel.sharding.make_sharded_channelize_step`).
    Requires the bank to sit directly on a raw capture (the chained
    case shards via the stream runner); the unaligned capture tail runs
    through the single-device path.  The per-shard slice is the "read"
    for the per-read truncation semantics above, so when the capture is
    long enough that each shard pulls a full ``chunk`` the output is
    bit-equal to the single-device run at the same ``chunk`` (pinned by
    tests); on short captures the shard pull shrinks to fit and the
    boundary truncation falls at those (reported) pull edges instead.
    """
    from quadrs_tpu.runtime import Executor, root_step_of, window_batches

    total = chan.length if max_out is None else min(chan.length, max_out)
    if total <= 0:
        return
    done = 0
    lag0 = 0
    if mesh is not None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from quadrs_tpu.parallel.sharding import make_sharded_channelize_step

        src = chan.inner
        if src.root() is not src or not getattr(src, "has_staging", False):
            raise ValueError(
                "channelize -mesh shards a raw capture's sample axis; "
                "drop the intermediate stages or drop -mesh"
            )
        k, size = chan.channels, chan.size
        n_time = int(mesh.shape["time"])
        # per-shard outputs per dispatch: the executor chunk, clamped so
        # short captures still exercise the mesh (halo needs >= size
        # input samples per shard)
        avail = (src.length - size) // (n_time * k)
        per_shard = max(-(-size // k), min(chunk, avail))
        step_out = n_time * per_shard
        step_fn = make_sharded_channelize_step(chan.taps, k, src.format, mesh)
        plane_sh = NamedSharding(mesh, P(None, "time"))
        tail_sh = NamedSharding(mesh, P(None, None))
        o = 0
        while o + step_out <= total and (o + step_out) * k + size <= src.length:
            planes = src.stage(o * k, (o + step_out) * k)
            tail = src.stage((o + step_out) * k, (o + step_out) * k + size)
            re, im = step_fn(
                jax.device_put(np.ascontiguousarray(planes), plane_sh),
                jax.device_put(np.ascontiguousarray(tail), tail_sh),
            )
            data = (
                np.asarray(re).astype(np.complex64)
                + 1j * np.asarray(im).astype(np.complex64)
            )
            yield ChannelChunk(start=o, data=np.ascontiguousarray(data.T))
            done += step_out
            if progress is not None:
                progress(done)
            o += step_out
        lag0 = o
    if lag0 >= total:
        return
    offsets = np.arange(lag0, total, chunk, dtype=np.int64)
    batch, batches = window_batches(offsets, chunk, root_step=root_step_of(chan))
    ex = Executor(chan, chunk, batch=batch)
    for offs in batches:
        out, valid = ex.run(offs)  # (b, chunk, K)
        for row, off, v in zip(out, offs, valid):
            v = int(min(v, total - off))
            if v <= 0:
                continue
            yield ChannelChunk(start=int(off), data=np.ascontiguousarray(row[:v].T))
            done += v
            if progress is not None:
                progress(done)
