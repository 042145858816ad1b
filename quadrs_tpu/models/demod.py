"""Demodulator models: capture in, bits out.

Composed end-to-end receivers built from the framework's stages — the
"model family" layer above the raw pipeline.  Device side: decode, mix,
filter, energy/discriminator reductions (one fused program per chunk);
host side: clock recovery (inherently sequential, see
:mod:`quadrs_tpu.bits`).

``OokDemod`` implements the README's OOK workflow programmatically
(envelope -> threshold -> run-length clock recovery -> Manchester).
``FskDemod`` wraps shift -> lowpass -> halves-energy discriminator ->
clock recovery.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from quadrs_tpu import bits as bits_mod
from quadrs_tpu import sinks
from quadrs_tpu.stream import LowPass, Shift, Stream

_TAU = 2.0 * math.pi


def manchester_decode(bitstream: list[bool]) -> list[int]:
    """Pair (a, b) -> 1 for pulse-first (10), 0 for gap-first (01);
    returns the longest aligned decode of the stream."""
    best: list[int] = []
    for phase in (0, 1):
        out: list[int] = []
        pairs = zip(bitstream[phase::2], bitstream[phase + 1 :: 2])
        for a, b in pairs:
            if a == b:
                if len(out) > len(best):
                    best = out
                out = []
                continue
            out.append(1 if a and not b else 0)
        if len(out) > len(best):
            best = out
    return best


@dataclass
class OokDemod:
    """On-off-keying receiver: spectral envelope -> pulses -> bits.

    ``width``/``stride`` window the envelope detector exactly like the
    README's `sparkfft -width 4 -stride 2` flow; ``threshold`` is the
    blank/active magnitude cut; ``samples_per_bit`` is in *windows*.
    """

    width: int = 4
    stride: int = 2
    threshold: float = 0.001
    samples_per_bit: float = 8.0

    def pulses(self, stream: Stream, mesh=None) -> np.ndarray:
        from quadrs_tpu.ops.stft import stft_norms
        from quadrs_tpu.runtime import Executor, root_step_of, window_batches

        offsets = np.arange(0, stream.length - self.width, self.stride, dtype=np.int64)
        if len(offsets) == 0:
            raise ValueError("input shorter than the envelope window")

        th = np.float32(self.threshold)

        def post(x):  # device-side envelope flags, one bool per window
            return (stft_norms(x) >= th).any(axis=1)

        # chunk-level banded program for small windows (bare chains):
        # never materializes (k, width) frames
        chunk_post = (
            _envelope_chunk_post(self.width, self.stride, self.threshold)
            if self.width <= 16 and self.stride <= 16
            else None
        )
        fast = _strided_windows_dev(
            stream, self.width, self.stride, len(offsets), post, mesh=mesh,
            chunk_post=chunk_post,
        )
        if fast is not None:
            return fast
        if mesh is not None:
            raise ValueError(
                "-mesh shards the streaming demod front end, which needs "
                "the receiver's own chain over a raw capture file; drop "
                "the chained stages / live pipe or drop -mesh"
            )
        batch, batches = window_batches(offsets, self.width, root_step=root_step_of(stream))
        ex = Executor(stream, self.width, batch=batch, post=stft_norms)
        flags = []
        for offs in batches:
            norms, valid = ex.run(offs)
            if not np.all(valid == self.width):
                raise RuntimeError("short read in OOK demod")
            flags.append((norms >= th).any(axis=1))
        return np.concatenate(flags)

    def demodulate(self, stream: Stream, mesh=None) -> tuple[float, list[bool]]:
        """Returns (clock_error, raw pulse bits)."""
        return bits_mod.scan(
            self.pulses(stream, mesh=mesh), self.samples_per_bit
        )

    def decode_manchester(self, stream: Stream, mesh=None) -> list[int]:
        _, raw = self.demodulate(stream, mesh=mesh)
        return manchester_decode(raw)


@dataclass
class FskDemod:
    """Two-tone FSK receiver: shift -> lowpass -> halves-energy
    discriminator -> clock recovery.

    ``center``: offset of the FSK pair from DC (the `shift` amount);
    ``bandwidth``/``decimate``/``taps``: the channel filter;
    ``fft_width``/``stride``: discriminator windowing (output domain);
    ``symbols_per_window``: inverse symbol rate in windows.
    """

    center: int = 0
    bandwidth: int = 200_000
    decimate: int = 32
    taps: int = 400
    fft_width: int = 64
    stride: int | None = None
    samples_per_symbol: float = 1.0

    def channel(self, stream: Stream) -> Stream:
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def symbols(self, stream: Stream, mesh=None) -> list[int]:
        levels = sinks.freq_levels(
            self.channel(stream), self.fft_width, self.stride, levels=2,
            mesh=mesh,
        )
        return levels.vals

    def demodulate(self, stream: Stream, mesh=None) -> tuple[float, list[bool]]:
        """Run-length clock recovery over the symbol stream."""
        syms = [bool(v) for v in self.symbols(stream, mesh=mesh)]
        return bits_mod.scan(syms, self.samples_per_symbol)


@dataclass
class FmDemod:
    """Frequency-modulation receiver: shift -> lowpass -> quadrature
    discriminator -> (optional) audio filter.  No reference counterpart
    (quadrs demodulates OOK/FSK only) — this is the
    framework's analog-FM model family, built from the same stages.

    The discriminator is the classic polar one: the instantaneous
    frequency at channel sample ``n`` is
    ``angle(x[n] * conj(x[n-1])) * rate / (2*pi)`` Hz.  It is computed
    on device in large chunks (each chunk reads one extra leading
    sample, so chunk boundaries are exact: the output is independent of
    the chunk size).  Output sample ``i`` corresponds to channel sample
    ``i + 1`` — the first channel sample has no predecessor.

    ``deviation`` is the full-scale frequency swing in Hz: audio is
    ``inst_freq / deviation``, so a transmitter swinging +/-deviation
    yields audio in [-1, 1].  ``audio_bandwidth``/``audio_decimate``
    add a second (real) decimating FIR after the discriminator —
    broadcast FM channels decimate to ~250 kHz for the discriminator
    and again to an audio rate here.  ``audio_rate`` rationally
    resamples the result to an exact device rate (48 kHz is rarely an
    integer divisor of the channel rate; see
    :func:`quadrs_tpu.ops.resample.resample_real`).
    """

    center: int = 0
    bandwidth: int = 100_000
    decimate: int = 8
    taps: int = 400
    deviation: float = 75_000.0
    audio_bandwidth: int | None = None
    audio_decimate: int = 1
    audio_taps: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    chunk: int = 1 << 16  # discriminator samples per device window

    def channel(self, stream: Stream) -> Stream:
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def _discriminate_dev(self, stream: Stream, mesh=None):
        """``(channel_rate_hz, device f32[channel_len - 1])`` in Hz —
        the discriminator output assembled on device (window at offset
        o reads chan[o .. o+c] and emits d for samples o+1 .. o+c, so
        offsets stepping c produce every channel sample >= 1 once)."""
        import jax.numpy as jnp

        chan = self.channel(stream)
        if chan.length < 2:
            raise ValueError("input too short for the FM discriminator")
        rate = chan.sample_rate
        c = min(self.chunk, chan.length - 1)
        scale = np.float32(rate / (2.0 * np.pi))

        def post(x):  # (B, c+1) complex -> (B, c) f32 Hz
            d = x[:, 1:] * jnp.conj(x[:, :-1])
            return jnp.arctan2(jnp.imag(d), jnp.real(d)) * scale

        return rate, _chunked_signal_dev(chan, c, 1, post, mesh=mesh)

    def discriminate(self, stream: Stream, mesh=None) -> tuple[int, np.ndarray]:
        """Instantaneous frequency of the filtered channel.

        Returns ``(channel_rate_hz, f32[channel_len - 1])`` in Hz.
        """
        rate, freq = self._discriminate_dev(stream, mesh=mesh)
        return rate, np.asarray(freq)

    def demodulate(self, stream: Stream, mesh=None) -> tuple[int, np.ndarray]:
        """Full receive chain to normalized audio.

        Returns ``(audio_rate_hz, f32 audio)`` with ``inst_freq /
        deviation`` scaling (and the audio FIR applied when
        configured).  The discriminator output stays on device through
        the fused audio tail — only the final audio is fetched.
        """
        rate, freq = self._discriminate_dev(stream, mesh=mesh)
        return _audio_stage(self, rate, freq, div=float(self.deviation))


def _audio_fir(
    rate: int,
    audio: np.ndarray,
    bandwidth: int | None,
    decimate: int,
    n_taps: int,
) -> tuple[int, np.ndarray]:
    """Real decimating FIR over a demodulated audio signal (device, one
    dispatch), with the same taps family and output-length convention as
    :class:`~quadrs_tpu.stream.LowPass`:
    ``n_out = 1 + (len - taps) // decimate``."""
    d = decimate
    cutoff_hz = (
        bandwidth
        if bandwidth is not None
        else rate // (2 * d)  # anti-alias at the output Nyquist
    )
    n_out = 1 + (len(audio) - n_taps) // d
    if n_out < 1:
        raise ValueError("audio shorter than the audio filter")
    n_in = n_out * d + n_taps
    x = np.zeros(n_in, dtype=np.float32)
    x[: len(audio)] = audio[:n_in]
    return rate // d, np.asarray(
        _audio_fir_fn(cutoff_hz / rate, n_taps, d, n_out)(x)
    )


@functools.lru_cache(maxsize=32)
def _audio_fir_fn(cutoff_ratio: float, n_taps: int, d: int, n_out: int):
    """Cached jitted core of :func:`_audio_fir` — demodulating many
    bursts with the same geometry must not recompile per burst."""
    import jax
    import jax.numpy as jnp

    from quadrs_tpu.ops.fir import fir_decimate, lowpass_taps

    taps = lowpass_taps(cutoff_ratio, n_taps)

    @jax.jit
    def run(a):  # complex packing happens on device
        xc = jax.lax.complex(a, jnp.zeros_like(a))
        y = fir_decimate(xc[None, :], taps, d, n_out)
        return jnp.real(y[0])

    return run


@functools.lru_cache(maxsize=64)
def _audio_stage_fused(
    n: int,
    rate: int,
    bandwidth: int | None,
    decimate: int,
    n_taps: int,
    target: int | None,
) -> tuple:
    """One jitted program for the whole analog audio tail: elementwise
    prologue (``x / div + bias`` — FM's deviation scaling, AM's
    modulation-depth normalization) -> optional real decimating FIR ->
    optional rational resample, with NO intermediate host transfer.
    The per-stage size math is :func:`_audio_fir`'s and
    :func:`~quadrs_tpu.ops.resample.resample_real`'s, computed at trace
    build; the device only ever ships the final audio to the host.
    Cached by geometry — many bursts, one compile.

    Returns ``(jitted fn(x, div, bias) -> f32 audio, out_rate)``."""
    import jax
    import jax.numpy as jnp

    from quadrs_tpu.ops.fir import _overlapped_frames, fir_decimate, lowpass_taps
    from quadrs_tpu.ops.resample import resample_tables

    cur_rate, cur_n = int(rate), int(n)
    fir_cfg = None
    if bandwidth is not None or decimate != 1:
        d = decimate
        cutoff_hz = bandwidth if bandwidth is not None else cur_rate // (2 * d)
        f_out = 1 + (cur_n - n_taps) // d
        if f_out < 1:
            raise ValueError("audio shorter than the audio filter")
        f_in = f_out * d + n_taps
        fir_cfg = (lowpass_taps(cutoff_hz / cur_rate, n_taps), d, f_out, f_in)
        cur_rate //= d
        cur_n = f_out
    rs_cfg = None
    if target is not None and int(target) != cur_rate:
        tgt = int(target)
        if tgt <= 0:
            raise ValueError("rates must be positive")
        g = math.gcd(cur_rate, tgt)
        l, m_ = tgt // g, cur_rate // g
        size = 2 * 8 * max(l, m_)  # resample_real's power=8 default
        weights, gamma_min, frame_len, dvec = resample_tables(size, l, m_)
        jmax = (cur_n - gamma_min - 1 - dvec[0]) // m_
        r_out = int(np.min((jmax + 1) * l + np.arange(l)))
        if r_out < 1:
            raise ValueError("audio shorter than the resampling filter")
        nb = -(-r_out // l)
        r_in = (nb - 1) * m_ + frame_len
        rs_cfg = (
            jnp.asarray(weights[0]), gamma_min, m_, frame_len, nb, r_out, r_in,
        )
        cur_rate = tgt

    @jax.jit
    def run(x: jnp.ndarray, div: jnp.ndarray, bias: jnp.ndarray) -> jnp.ndarray:
        y = x / div + bias
        if fir_cfg is not None:
            taps, d, f_out, f_in = fir_cfg
            take = min(f_in, y.shape[0])
            z = y[:take] if take == f_in else jnp.pad(y, (0, f_in - take))
            yc = jax.lax.complex(z, jnp.zeros_like(z))
            y = jnp.real(fir_decimate(yc[None, :], taps, d, f_out)[0])
        if rs_cfg is not None:
            w0, gamma_min, m_, frame_len, nb, r_out, r_in = rs_cfg
            take = min(r_in, max(0, y.shape[0] - gamma_min))
            z = y[gamma_min : gamma_min + take]
            if take < r_in:
                z = jnp.pad(z, (0, r_in - take))
            frames = _overlapped_frames(z[None, :], m_, frame_len, nb)
            y = jnp.einsum(
                "bfm,ml->bfl", frames, w0,
                precision=jax.lax.Precision.HIGHEST,
            ).reshape(-1)[:r_out]
        return y

    return run, cur_rate


def _audio_stage(
    demod, rate: int, audio, div: float = 1.0, bias: float = 0.0
) -> tuple[int, np.ndarray]:
    """The shared audio tail of every analog demod (FM/AM/SSB):
    elementwise ``audio / div + bias`` prologue, optional real
    decimating FIR, optional rational resample to an exact device rate
    — driven by the model's ``audio_*`` fields and fused into ONE
    device program (:func:`_audio_stage_fused`).  ``audio`` may be a
    host f32 array or a device array left by the chunked chain
    programs — either way only the FINAL audio crosses back to the
    host."""
    import jax.numpy as jnp

    if (
        isinstance(audio, np.ndarray)
        and div == 1.0
        and bias == 0.0
        and demod.audio_bandwidth is None
        and demod.audio_decimate == 1
        and (demod.audio_rate is None or demod.audio_rate == rate)
    ):
        return rate, audio  # nothing to do; skip the device round-trip
    fn, out_rate = _audio_stage_fused(
        len(audio), rate, demod.audio_bandwidth, demod.audio_decimate,
        demod.audio_taps, demod.audio_rate,
    )
    y = fn(jnp.asarray(audio), jnp.float32(div), jnp.float32(bias))
    return out_rate, np.asarray(y)


def _channel_parts(chan: Stream):
    """Decompose a ``[Shift at channel rate ∘] [LowPass ∘] [Shift ∘]
    raw-source`` chain — the shape every receiver's :meth:`channel`
    builds, plus the bare/shifted raw source the OOK envelope windows —
    into ``(lowpass_or_None, mix_nco_or_None, source,
    outer_shift_or_None)``, or None when the chain doesn't match
    (chained user stages, live pipes, non-stageable sources)."""
    outer = None
    lp = chan
    if isinstance(lp, Shift) and isinstance(lp.inner, LowPass):
        # SSB's midpoint re-shift at channel rate
        outer, lp = lp, lp.inner
    if not isinstance(lp, LowPass):
        lp, inner = None, lp  # bare source (OOK: strided raw windows)
    else:
        inner = lp.inner
    nco = None
    if isinstance(inner, Shift):
        if inner.sample_rate != inner.inner.sample_rate:
            return None
        nco = inner._nco
        inner = inner.inner
    if inner.root() is not inner or not getattr(inner, "has_staging", False):
        return None
    if getattr(inner, "is_live", False):
        return None
    return lp, nco, inner, outer


_CHANNEL_RAW_BUDGET = 1 << 23  # raw samples per streaming dispatch


@functools.lru_cache(maxsize=16)
def _envelope_weights(width: int, stride: int) -> tuple[np.ndarray, np.ndarray]:
    """Banded DFT-bin weights for the small-width strided envelope:
    ``W[l*stride + j, m*128 + l] = F[j, m]`` — 128 strided windows x
    ``width`` bins per matmul block, so the envelope never materializes
    ``(k, width)`` frames of tiny rows.  Returns f32
    ``(span_p, width*128)`` real/imag planes."""
    from quadrs_tpu.ops.stft import _dft_matrix_np

    f = _dft_matrix_np(width)
    span = 127 * stride + width
    span_p = -(-span // 128) * 128
    wr = np.zeros((span_p, width * 128), dtype=np.float32)
    wi = np.zeros((span_p, width * 128), dtype=np.float32)
    for m in range(width):
        for l in range(128):
            wr[l * stride : l * stride + width, m * 128 + l] = f[:, m].real
            wi[l * stride : l * stride + width, m * 128 + l] = f[:, m].imag
    return wr, wi


def _envelope_chunk_post(width: int, stride: int, threshold: float):
    """Chunk-level OOK envelope: flags ``any_bin(|DFT bin| >= th)`` for
    ``kk`` stride-spaced windows straight from the decoded chunk (see
    :func:`_envelope_weights`).  Boolean output matches the per-frame
    ``stft_norms`` path (same DFT, f32 matmul accumulation may differ
    at the last ulp of the magnitude — a flag flips only when a
    window's peak bin sits within rounding of the threshold)."""
    import jax
    import jax.numpy as jnp

    from quadrs_tpu.ops.fir import _overlapped_frames

    wr_np, wi_np = _envelope_weights(width, stride)
    span_p = wr_np.shape[0]
    th = np.float32(threshold)

    def chunk_post(x, kk):
        wr = jnp.asarray(wr_np)
        wi = jnp.asarray(wi_np)
        g = -(-kk // 128)
        lr = _overlapped_frames(jnp.real(x)[None, :], 128 * stride, span_p, g)[0]
        li = _overlapped_frames(jnp.imag(x)[None, :], 128 * stride, span_p, g)[0]
        p = jax.lax.Precision.HIGHEST
        br = jnp.matmul(lr, wr, precision=p) - jnp.matmul(li, wi, precision=p)
        bi = jnp.matmul(lr, wi, precision=p) + jnp.matmul(li, wr, precision=p)
        v = (br * br + bi * bi).reshape(g, width, 128).max(axis=1)
        return jnp.sqrt(v.reshape(-1)[:kk]) >= th

    return chunk_post


def _channel_step(
    chan: Stream, c: int, lead: int, post, stride: int | None = None,
    mesh=None, chunk_post=None,
):
    """The streaming demod dispatch: one jitted program computing ``k``
    per-pull windows of the channel (decode -> table mix -> truncated
    FIR -> optional channel-rate re-shift -> ``post``) from one
    contiguous staged chunk, plus a host-side argument builder.

    Per-pull truncation is the pinned contract (each window's FIR tail
    sees zeros past its own block, so the chunk size is part of the
    semantics, exactly as for the sparkfft / writer sinks) — windows
    here are placed and truncated identically to the Executor path; the
    NCO mix is evaluated from host-exact f64 cos/sin tables by the
    angle-addition identity (4 mul + 2 add per element) instead of the
    two per-element device transcendentals that dominate that path, so
    values agree to f32 rounding of the mix.

    ``stride``: channel samples between window starts (default ``c``:
    the analog receivers' contiguous assembly, each window overlapping
    the next by ``lead``).  ``sinks.freq_levels`` passes its own stride
    for the reference bucket's strided discriminator windows.

    ``chunk_post``: optional chunk-level replacement for ``post`` on
    BARE chains (no mix, no FIR, no re-shift — the raw-capture OOK
    shape): ``chunk_post(x, kk) -> (kk, ...)`` receives the decoded
    complex chunk covering ``kk`` windows instead of materialized
    ``(kk, n_in)`` frames, so tiny widths skip the 128-lane frame
    padding (:func:`_envelope_chunk_post`); it must produce the same
    values as ``post`` over the frames.  Ignored on channel-shaped
    chains.  It also lifts the heavily-overlapped-window guard (the
    banded weights duplicate ~width/(128*stride), not width/stride).

    ``mesh``: a Tx1 :func:`quadrs_tpu.parallel.sharding.make_mesh` —
    the dispatch's window axis time-shards over the chips.  Each chip
    holds a contiguous ``k/T`` windows' worth of NATIVE capture planes
    and pulls the ``n_in - hop`` window-overlap halo from its right
    neighbor over the interconnect (``ppermute``; the last shard takes the fed tail
    — the true stream continuation), decodes on device, and runs the
    SAME per-window program on its local windows, so sharded windows
    match the single-device dispatch to f32 accumulation order (XLA
    tiles the FIR matmuls differently per batch shape; placement and
    truncation are exact).  Mesh dispatches cover FULL windows only
    (``geom['n_full']`` of them) — the EOF tail stitches through a
    single-device builder, exactly like the sharded matched filter
    (:func:`quadrs_tpu.parallel.sharding.make_sharded_find_step`).

    Returns ``(run, args_for, geom)`` — ``run(*args) -> (k, n - lead,
    ...)`` traced program, ``args_for(o) -> (*args, v)`` for the
    dispatch whose first window sits at channel offset ``o`` — or None
    when the chain shape is unsupported (chained user stages, live
    pipes) or, with ``mesh``, when the capture is too short to give
    every chip a window."""
    import jax
    import jax.numpy as jnp

    from quadrs_tpu.formats import decode_plane, pack_complex

    hit = _channel_parts(chan)
    if hit is None:
        return None
    lp, nco, src, outer = hit
    d, size = (lp.decimate, lp.size) if lp is not None else (1, 0)
    use_chunk = chunk_post is not None and lp is None and nco is None \
        and outer is None
    if chan.length - lead < 1:
        return None  # caller's too-short guards produce the error text
    stride = c if stride is None else int(stride)
    hop = stride * d  # raw samples between window starts
    n = c + lead  # channel samples per window
    n_in = n * d + size  # raw samples per window
    if n_in > 8 * hop and not use_chunk:
        return None  # heavily overlapped windows: the frame duplication
        # would balloon memory — the strided-bank machinery's domain
        # (chunk_post never builds the frames, so it is exempt)
    # k windows per dispatch: bounded by the staged raw span AND by the
    # lane-padded frame footprint (a width-4 OOK window still occupies a
    # 128-lane row on device), never more than the stream needs (frames
    # come from ceil(n_in/hop) row slices of the decoded chunk, so k is
    # free to be large without unrolling the program)
    pad_in = -(-n_in // 128) * 128
    if use_chunk:
        # no (k, n_in) frames: the footprint is the staged planes plus
        # the ~(width/(128*stride))-duplicated banded lhs, so only the
        # raw budget bounds k — and tiny-hop dispatches need to be FAT
        # to amortize the per-dispatch overhead
        k = max(1, _CHANNEL_RAW_BUDGET // max(1, hop))
        k = min(k, -(-int(chan.length - lead) // stride), 1 << 21)
    else:
        k = max(1, min(_CHANNEL_RAW_BUDGET // max(1, hop),
                       2 * _CHANNEL_RAW_BUDGET // pad_in))
        k = min(k, -(-int(chan.length - lead) // stride), 1 << 18)
    n_time = 1
    # window-overlap halo a shard pulls from its right neighbor; gapped
    # strided windows (stride > width: n_in <= hop) need none — every
    # window lies inside its own shard's k_loc*hop slice
    halo_n = max(0, n_in - hop)
    if mesh is not None:
        if mesh.shape.get("stream", 1) != 1:
            raise ValueError(
                "demod -mesh shards one capture over 'time'; use a Tx1 mesh"
            )
        n_time = int(mesh.shape["time"])
        # full windows only: window j (raw offset j*hop) is full iff
        # j*hop + n_in <= src.length; partial windows stitch through the
        # single-device builder
        n_full = 0 if src.length < n_in else (src.length - n_in) // hop + 1
        # per-chip budget; k divisible by the mesh so every chip gets
        # the same window count, clamped so short captures still shard
        k = min(k * n_time, n_full // n_time * n_time, 1 << 18)
        if k < n_time:
            return None  # too short to give every chip a window
        k_loc = k // n_time
        if halo_n > k_loc * hop:
            return None  # halo would reach past the immediate neighbor
    span = (k - 1) * hop + n_in  # contiguous raw per dispatch
    step = k * stride  # channel samples advanced per dispatch

    # host-exact trig tables: cos/sin of the in-window angle deltas
    # (f64-evaluated, one-time) and per-window base phases per dispatch
    if nco is not None:
        cd_np, sd_np = nco.cis(np.arange(n_in, dtype=np.int64))
        cd = jnp.asarray(cd_np.astype(np.float32))
        sd = jnp.asarray(sd_np.astype(np.float32))

    def core(x, c0, s0, th_outer, valid_in, kk):
        """Per-window compute shared by the single-device jit and the
        shard_map local: ``x`` the decoded complex chunk covering ``kk``
        windows (length >= (kk-1)*hop + n_in)."""
        from quadrs_tpu.ops.fir import _overlapped_frames

        if use_chunk:
            # bare chain: windows are raw slices — hand the chunk to the
            # caller's chunk-level program (per-window EOF masking is
            # moot: strided callers drop partial windows on the host,
            # and staged pads are zeros)
            return chunk_post(x[: (kk - 1) * hop + n_in], kk)

        # (kk, n_in) windows from ceil(n_in/hop) row slices of the
        # decoded chunk — the overlap is re-sliced, never re-read (and
        # never gathered: overlapping-window gathers are the 80x cliff)
        rows = _overlapped_frames(x[None, :], hop, n_in, kk)[0]
        # zero past each window's valid extent BEFORE the FIR, exactly
        # as LowPass.read_batch does (EOF truncation in decoded domain)
        mask = (
            jnp.arange(n_in, dtype=jnp.int32)[None, :] < valid_in[:, None]
        )
        rows = jnp.where(mask, rows, 0)
        if nco is not None:
            cm = c0[:, None] * cd[None, :] - s0[:, None] * sd[None, :]
            sm = s0[:, None] * cd[None, :] + c0[:, None] * sd[None, :]
            rows = jax.lax.complex(
                jnp.real(rows) * cm - jnp.imag(rows) * sm,
                jnp.real(rows) * sm + jnp.imag(rows) * cm,
            )
        if lp is not None:
            from quadrs_tpu.ops.fir import fir_decimate

            y = fir_decimate(rows, lp.taps, d, n, impl=lp.fir_impl)
        else:
            y = rows  # bare source: the window IS the channel
        if outer is not None:
            ph = jax.lax.complex(jnp.cos(th_outer), jnp.sin(th_outer))
            y = y * ph.astype(y.dtype)
        return post(y)  # (kk, n - lead, ...trailing component axes)

    def _decode(block):
        return pack_complex(
            decode_plane(block[0], src.format, xp=jnp),
            decode_plane(block[1], src.format, xp=jnp),
            xp=jnp,
        )

    if mesh is None:
        @jax.jit
        def run(planes, c0, s0, th_outer, valid_in):
            return core(_decode(planes), c0, s0, th_outer, valid_in, k)
    else:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        def local(planes_l, tail_l, c0_l, s0_l, th_l, valid_l):
            if halo_n:
                perm = [(i, (i - 1) % n_time) for i in range(n_time)]
                halo = jax.lax.ppermute(planes_l[:, :halo_n], "time", perm)
                tail_l = jax.lax.pcast(tail_l, ("time",), to="varying")
                is_last = jax.lax.axis_index("time") == n_time - 1
                halo = jnp.where(is_last, tail_l, halo)
                block = jnp.concatenate([planes_l, halo], axis=1)
            else:
                block = planes_l
            return core(_decode(block), c0_l, s0_l, th_l, valid_l, k_loc)

        # out_specs: the window axis shards, trailing axes replicate —
        # probed from the post's output tree (e.g. PSK's stacked planes)
        probe = jax.eval_shape(
            lambda x, c0, s0, th, v: core(x, c0, s0, th, v, k_loc),
            jax.ShapeDtypeStruct(((k_loc - 1) * hop + n_in,), jnp.complex64),
            jax.ShapeDtypeStruct((k_loc,), jnp.float32),
            jax.ShapeDtypeStruct((k_loc,), jnp.float32),
            jax.ShapeDtypeStruct((k_loc, n), jnp.float32),
            jax.ShapeDtypeStruct((k_loc,), jnp.int32),
        )
        out_specs = jax.tree_util.tree_map(
            lambda s: P("time", *([None] * (len(s.shape) - 1))), probe
        )
        run = jax.jit(jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, "time"), P(None, None), P("time"),
                      P("time"), P("time", None), P("time")),
            out_specs=out_specs,
            # fir_decimate's overlap-save path scans with unvarying
            # inits (shared single-chip code), like the find step
            check_vma=False,
        ))
        plane_sh = NamedSharding(mesh, P(None, "time"))
        rep_sh = NamedSharding(mesh, P(None, None))
        vec_sh = NamedSharding(mesh, P("time"))
        th_sh = NamedSharding(mesh, P("time", None))

    if mesh is None:
        zeros = jax.device_put(np.zeros((k, n), dtype=np.float32))
    else:
        zeros = jax.device_put(np.zeros((k, n), dtype=np.float32), th_sh)

    def args_for(o: int):
        """Host-side inputs for the dispatch at channel offset ``o``:
        ``(*run args, v)`` — ``v`` the per-window valid channel
        counts.  Mesh dispatches must cover full windows only (the
        caller steps through ``geom['n_full']``)."""
        lo = o * d
        w_offs = o + stride * np.arange(k, dtype=np.int64)
        if mesh is None:
            hi = min(lo + span, src.length)
            planes = np.ascontiguousarray(src.stage(lo, hi))
            got = planes.shape[-1]
            if got < span:
                planes = np.pad(planes, ((0, 0), (0, span - got)))
            planes_dev = jax.device_put(planes)
            valid_in = np.clip(src.length - w_offs * d, 0, n_in)
        else:
            body = np.ascontiguousarray(src.stage(lo, lo + k * hop))
            tail = np.ascontiguousarray(
                src.stage(lo + k * hop, lo + k * hop + halo_n)
            ) if halo_n else np.zeros((2, 0), dtype=body.dtype)
            planes_dev = jax.device_put(body, plane_sh)
            tail_dev = jax.device_put(tail, rep_sh)
            valid_in = np.full((k,), n_in, dtype=np.int64)
        v = np.maximum(valid_in - size, 0) // d
        if nco is not None:
            c0_np, s0_np = nco.cis(w_offs * d)
            c0 = c0_np.astype(np.float32)
            s0 = s0_np.astype(np.float32)
        else:
            c0 = s0 = np.zeros((k,), np.float32)
        th_np = (
            outer._nco.angles(
                w_offs[:, None] + np.arange(n, dtype=np.int64)[None, :]
            ).astype(np.float32)
            if outer is not None
            else None
        )
        if mesh is None:
            th_outer = jax.device_put(th_np) if th_np is not None else zeros
            return (
                planes_dev, jnp.asarray(c0), jnp.asarray(s0), th_outer,
                jnp.asarray(valid_in.astype(np.int32)), v,
            )
        th_outer = (
            jax.device_put(th_np, th_sh) if th_np is not None else zeros
        )
        return (
            planes_dev, tail_dev,
            jax.device_put(c0, vec_sh), jax.device_put(s0, vec_sh),
            th_outer,
            jax.device_put(valid_in.astype(np.int32), vec_sh), v,
        )

    geom = {"k": k, "n": n, "n_in": n_in, "span": span, "step": step,
            "decimate": d}
    if mesh is not None:
        geom["n_full"] = n_full
    return run, args_for, geom


def _streaming_signal_dev(chan: Stream, c: int, lead: int, post, mesh=None):
    """:func:`_chunked_signal_dev`'s fast path: drive
    :func:`_channel_step` dispatches over the whole stream and assemble
    the flat result on device.  Output length and EOF arithmetic match
    the Executor path exactly; values agree to f32 rounding of the mix.
    Returns None when the chain shape is unsupported.

    ``mesh``: time-shard the full-window aligned prefix across the
    chips (see :func:`_channel_step`); the EOF tail stitches through
    the single-device dispatches below, so output length and placement
    are unchanged.  Mesh parts are assembled on host (f32 only — the
    audio tail re-uploads once)."""
    import jax.numpy as jnp

    built = _channel_step(chan, c, lead, post)
    if built is None:
        return None
    run, args_for, geom = built
    k, step = geom["k"], geom["step"]
    n = geom["n"]
    parts = []
    o0 = 0
    if mesh is not None:
        m_built = _channel_step(chan, c, lead, post, mesh=mesh)
        if m_built is not None:
            run_m, args_m, geom_m = m_built
            k_m, n_full = geom_m["k"], geom_m["n_full"]
            # windows step c here, so window j sits at channel offset
            # j*c; dispatch while every window in it is full
            w0 = 0
            while w0 + k_m <= n_full:
                *margs, _v = args_m(w0 * c)
                out = run_m(*margs)
                parts.append(
                    np.asarray(out).reshape((-1,) + out.shape[2:])
                )
                w0 += k_m
            o0 = w0 * c
    stop = False
    for o in range(o0, int(chan.length - lead), step):
        *args, v = args_for(o)
        out = run(*args)
        m = k * c
        for j in range(k):
            if v[j] < n:
                m = j * c + max(int(v[j]) - lead, 0)
                stop = True
                break
        # flatten windows; trailing component axes (e.g. PSK's stacked
        # real/imag planes) ride along
        flat = out.reshape((-1,) + out.shape[2:])
        parts.append(flat if m == flat.shape[0] else flat[:m])
        if stop:
            break
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def _strided_windows_dev(
    stream: Stream, width: int, stride: int, total: int, post, mesh=None,
    chunk_post=None,
):
    """``post`` outputs for ``total`` FULL strided ``width``-windows of
    ``stream`` (the ``freq_levels`` / OOK-envelope shape: every window
    read-exact, no EOF truncation), computed by streaming
    :func:`_channel_step` dispatches and assembled on host.  Returns the
    concatenated tree (leading axis ``total``) or None when the chain
    shape is unsupported — callers keep the windowed Executor path as
    the general fallback.

    ``mesh``: time-shard an aligned prefix of the windows across the
    chips (see :func:`_channel_step`); the remainder runs through the
    single-device dispatches below."""
    import jax

    if total <= 0:
        return None
    built = _channel_step(stream, width, 0, post, stride=stride,
                          chunk_post=chunk_post)
    if built is None:
        return None
    run, args_for, geom = built
    k = geom["k"]
    chunks = []
    start = 0
    if mesh is not None:
        m_built = _channel_step(stream, width, 0, post, stride=stride,
                                mesh=mesh, chunk_post=chunk_post)
        if m_built is not None:
            run_m, args_m, geom_m = m_built
            k_m = geom_m["k"]
            lim = min(total, geom_m["n_full"])
            while start + k_m <= lim:
                *margs, _v = args_m(start * stride)
                out = run_m(*margs)
                chunks.append(
                    jax.tree_util.tree_map(lambda a: np.asarray(a), out)
                )
                start += k_m
    for w0 in range(start, total, k):
        *args, v = args_for(w0 * stride)
        take = min(k, total - w0)
        if np.any(np.asarray(v[:take]) < width):
            # placement disagrees with the read-exact contract; let the
            # Executor path produce the canonical error
            return None
        out = run(*args)
        chunks.append(
            jax.tree_util.tree_map(lambda a: np.asarray(a[:take]), out)
        )
    if len(chunks) == 1:
        return chunks[0]
    return jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *chunks)


def _chunked_signal_dev(
    chan: Stream, c: int, lead: int, post, mesh=None
) -> "object":
    """Run ``post`` over the channel in ``c``-sample device chunks
    (windows of ``c + lead`` samples at offsets stepping ``c``, each
    emitting ``c`` f32 outputs) and assemble the flat result ON DEVICE
    — the analog demods' shared chunk loop, with no per-chunk host
    fetch.  A short read (EOF only — see FmDemod.discriminate) truncates
    and ends the stream, exactly as the host assembly did.

    Chains of the shape every receiver's ``channel()`` builds over a
    stageable raw source take the streaming front end
    (:func:`_streaming_signal_dev` — measured 10-50x the windowed
    Executor path); anything else (user-chained stages, pipes) keeps
    the fully general windowed path below."""
    import jax.numpy as jnp

    from quadrs_tpu.runtime import Executor, root_step_of, window_batches

    out = _streaming_signal_dev(chan, c, lead, post, mesh=mesh)
    if out is not None:
        return out
    if mesh is not None:
        raise ValueError(
            "-mesh shards the streaming demod front end, which needs "
            "the receiver's own chain over a raw capture file; drop "
            "the chained stages / live pipe or drop -mesh"
        )

    offsets = np.arange(0, chan.length - lead, c, dtype=np.int64)
    batch, batches = window_batches(
        offsets, c + lead, root_step=root_step_of(chan)
    )
    ex = Executor(chan, c + lead, batch=batch, post=post)
    parts = []
    for offs in batches:
        vals, valid = ex.run(offs)  # (B', c) f32, device-resident
        m = vals.shape[0] * c
        stop = False
        for i in range(len(offs)):
            v = int(valid[i])
            if v < c + lead:
                m = i * c + max(v - lead, 0)
                stop = True
                break
        flat = vals.reshape(-1)
        parts.append(flat if m == flat.shape[0] else flat[:m])
        if stop:
            break
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


@dataclass
class AmDemod:
    """Amplitude-modulation receiver: shift -> lowpass -> envelope
    detector -> (optional) audio filter.  No reference counterpart —
    the third analog product alongside :class:`FmDemod`, built from the
    same stages.

    The envelope is ``|x[n]|`` of the filtered channel; audio is the
    modulation ``envelope / mean(envelope) - 1`` (so a transmitter at
    modulation depth m yields audio swinging +/-m around zero,
    independent of capture gain).  The whole capture's mean is the
    carrier estimate — these are buffered bursts, like the other demod
    models.
    """

    center: int = 0
    bandwidth: int = 10_000
    decimate: int = 8
    taps: int = 400
    audio_bandwidth: int | None = None
    audio_decimate: int = 1
    audio_taps: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    chunk: int = 1 << 16  # envelope samples per device window

    def channel(self, stream: Stream) -> Stream:
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def _envelope_dev(self, stream: Stream, mesh=None):
        """``(channel_rate_hz, device |x| f32[channel_len])`` of the
        filtered channel (chunked on device; no window overlap)."""
        import jax.numpy as jnp

        chan = self.channel(stream)
        if chan.length < 1:
            raise ValueError("input too short for the AM envelope")
        c = min(self.chunk, chan.length)
        return chan.sample_rate, _chunked_signal_dev(chan, c, 0, jnp.abs, mesh=mesh)

    def envelope(self, stream: Stream, mesh=None) -> tuple[int, np.ndarray]:
        """``(channel_rate_hz, |x| f32[channel_len])`` of the filtered
        channel (chunked on device; no window overlap needed)."""
        rate, env = self._envelope_dev(stream, mesh=mesh)
        return rate, np.asarray(env)

    def demodulate(self, stream: Stream, mesh=None) -> tuple[int, np.ndarray]:
        """Full receive chain to audio in modulation-depth units
        (``envelope / carrier - 1``).  The envelope stays on device
        through the fused audio tail; only the carrier estimate (one
        scalar — the sanity gate below needs it on host anyway) and the
        final audio are fetched."""
        import jax
        import jax.numpy as jnp

        rate, env = self._envelope_dev(stream, mesh=mesh)
        carrier = float(jax.jit(jnp.mean)(jnp.asarray(env)))
        if carrier <= 0.0:
            raise ValueError("no carrier: the channel envelope is all zero")
        return _audio_stage(self, rate, env, div=carrier, bias=-1.0)


@dataclass
class SsbDemod:
    """Single-sideband receiver (filter method): shift the chosen
    sideband's midpoint to DC, symmetric lowpass + decimate, undo the
    midpoint shift at the channel rate, take the real part.  No
    reference counterpart — the fourth analog product alongside
    :class:`FmDemod`/:class:`AmDemod`, built from the same validated
    stages (two exact-NCO shifts and one decimating FIR).

    ``center`` follows the house shift convention (the value handed to
    :class:`~quadrs_tpu.stream.Shift`): bring the SUPPRESSED CARRIER to
    DC with ``center = -carrier_offset``.  USB then occupies
    ``[0, bandwidth]`` and LSB ``[-bandwidth, 0]`` around DC; the demod
    pre-shifts by ``-/+ bandwidth/2`` so the sideband is symmetric
    about DC, filters at ``bandwidth/2``, decimates, and re-shifts by
    ``+/- bandwidth/2`` at the channel rate so ``real(x)`` is the
    audio.  Gain is 1: a unit USB tone ``e^{j 2 pi (fc + fa) t}``
    recovers ``cos(2 pi fa t + phi)`` at unit amplitude (``phi`` from
    the FIR group delay).  ``bandwidth`` must be even (the midpoint
    shift is exact integer Hz) and under the channel rate.
    """

    center: int = 0
    bandwidth: int = 3_000
    decimate: int = 8
    taps: int = 400
    sideband: str = "usb"  # or "lsb"
    audio_bandwidth: int | None = None
    audio_decimate: int = 1
    audio_taps: int = 64
    audio_rate: int | None = None  # rational resample to this exact Hz
    chunk: int = 1 << 16  # baseband samples per device window

    def _sign(self) -> int:
        if self.sideband not in ("usb", "lsb"):
            raise ValueError(f"unknown sideband {self.sideband!r}: usb|lsb")
        return 1 if self.sideband == "usb" else -1

    def channel(self, stream: Stream) -> Stream:
        if self.bandwidth % 2 or self.bandwidth <= 0:
            raise ValueError("bandwidth must be positive and even")
        sign = self._sign()
        half = self.bandwidth // 2
        pre = self.center - sign * half  # carrier -> DC, then midpoint -> DC
        chain: Stream = stream
        if pre:
            chain = Shift(chain, pre, chain.sample_rate)
        chain = LowPass(chain, half, self.decimate, self.taps)
        # after the re-shift the audio occupies [0, bandwidth] of a REAL
        # stream at the channel rate: anything past rate/2 folds, so the
        # guard is bandwidth <= rate/2 (not merely < rate)
        if self.bandwidth * 2 > chain.sample_rate:
            raise ValueError(
                f"bandwidth {self.bandwidth} exceeds half the channel rate "
                f"{chain.sample_rate} (lower the decimation or the bandwidth)"
            )
        if half:  # undo the midpoint shift at the decimated rate
            chain = Shift(chain, sign * half, chain.sample_rate)
        return chain

    def _baseband_dev(self, stream: Stream, mesh=None):
        """``(channel_rate_hz, device real(x) f32[channel_len])`` of the
        re-centered sideband (chunked on device, no overlap needed)."""
        import jax.numpy as jnp

        chan = self.channel(stream)
        if chan.length < 1:
            raise ValueError("input too short for the SSB demodulator")
        c = min(self.chunk, chan.length)
        return chan.sample_rate, _chunked_signal_dev(chan, c, 0, jnp.real, mesh=mesh)

    def baseband(self, stream: Stream, mesh=None) -> tuple[int, np.ndarray]:
        """``(channel_rate_hz, real(x) f32[channel_len])`` of the
        re-centered sideband (chunked on device, no overlap needed)."""
        rate, bb = self._baseband_dev(stream, mesh=mesh)
        return rate, np.asarray(bb)

    def demodulate(self, stream: Stream, mesh=None) -> tuple[int, np.ndarray]:
        """Full receive chain to audio (``real`` of the re-centered
        sideband, optional audio FIR / rational resample) — device-
        resident end to end; only the final audio is fetched."""
        rate, bb = self._baseband_dev(stream, mesh=mesh)
        return _audio_stage(self, rate, bb)


# --------------------------------------------------------------- PSK


@dataclass(frozen=True)
class PskEstimate:
    """Synchronization estimates recovered from one PSK burst."""

    freq_hz: float  # residual carrier offset at the channel rate
    phase: float  # common phase (radians; one of the ``order`` branches)
    tau: float  # symbol timing offset, channel samples in [0, sps)
    sps: float  # channel samples per symbol
    rate: int  # channel sample rate (Hz)
    n: int  # baseband samples analyzed


@functools.lru_cache(maxsize=None)
def _psk_peak_fn(npad: int, order: int):
    """Device program: power spectrum peak of the order-th power of the
    masked burst.  Returns ``(k0, P[k0-1], P[k0], P[k0+1])`` for
    host-side parabolic refinement (one scalar fetch; the f64 math that
    follows stays on the host, like every NCO phase in this package)."""
    import jax
    import jax.numpy as jnp

    def run(planes, n):
        idx = jnp.arange(npad, dtype=jnp.int32)
        mask = (idx < n).astype(jnp.float32)
        x = jax.lax.complex(planes[0] * mask, planes[1] * mask)
        xm = x
        for _ in range(order.bit_length() - 1):  # order in (2, 4)
            xm = xm * xm
        p = jnp.abs(jnp.fft.fft(xm)) ** 2
        k0 = jnp.argmax(p)
        return k0, p[(k0 - 1) % npad], p[k0], p[(k0 + 1) % npad]

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _psk_process_fn(npad: int, order: int, mf_len: int):
    """Device program: derotate by the host-exact phase table, matched
    filter (length-``mf_len`` moving average via cumsum), and reduce —
    the order-th-power sum (common phase) and the Oerder-Meyr timing
    correlator ``sum |z|^2 e^{-j 2 pi n / sps}`` over full filter
    windows.  Returns the filtered planes plus both reductions as f32
    plane pairs."""
    import jax
    import jax.numpy as jnp

    def run(planes, rot, tim, n):
        idx = jnp.arange(npad, dtype=jnp.int32)
        mask = (idx < n).astype(jnp.float32)
        x = jax.lax.complex(planes[0] * mask, planes[1] * mask)
        y = x * jax.lax.complex(rot[0], rot[1])
        ym = y
        for _ in range(order.bit_length() - 1):
            ym = ym * ym
        s = jnp.sum(ym)
        c = jnp.cumsum(y)
        z = (c - jnp.concatenate([jnp.zeros(mf_len, y.dtype), c[:-mf_len]])) / mf_len
        full = ((idx >= mf_len - 1) & (idx < n)).astype(jnp.float32)
        w = (jnp.real(z) ** 2 + jnp.imag(z) ** 2) * full
        e = jnp.sum(w * jax.lax.complex(tim[0], tim[1]))
        return (
            (jnp.real(z), jnp.imag(z)),
            (jnp.real(s), jnp.imag(s)),
            (jnp.real(e), jnp.imag(e)),
        )

    return jax.jit(run)


_QPSK_GRAY = {0: (0, 0), 1: (0, 1), 2: (1, 1), 3: (1, 0)}


@dataclass
class PskDemod:
    """Phase-shift-keying receiver (BPSK/QPSK), block-coherent.

    shift -> lowpass channel (the validated stages), then one device
    program per burst: residual-carrier estimate from the order-th
    power's FFT peak (parabolically refined on the host), derotation by
    a HOST-EXACT f64 phase table (the ExactNCO convention — f32 phase
    accumulation would drift over a long burst), a one-symbol
    moving-average matched filter, and the Oerder-Meyr timing
    correlator.  The host then samples symbols at the recovered
    instants (linear interpolation) and slices — carrier and timing are
    closed-form BLOCK estimates, not a sequential PLL, so all
    per-sample work is batched device math; the only O(n) host step is
    building the two phase tables and the O(symbols) decode (the same
    device/host split as :mod:`quadrs_tpu.bits`' clock recovery).  No
    reference counterpart (quadrs demodulates OOK/FSK only).

    ``center`` follows the house shift convention (the value handed to
    :class:`~quadrs_tpu.stream.Shift`): bring the carrier to DC with
    ``center = -carrier_offset``.  ``symbol_rate`` is in symbols/sec;
    the channel must keep ``sps = channel_rate / symbol_rate >= 2``
    (4+ recommended).  ``order`` is 2 (BPSK) or 4 (QPSK, Gray-coded
    00 01 11 10 counter-clockwise).  With ``differential`` (default)
    the decoder emits phase TRANSITIONS, which cancels the order-fold
    ambiguity of power-law carrier recovery — the transmitter must
    encode differentially; one symbol is consumed as the reference.
    Coherent slicing (``differential=False``) emits absolute positions
    that carry an unresolved common rotation of ``2*pi/order``.

    Validity: the residual carrier must satisfy
    ``|freq| < rate / (2 * order)`` (the order-th-power line must not
    alias) and sit well inside the channel filter.

    **Carrier drift** (``block``): the single block estimate leaves a
    time-varying residual when the carrier DRIFTS across the burst (any
    real crystal warms up); differential decode flips bits once the
    residual reaches ``symbol_rate / (2 * order)`` Hz — the drift
    budget of ``block=0``.  ``block=N`` re-estimates the carrier every
    ``N`` baseband samples (same order-th-power peak, one small device
    program per block), integrates the piecewise-linear frequency
    track into a CONTINUOUS host-f64 phase ramp (no per-block phase
    stitching — frequency integration keeps phase continuous by
    construction), derotates, and runs the normal estimator on the
    detrended burst, which then sees only the per-block residual
    (drift * block / n).  Each block must hold >= ~4 symbols; 10-50
    symbols per block is a good range."""

    center: int = 0
    bandwidth: int = 200_000
    decimate: int = 32
    taps: int = 400
    symbol_rate: float = 0.0  # REQUIRED: symbols per second
    order: int = 2
    differential: bool = True
    chunk: int = 1 << 16  # baseband samples per executor pull
    block: int = 0  # baseband samples per carrier estimate (0 = whole burst)

    def _check(self) -> None:
        if self.order not in (2, 4):
            raise ValueError(f"order must be 2 (BPSK) or 4 (QPSK), not {self.order}")
        if self.symbol_rate <= 0:
            raise ValueError("symbol_rate must be positive (symbols per second)")

    def channel(self, stream: Stream) -> Stream:
        self._check()
        chain: Stream = stream
        if self.center:
            chain = Shift(chain, self.center, chain.sample_rate)
        return LowPass(chain, self.bandwidth, self.decimate, self.taps)

    def baseband(self, stream: Stream, mesh=None) -> tuple[int, np.ndarray]:
        """``(channel_rate_hz, complex64[channel_len])`` of the filtered
        channel (chunked on device; the executor returns f32 planes and
        repacks — bursts are buffered whole, like the other demods)."""
        from quadrs_tpu.runtime import Executor, root_step_of, window_batches

        import jax.numpy as jnp

        chan = self.channel(stream)
        if chan.length < 1:
            raise ValueError("input too short for the PSK demodulator")
        rate = chan.sample_rate
        c = min(self.chunk, chan.length)
        sig = _streaming_signal_dev(
            chan, c, 0,
            lambda x: jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1),
            mesh=mesh,
        )
        if sig is not None:
            arr = np.asarray(sig)  # (m, 2) f32 — complex never crosses
            return rate, (arr[..., 0] + 1j * arr[..., 1]).astype(np.complex64)
        offsets = np.arange(0, chan.length, c, dtype=np.int64)
        batch, batches = window_batches(offsets, c, root_step=root_step_of(chan))
        ex = Executor(chan, c, batch=batch)
        out = np.empty(chan.length, dtype=np.complex64)
        for offs in batches:
            vals, valid = ex.run(offs)
            for i in range(len(offs)):
                o, v = int(offs[i]), int(valid[i])
                out[o : o + v] = vals[i][:v]
                if v < c:
                    # short read: EOF only (see FmDemod.discriminate)
                    return rate, out[: o + v]
        return rate, out

    def _block_freq(self, rate: int, xb: np.ndarray) -> float:
        """Order-th-power FFT peak of one baseband slice, parabolically
        refined — the same estimator :meth:`analyze` runs on the whole
        burst, reused per block for the drift track."""
        from quadrs_tpu.runtime import _round_up_pow2

        nb = len(xb)
        npad = max(256, _round_up_pow2(nb))
        planes = np.zeros((2, npad), dtype=np.float32)
        planes[0, :nb] = np.real(xb)
        planes[1, :nb] = np.imag(xb)
        return self._peak_khat(planes, nb, npad) / (self.order * npad) * rate

    def _peak_khat(self, planes: np.ndarray, n: int, npad: int) -> float:
        """Refined order-th-power spectral peak, in bins of ``npad``
        (divide by ``order * npad`` for cycles/sample)."""
        k0, pm, p0, pp = _psk_peak_fn(npad, self.order)(planes, np.int32(n))
        k0, pm, p0, pp = int(k0), float(pm), float(p0), float(pp)
        denom = pm - 2.0 * p0 + pp
        delta = 0.0 if denom == 0.0 else 0.5 * (pm - pp) / denom
        khat = k0 + min(0.5, max(-0.5, delta))
        if khat > npad / 2:
            khat -= npad
        return khat

    def _carrier_detrend(self, rate: int, x: np.ndarray) -> tuple[np.ndarray, float]:
        """Blockwise carrier tracking: estimate the offset every
        ``block`` samples, linearly interpolate the frequency between
        block midpoints (constant beyond the ends), integrate to an f64
        phase ramp, and derotate.  Returns the detrended burst and the
        burst-mean removed frequency (added back into the reported
        estimate)."""
        n, b = len(x), int(self.block)
        sps = rate / self.symbol_rate
        min_blk = max(1, int(round(sps))) + int(math.ceil(3 * sps))
        if b < min_blk:
            raise ValueError(
                f"block={b} baseband samples holds under ~4 symbols at "
                f"sps={sps:.1f}: raise -block (>= {min_blk})"
            )
        n_blocks = max(1, n // b)  # the ragged tail merges into the last
        bounds = [i * b for i in range(n_blocks)] + [n]
        mids = np.empty(n_blocks, dtype=np.float64)
        freqs = np.empty(n_blocks, dtype=np.float64)
        for i, (s, e) in enumerate(zip(bounds[:-1], bounds[1:])):
            mids[i] = 0.5 * (s + e - 1)
            freqs[i] = self._block_freq(rate, x[s:e])
        f_t = np.interp(np.arange(n, dtype=np.float64), mids, freqs)
        phi = _TAU * np.cumsum(f_t) / rate  # continuous by construction
        y = (x * np.exp(-1j * phi)).astype(np.complex64)
        return y, float(np.mean(f_t))

    def analyze(self, rate: int, x: np.ndarray) -> tuple[PskEstimate, np.ndarray]:
        """Synchronize and sample one baseband burst.

        Returns ``(estimate, symbols)`` where ``symbols`` are the
        matched-filtered complex decisions, derotated so the ideal
        constellation is the ``order``-th roots of unity (up to the
        power-law ambiguity).  With ``block > 0`` the carrier is first
        detrended blockwise (see the class docstring); the reported
        ``freq_hz`` is then the burst-mean track plus the residual.
        """
        self._check()
        f_track = 0.0
        if self.block:
            x, f_track = self._carrier_detrend(rate, x)
        m_ord = self.order
        sps = rate / self.symbol_rate
        if sps < 2.0:
            raise ValueError(
                f"{sps:.2f} channel samples/symbol < 2: lower the symbol "
                "rate or the decimation"
            )
        mf_len = max(1, int(round(sps)))
        from quadrs_tpu.runtime import _round_up_pow2

        n = len(x)
        if n < mf_len + int(math.ceil(3 * sps)):
            raise ValueError("burst too short: needs at least ~4 symbols")
        npad = max(256, _round_up_pow2(n))
        planes = np.zeros((2, npad), dtype=np.float32)
        planes[0, :n] = np.real(x)
        planes[1, :n] = np.imag(x)

        khat = self._peak_khat(planes, n, npad)

        # host-exact derotation / timing tables (f64 reductions mod one
        # cycle, then one f32 cos/sin — the ExactNCO discipline)
        nn = np.arange(npad, dtype=np.float64)
        ph = -_TAU * np.mod(khat * nn, m_ord * npad) / (m_ord * npad)
        rot = np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)
        pht = -_TAU * np.mod(nn / sps, 1.0)
        tim = np.stack([np.cos(pht), np.sin(pht)]).astype(np.float32)

        z_pl, s_pl, e_pl = _psk_process_fn(npad, m_ord, mf_len)(
            planes, rot, tim, np.int32(n)
        )
        z = np.asarray(z_pl[0]).astype(np.complex64)
        z += 1j * np.asarray(z_pl[1]).astype(np.complex64)
        s = complex(float(s_pl[0]), float(s_pl[1]))
        e = complex(float(e_pl[0]), float(e_pl[1]))
        phase = math.atan2(s.imag, s.real) / m_ord
        tau = (-math.atan2(e.imag, e.real) / _TAU) % 1.0 * sps

        est = PskEstimate(
            freq_hz=f_track + khat / (m_ord * npad) * rate,
            phase=phase,
            tau=tau,
            sps=sps,
            rate=int(rate),
            n=n,
        )

        # symbol instants: tau + k*sps, inside full matched-filter
        # windows ([mf_len-1, n-1]); linear interpolation, then the
        # common-phase derotation (host, O(symbols))
        k_start = max(0, int(math.ceil((mf_len - 1 - tau) / sps)))
        k_end = int(math.floor((n - 1 - tau) / sps))
        if k_end < k_start:
            raise ValueError("burst too short: no full symbol instants")
        t = tau + np.arange(k_start, k_end + 1, dtype=np.float64) * sps
        i = np.minimum(np.floor(t).astype(np.int64), n - 2)
        f = (t - i).astype(np.float32)
        sym = z[i] * (1.0 - f) + z[i + 1] * f
        sym = sym * np.complex64(complex(math.cos(-phase), math.sin(-phase)))
        return est, sym.astype(np.complex64)

    def symbols(self, stream: Stream, mesh=None) -> tuple[PskEstimate, np.ndarray]:
        rate, x = self.baseband(stream, mesh=mesh)
        return self.analyze(rate, x)

    def slice(self, sym: np.ndarray) -> list[int]:
        """Decisions -> bits.  Differential mode decodes the phase
        increment between consecutive symbols (index ``m`` of
        ``e^{j 2 pi m / order}``); coherent mode the absolute position.
        QPSK maps each index through the Gray code 00 01 11 10."""
        m_ord = self.order
        if self.differential:
            if len(sym) < 2:
                raise ValueError("differential decode needs >= 2 symbols")
            d = sym[1:] * np.conj(sym[:-1])
            ang = np.arctan2(d.imag, d.real)
        else:
            ang = np.arctan2(sym.imag, sym.real)
        m = np.round(ang * (m_ord / _TAU)).astype(np.int64) % m_ord
        if m_ord == 2:
            return [int(v) for v in m]
        out: list[int] = []
        for v in m:
            out.extend(_QPSK_GRAY[int(v)])
        return out

    def demodulate(
        self, stream: Stream, mesh=None
    ) -> tuple[PskEstimate, list[int]]:
        """Full receive chain: capture -> synchronized bits."""
        est, sym = self.symbols(stream, mesh=mesh)
        return est, self.slice(sym)
