"""Multi-chip execution: time-sharded streaming with halo exchange.

The reference is strictly single-threaded; this counterpart scales the
sample stream across a device mesh.  The time axis is sharded: each
device holds a contiguous slice of the capture, exchanges a
``taps``-sample halo with its right neighbor over the interconnect
(``ppermute``), and runs the fused decode -> mix -> FIR -> STFT step on its slice.  A
second optional mesh axis shards independent streams (the batched
waterfall / channelizer case), giving dp x sp-style 2-D parallelism.

NCO phase coherence across shards costs nothing: each shard's start
phase is planned exactly on the host (integer reduction mod the sample
rate), so there is no sequential carry between chips — the whole chain
stays embarrassingly parallel except for the halo.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quadrs_tpu.models.receiver import PipelineModel


def make_mesh(n_time: int, n_stream: int = 1, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    if len(devices) < n_time * n_stream:
        raise ValueError(
            f"need {n_time * n_stream} devices, have {len(devices)}"
        )
    grid = devices[: n_time * n_stream].reshape(n_stream, n_time)
    return Mesh(grid, ("stream", "time"))


def halo_samples(cfg) -> int:
    """Samples a shard needs past its local slice: its last FIR output
    ``y[i]`` reads ``x[i*D + ceil(taps/2) .. i*D + ceil(taps/2) + taps)``,
    i.e. ``ceil(taps/2) + taps - D`` beyond the local extent."""
    half_up = cfg.taps - cfg.taps // 2
    return max(cfg.taps, cfg.taps + half_up - cfg.decimate)


def make_sharded_stream_step(
    model: PipelineModel, mesh: Mesh, search: bool = False
):
    """Build the jitted multi-chip streaming step.

    Takes ``raw`` of shape (S, 2, n_local*T) native-dtype planes with
    the time axis sharded (``P('stream', None, 'time')``), per-shard
    phases ``theta0`` of shape (S, T) sharded ``P('stream', 'time')``,
    and ``tail`` of shape (S, 2, halo_samples(cfg)) — the samples that
    *follow* the chunk in the stream (zeros at EOF), replicated over
    'time'.  Returns (S, windows, fft_width) f32 spectrogram rows with
    the window axis sharded over 'time'.

    Every shard's halo is its right neighbor's head over the interconnect
    (``ppermute``); the last shard's halo is the fed ``tail``, so every
    output window is exact streaming continuation — no wrapped data, no
    windows for the caller to drop, and chunks advance by their full
    length.

    ``search=True`` reduces each window to its fftshifted peak bin and
    magnitude *inside the shard* (the reduction is per-window, so it
    never crosses the interconnect): returns ((S, windows) int32, (S, windows) f32)
    instead of the norms.

    The built step is memoized on the model per (mesh, search):
    constructing many runners over one model (the serve
    daemon builds one per connection) reuses the same jitted wrapper
    instead of recompiling — equal meshes hash equal, so fresh
    ``make_mesh`` results hit too.
    """
    cache = model.__dict__.setdefault("_sharded_step_cache", {})
    key = ("stream", mesh, search)
    if key in cache:
        return cache[key]
    cfg = model.cfg
    halo_samps = halo_samples(cfg)
    if cfg.taps // (2 * cfg.decimate) >= cfg.fft_width:
        raise ValueError("fft window shorter than the FIR group delay span")
    n_time = mesh.shape["time"]

    def local_step(raw_local, theta0_local, tail_local):
        # raw_local: (S_l, 2, n_local) planes; theta0_local: (S_l, 1);
        # tail_local: (S_l, 2, halo_samps), identical on every time-shard
        if raw_local.shape[2] < halo_samps:
            raise ValueError(
                f"per-shard slice of {raw_local.shape[2]} samples is shorter "
                f"than the {halo_samps}-sample halo; use chunks of at least "
                f"{halo_samps} samples per time-shard"
            )
        perm = [(i, (i - 1) % n_time) for i in range(n_time)]
        head = raw_local[:, :, :halo_samps]
        halo = jax.lax.ppermute(head, "time", perm)
        tail_local = jax.lax.pcast(tail_local, ("time",), to="varying")
        is_last = jax.lax.axis_index("time") == n_time - 1
        halo = jnp.where(is_last, tail_local, halo)
        block = jnp.concatenate([raw_local, halo], axis=2)
        norms = jax.vmap(model.step_stream)(block, theta0_local[:, 0])
        return model._peak_reduce(norms) if search else norms

    out_spec = (
        (P("stream", "time"), P("stream", "time"))
        if search
        else P("stream", "time", None)
    )
    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("stream", None, "time"),
            P("stream", "time"),
            P("stream", None, None),
        ),
        out_specs=out_spec,
    )
    cache[key] = jax.jit(step)
    return cache[key]


def waterfall_halo(cfg) -> int:
    """Samples a waterfall time-shard needs past its local slice: the
    window starting at its last stride cell reads ``fft_width - stride``
    beyond the local extent (zero for tiling/skipping strides)."""
    return max(0, cfg.fft_width - cfg.stride)


def make_sharded_waterfall_step(
    model, mesh: Mesh, search: bool = False
):
    """Multi-chip waterfall bank: streams shard over 'stream', the sample
    axis over 'time'.  Takes (S, 2, n_local*T) native planes sharded
    ``P('stream', None, 'time')`` with each time-shard's slice a whole
    number of ``stride`` cells; returns (S, windows, width) norms with
    the window axis sharded over 'time' — ``n_local // stride`` windows
    per shard.

    * ``stride >= fft_width`` (tiling/skipping): windows never leave
      their stride cell, so the bank is embarrassingly parallel
      (zero-halo; call with just the planes).
    * ``stride < fft_width`` (overlapped): each shard's trailing windows
      read ``fft_width - stride`` samples into its right neighbor — the
      halo crosses the interconnect via ``ppermute`` exactly like the stream step,
      and the call takes a second ``tail`` argument of shape
      (S, 2, fft_width - stride), replicated over 'time': the true
      continuation of the chunk (zeros at EOF — the caller drops the
      windows that would read past the capture).

    ``search=True`` returns the per-window peak ``(idx, val)`` instead
    of norms — the reduction is per-window (shard-local), so it never
    crosses the interconnect.

    Memoized on the model per (mesh, search), like
    :func:`make_sharded_stream_step`.
    """
    cache = model.__dict__.setdefault("_sharded_step_cache", {})
    key = ("waterfall", mesh, search)
    if key in cache:
        return cache[key]
    cfg = model.cfg
    halo = waterfall_halo(cfg)
    n_time = mesh.shape["time"]

    def check_local(n_local: int):
        if n_local % cfg.stride:
            raise ValueError(
                f"per-shard slice of {n_local} samples is not a whole "
                f"number of {cfg.stride}-sample stride cells"
            )

    def compute(block):
        if search:
            return model.jit_search()(block)
        return model.step(block)

    def local_step(raw_local):
        check_local(raw_local.shape[2])
        return compute(raw_local)

    def local_step_halo(raw_local, tail_local):
        check_local(raw_local.shape[2])
        if raw_local.shape[2] < halo:
            raise ValueError(
                f"per-shard slice of {raw_local.shape[2]} samples is "
                f"shorter than the {halo}-sample window halo"
            )
        perm = [(i, (i - 1) % n_time) for i in range(n_time)]
        head = raw_local[:, :, :halo]
        nbr = jax.lax.ppermute(head, "time", perm)
        tail_local = jax.lax.pcast(tail_local, ("time",), to="varying")
        is_last = jax.lax.axis_index("time") == n_time - 1
        nbr = jnp.where(is_last, tail_local, nbr)
        return compute(jnp.concatenate([raw_local, nbr], axis=2))

    out_spec = P("stream", "time") if search else P("stream", "time", None)
    out_specs = (out_spec, out_spec) if search else out_spec
    if halo == 0:
        step = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P("stream", None, "time"),),
            out_specs=out_specs,
        )
    else:
        step = jax.shard_map(
            local_step_halo,
            mesh=mesh,
            in_specs=(P("stream", None, "time"), P("stream", None, None)),
            out_specs=out_specs,
        )
    cache[key] = jax.jit(step)
    return cache[key]


def find_halo(pattern_len: int) -> int:
    """Samples a matched-filter time-shard needs past its local slice:
    the score at its last local lag reads ``pattern_len - 1`` samples
    into its right neighbor — the exact analogue of the FIR halo
    (:func:`halo_samples`)."""
    return pattern_len - 1


def make_sharded_find_step(
    pattern, c: int, fmt, mesh: Mesh, freqs=None, fft_impl: str = "auto"
):
    """Multi-chip matched-filter correlator (the device program behind
    ``sinks.find_pattern(mesh=...)``).

    The sample axis shards over the mesh's 'time' axis: each chip holds
    a contiguous slice of NATIVE capture planes, pulls the ``l-1``
    sample halo from its right neighbor over the interconnect (``ppermute``; the
    last shard takes the fed ``tail`` — the true stream continuation),
    decodes on device, assembles its slice into overlap-save FFT
    windows (row slices + concat, never a strided gather) and scores
    every local lag with the SAME single-chip program
    (:func:`quadrs_tpu.ops.correlate.make_xcorr_post`'s compute) —
    windows start at multiples of ``n_out = c - l + 1`` from the chunk
    origin, identical partitioning to the single-device executor, so
    sharded scores match to f32 accumulation order (XLA tiles the DFT
    matmuls differently per batch shape; offsets/which are exact).

    Returns a jitted step taking ``planes`` (2, n_total) native planes
    sharded ``P(None, 'time')`` and ``tail`` (2, l-1) replicated;
    yields ``(score, scale, ridx)`` each (n_total,) sharded
    ``P('time')`` — entry ``t`` is lag ``chunk_origin + t``.
    ``n_total / n_time`` must be a whole number of ``n_out`` lag cells.
    """
    from quadrs_tpu.formats import decode_plane, pack_complex
    from quadrs_tpu.ops.correlate import make_xcorr_post
    from quadrs_tpu.ops.fir import _overlapped_frames

    pats = (
        [np.asarray(p) for p in pattern]
        if isinstance(pattern, (list, tuple))
        else [np.asarray(pattern)]
    )
    l = max(len(p) for p in pats)
    n_out = c - l + 1
    compute = make_xcorr_post(pats, c, freqs, fft_impl=fft_impl)
    n_time = mesh.shape["time"]
    if mesh.shape.get("stream", 1) != 1:
        raise ValueError(
            "the matched filter shards one capture over 'time'; use a "
            "Tx1 mesh"
        )

    def local(planes_local, tail_local):
        n_loc = planes_local.shape[1]
        if n_loc % n_out:
            raise ValueError(
                f"per-shard slice of {n_loc} samples is not a whole "
                f"number of {n_out}-lag cells"
            )
        b = n_loc // n_out
        perm = [(i, (i - 1) % n_time) for i in range(n_time)]
        head = planes_local[:, : l - 1]
        halo = jax.lax.ppermute(head, "time", perm)
        tail_local = jax.lax.pcast(tail_local, ("time",), to="varying")
        is_last = jax.lax.axis_index("time") == n_time - 1
        halo = jnp.where(is_last, tail_local, halo)
        block = jnp.concatenate([planes_local, halo], axis=1)
        re = decode_plane(block[0], fmt, xp=jnp)
        im = decode_plane(block[1], fmt, xp=jnp)
        xc = pack_complex(re, im, xp=jnp)
        frames = _overlapped_frames(xc[None, :], n_out, c, b)[0]  # (b, c)
        score, scale, ridx = compute(frames)
        return score.reshape(-1), scale.reshape(-1), ridx.reshape(-1)

    step = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, "time"), P(None, None)),
        out_specs=(P("time"), P("time"), P("time")),
        # the bank/grid path scans rows with an unvarying zeros init
        # (shared single-chip code); vma checking would demand pcast
        # annotations inside it
        check_vma=False,
    )
    return jax.jit(step)


def channelize_halo(size: int) -> int:
    """Input samples a channelizer time-shard needs past its K-aligned
    local slice: the bank's span arithmetic is LowPass-with-decimate-K
    (reference ``src/filter.rs:68-71``: ``n*D + taps`` raw samples per
    ``n`` outputs), so the last local output's window reads ``size``
    samples into the right neighbor."""
    return size


def make_sharded_channelize_step(taps, k: int, fmt, mesh: Mesh):
    """Multi-chip polyphase channelizer (the device program behind
    ``run_channelize(mesh=...)``).

    The capture's sample axis shards over the mesh's 'time' axis: each
    chip holds a contiguous K-aligned slice of NATIVE capture planes,
    pulls the ``size``-sample FIR halo from its right neighbor over the interconnect
    (``ppermute``; the last shard takes the fed ``tail`` — the true
    stream continuation), decodes on device and runs the SAME bank
    program as the single-device path
    (:func:`quadrs_tpu.ops.channelizer.channelize_block`) on its slice.
    Sharded channels match single-device output to f32 accumulation
    order (XLA tiles the branch FMAs / cross-branch DFT matmuls
    differently per batch shape).

    Returns a jitted step taking ``planes`` (2, n_total) native planes
    sharded ``P(None, 'time')`` (``n_total / n_time`` a whole number of
    ``k``-sample output cells, at least ``size`` samples per shard) and
    ``tail`` (2, size) replicated; yields f32 planes ``(re, im)`` each
    of shape (n_total//k, K) with the output-sample axis sharded
    ``P('time')``."""
    from quadrs_tpu.formats import decode_plane, pack_complex
    from quadrs_tpu.ops.channelizer import channelize_block

    taps = np.asarray(taps, dtype=np.float32)
    size = len(taps)
    n_time = mesh.shape["time"]
    if mesh.shape.get("stream", 1) != 1:
        raise ValueError(
            "channelize shards one capture over 'time'; use a Tx1 mesh"
        )

    def local(planes_local, tail_local):
        n_loc = planes_local.shape[1]
        if n_loc % k:
            raise ValueError(
                f"per-shard slice of {n_loc} samples is not a whole "
                f"number of {k}-sample output cells"
            )
        if n_loc < size:
            raise ValueError(
                f"per-shard slice of {n_loc} samples is shorter than the "
                f"{size}-sample FIR halo; use larger chunks"
            )
        n_out = n_loc // k
        perm = [(i, (i - 1) % n_time) for i in range(n_time)]
        head = planes_local[:, :size]
        halo = jax.lax.ppermute(head, "time", perm)
        tail_local = jax.lax.pcast(tail_local, ("time",), to="varying")
        is_last = jax.lax.axis_index("time") == n_time - 1
        halo = jnp.where(is_last, tail_local, halo)
        block = jnp.concatenate([planes_local, halo], axis=1)
        re = decode_plane(block[0], fmt, xp=jnp)
        im = decode_plane(block[1], fmt, xp=jnp)
        x = pack_complex(re, im, xp=jnp)[None, :]
        y = channelize_block(x, taps, k, n_out)[0]  # (n_out, K)
        return jnp.real(y), jnp.imag(y)

    step = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, "time"), P(None, None)),
        out_specs=(P("time", None), P("time", None)),
        # batched_fft's four-step path scans with unvarying inits
        # (shared single-chip code), like the find step
        check_vma=False,
    )
    return jax.jit(step)


def plan_shard_phases(model: PipelineModel, n_local: int, n_time: int, n_stream: int = 1):
    """Host-side exact phases for each (stream, time-shard) start offset."""
    offs = np.arange(n_time, dtype=np.int64) * n_local
    theta = model.theta0(offs)
    return np.broadcast_to(theta[None, :], (n_stream, n_time)).copy()


def shard_chunk(raw: np.ndarray, mesh: Mesh) -> jax.Array:
    """Place a host array onto the mesh: plane chunks (S, 2, C) shard as
    (stream, -, time); 2-D arrays like the phase table as (stream, time)."""
    spec = P("stream", None, "time") if raw.ndim == 3 else P("stream", "time")
    return jax.device_put(raw, NamedSharding(mesh, spec))


def replicate_tail(tail: np.ndarray, mesh: Mesh) -> jax.Array:
    """Place a (S, 2, halo) tail: sharded over streams, replicated over
    the time axis (every time-shard receives it; only the last uses it)."""
    return jax.device_put(tail, NamedSharding(mesh, P("stream", None, None)))
