"""FIR low-pass taps and decimating convolution kernels.

Tap math mirrors the reference exactly in f32 (``src/filter.rs:86-105``):
Blackman-windowed sinc, normalized to unit sum.  The decimating
convolution evaluates the reference's indexing

    y[i] = sum_{j=0}^{N-1} x[i*D + N/2 + j] * h[j]

(``convoluted[N + i*D]`` of ``src/filter.rs:78-80`` expressed directly).
Out-of-block taps contribute zero — callers pre-mask the block at its
valid extent, matching ``complex_convolve``'s bounds-skip
(``src/filter.rs:116``).

Two device implementations:

* ``direct`` — gather overlapping frames, one ``(B*n_out, N) @ (N,)``
  dot.  Correct for any size; memory grows with ``N/D`` overlap.
* ``polyphase`` — decompose ``h`` into ``M = ceil(N/D)`` phase
  subfilters; one ``(…, D) @ (D, M)`` matmul computes every phase
  product, then ``M`` shifted adds assemble outputs.  Work is exactly
  ``N/D`` MACs per input sample with no frame blowup: the matmul-shaped
  layout for heavy decimation.

* ``overlap_save`` — blockwise FFT convolution for long filters
  (``lowpass -power 2000`` class): frames of size ``M`` overlap by
  ``N-1``, correlate in the frequency domain (``X * conj(H)``), keep the
  linear-valid region, decimate.  O(log M) work per input sample
  instead of O(N/D).

All run in f32 with ``Precision.HIGHEST``: at the default precision an
f32 matmul may run in a reduced format (TF32 on a GPU), which the
conformance path cannot afford.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import numpy as np

_PI32 = np.float32(np.pi)


def lowpass_taps(cutoff: float, size: int) -> np.ndarray:
    """Blackman-windowed sinc taps, f32, unit-sum normalized.

    ``cutoff`` is frequency / sample_rate (``src/filter.rs:126-128``);
    formulas and op order follow ``src/filter.rs:86-105`` in f32.

    Odd sizes diverge deliberately: the reference's ``sin(0)/0`` center
    tap is NaN there (its CLI only produces even sizes, 2*power or 40),
    while this defines sinc(0)=1 so odd sizes are usable.
    """
    if size < 2:
        raise ValueError("filter size must be at least 2")
    c = np.float32(cutoff)
    i = np.arange(size, dtype=np.float32)
    sz = np.float32(size)

    x = np.float32(2.0) * c * (i - (sz - np.float32(1.0)) / np.float32(2.0))
    xpi = x * _PI32
    safe = np.where(xpi == 0, np.float32(1.0), xpi)  # avoid a 0/0 warning
    sinc = np.where(xpi == 0, np.float32(1.0), np.sin(safe) / safe)

    t = np.float32(2.0) * _PI32 * i / (sz - np.float32(1.0))
    window = (
        np.float32(0.42)
        - np.float32(0.5) * np.cos(t)
        + np.float32(0.08) * np.cos(np.float32(2.0) * t)
    )

    taps = (sinc * window).astype(np.float32)
    return (taps / taps.sum(dtype=np.float32)).astype(np.float32)


def _real_dot(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(x, w, precision=jax.lax.Precision.HIGHEST)


def is_spectral(size: int, d: int) -> bool:
    """True when ``auto`` routes a (taps, decimate) pair to a
    frequency-domain impl.  The single source of truth for the
    crossover — models.receiver premixes the NCO into complex taps
    exactly when this holds, and complex taps are free only in the
    spectral impls."""
    return -(-size // d) > 64


def fir_decimate(
    x: jnp.ndarray,
    taps: np.ndarray,
    decimate: int,
    n_out: int,
    *,
    impl: str = "auto",
) -> jnp.ndarray:
    """Decimating FIR over a batch of blocks.

    ``x``: (B, n_in) complex64 with ``n_in = n_out*decimate + len(taps)``;
    entries past each block's valid extent must already be zero.
    Returns (B, n_out) complex64.

    ``taps`` may be complex64 (a modulated band-pass filter — the
    premixed-taps streaming path commutes the NCO mix into the filter,
    see models.receiver).  The spectral impls handle complex taps
    natively at no extra cost; the time-domain impls decompose into two
    real-taps passes.
    """
    taps = np.asarray(taps)
    if not np.iscomplexobj(taps):
        taps = taps.astype(np.float32)
    size = len(taps)
    d = int(decimate)

    if impl == "auto":
        if is_spectral(size, d):
            # polyphase overlap-save: decimated-rate FFTs via the
            # four-step matmul split
            impl = "os_poly"
        elif d >= 4:
            # the polyphase's m shifted adds scale worse than the banded
            # matmul's FLOP overhead once the dispatch is fat enough to
            # fill the matmul units — and "fat" is the TOTAL output
            # count B*n_out, not the per-row length.  The 2^17 crossover
            # is not yet re-measured on a GPU.
            total_out = int(x.shape[0]) * n_out
            impl = "banded" if total_out >= (1 << 17) else "polyphase"
        else:
            impl = "direct"

    if np.iscomplexobj(taps) and impl not in ("overlap_save", "os_poly"):
        # two real-taps passes: sum_j x[..]*(hr[j] + i*hi[j]).  Must run
        # AFTER auto resolution or a time-domain impl would silently
        # cast the taps to f32 and drop the imaginary part.
        hr = np.ascontiguousarray(taps.real, dtype=np.float32)
        hi = np.ascontiguousarray(taps.imag, dtype=np.float32)
        return (
            fir_decimate(x, hr, d, n_out, impl=impl)
            + 1j * fir_decimate(x, hi, d, n_out, impl=impl)
        ).astype(jnp.complex64)

    # Drop the group-delay prefix: the reference's pick convoluted[N+i*D]
    # with output index m reading input m - floor(N/2) + j works out to
    # x[i*D + (N - floor(N/2)) + j] — i.e. a ceil(N/2) prefix (equal to
    # N/2 for the even sizes the CLI produces).  Also make sure the
    # block covers the last frame (the reference zero-pads there via its
    # bounds-skip).
    needed = (n_out - 1) * d + size
    x = x[:, size - size // 2 :]
    if x.shape[1] < needed:
        x = jnp.pad(x, ((0, 0), (0, needed - x.shape[1])))

    if impl == "direct":
        # frames via row slices + concat, never an overlapping gather
        frames = _overlapped_frames(x, d, size, n_out)  # (B, n_out, size)
        h = jnp.asarray(taps)
        return (
            _real_dot(frames.real, h) + 1j * _real_dot(frames.imag, h)
        ).astype(jnp.complex64)

    if impl == "polyphase":
        m = -(-size // d)
        h = np.zeros(m * d, dtype=np.float32)
        h[:size] = taps
        hp = jnp.asarray(h.reshape(m, d).T)  # (d, m)
        t = -(-x.shape[1] // d)
        if x.shape[1] < t * d:
            x = jnp.pad(x, ((0, 0), (0, t * d - x.shape[1])))
        xp = x.reshape(x.shape[0], t, d)
        # (B, t, m): phase products for every (block position, subfilter)
        c = (
            _real_dot(xp.real, hp) + 1j * _real_dot(xp.imag, hp)
        ).astype(jnp.complex64)
        out = c[:, 0:n_out, 0]
        for k in range(1, m):
            out = out + c[:, k : k + n_out, k]
        return out

    if impl == "overlap_save":
        return _overlap_save(x, taps, d, n_out)

    if impl == "os_poly":
        return _overlap_save_poly(x, taps, d, n_out)

    if impl == "banded":
        return _banded(x, taps, d, n_out)

    raise ValueError(f"unknown fir impl: {impl}")


@functools.lru_cache(maxsize=16)
def _banded_weights(taps_key, d: int) -> np.ndarray:
    """(span_p, 128) banded matrix W[p, l] = h[p - l*d]: 128 decimated
    outputs per matmul column block."""
    taps = np.frombuffer(taps_key, dtype=np.float32)
    size = len(taps)
    span = 127 * d + size
    span_p = -(-span // 128) * 128
    w = np.zeros((span_p, 128), dtype=np.float32)
    for l in range(128):
        w[l * d : l * d + size, l] = taps
    return w


def _overlapped_frames(x: jnp.ndarray, hop: int, m: int, n_frames: int) -> jnp.ndarray:
    """(B, L) -> (B, n_frames, m) frames at stride ``hop`` without a
    gather: a reshape + k consecutive row-slices + concat
    (k = ceil(m/hop)), all contiguous copies."""
    k = -(-m // hop)
    rows_needed = n_frames + k - 1
    need = rows_needed * hop
    if x.shape[1] < need:
        x = jnp.pad(x, ((0, 0), (0, need - x.shape[1])))
    rows = x[:, : rows_needed * hop].reshape(x.shape[0], rows_needed, hop)
    parts = [rows[:, i : i + n_frames] for i in range(k)]
    return jnp.concatenate(parts, axis=2)[:, :, :m]


def _banded(x: jnp.ndarray, taps: np.ndarray, d: int, n_out: int) -> jnp.ndarray:
    """Decimating FIR as one dense banded matmul.

    Groups of 128 outputs share one input span; lhs gathers the spans
    (~size/(128*d) read overlap) and a single ``(B*G, span) @ (span,
    128)`` f32 matmul produces every output.  Zeros in the band waste
    FLOPs; the layout trades them for contiguous memory traffic.
    """
    size = len(taps)
    w = _banded_weights(taps.astype(np.float32).tobytes(), d)
    span_p = w.shape[0]
    groups = -(-n_out // 128)
    lhs = _overlapped_frames(x, 128 * d, span_p, groups)  # (B, groups, span_p)
    wj = jnp.asarray(w)
    p = jax.lax.Precision.HIGHEST
    re = jnp.matmul(lhs.real, wj, precision=p)
    im = jnp.matmul(lhs.imag, wj, precision=p)
    y = (re + 1j * im).astype(jnp.complex64)  # (B, groups, 128)
    return y.reshape(x.shape[0], groups * 128)[:, :n_out]


def _overlap_save_poly(
    x: jnp.ndarray, taps: np.ndarray, d: int, n_out: int
) -> jnp.ndarray:
    """Polyphase overlap-save: every FFT runs at the *decimated* rate.

    Splitting tap index ``j = q*d + r`` turns the decimating correlation
    into a sum of ``d`` phase correlations, each between the phase-``r``
    decimated input ``x_r[n] = x[n*d + r]`` and subfilter
    ``h_r[q] = h[q*d + r]`` of length ``ceil(size/d)``:

        y[i] = sum_r sum_q x[(i+q)*d + r] * h[q*d + r]
             = sum_r corr(x_r, h_r)[i]

    The plain overlap-save computes a full-rate circular convolution and
    throws away ``(d-1)/d`` of the IFFT outputs (plus a stride-``d``
    pick); here the forward FFTs cover the same samples in ``d``
    transforms of ``1/d`` the length, the phase spectra sum *before* the
    inverse transform, and every IFFT output is kept — ~3x fewer
    butterflies at the power=2000 / decimate=32 operating point, and no
    strided HBM access.
    """
    from quadrs_tpu.ops.stft import mxu_fft_planes

    size = len(taps)
    md = -(-size // d)  # decimated-domain subfilter length
    # decimated-rate frame, much larger than the classic ~4x-filter
    # rule: the overlap fraction and the per-frame phase-spectra
    # reduction both shrink with m2.  Target a 128K-
    # sample raw frame, capped at 4096 bins, floored by 2x the subfilter
    # — but never larger than one frame covering every requested output
    # (small per-read conformance pulls would otherwise pay for a
    # benchmark-sized frame of zero padding).
    base = max(min(131072 // d, 4096), 512)
    m2 = 1 << (max(2 * md, min(base, n_out + md - 1)) - 1).bit_length()
    hop2 = m2 - md + 1  # valid correlation outputs per frame
    n_frames = -(-n_out // hop2)

    # correlation spectrum sum_j h[j] e^{+2pi i jk/N} = conj(FFT(conj(h)))
    # of each zero-padded subfilter, f64 on host -> f32 planes; the
    # inner conj is a no-op for real taps and makes complex (premixed
    # band-pass) taps come out right
    hp = np.zeros((md * d,), dtype=np.complex128)
    hp[:size] = taps.astype(np.complex128)
    h_f64 = np.conj(np.fft.fft(np.conj(hp).reshape(md, d), n=m2, axis=0))  # (m2, d)
    hr = jnp.asarray(h_f64.real.T.astype(np.float32))  # (d, m2)
    hi = jnp.asarray(h_f64.imag.T.astype(np.float32))

    # raw-domain frames at stride hop2*d; reshaping (m2, d) makes the
    # phase decomposition a free view: frame[n, r] = x_r[k*hop2 + n]
    frames = _overlapped_frames(x, hop2 * d, m2 * d, n_frames)  # (B, F, m2*d)
    b = x.shape[0]
    ph = frames.reshape(b, n_frames, m2, d).transpose(0, 1, 3, 2)
    fwd = mxu_fft_planes(ph.real, ph.imag)  # (B, F, d, m2) or None
    if fwd is not None:
        sr, si = fwd
        accr = jnp.sum(sr * hr - si * hi, axis=2)  # (B, F, m2)
        acci = jnp.sum(sr * hi + si * hr, axis=2)
        yr, yi = mxu_fft_planes(accr, acci, inverse=True)
    else:
        # enormous subfilters (m2 > 1024^2) have no matmul split with
        # every matmul <= 1024 wide; fall back to XLA's FFT
        spec = jnp.fft.fft(jax.lax.complex(ph.real, ph.imag))
        acc = jnp.sum(spec * jax.lax.complex(hr, hi), axis=2)
        inv = jnp.fft.ifft(acc)
        yr, yi = jnp.real(inv), jnp.imag(inv)
    y = jax.lax.complex(yr[:, :, :hop2], yi[:, :, :hop2])
    return y.reshape(b, n_frames * hop2)[:, :n_out].astype(jnp.complex64)


def _overlap_save(x: jnp.ndarray, taps: np.ndarray, d: int, n_out: int) -> jnp.ndarray:
    """Frequency-domain decimating correlation over overlapped frames.

    ``x``: (B, L) complex64 with the group-delay prefix already dropped;
    computes ``y[i] = sum_j x[i*d + j] h[j]`` like the time-domain paths.
    """
    size = len(taps)
    # frame size: power of two, ~4x the filter — the overlap fraction
    # dominates the cost below that
    m = 1 << max(size * 4 - 1, 4096).bit_length()
    hop = ((m - size + 1) // d) * d
    if hop <= 0:
        raise ValueError("filter too long for overlap-save frame")
    n_frames = -(-(n_out * d) // hop)

    # correlation spectrum conj(FFT(conj(h))) — see _overlap_save_poly
    h_f64 = np.conj(np.fft.fft(np.conj(taps.astype(np.complex128)), m))
    h_f = jax.lax.complex(
        jnp.asarray(h_f64.real.astype(np.float32)),
        jnp.asarray(h_f64.imag.astype(np.float32)),
    )

    frames = _overlapped_frames(x, hop, m, n_frames)  # (B, n_frames, m)
    spec = jnp.fft.fft(frames) * h_f
    corr = jnp.fft.ifft(spec)
    # linear-valid decimated outputs of each frame: 0, d, ..., hop-d
    picks = corr[:, :, 0:hop:d]  # (B, n_frames, hop//d)
    y = picks.reshape(x.shape[0], n_frames * (hop // d))
    return y[:, :n_out].astype(jnp.complex64)
