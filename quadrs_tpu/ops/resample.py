"""Rational resampler tables and kernel: sample-rate conversion by L/M.

Addition (no reference counterpart — quadrs only has integer
decimation, ``src/filter.rs``).  Semantics follow the house FIR
convention (:mod:`quadrs_tpu.ops.fir`): with the zero-stuffed upsample
``u[n] = x[n/L] if L|n else 0`` and Blackman-sinc taps ``h`` of length
``N`` (cutoff ``min(1/(2L), 1/(2M))`` of the upsampled rate, scaled by
``L`` to preserve amplitude),

    y[i] = sum_j h[j] * u[i*M + c + j],     c = N - N//2

— the same correlation-with-group-delay-pick shape as LowPass, so
``Resample(up=1, down=M)`` computes exactly ``LowPass(sr/(2M), M, N)``'s
sums (equal within f32 accumulation order, ≤1e-6 rel measured; impl
selection in :func:`quadrs_tpu.ops.fir.fir_decimate` orders the adds
differently).

Only every L-th tap hits data: with ``phi(i) = (-(i*M + c)) mod L`` the
sum collapses to ``y[i] = sum_q h[phi + q*L] x[beta + q]`` where
``beta = (i*M + c + phi)/L``.  Outputs group into blocks of L (the
phase pattern repeats when i advances by L), every block reads one
input frame at stride M, and the whole block is ONE small matmul:

    y[block j] = frames[j] @ W[w]          (m x L, matmul-shaped)

where ``w = off mod L`` selects among L precomputed weight matrices
(the phase pattern of a window depends only on its start offset mod L).
Frames come from the no-gather row-slice builder
(:func:`quadrs_tpu.ops.fir._overlapped_frames`).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=8)
def resample_tables(size: int, up: int, down: int):
    """Precompute the per-phase geometry and weight table.

    Returns ``(weights, gamma_min, frame_len, d)``:

    * ``weights``: (L, m, L) f32 — ``y[jL + r] = frames[j] @ weights[w][:, r]``
      for a window starting at output offset ``off`` with ``w = off mod L``;
      frame ``j`` is ``x[a*M + gamma_min + j*M : ... + m]`` where
      ``a = (off - w) / L``.
    * ``gamma_min``: first input sample (relative to ``a*M``) any phase touches.
    * ``frame_len`` (m): input samples per frame.
    * ``d``: (L, L) int64 — output ``jL + r`` of a window with phase ``w``
      needs window-relative input samples through ``j*M + d[w, r]``
      inclusive; used for exact valid counts.
    """
    from quadrs_tpu.ops.fir import lowpass_taps

    l, m_ = int(up), int(down)
    n = int(size)
    cutoff = min(1.0 / (2 * l), 1.0 / (2 * m_))
    taps = lowpass_taps(cutoff, n) * np.float32(l)
    c = n - n // 2

    w_r = np.arange(l)[:, None] + np.arange(l)[None, :]  # (w, r) -> w + r
    phi = (-(w_r * m_ + c)) % l
    gamma = (w_r * m_ + c + phi) // l  # exact: numerator divisible by L
    q_count = -(-(n - phi) // l)  # taps per phase (ceil)
    gamma_min = int(gamma.min())
    frame_len = int((gamma - gamma_min + q_count).max())

    qmax = int(q_count.max())
    q = np.arange(qmax)
    tap_idx = phi[..., None] + q * l  # (L, L, qmax)
    ok = tap_idx < n
    t_idx = gamma[..., None] - gamma_min + q
    w_idx, r_idx = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
    w_idx = np.broadcast_to(w_idx[..., None], tap_idx.shape)
    r_idx = np.broadcast_to(r_idx[..., None], tap_idx.shape)
    weights = np.zeros((l, frame_len, l), dtype=np.float32)
    weights[w_idx[ok], t_idx[ok], r_idx[ok]] = taps[tap_idx[ok]]

    d = gamma - gamma_min + q_count - 1  # last frame-relative index read
    return weights, gamma_min, frame_len, d.astype(np.int64)


def resample_real(
    audio: np.ndarray, rate: int, target_rate: int, *, power: int = 8
) -> tuple[int, np.ndarray]:
    """Resample a whole real (f32) signal from ``rate`` to
    ``target_rate`` Hz — the demod models' audio stage (FM/AM audio to
    a sound-device rate like 48 kHz, which is rarely an integer divisor
    of the channel rate).

    Same tables and semantics as :func:`resample_tables` with the
    window at offset 0 (phase class w=0): one ``(frames, m) @ (m, L)``
    matmul over the burst, output length = the exact full-window count.
    Identity when the rates already match.
    """
    rate, target_rate = int(rate), int(target_rate)
    if rate <= 0 or target_rate <= 0:
        raise ValueError("rates must be positive")
    if rate == target_rate:
        return rate, audio
    g = math.gcd(rate, target_rate)
    l, m_ = target_rate // g, rate // g
    size = 2 * int(power) * max(l, m_)
    weights, gamma_min, frame_len, d = resample_tables(size, l, m_)
    avail = len(audio) - gamma_min
    jmax = (avail - 1 - d[0]) // m_
    n_out = int(np.min((jmax + 1) * l + np.arange(l)))
    if n_out < 1:
        raise ValueError("audio shorter than the resampling filter")
    nb = -(-n_out // l)
    n_in = (nb - 1) * m_ + frame_len
    x = np.zeros(n_in, dtype=np.float32)
    take = min(n_in, max(0, len(audio) - gamma_min))
    x[:take] = audio[gamma_min : gamma_min + take]

    return target_rate, np.asarray(_resample_real_fn(size, l, m_, nb, n_out)(x))


@functools.lru_cache(maxsize=32)
def _resample_real_fn(size: int, up: int, down: int, nb: int, n_out: int):
    """Cached jitted core of :func:`resample_real` — demodulating many
    bursts with the same geometry must not recompile per burst."""
    weights, _, frame_len, _ = resample_tables(size, up, down)
    w0 = jnp.asarray(weights[0])
    from quadrs_tpu.ops.fir import _overlapped_frames

    @jax.jit
    def run(a):
        frames = _overlapped_frames(a[None, :], down, frame_len, nb)  # (1, nb, m)
        y = jnp.einsum(
            "bfm,ml->bfl", frames, w0, precision=jax.lax.Precision.HIGHEST
        )
        return y.reshape(-1)[:n_out]

    return run


def resample_block(
    x: jnp.ndarray, w_sel: jnp.ndarray, size: int, up: int, down: int, n_out: int
) -> jnp.ndarray:
    """Resample a batch of staged blocks.

    ``x``: (B, n_in) complex64, the window's input beginning at
    ``a*M + gamma_min`` (host-planned), entries past the valid extent
    already zero; ``w_sel``: (B,) int32 phase class (``off mod L``).
    Returns (B, n_out) complex64.
    """
    weights, _, m, _ = resample_tables(size, up, down)
    l = int(up)
    nb = -(-n_out // l)
    from quadrs_tpu.ops.fir import _overlapped_frames

    frames = _overlapped_frames(x, int(down), m, nb)  # (B, nb, m)
    wsel = jnp.take(jnp.asarray(weights), w_sel, axis=0)  # (B, m, L)
    p = jax.lax.Precision.HIGHEST
    re = jnp.einsum("bfm,bml->bfl", frames.real, wsel, precision=p)
    im = jnp.einsum("bfm,bml->bfl", frames.imag, wsel, precision=p)
    y = (re + 1j * im).astype(jnp.complex64)
    return y.reshape(y.shape[0], nb * l)[:, :n_out]
