"""Polyphase channelizer kernel: K equally-spaced channels per pass.

No reference counterpart: quadrs extracts ONE channel per run with
``shift`` -> ``lowpass`` (README.md:89-95, ``src/shift.rs`` +
``src/filter.rs``).  This is the product for "give me every
channel of this band at once" — a critically-sampled polyphase filter
bank whose channel ``k`` reproduces the reference composition

    Shift(-k*sr/K) -> LowPass(cutoff, decimate=K, size=N)

within f32 commutation (the mix is folded through the filter instead of
applied per sample), at ~1/K the work of running K such chains.

Derivation.  The composed chain computes (``src/filter.rs:68-80``
indexing with the group-delay prefix ``c = N - N//2`` dropped, and the
NCO's absolute-index phase ``e^{-j2pi k a/K}`` from ``src/shift.rs:49``)

    y_k[i] = sum_j x[i*K + c + j] * e^{-j2pi k (c+j)/K} * h[j]

— the ``i*K`` phase term vanishes because the decimation equals the
channel count, so the phase depends only on ``j``.  Splitting
``j = u*K + s`` gives per-branch FIRs and one cross-branch DFT:

    b[i, s] = sum_u x[(i+u)*K + c + s] * h[u*K + s]      (U shifted FMAs)
    y[i, k] = e^{-j2pi k c/K} * sum_s b[i, s] e^{-j2pi k s/K}

The branch stage is ``U = ceil(N/K)`` fused multiply-adds over a
``(B, n, K)`` block (exactly N MACs per input sample, independent of K);
the DFT rides :func:`~quadrs_tpu.ops.stft.batched_fft` (dense matmul
to 256 channels, four-step matmul split beyond).  Channel ``k`` is
centered at ``+k*sr/K`` (DFT-bin order: ``k >= K/2`` alias to negative
frequencies, k - K).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=16)
def _branch_taps(taps_key: bytes, k: int) -> np.ndarray:
    """(U, K) f32 branch-subfilter matrix hm[u, s] = h[u*K + s]."""
    taps = np.frombuffer(taps_key, dtype=np.float32)
    u = -(-len(taps) // k)
    hm = np.zeros(u * k, dtype=np.float32)
    hm[: len(taps)] = taps
    return hm.reshape(u, k)


@functools.lru_cache(maxsize=16)
def _center_phase(size: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """f32 planes of the group-delay phase e^{-j*2pi*k*c/K}, c=N-N//2."""
    c = size - size // 2
    ph = np.exp(-2j * np.pi * np.arange(k) * c / k)  # f64 on host
    return ph.real.astype(np.float32), ph.imag.astype(np.float32)


def channelize_block(x: jnp.ndarray, taps: np.ndarray, k: int, n_out: int) -> jnp.ndarray:
    """All-channel filter bank over a batch of blocks.

    ``x``: (B, n_in) complex64 with ``n_in = n_out*k + len(taps)``;
    entries past each block's valid extent must already be zero (the
    caller masks, reproducing the reference's per-read truncated
    convolution).  Returns (B, n_out, k) complex64: channel ``ch`` of
    block ``b`` is ``out[b, :, ch]``.
    """
    from quadrs_tpu.ops.stft import batched_fft

    taps = np.asarray(taps, dtype=np.float32)
    size = len(taps)
    c = size - size // 2
    hm = _branch_taps(taps.tobytes(), k)
    u = hm.shape[0]

    # drop the group-delay prefix; pad so every branch FIR's last frame
    # exists (zero taps / zero data beyond, like fir_decimate)
    z = x[:, c:]
    rows_needed = n_out + u - 1
    need = rows_needed * k
    if z.shape[1] < need:
        z = jnp.pad(z, ((0, 0), (0, need - z.shape[1])))
    rows = z[:, :need].reshape(z.shape[0], rows_needed, k)

    # branch FIRs: U shifted fused multiply-adds of (B, n_out, K) blocks
    acc = rows[:, 0:n_out, :] * hm[0]
    for i in range(1, u):
        acc = acc + rows[:, i : i + n_out, :] * hm[i]

    # cross-branch DFT (auto: dense matmul or four-step split), then
    # the per-channel group-delay phase — constants stay in f32 planes
    y = batched_fft(acc)
    pr, pi = _center_phase(size, k)
    phase = jax.lax.complex(jnp.asarray(pr), jnp.asarray(pi))
    return (y * phase).astype(jnp.complex64)
