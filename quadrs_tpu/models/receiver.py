"""The flagship fused pipeline: decode -> NCO mix -> FIR decimate -> STFT.

This is the production counterpart of the chained CLI pipeline
(``from -> shift -> lowpass -> sparkfft``): one jit-compiled step that
takes a raw capture chunk in its native narrow dtype and produces the
spectrogram magnitudes, with every stage fused by XLA — the decode and
mix are elementwise work that XLA fuses into the FIR and DFT consumers.

Two execution modes:

* :func:`PipelineModel.step_windows` — per-window semantics matching the
  reference's pull model bit-for-bit at block boundaries (used by the
  conformance executor and ``entry()``).

* :func:`PipelineModel.step_stream` — contiguous streaming over a long
  chunk: the FIR runs once over the chunk (no per-window overlap
  recompute) and the decimated output reshapes into STFT windows.  This
  is the throughput mode ``bench.py`` measures and the sharded
  multi-chip path distributes (see :mod:`quadrs_tpu.parallel`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from quadrs_tpu.formats import FileFormat, decode_plane, pack_complex
from quadrs_tpu.ops.fir import fir_decimate, lowpass_taps
from quadrs_tpu.ops.stft import stft_norms



@dataclass(frozen=True)
class PipelineConfig:
    """The BASELINE north-star chain: shift -> lowpass(decimate) -> STFT."""

    sample_rate: int = 21_000_000
    shift_freq: int = 280_000
    lp_freq: int = 200_000
    decimate: int = 32
    taps: int = 400
    fft_width: int = 64
    fmt: FileFormat = FileFormat.COMPLEX_FLOAT32
    fir_impl: str = "auto"

    @property
    def window_raw(self) -> int:
        """Raw samples per STFT window in per-window mode."""
        return self.fft_width * self.decimate + self.taps


class PipelineModel:
    def __init__(self, cfg: PipelineConfig):
        from quadrs_tpu.ops.nco import ExactNCO

        self.cfg = cfg
        self.taps = lowpass_taps(cfg.lp_freq / cfg.sample_rate, cfg.taps)
        self._nco = ExactNCO(cfg.shift_freq, cfg.sample_rate)

    # -- host-side exact phase planning (shared ExactNCO invariant) --------
    def theta0(self, offs: np.ndarray) -> np.ndarray:
        return self._nco.angles(offs)

    def delta(self, n: int) -> np.ndarray:
        return self._nco.angles(np.arange(n, dtype=np.int64))

    # -- device steps -----------------------------------------------------
    def _mix(self, x: jnp.ndarray, theta0: jnp.ndarray, n: int) -> jnp.ndarray:
        delta = jnp.asarray(self.delta(n))
        theta = theta0[..., None] + delta
        return x * (jnp.cos(theta) + 1j * jnp.sin(theta)).astype(jnp.complex64)

    _MIX_TILE = 4096

    def _mix_stream(self, x: jnp.ndarray, theta0: jnp.ndarray) -> jnp.ndarray:
        """NCO mix over a long contiguous chunk without an O(chunk) angle
        table OR O(chunk) device trig: index i = q*K + r decomposes the
        exact rotation into ``cis(theta0) · cis(thetaQ[q]) · cis(thetaR[r])``.
        The q/r factors are host-exact f64-rounded tables (O(n/K + K)
        values), the traced base costs two transcendentals total, and
        each sample pays only the angle-addition multiplies."""
        k = self._MIX_TILE
        n = x.shape[-1]
        rows = -(-n // k)
        pad = rows * k - n
        if pad:
            x = jnp.pad(x, (0, pad))
        cq, sq = self._nco.cis(np.arange(rows, dtype=np.int64) * k)
        cr, sr = self._nco.cis(np.arange(k, dtype=np.int64))
        c0, s0 = jnp.cos(theta0), jnp.sin(theta0)
        # rotate the row table by the base angle: (rows,) cheap
        ca = (c0 * cq - s0 * sq)[:, None]
        sa = (s0 * cq + c0 * sq)[:, None]
        # combine with the in-row table: (rows, k) via angle addition
        c = ca * cr[None, :] - sa * sr[None, :]
        s = sa * cr[None, :] + ca * sr[None, :]
        xr = x.reshape(rows, k)
        mixed = jax.lax.complex(
            xr.real * c - xr.imag * s, xr.real * s + xr.imag * c
        )
        return mixed.reshape(rows * k)[:n]

    # -- premixed-taps streaming (spectral FIR only) ------------------------
    @cached_property
    def _spectral_fir(self) -> bool:
        """True when step_stream's FIR runs in the frequency domain
        (overlap-save class), where the NCO mix commutes into the filter
        for free: ``sum_j x[iD+j] e^{i theta(iD+j)} h[j] = e^{i theta(iD)}
        sum_j x[iD+j] (h[j] e^{i theta(j)})`` — complex band-pass taps
        plus a decimated-rate output twiddle, no per-sample mix at all.
        (The matmul impls would pay 2x for complex taps, so they keep the
        table-based _mix_stream.)"""
        from quadrs_tpu.ops.fir import is_spectral

        if self.cfg.fir_impl in ("overlap_save", "os_poly"):
            return True
        if self.cfg.fir_impl != "auto":
            return False
        return is_spectral(self.cfg.taps, self.cfg.decimate)

    @cached_property
    def _premixed_taps(self) -> np.ndarray:
        """The reference's f32 taps modulated by the exact NCO rotation
        at each tap index: a complex band-pass filter."""
        dj = self._nco.angles(np.arange(self.cfg.taps, dtype=np.int64), dtype=np.float64)
        return (self.taps.astype(np.float64) * np.exp(1j * dj)).astype(np.complex64)

    def _twiddle_decimated(
        self, y: jnp.ndarray, theta0: jnp.ndarray, n_dec: int
    ) -> jnp.ndarray:
        """Rotate decimated premixed-FIR outputs by the exact NCO angle
        of their first contributing sample: host-exact cis tables at the
        decimated rate, rotated by the traced chunk base angle."""
        cfg = self.cfg
        prefix = cfg.taps - cfg.taps // 2  # matches fir_decimate's drop
        twr, twi = self._nco.cis(
            prefix + cfg.decimate * np.arange(n_dec, dtype=np.int64)
        )
        c0, s0 = jnp.cos(theta0), jnp.sin(theta0)
        cr = c0 * jnp.asarray(twr) - s0 * jnp.asarray(twi)
        ci = s0 * jnp.asarray(twr) + c0 * jnp.asarray(twi)
        return jax.lax.complex(y.real * cr - y.imag * ci, y.real * ci + y.imag * cr)

    def _decode(self, raw: jnp.ndarray) -> jnp.ndarray:
        """(…, 2, n) native-dtype planes -> (…, n) complex64, on chip.

        Planar layout: the host / native loader deinterleaves once, so
        the device reads two contiguous planes instead of a stride-2
        gather.
        """
        re = decode_plane(raw[..., 0, :], self.cfg.fmt, xp=jnp)
        im = decode_plane(raw[..., 1, :], self.cfg.fmt, xp=jnp)
        return pack_complex(re, im, xp=jnp)

    def step_windows(self, raw: jnp.ndarray, theta0: jnp.ndarray) -> jnp.ndarray:
        """Per-window mode: ``raw`` is (B, 2, window_raw) native-dtype
        planes (one block per STFT window), ``theta0`` (B,) exact window
        phases.  Returns (B, fft_width) f32 spectrogram rows."""
        cfg = self.cfg
        x = self._mix(self._decode(raw), theta0, cfg.window_raw)
        y = fir_decimate(x, self.taps, cfg.decimate, cfg.fft_width, impl=cfg.fir_impl)
        return stft_norms(y)

    def step_stream(
        self,
        raw: jnp.ndarray,
        theta0: jnp.ndarray,
        valid: jnp.ndarray | None = None,
    ) -> jnp.ndarray:
        """Streaming mode: ``raw`` is (2, n_chunk) native-dtype planes of
        a contiguous chunk (including ``taps`` halo at its end),
        ``theta0`` a scalar phase for the chunk start.  The FIR runs once
        across the chunk; the decimated stream reshapes into adjacent
        STFT windows (stride == width, the sparkfft default).  Returns
        (n_windows, fft_width) f32.

        ``valid``: optional count of real samples in ``raw``.  Zero
        padding must happen in the *decoded* domain — a zero byte
        decodes to -127.5 (cu8) / -32767.5 (cs16) — so callers that pad
        raw planes past EOF must pass the true length here.
        """
        cfg = self.cfg
        n_in = raw.shape[-1]
        x = self._decode(raw)
        if valid is not None:
            mask = jnp.arange(n_in, dtype=jnp.int32) < valid
            x = jnp.where(mask, x, 0)
        n_dec = (n_in - cfg.taps) // cfg.decimate
        n_windows = n_dec // cfg.fft_width
        if self._spectral_fir:
            y = fir_decimate(
                x[None, :], self._premixed_taps, cfg.decimate, n_dec, impl=cfg.fir_impl
            )[0]
            y = self._twiddle_decimated(y, theta0, n_dec)
        else:
            x = self._mix_stream(x, theta0)
            y = fir_decimate(x[None, :], self.taps, cfg.decimate, n_dec, impl=cfg.fir_impl)[0]
        return stft_norms(y[: n_windows * cfg.fft_width].reshape(n_windows, cfg.fft_width))

    # -- per-window peak search (the StreamRunner counterpart of
    # WaterfallModel.search: scan the decimated channel for its peak) ----
    @staticmethod
    def _peak_reduce(norms: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(…, W) fftshifted norms -> ((…,) int32 argmax bin, (…,) f32
        magnitude) — ties to the lowest shifted bin like jnp.argmax."""
        return jnp.argmax(norms, axis=-1).astype(jnp.int32), jnp.max(norms, axis=-1)

    def step_stream_search(
        self,
        raw: jnp.ndarray,
        theta0: jnp.ndarray,
        valid: jnp.ndarray | None = None,
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """:meth:`step_stream` reduced per window: the fftshifted peak
        bin and its magnitude for each STFT window of the decimated
        chain — the "scan this channel for the peak" serving product
        (XLA keeps the reduction fused with the STFT; the spectrogram
        rows never round-trip through the host)."""
        return self._peak_reduce(self.step_stream(raw, theta0, valid))

    @cached_property
    def jit_step_windows(self):
        return jax.jit(self.step_windows)

    @cached_property
    def jit_step_stream(self):
        return jax.jit(self.step_stream)

    @cached_property
    def jit_step_stream_search(self):
        return jax.jit(self.step_stream_search)

    # -- convenience ------------------------------------------------------
    def chunk_bytes(self, n_samples: int) -> int:
        return n_samples * self.cfg.fmt.pair_bytes

    def synth_raw(self, n_samples: int, seed: int = 0) -> np.ndarray:
        """Synthetic capture as (2, n_samples) native-dtype planes."""
        from quadrs_tpu.formats import synth_planes

        return synth_planes(self.cfg.fmt, n_samples, seed)
