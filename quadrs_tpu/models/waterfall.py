"""Batched multi-stream waterfall: many captures, one fused program.

BASELINE config 5: "64 parallel cs8 IQ streams, fused decode + 1024-pt
strided STFT spectrogram search".  All streams decode on device and go
through one batched windowing + DFT over ``(S*windows, W)`` frames, plus
an optional peak-search or band-survey reduction that XLA fuses into the
norms, so the whole waterfall bank is one XLA program per chunk.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from quadrs_tpu.formats import FileFormat, decode_plane, pack_complex
from quadrs_tpu.ops.fir import _overlapped_frames
from quadrs_tpu.ops.stft import blackman_harris_window, stft_norms


@dataclass(frozen=True)
class WaterfallConfig:
    n_streams: int = 64
    fft_width: int = 1024
    stride: int = 1024
    fmt: FileFormat = FileFormat.COMPLEX_INT8
    windowing: str = "rectangular"  # or "blackman-harris"


class WaterfallModel:
    def __init__(self, cfg: WaterfallConfig):
        self.cfg = cfg
        self.window = (
            blackman_harris_window(cfg.fft_width)
            if cfg.windowing in ("blackman-harris", "blackmanharris")
            else None
        )

    def step(self, raw: jnp.ndarray) -> jnp.ndarray:
        """(S, 2, n) native planes -> (S, windows, fft_width) f32 norms."""
        cfg = self.cfg
        n = raw.shape[-1]
        n_windows = (n - cfg.fft_width) // cfg.stride + 1
        re = decode_plane(raw[:, 0, :], cfg.fmt, xp=jnp)
        im = decode_plane(raw[:, 1, :], cfg.fmt, xp=jnp)
        x = pack_complex(re, im, xp=jnp)  # (S, n)
        frames = _overlapped_frames(x, cfg.stride, cfg.fft_width, n_windows)
        s = frames.shape[0]
        norms = stft_norms(
            frames.reshape(s * n_windows, cfg.fft_width), window=self.window
        )
        return norms.reshape(s, n_windows, cfg.fft_width)

    def search(self, raw: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Spectrogram search: per (stream, window) the peak bin and its
        magnitude — the device-side reduction for scanning many bands."""
        return self.jit_search()(raw)

    @functools.cache
    def jit_search(self):
        """Jitted peak-search step, symmetric with :meth:`jit_step`:
        (S, 2, n) native planes -> ((S, windows) int32 fftshifted peak
        bins, (S, windows) f32 magnitudes)."""
        def run(r):
            norms = self.step(r)
            return jnp.argmax(norms, axis=-1), jnp.max(norms, axis=-1)

        return jax.jit(run)

    @functools.cache
    def jit_scan(self):
        """Jitted band-survey step, symmetric with :meth:`jit_search`:
        ``(raw, threshold)`` -> per (stream, fftshifted bin) the
        ``(sum, max, count > threshold)`` of the window norms, each
        (S, width) f32."""

        def run(r, thr):
            norms = self.step(r)
            return (
                jnp.sum(norms, axis=1),
                jnp.max(norms, axis=1),
                jnp.sum((norms > thr).astype(jnp.float32), axis=1),
            )

        return jax.jit(run)

    @functools.cache
    def jit_step(self):
        return jax.jit(self.step)

    def synth_raw(self, n: int, seed: int = 0) -> np.ndarray:
        from quadrs_tpu.formats import synth_planes

        return synth_planes(self.cfg.fmt, n, seed, n_streams=self.cfg.n_streams)
