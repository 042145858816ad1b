"""Waterfall renderers — file-writing parity for the reference GUIs.

The reference ships two OpenGL desktop waterfalls; an accelerator host has no
display, so the same render engines write PNGs instead:

* :func:`ui_render` mirrors the legacy conrod GUI's ``render``
  (``src/ui/mod.rs:294-412``): stride-1 STFT, one column per window,
  wrapping into row-bands every ``stretch*fft_width + 16`` px, HSV
  colormap ``hue=(1-mag/2.29)*0.8*360°, sat=1, val=mag/2.29``
  (``src/ui/mod.rs:351-372``), black separator column every ``stride``
  windows.

* :func:`eui_render` mirrors the egui GUI's off-thread render
  (``src/eui/mod.rs:86-113``): Blackman-Harris ``take_fft`` over a
  percentage slice of the file, 2048 rows, blue-channel colormap
  ``b = saturate(mag/10*256)`` (``src/eui/mod.rs:103-106``).

The STFT math runs batched on the device; only colormapping happens on
the host (vectorized numpy, not per-pixel loops).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from quadrs_tpu.ops.stft import stft_norms
from quadrs_tpu.runtime import Executor, root_step_of, window_batches
from quadrs_tpu.sinks import take_fft
from quadrs_tpu.sources import SampleSource
from quadrs_tpu.stream import Stream
from quadrs_tpu.utils.sniff import guess_details


@dataclass
class UiParams:
    """Defaults per ``src/ui/mod.rs:71-77`` (window size :26-27)."""

    width: int = 800
    height: int = 600
    fft_width: int = 8
    stride: int = 1
    stretch: int = 4


def _hsv_to_rgb_u8(scaled: np.ndarray) -> np.ndarray:
    """The legacy GUI colormap: scaled magnitude in [0, ~1] -> (r, g, b).

    hue = (1-scaled)*0.8*360 deg, sat = 1, value = scaled, then
    ``(channel * 256) as u8`` with Rust's saturating cast.
    """
    inv = 1.0 - scaled
    h = (inv * 0.8 * 360.0) % 360.0
    v = 1.0 - inv
    c = v  # chroma = v * s, s = 1
    hp = h / 60.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    z = np.zeros_like(c)
    sector = np.floor(hp).astype(np.int32) % 6
    r = np.choose(sector, [c, x, z, z, x, c])
    g = np.choose(sector, [x, c, c, x, z, z])
    b = np.choose(sector, [z, z, x, c, c, x])
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb * 256.0, 0, 255).astype(np.uint8)


def ui_render(
    stream: Stream, params: UiParams | None = None
) -> tuple[np.ndarray, float, float]:
    """Render the legacy-GUI waterfall; returns (H, W, 3) u8 + (min, max)
    observed scaled magnitudes (the reference prints these,
    ``src/ui/mod.rs:409``)."""
    p = params or UiParams()
    w, h = p.width, p.height
    if w <= p.fft_width:
        raise ValueError("window too narrow")
    if p.stretch <= 0:
        raise ValueError("negative stretching")

    img = np.zeros((h, w, 3), dtype=np.uint8)
    row_height = p.stretch * p.fft_width + 16

    samples_available = stream.length - p.fft_width
    if samples_available <= 0:
        raise ValueError("input shorter than fft width")
    # columns fill left-to-right then wrap to the next row-band; stop
    # when the band start exceeds the canvas (src/ui/mod.rs:325-331)
    max_bands = h // row_height + 1
    n_windows = int(min(samples_available, w * max_bands))
    offsets = np.arange(n_windows, dtype=np.int64)

    batch, batches = window_batches(offsets, p.fft_width, root_step=root_step_of(stream))
    ex = Executor(stream, p.fft_width, batch=batch, post=stft_norms)
    norms_all = []
    for offs in batches:
        norms, valid = ex.run(offs)
        if not np.all(valid == p.fft_width):
            raise RuntimeError("read-exact messed up in ui render")
        norms_all.append(norms)
    norms = np.concatenate(norms_all, axis=0)  # (n_windows, fft_width)

    scaled = norms / np.float32(2.29)
    obs_min = float(min(scaled.min(initial=99.0), 99.0))
    obs_max = float(max(scaled.max(initial=0.0), 0.0))

    colors = _hsv_to_rgb_u8(scaled.astype(np.float64))  # (n, fw, 3)
    # black separator column every `stride` windows (src/ui/mod.rs:374-376)
    colors[::p.stride, :, :] = 0

    cols = np.arange(n_windows)
    ox = cols % w
    band = cols // w
    oy = band * row_height

    # vertical layout: each fft bin o paints `stretch` pixels starting at
    # oy + o*stretch; the framebuffer y axis is bottom-up
    # (src/ui/mod.rs:286-291), i.e. image row = h - 1 - y.
    fw = p.fft_width
    # fftshift ordering (skip half, chain take half) already applied by stft_norms
    for o in range(fw):
        for off in range(p.stretch):
            y = oy + o * p.stretch + off
            ok = y < h
            img[h - 1 - y[ok], ox[ok]] = colors[ok, o]

    return img, obs_min, obs_max


def ui_render_file(
    stream: Stream, path: str | Path = "ui.png", params: UiParams | None = None
) -> Path:
    from PIL import Image

    img, obs_min, obs_max = ui_render(stream, params)
    print(f"{obs_min} {obs_max}")
    path = Path(path)
    Image.fromarray(img).save(path)
    return path


def ui_render_frames(
    stream: Stream,
    n_frames: int,
    path_prefix: str | Path = "ui",
    params: UiParams | None = None,
) -> list[Path]:
    """Parameter-sweep render approximating the interactive loop.

    The legacy GUI re-renders whenever a parameter changes
    (``src/ui/mod.rs:235-258``); its fft+ button doubles ``fft_width``
    (``:140-160``).  Frame ``k`` renders with ``fft_width * 2**k`` — one
    PNG per simulated button click — as ``{prefix}{k:03d}.png``.
    """
    from PIL import Image

    if n_frames < 1:
        raise ValueError("need at least one frame")
    p = params or UiParams()
    paths: list[Path] = []
    for k in range(n_frames):
        fw = p.fft_width << k
        if k > 0 and fw >= min(stream.length, p.width):
            break  # the GUI would refuse this click; stop the sweep
            # (frame 0 falls through so a bad starting fft_width raises
            # ui_render's error instead of silently writing nothing)
        frame = UiParams(
            width=p.width, height=p.height, fft_width=fw, stride=p.stride, stretch=p.stretch
        )
        img, obs_min, obs_max = ui_render(stream, frame)
        print(f"{obs_min} {obs_max}")
        path = Path(f"{path_prefix}{k:03d}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths


@dataclass
class EuiParams:
    """Defaults per ``src/eui/mod.rs:62-70``: 46%..46.3% of the file,
    512-wide Blackman-Harris FFT, 2048 output rows (:87)."""

    start_pct: float = 46.0
    end_pct: float = 46.3
    fft_width: int = 512
    rows: int = 2048


def eui_render(stream: Stream, params: EuiParams | None = None) -> np.ndarray:
    """Render the egui waterfall; returns (rows, fft_width, 3) u8."""
    p = params or EuiParams()
    start = int(np.float32(stream.length) * np.float32(p.start_pct) / np.float32(100.0))
    end = int(np.float32(stream.length) * np.float32(p.end_pct) / np.float32(100.0))
    res = take_fft(stream, (start, end), p.fft_width, p.rows, windowing="blackman-harris")
    # blue-channel map with Rust's saturating `as u8` (src/eui/mod.rs:103-106)
    b = np.clip(res.norms / 10.0 * 256.0, 0, 255).astype(np.uint8)
    img = np.zeros((res.output_len, p.fft_width, 3), dtype=np.uint8)
    img[:, :, 2] = b
    return img


def eui_render_file(
    filename: str | Path | None,
    path: str | Path = "eui.png",
    params: EuiParams | None = None,
) -> Path:
    from PIL import Image

    if filename is None:
        raise ValueError("filename currently required")
    # eui reopens the file itself via sniffing (src/eui/mod.rs:31-36)
    details = guess_details(str(filename))
    stream = SampleSource.from_file(str(filename), details)
    img = eui_render(stream, params)
    path = Path(path)
    Image.fromarray(img).save(path)
    return path


def eui_render_frames(
    filename: str | Path | None,
    n_frames: int,
    path_prefix: str | Path = "eui",
    params: EuiParams | None = None,
) -> list[Path]:
    """Scrolling-waterfall render approximating the slider loop.

    The egui GUI re-renders whenever the start/end sliders move
    (``src/eui/mod.rs:154-161``).  Frame ``k`` advances the visible
    slice by its own span — dragging both sliders in lockstep across
    the capture — writing ``{prefix}{k:03d}.png`` until the slice
    reaches the end of the file.
    """
    from PIL import Image

    if filename is None:
        raise ValueError("filename currently required")
    if n_frames < 1:
        raise ValueError("need at least one frame")
    p = params or EuiParams()
    span = p.end_pct - p.start_pct
    if span <= 0:
        raise ValueError("end must be after start")
    details = guess_details(str(filename))
    stream = SampleSource.from_file(str(filename), details)
    paths: list[Path] = []
    for k in range(n_frames):
        start = p.start_pct + k * span
        end = start + span
        if end >= 100.0:
            # the right slider stop: end_pct=100 maps to end_sample ==
            # len, which take_fft rejects (reference ffts.rs:36 asserts
            # end < len, so the GUI panics there; the sweep just stops)
            break
        frame = EuiParams(
            start_pct=start, end_pct=end, fft_width=p.fft_width, rows=p.rows
        )
        img = eui_render(stream, frame)
        path = Path(f"{path_prefix}{k:03d}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths
