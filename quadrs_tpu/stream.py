"""The lazy stream graph — the counterpart of the reference's
``Samples`` trait (``src/samples.rs:11-28``).

The reference models DSP as pull-based random access: every stage
implements ``len() / sample_rate() / read_at(off, buf)`` and computes on
demand, recursing down the wrapper stack.  A literal port (per-sample
Python, or per-window device dispatch) would be hostile to XLA, so the
same *semantics* are split across two phases:

* **plan (host)** — given a batch of absolute window offsets, each node
  resolves everything offset-dependent with exact Python/numpy integer
  arithmetic: source spans, valid sample counts (the reference's
  short-read semantics), and NCO phase fractions ``(f*off) mod sr``
  (reduced exactly, so f32 trig stays accurate at any absolute offset —
  the reference gets this from f64 phase, ``src/shift.rs:49``).

* **read_batch (device)** — a pure traced function computing a whole
  ``(B, n)`` batch of windows in one XLA program.  Stages compose by
  ordinary function calls, so XLA fuses decode + mix + FIR + FFT into a
  single program.

Valid-count invariant: every node's output beyond its *source-derived*
valid count is exactly zero (sources mask), while transform stages that
shrink validity (LowPass) leave entries in ``[valid, n)`` unspecified;
consumers mask by the host-side valid counts.  This reproduces the
reference's truncated-convolution edge behavior bit-for-bit: the Rust
``complex_convolve`` skips out-of-buffer taps (``src/filter.rs:116``),
which is identical to convolving a zero-padded block.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import jax.numpy as jnp
import numpy as np

TAU = 2.0 * math.pi


@dataclass
class Plan:
    """Host-side plan for one batch of windows."""

    prep: Any  # pytree of numpy arrays, shipped to device
    valid: np.ndarray  # (B,) int64 — how many leading samples are real


class Stream:
    """A node in the lazy stream graph.

    Attributes mirror the reference trait: ``length`` (samples) and
    ``sample_rate`` (Hz).  ``length`` may over-report just like the
    reference's ``LowPass::len`` does (``src/filter.rs:45-48``); reads
    report the true valid count.
    """

    length: int
    sample_rate: int

    # -- host planning ----------------------------------------------------
    def span(self, off: int, n: int) -> tuple[int, int]:
        """Map an output span to the (offset, count) needed from the root
        source, composing through all stages."""
        raise NotImplementedError

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        """Vectorized host planning for window offsets ``offs`` (int64,
        shape (B,)) of static length ``n``.  ``base`` is the absolute
        root-source sample offset at which the staged buffer begins."""
        raise NotImplementedError

    # -- device compute ---------------------------------------------------
    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        """Traced compute of the batch: returns ``(B, n)`` complex64."""
        raise NotImplementedError

    # -- graph helpers ----------------------------------------------------
    def root(self) -> "Stream":
        node = self
        while hasattr(node, "inner"):
            node = node.inner
        return node

    # -- convenience ------------------------------------------------------
    def read_at(self, off: int, n: int) -> tuple[np.ndarray, int]:
        """Single-window convenience read (mirrors ``Samples::read_at``).

        Returns ``(samples[:n] complex64, valid)``.  Used by tests and
        small sinks; heavy sinks use :class:`quadrs_tpu.runtime.Executor`
        directly for batching.
        """
        from quadrs_tpu.runtime import Executor

        ex = Executor(self, n)
        out, valid = ex.run(np.asarray([off], dtype=np.int64))
        return np.asarray(out[0]), int(valid[0])


class Shift(Stream):
    """NCO frequency shifter (reference ``src/shift.rs``).

    Multiplies sample ``m`` (absolute index) by ``e^{j·2π·f·m/sr}``.
    The angle is reduced exactly on the host: ``(f·m) mod sr`` in integer
    arithmetic, then one f32 ``cos``/``sin`` on device — phase-coherent
    random access at any offset, like the reference's absolute-index f64
    phase (``src/shift.rs:46-53``) but without 64-bit floats on the device.
    """

    def __init__(self, inner: Stream, frequency: int, sample_rate: int | None = None):
        sample_rate = inner.sample_rate if sample_rate is None else sample_rate
        # reference src/shift.rs:20-24
        if not abs(frequency) < sample_rate // 2:
            raise ValueError("frequency must be under half the sample rate")
        if sample_rate <= 0:
            raise ValueError("sample rate must be positive")
        from quadrs_tpu.ops.nco import ExactNCO

        self.inner = inner
        self.frequency = int(frequency)
        self.sample_rate = int(sample_rate)
        self.length = inner.length
        self._nco = ExactNCO(self.frequency, self.sample_rate)

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(off, n)

    def _theta0(self, offs: np.ndarray) -> np.ndarray:
        return self._nco.angles(offs)

    def _delta(self, n: int) -> np.ndarray:
        return self._nco.angles(np.arange(n, dtype=np.int64))

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        inner = self.inner.plan(offs, n, base)
        prep = {"inner": inner.prep, "theta0": self._theta0(offs)}
        return Plan(prep=prep, valid=inner.valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        x = self.inner.read_batch(ctx, prep["inner"], n)
        delta = jnp.asarray(self._delta(n))  # trace-time constant
        theta = prep["theta0"][:, None] + delta[None, :]
        phasor = jnp.cos(theta) + 1j * jnp.sin(theta)
        return x * phasor.astype(jnp.complex64)


class LowPass(Stream):
    """Windowed-sinc FIR low-pass + decimator (reference ``src/filter.rs``).

    Taps are a Blackman-windowed sinc normalized to unit sum
    (``src/filter.rs:86-105``), computed in f32 exactly as the reference.
    A read of ``n`` output samples at offset ``off`` pulls
    ``n*decimate + taps`` raw samples at ``off*decimate`` and evaluates

        y[i] = sum_j x[i*D + taps/2 + j] * h[j]

    — the reference's ``convoluted[taps + i*decimate]`` pick with its
    group delay baked in (``src/filter.rs:68-80``).  Out-of-buffer taps
    read zeros, reproducing the reference's per-read truncation at block
    boundaries (``src/filter.rs:116``): outputs near the end of each
    pulled block are computed against a zero-padded tail even when more
    data exists in the stream, and sinks' pull sizes determine where
    those boundaries fall.
    """

    def __init__(
        self,
        inner: Stream,
        frequency: int,
        decimate: int,
        size: int,
        *,
        fir_impl: str = "auto",
    ):
        from quadrs_tpu.ops.fir import lowpass_taps

        if decimate <= 0:
            raise ValueError("decimate must be positive")
        self.inner = inner
        self.decimate = int(decimate)
        self.frequency = int(frequency)
        self.size = int(size)
        self.fir_impl = fir_impl
        self.sample_rate = inner.sample_rate // self.decimate
        # reference src/filter.rs:45-48
        if inner.length < self.size:
            raise ValueError("input shorter than the filter")
        self.length = 1 + (inner.length - self.size) // self.decimate
        cutoff = self.frequency / inner.sample_rate  # src/filter.rs:126-128
        self.taps = lowpass_taps(cutoff, self.size)

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(off * self.decimate, n * self.decimate + self.size)

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        n_in = n * self.decimate + self.size
        inner = self.inner.plan(offs * self.decimate, n_in, base)
        valid_in = inner.valid
        valid_out = np.maximum(valid_in - self.size, 0) // self.decimate
        prep = {"inner": inner.prep, "valid_in": valid_in.astype(np.int32)}
        return Plan(prep=prep, valid=valid_out)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        from quadrs_tpu.ops.fir import fir_decimate

        n_in = n * self.decimate + self.size
        x = self.inner.read_batch(ctx, prep["inner"], n_in)
        # Zero anything past this read's valid extent so the convolution
        # sees the same truncated block the reference does.
        mask = jnp.arange(n_in, dtype=jnp.int32)[None, :] < prep["valid_in"][:, None]
        x = jnp.where(mask, x, 0)
        return fir_decimate(x, self.taps, self.decimate, n, impl=self.fir_impl)


def _tw_indices(lead: jnp.ndarray, n: int, window: int):
    """Per-row block indices for trailing windows ``(m-W, m]``.

    ``lead[r]`` is the block index of row ``r``'s first output sample
    (``W-1`` once the stream has warmed up; smaller only for windows
    that start within the first ``W-1`` samples of the capture, where
    the lookback clamps at offset 0).  Returns ``(idx, hi, lo)``:
    ``idx`` addresses output samples in the padded input block, ``hi``/
    ``lo`` address an exclusive-prefix cumsum such that
    ``cs[hi] - cs[lo]`` is each output position's trailing-window sum.
    """
    idx = lead[:, None] + jnp.arange(n, dtype=jnp.int32)[None, :]
    hi = idx + 1
    lo = jnp.maximum(hi - window, 0)
    return idx, hi, lo


def _tw_count(abs_c: jnp.ndarray, n: int, window: int) -> jnp.ndarray:
    """(B, n) f32 sample count of each trailing window: ``min(W, m+1)``
    at absolute position ``m``.  ``abs_c`` is the absolute position of
    each row's first output, pre-clipped to ``W`` on the host so int32
    arithmetic cannot overflow at large offsets."""
    m1 = abs_c[:, None] + jnp.arange(n, dtype=jnp.int32)[None, :] + 1
    return jnp.minimum(m1, window).astype(jnp.float32)


class _Trailing(Stream):
    """Shared plumbing for stages conditioned on a trailing window of
    the last ``W`` input samples (inclusive of the current one): exact
    random access (the lookback is re-read, clamped at the stream
    start), so outputs are pull-size invariant — unlike LowPass's
    reference-mandated per-read truncation, these stages are
    additions and choose exact semantics (the same stance as Resample's
    exact ``length``)."""

    window: int

    def __init__(self, inner: Stream, window: int):
        if window < 1:
            raise ValueError("window must be at least 1")
        self.inner = inner
        self.window = int(window)
        self.length = inner.length
        self.sample_rate = inner.sample_rate

    def span(self, off: int, n: int) -> tuple[int, int]:
        lo = max(0, off - (self.window - 1))
        return self.inner.span(lo, n + (off - lo))

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        back = self.window - 1
        offs_in = np.maximum(offs - back, 0)
        lead = (offs - offs_in).astype(np.int32)
        inner = self.inner.plan(offs_in, n + back, base)
        valid_out = np.clip(inner.valid - lead.astype(np.int64), 0, n)
        prep = {
            "inner": inner.prep,
            "lead": lead,
            "abs_c": np.minimum(offs, self.window).astype(np.int32),
            "valid_out": valid_out.astype(np.int32),
        }
        return Plan(prep=prep, valid=valid_out)

    @staticmethod
    def _mask_valid(y: jnp.ndarray, prep: Any, n: int) -> jnp.ndarray:
        """Keep the module invariant that outputs past the source-derived
        valid count are exactly zero (a trailing mean/gain would
        otherwise leak into the padding region)."""
        keep = (
            jnp.arange(n, dtype=jnp.int32)[None, :] < prep["valid_out"][:, None]
        )
        return jnp.where(keep, y, 0)

    def _inner_block(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        return self.inner.read_batch(ctx, prep["inner"], n + self.window - 1)


class DcBlock(_Trailing):
    """DC-offset remover (an addition; no reference
    counterpart).  Subtracts from each sample the mean of the trailing
    ``window`` input samples (inclusive):

        y[m] = x[m] - mean(x[max(0, m-W+1) .. m])

    — the digital equivalent of rtl-sdr/gqrx "DC remove": direct-
    conversion tuners park a DC spike at the center bin that a
    ``shift``-then-``lowpass`` chain would otherwise mix into the
    channel.  The trailing mean is two cumsum lookups per output (the
    moving sum is a prefix-sum difference, no per-window reduction);
    the f32 prefix accumulates per pulled block, so values agree
    across pull sizes to ~1e-6 relative, not bit-exactly.
    """

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        x = self._inner_block(ctx, prep, n)
        if self.window == 1:  # trailing window is the sample itself
            return jnp.zeros_like(x)
        zero = jnp.zeros((x.shape[0], 1), dtype=x.dtype)
        cs = jnp.concatenate([zero, jnp.cumsum(x, axis=1)], axis=1)
        idx, hi, lo = _tw_indices(prep["lead"], n, self.window)
        ssum = jnp.take_along_axis(cs, hi, axis=1) - jnp.take_along_axis(
            cs, lo, axis=1
        )
        dc = ssum / _tw_count(prep["abs_c"], n, self.window)
        y = jnp.take_along_axis(x, idx, axis=1) - dc
        return self._mask_valid(y, prep, n)


class Agc(_Trailing):
    """Automatic gain control (an addition).  Normalizes the
    trailing-window RMS to ``target``:

        rms[m] = sqrt(mean(|x[k]|^2, k in (m-W, m]))
        y[m]   = x[m] * target / max(rms[m], target / max_gain)

    Instant attack (the current sample is inside its own window, so a
    strong burst cannot overshoot by more than its first-sample share)
    and ``window``-shaped decay; ``max_gain`` stops silence from being
    amplified into noise.  Gain is a pure function of the trailing
    input window, so random access and pull-size invariance hold like
    every other stage (values to ~1e-6: f32 prefix sums)."""

    def __init__(
        self,
        inner: Stream,
        target: float = 1.0,
        window: int = 4_000,  # matches the CLI default "4k" (decimal SI)
        max_gain: float = 1000.0,
    ):
        super().__init__(inner, window)
        if not target > 0:
            raise ValueError("target must be positive")
        if not max_gain > 0:
            raise ValueError("max-gain must be positive")
        self.target = float(target)
        self.max_gain = float(max_gain)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        x = self._inner_block(ctx, prep, n)
        p = jnp.real(x) ** 2 + jnp.imag(x) ** 2
        if self.window == 1:
            # direct per-sample magnitude: the cumsum difference would
            # carry prefix-relative cancellation noise (~1% at tiny
            # window sums), pointless when the window is one sample
            rms = jnp.sqrt(p)
            gain = self.target / jnp.maximum(rms, self.target / self.max_gain)
            return self._mask_valid(x * gain, prep, n)
        zero = jnp.zeros((p.shape[0], 1), dtype=p.dtype)
        cs = jnp.concatenate([zero, jnp.cumsum(p, axis=1)], axis=1)
        idx, hi, lo = _tw_indices(prep["lead"], n, self.window)
        psum = jnp.take_along_axis(cs, hi, axis=1) - jnp.take_along_axis(
            cs, lo, axis=1
        )
        mean = jnp.maximum(psum, 0.0) / _tw_count(prep["abs_c"], n, self.window)
        rms = jnp.sqrt(mean)
        gain = self.target / jnp.maximum(rms, self.target / self.max_gain)
        y = jnp.take_along_axis(x, idx, axis=1) * gain
        return self._mask_valid(y, prep, n)


class IqCorrect(Stream):
    """IQ-imbalance corrector (an addition).  Applies the
    standard widely-linear correction

        y[m] = x[m] - c * conj(x[m])

    which cancels an image produced by receiver gain/phase mismatch
    (model ``x = alpha*s + beta*conj(s)``; the image term vanishes for
    ``c = beta/conj(alpha)`` up to second order).  ``c`` is either
    given explicitly or blind-estimated once at construction from the
    capture's leading samples via the MEAN-CENTERED circularity ratio

        z = x - E[x],    rho = E[z^2] / E[|z|^2],    c = rho / 2

    (host f64 — exact and deterministic; centering keeps a DC offset —
    including the cu8/cs16 decode formulas' parked baseline — from
    reading as an image).  A proper complex signal has
    ``E[s^2] = 0``, so ``E[x^2] = 2*beta*E[|s|^2]`` measures the image
    directly; halving the ratio lands ``c = beta/(1+|beta|^2)``, which
    leaves a THIRD-order residual ``beta*|beta|^2/(1+|beta|^2)`` — the
    closed-form single-shot equivalent of the adaptive circularity-
    nulling compensator.  The applied
    correction is a fixed elementwise linear map: random-access
    coherent, pull-size invariant, length/rate preserving."""

    def __init__(
        self,
        inner: Stream,
        c: complex | None = None,
        est_samples: int = 256_000,  # matches the CLI's '-est 256k'
    ):
        self.inner = inner
        self.length = inner.length
        self.sample_rate = inner.sample_rate
        if c is None:
            n = int(min(est_samples, inner.length))
            if n < 2:
                raise ValueError("capture too short to estimate IQ imbalance")
            x, valid = inner.read_at(0, n)
            x = np.asarray(x[:valid], dtype=np.complex128)
            # moments about the MEAN: a DC offset — a tuner's center
            # spike, or the cu8/cs16 decode formulas parking the whole
            # capture near -127 / -32767.5 — is not an IQ image and
            # must not bias (or, for the integer formats, saturate)
            # the estimate
            x = x - x.mean()
            denom = float(np.sum(np.abs(x) ** 2))
            if denom == 0.0:
                raise ValueError(
                    "constant capture: cannot estimate IQ imbalance"
                )
            rho = complex(np.sum(x * x) / denom)
            if abs(rho) > 0.9:
                raise ValueError(
                    f"circularity ratio |E[x^2]|/E[|x|^2] = {abs(rho):.3f}: "
                    "the signal is nearly non-circular (e.g. pure real/AM "
                    "at DC), so blind estimation would cancel the signal "
                    "itself — pass an explicit coefficient instead"
                )
            c = rho / 2.0
        self.c = complex(c)

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(off, n)

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        inner = self.inner.plan(offs, n, base)
        return Plan(prep={"inner": inner.prep}, valid=inner.valid)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        x = self.inner.read_batch(ctx, prep["inner"], n)
        c = jnp.complex64(self.c)
        return x - c * jnp.conj(x)


class Resample(Stream):
    """Rational sample-rate converter (an addition; the
    reference only decimates, ``src/filter.rs``).

    Converts by ``up/down`` (reduced internally): zero-stuff by L,
    Blackman-sinc anti-alias/anti-image FIR at the upsampled rate
    (cutoff ``min(1/(2L), 1/(2M))``, amplitude-preserving ``*L`` gain),
    take every M-th output with the house group-delay pick — see
    :mod:`quadrs_tpu.ops.resample` for the exact formula and the
    one-matmul-per-block device shape.  ``Resample(s, 1, M, size=N)``
    computes the same sums as ``LowPass(s, sr/(2M), M, N)`` — same
    taps, same indexing — differing only in f32 accumulation order
    (measured ≤1e-6 rel; the LowPass path routes through
    :func:`~quadrs_tpu.ops.fir.fir_decimate`'s impl selection, this
    one is a per-phase weight matmul).

    Unlike LowPass's reference-mandated over-report, ``length`` is the
    exact readable output count, so ``write`` on a resampled chain ends
    cleanly instead of with the reference's short-read panic.
    """

    def __init__(
        self,
        inner: Stream,
        up: int,
        down: int,
        *,
        size: int | None = None,
        power: int = 8,
    ):
        from quadrs_tpu.ops.resample import resample_tables

        if up <= 0 or down <= 0:
            raise ValueError("up/down must be positive")
        g = math.gcd(int(up), int(down))
        self.up = int(up) // g
        self.down = int(down) // g
        out_rate_num = inner.sample_rate * self.up
        if out_rate_num % self.down:
            raise ValueError(
                f"resample {self.up}/{self.down} of {inner.sample_rate} Hz "
                "gives a non-integer sample rate"
            )
        self.inner = inner
        self.sample_rate = out_rate_num // self.down
        self.size = (
            int(size) if size is not None else 2 * int(power) * max(self.up, self.down)
        )
        if self.size < 2:
            raise ValueError("filter size must be at least 2")
        if inner.length * self.up < self.size:
            raise ValueError("input shorter than the resampling filter")
        _, self._gamma_min, self._frame_len, self._d = resample_tables(
            self.size, self.up, self.down
        )
        # exact readable length: output j*L + r needs window-relative
        # input through j*M + d[0, r]; the shortest phase's first
        # unreadable index is the valid-prefix count (window at off 0)
        avail = inner.length - self._gamma_min
        jmax = (avail - 1 - self._d[0]) // self.down
        self.length = max(0, int(np.min((jmax + 1) * self.up + np.arange(self.up))))

    def _n_in(self, n: int) -> int:
        nb = -(-n // self.up)
        return (nb - 1) * self.down + self._frame_len

    def span(self, off: int, n: int) -> tuple[int, int]:
        return self.inner.span(
            (off // self.up) * self.down + self._gamma_min, self._n_in(n)
        )

    def plan(self, offs: np.ndarray, n: int, base: int) -> Plan:
        offs = np.asarray(offs, dtype=np.int64)
        w = offs % self.up
        inner_offs = (offs // self.up) * self.down + self._gamma_min
        inner = self.inner.plan(inner_offs, self._n_in(n), base)
        valid_in = inner.valid.astype(np.int64)
        jmax = (valid_in[:, None] - 1 - self._d[w]) // self.down
        first_bad = np.min((jmax + 1) * self.up + np.arange(self.up), axis=1)
        valid_out = np.clip(first_bad, 0, n)
        prep = {
            "inner": inner.prep,
            "w_sel": w.astype(np.int32),
            "valid_in": valid_in.astype(np.int32),
        }
        return Plan(prep=prep, valid=valid_out)

    def read_batch(self, ctx: dict, prep: Any, n: int) -> jnp.ndarray:
        from quadrs_tpu.ops.resample import resample_block

        n_in = self._n_in(n)
        x = self.inner.read_batch(ctx, prep["inner"], n_in)
        mask = jnp.arange(n_in, dtype=jnp.int32)[None, :] < prep["valid_in"][:, None]
        x = jnp.where(mask, x, 0)
        return resample_block(x, prep["w_sel"], self.size, self.up, self.down, n)
