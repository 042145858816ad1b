"""Short-time FFT kernels: batched DFT, fftshift, window functions.

The reference runs rustfft's forward transform (standard unnormalized
DFT, negative exponent) per strided window (``src/fft.rs:25-32``,
``src/ffts.rs:25``) and displays fftshifted magnitudes
(``src/fft.rs:48-52``).

FFTs over large batches route by width (:func:`_auto_impl`): widths to
256 run as one dense DFT matmul (``(B, W) @ (W, W)``); from 512 up a
four-step two-factor split (:func:`four_step_fft_planes` — two skinny
matmuls + a twiddle, ``a+b`` MACs per sample instead of ``W``);
unfactorable (prime-ish) widths fall back to XLA's native FFT.  The
crossovers are not yet re-measured against cuFFT on a GPU.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

TAU = 2.0 * math.pi

# Widths up to this run as a dense DFT matmul; the four-step split
# takes over from 512.
_DFT_MATMUL_MAX_WIDTH = 256
# Largest single matmul factor inside a four-step split.
_FOUR_STEP_MAX_FACTOR = 1024


@functools.lru_cache(maxsize=32)
def _dft_matrix_np(width: int) -> np.ndarray:
    k = np.arange(width, dtype=np.float64)
    w = np.exp(-2j * np.pi * np.outer(k, k) / width)
    return w.astype(np.complex64)


def dft_matrix(width: int) -> np.ndarray:
    """The ``W x W`` forward DFT matrix (complex64, computed in f64)."""
    return _dft_matrix_np(width)


def _auto_impl(width: int) -> str:
    """Dense DFT matmul to 256; from 512 the cheaper house split by
    :func:`mxu_fft_choice`'s 128-lane-floor effective cost (four_step
    512-8192, three_step from 16384); XLA FFT when the width won't
    split (primes and widths with huge factors)."""
    if width <= _DFT_MATMUL_MAX_WIDTH:
        return "matmul"
    choice = mxu_fft_choice(width)
    return "xla" if choice is None else choice[0]


def batched_fft(x: jnp.ndarray, *, impl: str = "auto") -> jnp.ndarray:
    """Forward DFT along the last axis of a complex64 batch."""
    width = x.shape[-1]
    if impl == "auto":
        impl = _auto_impl(width)

    if impl == "xla":
        return jnp.fft.fft(x).astype(jnp.complex64)

    if impl == "four_step":
        yr, yi = four_step_fft_planes(x.real, x.imag, _require_four_step(width))
        return jax.lax.complex(yr, yi)

    if impl == "three_step":
        a, b1 = _require_three_step(width)
        yr, yi = three_step_fft_planes(x.real, x.imag, a, b1)
        return jax.lax.complex(yr, yi)

    if impl == "matmul":
        f = _dft_matrix_np(width)
        fr = jnp.asarray(f.real)
        fi = jnp.asarray(f.imag)
        xr, xi = x.real, x.imag
        p = jax.lax.Precision.HIGHEST
        # X = x @ F^T, F symmetric so F^T == F.
        re = jnp.matmul(xr, fr, precision=p) - jnp.matmul(xi, fi, precision=p)
        im = jnp.matmul(xr, fi, precision=p) + jnp.matmul(xi, fr, precision=p)
        return (re + 1j * im).astype(jnp.complex64)

    raise ValueError(f"unknown fft impl: {impl}")


@functools.lru_cache(maxsize=64)
def _four_step_tables(width: int, a: int, inverse: bool):
    """f32 plane tables for the four-step DFT: F_a, the (b, a) twiddle
    W_N^{qr}, and F_b — all rounded from f64."""
    b = width // a
    sign = 2j if inverse else -2j
    fa = np.exp(sign * np.pi * np.outer(np.arange(a), np.arange(a)) / a)
    fb = np.exp(sign * np.pi * np.outer(np.arange(b), np.arange(b)) / b)
    tw = np.exp(sign * np.pi * np.outer(np.arange(b), np.arange(a)) / width)
    to32 = lambda m: (m.real.astype(np.float32), m.imag.astype(np.float32))
    return to32(fa), to32(tw), to32(fb)


def _four_step_factor(width: int) -> int | None:
    """Pick ``a`` for a two-factor split ``width = a*b`` (None if no
    split has both factors in range): a ≈ 16 through width 2048, a ≈ 32
    beyond — small first factors keep the twiddle-stage tiles skinny
    while the second matmul carries the contraction."""
    target = 16 if width <= 2048 else 32
    best = None
    for a in range(4, min(width, _FOUR_STEP_MAX_FACTOR) + 1):
        if width % a or not (4 <= width // a <= _FOUR_STEP_MAX_FACTOR):
            continue
        if best is None or abs(math.log2(a / target)) < abs(math.log2(best / target)):
            best = a
    return best


def _require_four_step(width: int) -> int:
    a = _four_step_factor(width)
    if a is None:
        raise ValueError(f"width {width} has no four-step split")
    return a


def four_step_fft_planes(
    xr: jnp.ndarray, xi: jnp.ndarray, a: int, *, inverse: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Cooley-Tukey two-factor DFT as matmuls, on f32 planes.

    For ``N = a*b``, splitting input index ``n = b*p + q`` and output
    index ``k = r + a*s`` gives

        X[r + a*s] = sum_q W_N^{qr} W_b^{qs} (sum_p x[b*p + q] W_a^{pr})

    i.e. a width-``a`` DFT, an elementwise twiddle, and a width-``b``
    DFT: ``a + b`` MACs per sample instead of the dense matrix's ``N``
    (~10x less work at N=1024), while staying entirely on matmuls.
    Operates on real/imag planes and returns planes.  The einsum forms
    put the output indices in an order that makes the final reshape
    free.
    """
    width = xr.shape[-1]
    b = width // a
    assert a * b == width, (width, a)
    (far, fai), (twr, twi), (fbr, fbi) = _four_step_tables(width, a, inverse)
    p = jax.lax.Precision.HIGHEST
    batch = xr.shape[:-1]
    xr = xr.reshape(*batch, a, b)
    xi = xi.reshape(*batch, a, b)

    e = functools.partial(jnp.einsum, "...pq,pr->...qr", precision=p)
    zr = e(xr, jnp.asarray(far)) - e(xi, jnp.asarray(fai))
    zi = e(xr, jnp.asarray(fai)) + e(xi, jnp.asarray(far))

    tr, ti = jnp.asarray(twr), jnp.asarray(twi)
    zr, zi = zr * tr - zi * ti, zr * ti + zi * tr

    e2 = functools.partial(jnp.einsum, "...qr,qs->...sr", precision=p)
    yr = e2(zr, jnp.asarray(fbr)) - e2(zi, jnp.asarray(fbi))
    yi = e2(zr, jnp.asarray(fbi)) + e2(zi, jnp.asarray(fbr))
    # [s, r] flattens to k = s*a + r = r + a*s: no output transpose
    yr = yr.reshape(*batch, width)
    yi = yi.reshape(*batch, width)
    if inverse:
        scale = np.float32(1.0 / width)
        yr, yi = yr * scale, yi * scale
    return yr, yi


@functools.lru_cache(maxsize=32)
def _three_step_tables(width: int, a: int, b1: int, inverse: bool):
    """f32 plane tables for the three-factor split ``width = a*b1*b2``:
    F_a, the (b1, b2, a) outer twiddle W_N^{q r}, F_b1, the (b2, b1)
    inner twiddle W_b^{q2 s1}, and F_b2 — all rounded from f64."""
    b = width // a
    b2 = b // b1
    sign = 2j if inverse else -2j
    dft = lambda m: np.exp(sign * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    q = (np.arange(b1)[:, None] * b2 + np.arange(b2)[None, :]).reshape(b1, b2, 1)
    tw1 = np.exp(sign * np.pi * q * np.arange(a)[None, None, :] / width)
    tw2 = np.exp(sign * np.pi * np.outer(np.arange(b2), np.arange(b1)) / b)
    to32 = lambda m: (m.real.astype(np.float32), m.imag.astype(np.float32))
    return to32(dft(a)), to32(tw1), to32(dft(b1)), to32(tw2), to32(dft(b2))


def _three_step_factors(width: int) -> tuple[int, int] | None:
    """Pick ``(a, b1)`` for a three-factor split ``width = a*b1*b2``
    minimizing total matmul work (``a + b1 + b2`` MACs per sample);
    tie-break toward a larger ``a`` (the output lane axis).  None when
    no split has all three factors in [4, 1024]."""
    best = None
    for a in range(4, min(width // 16, 1024) + 1):
        if width % a:
            continue
        b = width // a
        for b1 in range(4, min(b // 4, 1024) + 1):
            if b % b1:
                continue
            b2 = b // b1
            if b2 > 1024:
                continue
            key = (a + b1 + b2, -a)
            if best is None or key < best[0]:
                best = (key, (a, b1))
    return None if best is None else best[1]


def _require_three_step(width: int) -> tuple[int, int]:
    fac = _three_step_factors(width)
    if fac is None:
        raise ValueError(f"width {width} has no three-step split")
    return fac


def three_step_fft_planes(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    a: int,
    b1: int,
    *,
    inverse: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Cooley-Tukey three-factor DFT as matmuls, on f32 planes.

    Splitting ``N = a*b1*b2`` twice — ``n = b*p + b2*q1 + q2`` (so the
    input reshape to ``(a, b1, b2)`` is free) and ``k = r + a*s1 +
    a*b1*s2`` — gives three skinny DFT matmuls with two elementwise
    twiddles between them:

        X[k] = sum_q2 W_b^{q2 s1} W_b2^{q2 s2} [ sum_q1 F_b1[q1 s1]
                 ( W_N^{q r} sum_p x[p q1 q2] F_a[p r] ) ]

    i.e. ``a + b1 + b2`` MACs per sample instead of the two-factor
    split's ``a + b``: at N=65536 that is 128 vs 1088, at 4096 it is
    48 vs 160 — butterfly-class arithmetic at matmul throughput.  The
    einsum forms keep the output index axes ordered ``[s2, s1, r]`` so
    the final flatten (``k = (s2*b1 + s1)*a + r``) is free, exactly
    like :func:`four_step_fft_planes`."""
    width = xr.shape[-1]
    b2 = width // (a * b1)
    assert a * b1 * b2 == width, (width, a, b1)
    (far, fai), (t1r, t1i), (f1r, f1i), (t2r, t2i), (f2r, f2i) = _three_step_tables(
        width, a, b1, inverse
    )
    p = jax.lax.Precision.HIGHEST
    batch = xr.shape[:-1]
    xr = xr.reshape(*batch, a, b1, b2)
    xi = xi.reshape(*batch, a, b1, b2)

    def cmul(zr, zi, wr, wi):
        return zr * wr - zi * wi, zr * wi + zi * wr

    def cstage(zr, zi, fr, fi, spec):
        e = functools.partial(jnp.einsum, spec, precision=p)
        fr, fi = jnp.asarray(fr), jnp.asarray(fi)
        return e(zr, fr) - e(zi, fi), e(zr, fi) + e(zi, fr)

    # stage A: a-point DFT over p;  [p, q1, q2] -> [q1, q2, r]
    zr, zi = cstage(xr, xi, far, fai, "...pqt,pr->...qtr")
    zr, zi = cmul(zr, zi, jnp.asarray(t1r), jnp.asarray(t1i))
    # stage B: b1-point DFT over q1;  [q1, q2, r] -> [q2, s1, r]
    zr, zi = cstage(zr, zi, f1r, f1i, "...qtr,qs->...tsr")
    zr, zi = cmul(zr, zi, jnp.asarray(t2r)[..., None], jnp.asarray(t2i)[..., None])
    # stage C: b2-point DFT over q2;  [q2, s1, r] -> [s2, s1, r]
    yr, yi = cstage(zr, zi, f2r, f2i, "...tsr,tu->...usr")
    # [s2, s1, r] flattens to k = (s2*b1 + s1)*a + r = r + a*s1 + a*b1*s2
    yr = yr.reshape(*batch, width)
    yi = yi.reshape(*batch, width)
    if inverse:
        scale = np.float32(1.0 / width)
        yr, yi = yr * scale, yi * scale
    return yr, yi


def _eff_macs(*factors: int) -> int:
    """Effective MACs/sample of a factored DFT: each stage's
    ``(..., f) @ (f, f)`` matmul is costed as if it had at least 128
    output lanes, so a factor below 128 costs as much as 128 (384 vs 256
    at 4096 favours the two-factor split; 384 vs 1152 at 65536 the
    three-factor one).  The floor models a 128-wide matrix unit and is
    not yet re-derived for a GPU."""
    return sum(max(f, 128) for f in factors)


def mxu_fft_choice(width: int) -> tuple[str, object] | None:
    """The cheaper house matmul DFT split for this width by effective
    MACs/sample (:func:`_eff_macs`): ``("four_step", a)`` or
    ``("three_step", (a, b1))``; None when the width won't factor (the
    caller falls back to XLA's FFT).  Ties prefer the two-factor split
    (fewer stages)."""
    fac3 = _three_step_factors(width)
    a4 = _four_step_factor(width)
    c3 = None if fac3 is None else _eff_macs(*fac3, width // (fac3[0] * fac3[1]))
    c4 = None if a4 is None else _eff_macs(a4, width // a4)
    if c4 is not None and (c3 is None or c4 <= c3):
        return ("four_step", a4)
    if c3 is not None:
        return ("three_step", fac3)
    return None


def mxu_fft_planes(
    xr: jnp.ndarray, xi: jnp.ndarray, *, inverse: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray] | None:
    """Route f32 planes through :func:`mxu_fft_choice`'s split for this
    width, or None when it has none (the caller falls back to XLA's
    FFT)."""
    width = xr.shape[-1]
    choice = mxu_fft_choice(width)
    if choice is None:
        return None
    kind, fac = choice
    if kind == "three_step":
        return three_step_fft_planes(xr, xi, fac[0], fac[1], inverse=inverse)
    return four_step_fft_planes(xr, xi, fac, inverse=inverse)


def fftshift(x: jnp.ndarray) -> jnp.ndarray:
    """Swap halves along the last axis (``src/fft.rs:48-52`` semantics)."""
    half = x.shape[-1] // 2
    return jnp.concatenate([x[..., half:], x[..., :half]], axis=-1)


def stft_norms(
    x: jnp.ndarray,
    *,
    window: np.ndarray | None = None,
    shift: bool = True,
    impl: str = "auto",
) -> jnp.ndarray:
    """Magnitudes of the DFT of each row: the sparkfft/take_fft hot path.

    ``x``: (B, W) complex64 windows.  Returns (B, W) f32 norms,
    fftshifted unless ``shift=False``.

    The magnitude is ``sqrt(re² + im²)`` computed on real planes rather
    than ``jnp.abs`` of a materialized complex spectrum (XLA's complex
    abs lowers to the overflow-safe hypot).  The plain form matches hypot to 1 ulp for
    spectra below ~1e18, far above any real capture; the reference's
    ``Complex::norm`` is hypot, and the glyph-exactness suites pass
    either way.
    """
    if window is not None:
        x = x * jnp.asarray(np.asarray(window, dtype=np.float32))
    width = x.shape[-1]
    if impl == "auto":
        impl = _auto_impl(width)

    if impl == "matmul":
        f = _dft_matrix_np(width)
        fr = jnp.asarray(f.real)
        fi = jnp.asarray(f.imag)
        xr, xi = x.real, x.imag
        p = jax.lax.Precision.HIGHEST
        rr = jnp.matmul(xr, fr, precision=p) - jnp.matmul(xi, fi, precision=p)
        ri = jnp.matmul(xr, fi, precision=p) + jnp.matmul(xi, fr, precision=p)
    elif impl == "four_step":
        rr, ri = four_step_fft_planes(x.real, x.imag, _require_four_step(width))
    else:
        spec = jnp.fft.fft(x)
        rr, ri = jnp.real(spec), jnp.imag(spec)
    if shift:
        rr, ri = fftshift(rr), fftshift(ri)
    return jnp.sqrt(rr * rr + ri * ri).astype(jnp.float32)


def blackman_harris_window(n: int) -> np.ndarray:
    """4-term Blackman-Harris window, f32 (``src/ffts.rs:110-119``)."""
    i = np.arange(n, dtype=np.float32)
    x = np.float32(TAU) * i / np.float32(n - 1)
    return (
        np.float32(0.35875)
        - np.float32(0.48829) * np.cos(x)
        + np.float32(0.14128) * np.cos(np.float32(2.0) * x)
        - np.float32(0.01168) * np.cos(np.float32(3.0) * x)
    ).astype(np.float32)
