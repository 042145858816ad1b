"""Matched-filter cross-correlation: find a known pattern in a stream.

Addition (no reference counterpart — quadrs has only the
energy-threshold sparkfft/bucket detectors): locates every occurrence of
a known complex pattern (a preamble, a sync word, a chirp) in a capture
by NORMALIZED cross-correlation, computed on device in the frequency
domain.

The score at offset ``n`` is the Cauchy-Schwarz ratio

    score[n] = |sum_m conj(p[m]) x[n+m]|^2 / (E_p * E_x[n])

with ``E_p = sum |p|^2`` and ``E_x[n] = sum_m |x[n+m]|^2`` — in [0, 1],
and 1 exactly when the window is a complex-scalar multiple of the
pattern, so the threshold is GAIN- and PHASE-INVARIANT.  ``scale[n] =
|corr[n]| / E_p`` recovers the match's amplitude relative to the
pattern.

Mapping to the hardware: the correlation runs as overlap-save FFT
convolution — the executor's window length ``c`` (a power of two) IS
the FFT block, each window yielding ``c - l + 1`` valid scores, so one
batched ``FFT -> pointwise multiply -> IFFT`` per chunk does all the
work, plus a cumulative-sum moving window for the energy term.  The
transforms ride the house matmul DFT splits by default (see
:func:`make_xcorr_post`'s ``fft_impl``).  The pattern's spectrum is
precomputed on the host in f64 (like every NCO table in this package)
and enters the program as f32 planes.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def make_xcorr_post(
    pattern,
    c: int,
    freqs: np.ndarray | None = None,
    fft_impl: str = "auto",
    extract: tuple[float, int] | None = None,
) -> Callable:
    """Executor ``post`` for pattern search.

    ``pattern``: one complex l-sample template (l >= 2, l <= c), or a
    sequence of P templates (a sync-word BANK — lengths may differ; the
    common lag range uses the longest).  Returns a traced transform of
    a ``(B, c)`` complex window batch into ``(score, scale, ridx)`` —
    ``(B, c - l_max + 1)`` f32/f32/int32, where ``ridx`` encodes the
    winning row as ``pattern_index * F + freq_index``.

    ``fft_impl``: the transform engine for the length-``c`` blocks —
    ``"xla"`` (XLA's FFT), ``"four_step"`` (the house two-factor
    matmul DFT, forward and inverse on f32 planes), or
    ``"three_step"`` (the three-factor split — ``a+b1+b2`` MACs per
    sample instead of ``a+b``; at c=65536 that is 128 vs 1088).
    ``"auto"`` (the default) routes through
    :func:`~quadrs_tpu.ops.stft.mxu_fft_choice` — cheapest split by
    effective MACs with the 128-lane floor, else XLA;
    ``bench_find`` carries the standing A/B of the three engines.

    ``freqs``: optional carrier-offset search grid in CYCLES PER SAMPLE
    (F values; 0.0 is the plain search).  Every template is premixed by
    each grid frequency on the host, giving P*F matched filters per
    window — one extra batched device axis — and each lag's outputs
    come from the row with the best NORMALIZED score (per-row E_p and
    energy window, so differently-scaled and differently-sized
    templates compete fairly).  A received pattern rotated by
    ``e^{j 2 pi f m}`` correlates fully against its ``f`` row (the
    plain row would lose ``|sinc(f*l)|``), so this is how a preamble is
    found under carrier offset.

    ``extract``: optional ``(threshold, k)`` — move the local-maximum
    candidate scan ON DEVICE so the host touches only real candidates
    instead of 12 bytes/lag of score planes (the full-score transfer
    would otherwise bound the product).  The returned
    callable then takes ``(x, left)`` — ``left`` the f32 score
    immediately LEFT of this dispatch's first lag (``-inf`` on the
    first) — flattens the batch to one contiguous M=B*(c-l+1) lag row
    (window offsets must abut by c-l+1, as ``find_pattern``'s grid
    does), marks positions ``0..M-2`` that are ``>= threshold`` and
    ``>=`` both neighbors (identical comparisons to :class:`PeakScan`),
    and returns the tuple

        (vals, idx, scl, rid, count, s_first, s_m2, s_last,
         scale_last, ridx_last)

    — top-``k`` candidate scores with their flat positions and gathered
    aux (entries with ``vals < threshold`` are padding), the true
    candidate count (host falls back to the full-score path when it
    exceeds ``k``), and the boundary scalars that carry PeakScan's
    exact pending-element semantics across dispatches: position M-1
    cannot be decided until its right neighbor arrives, so the host
    holds ``(s_last, scale_last, ridx_last)`` pending with
    ``s_m2`` as its left neighbor and decides it against the next
    dispatch's ``s_first``.
    """
    import jax
    import jax.numpy as jnp

    if isinstance(pattern, (list, tuple)):
        pats = [np.asarray(p, dtype=np.complex128) for p in pattern]
    else:
        arr = np.asarray(pattern, dtype=np.complex128)
        pats = [arr] if arr.ndim == 1 else list(arr)  # (P, l) also accepted
    lens = [len(p) for p in pats]
    for l_k in lens:
        if l_k < 2:
            raise ValueError("pattern must have at least 2 samples")
        if l_k > c:
            raise ValueError(f"pattern ({l_k}) longer than the window ({c})")
    l_max = max(lens)
    n_out = c - l_max + 1

    # host-exact spectra of the (premixed) conjugate templates, shipped
    # as f32 planes; row r = pattern (r // F) premixed by grid frequency (r % F)
    grid = np.zeros(1) if freqs is None else np.asarray(freqs, dtype=np.float64)
    n_f = len(grid)
    rows = []
    row_inv_ep = []
    row_len = []
    for p in pats:
        e_p = float(np.sum(np.abs(p) ** 2))
        if e_p <= 0.0:
            raise ValueError("pattern is all zero")
        m = np.arange(len(p), dtype=np.float64)
        for f in grid:
            rows.append(
                np.conj(np.fft.fft(p * np.exp(2j * np.pi * ((f * m) % 1.0)), c))
            )
            row_inv_ep.append(1.0 / e_p)
            row_len.append(len(p))
    pf = np.stack(rows)  # (R, c)
    pf_planes = np.stack([pf.real, pf.imag]).astype(np.float32)
    inv_ep_r = np.asarray(row_inv_ep, dtype=np.float32)
    inv_ep2_r = (inv_ep_r.astype(np.float64) ** 2).astype(np.float32)
    single = len(rows) == 1
    tiny = np.float32(1e-30)

    if fft_impl == "auto":
        from quadrs_tpu.ops.stft import mxu_fft_choice

        choice = mxu_fft_choice(c)
        fft_impl = "xla" if choice is None else choice[0]

    if fft_impl == "four_step":
        from quadrs_tpu.ops.stft import _require_four_step, four_step_fft_planes

        a_fac = _require_four_step(c)

        def fwd(x):
            yr, yi = four_step_fft_planes(jnp.real(x), jnp.imag(x), a_fac)
            return jax.lax.complex(yr, yi)

        def inv(x):
            yr, yi = four_step_fft_planes(
                jnp.real(x), jnp.imag(x), a_fac, inverse=True
            )
            return jax.lax.complex(yr, yi)

    elif fft_impl == "three_step":
        from quadrs_tpu.ops.stft import _require_three_step, three_step_fft_planes

        a3, b13 = _require_three_step(c)

        def fwd(x):
            yr, yi = three_step_fft_planes(jnp.real(x), jnp.imag(x), a3, b13)
            return jax.lax.complex(yr, yi)

        def inv(x):
            yr, yi = three_step_fft_planes(
                jnp.real(x), jnp.imag(x), a3, b13, inverse=True
            )
            return jax.lax.complex(yr, yi)

    elif fft_impl == "xla":
        fwd = lambda x: jnp.fft.fft(x, axis=-1)
        inv = lambda x: jnp.fft.ifft(x, axis=-1)
    else:
        raise ValueError(
            f"unknown fft impl: {fft_impl!r} (xla|four_step|three_step)"
        )

    def moving_energy(cs, l_k: int):
        # sum of |x|^2 over [n, n+l_k) for n in [0, n_out)
        return cs[:, l_k - 1 : l_k - 1 + n_out] - jnp.concatenate(
            [jnp.zeros((cs.shape[0], 1), cs.dtype), cs[:, : n_out - 1]], axis=-1
        )

    def prefix_sums(mag2):
        # Inclusive prefix sums over the window as two matmuls —
        # lane prefix as a (128, 128) triangular-ones matmul, coarse
        # prefix as a (c/128, c/128) one — in place of a length-c
        # sequential scan, with the same f32 error vs f64 as
        # jnp.cumsum (whether it still beats cumsum on a GPU is
        # unmeasured).  Falls back to cumsum when c isn't lane-aligned
        # or the coarse triangle would be a >16 MB constant.
        q = c // 128
        if c % 128 or q > 2048:
            return jnp.cumsum(mag2, axis=-1)
        hi = jax.lax.Precision.HIGHEST
        r3 = mag2.reshape(mag2.shape[0], q, 128)
        u = jnp.triu(jnp.ones((128, 128), jnp.float32))  # i <= j
        lane_ps = jax.lax.dot_general(
            r3, u, (((2,), (0,)), ((), ())), precision=hi
        )  # (B, q, 128) inclusive within each lane block
        u2 = jnp.triu(jnp.ones((q, q), jnp.float32), k=1)  # strict p < q
        coarse = jax.lax.dot_general(
            lane_ps[:, :, 127], u2, (((1,), (0,)), ((), ())), precision=hi
        )  # (B, q) exclusive across blocks
        return (coarse[:, :, None] + lane_ps).reshape(mag2.shape[0], c)

    def compute(x: jnp.ndarray):
        planes = jnp.asarray(pf_planes)
        pfc = jax.lax.complex(planes[0], planes[1])  # (R, c)
        xf = fwd(x)  # (B, c)
        mag2 = jnp.real(x) ** 2 + jnp.imag(x) ** 2
        cs = prefix_sums(mag2)
        # score = num / (e_p * e_x); normalizing by e_p^2 instead maps
        # zero-energy windows to score 0 without a divide-by-zero

        if single:
            corr = inv(xf * pfc[0][None, :])[:, :n_out]
            num = jnp.real(corr) ** 2 + jnp.imag(corr) ** 2
            den = jnp.maximum(moving_energy(cs, row_len[0]) * inv_ep_r[0], tiny)
            score = num * inv_ep2_r[0] / den
            scale = jnp.sqrt(num) * inv_ep_r[0]
            ridx = jnp.zeros(score.shape, jnp.int32)
            return score.astype(jnp.float32), scale.astype(jnp.float32), ridx

        # Row-sequential running max, scanned over rows, instead of one
        # (B, R, c) inverse transform followed by argmax over R and
        # take_along_axis: the middle-axis gathers of that epilogue
        # cost more than the R inverse DFTs.  One inverse per row with
        # where-selects keeps the epilogue elementwise; strict ``>`` in
        # ascending row order reproduces argmax's first-max tie break
        # exactly.  lax.scan keeps compile time flat in R (the grid is
        # capped at 256 rows upstream).  Moving energy is computed
        # once per UNIQUE template length, not once per row (a grid
        # of F frequencies would otherwise stack F identical arrays).
        lens = sorted(set(row_len))
        me_stack = jnp.stack([moving_energy(cs, l_k) for l_k in lens])
        den_idx = np.asarray(
            [lens.index(l_k) for l_k in row_len], dtype=np.int32
        )
        z = jnp.zeros((xf.shape[0], n_out), jnp.float32)
        init = (z - jnp.float32(1.0), z, jnp.zeros(z.shape, jnp.int32))

        def body(carry, xs):
            score, sc2, ridx = carry
            pr, pi, di, r, iep, iep2 = xs
            corr = inv(xf * jax.lax.complex(pr, pi)[None, :])[:, :n_out]
            num = jnp.real(corr) ** 2 + jnp.imag(corr) ** 2
            den = jnp.maximum(jnp.take(me_stack, di, axis=0) * iep, tiny)
            s_r = num * iep2 / den
            better = s_r > score
            # sc2 = (scale)^2: scale = sqrt(num) * inv_ep_r[best]
            return (
                jnp.where(better, s_r, score),
                jnp.where(better, num * iep2, sc2),
                jnp.where(better, r, ridx),
            ), None

        (score, sc2, ridx), _ = jax.lax.scan(
            body,
            init,
            (
                planes[0],
                planes[1],
                jnp.asarray(den_idx),
                jnp.arange(len(rows), dtype=jnp.int32),
                jnp.asarray(inv_ep_r),
                jnp.asarray(inv_ep2_r),
            ),
        )
        scale = jnp.sqrt(sc2)
        return (
            score.astype(jnp.float32),
            scale.astype(jnp.float32),
            ridx.astype(jnp.int32),
        )

    if extract is None:
        return compute

    thr = jnp.float32(extract[0])
    k = int(extract[1])

    def post_extract(x: jnp.ndarray, left: jnp.ndarray):
        score, scale, ridx = compute(x)
        s = score.reshape(-1)  # (M,) contiguous lags across the batch
        m = s.shape[0]
        # positions 0..M-2 have both neighbors in hand (position 0's
        # left is the carried ``left``); M-1 stays pending on the host
        v = s[:-1]
        lefts = jnp.concatenate([left.reshape(1).astype(s.dtype), s[:-2]])
        mask = (v >= thr) & (v >= lefts) & (v >= s[1:])
        count = jnp.sum(mask.astype(jnp.int32))
        # non-candidates sink to -1 < any threshold in (0, 1], so a
        # top-k over the masked row yields exactly the candidates.  A
        # flat lax.top_k(k=1024) over the fat dispatch's ~4.2M lags is
        # a full sort and out-costs the whole FFT correlation.
        # Candidates are SPARSE (local maxima
        # over threshold), so extraction goes hierarchical: per-block
        # max/argmax + per-block candidate counts (one cheap pass),
        # then top-k over the ~8k block maxima.  A block's masked max
        # is its only candidate or -1, so this is EXACT whenever no
        # block holds two candidates; a lax.cond falls back to the
        # flat sort for the (rare, clustered-hits) dispatch where one
        # does.  Padding rows keep vals=-1 < any threshold in (0, 1].
        kk = min(k, m - 1)
        w = jnp.where(mask, v, jnp.float32(-1.0))
        g = 512
        while g > 8 and (m - 1 + g - 1) // g < kk:
            g //= 2  # small dispatches: shrink blocks so nb >= kk
        nb = (m - 1 + g - 1) // g
        if nb >= kk and nb < m - 1:
            pad = nb * g - (m - 1)
            wb = jnp.concatenate(
                [w, jnp.full((pad,), -1.0, jnp.float32)]
            ).reshape(nb, g)
            bmax = jnp.max(wb, axis=-1)
            barg = jnp.argmax(wb, axis=-1).astype(jnp.int32)
            per_block = jnp.sum(
                jnp.concatenate(
                    [mask, jnp.zeros((pad,), bool)]
                ).reshape(nb, g),
                axis=-1,
                dtype=jnp.int32,
            )

            def hier(w):
                bv, bi = jax.lax.top_k(bmax, kk)
                return bv, (bi * g + jnp.take(barg, bi)).astype(jnp.int32)

            def full(w):
                fv, fi = jax.lax.top_k(w, kk)
                return fv, fi.astype(jnp.int32)

            vals, idx = jax.lax.cond(jnp.any(per_block > 1), full, hier, w)
        else:
            vals, idx = jax.lax.top_k(w, kk)
        scl = jnp.take(scale.reshape(-1), idx)
        rid = jnp.take(ridx.reshape(-1), idx)
        return (
            vals,
            idx.astype(jnp.int32),
            scl,
            rid,
            count,
            s[0],
            s[m - 2],
            s[m - 1],
            scale.reshape(-1)[m - 1],
            ridx.reshape(-1)[m - 1],
        )

    return post_extract


class PeakScan:
    """Streaming local-maximum scanner over a score sequence.

    ``feed`` consumes contiguous score/aux chunks (offsets must abut);
    a point is a hit when ``score >= threshold`` and it is >= both
    neighbors.  Exact across chunk boundaries: the last element of every
    feed is held back until its right neighbor arrives (``finish``
    flushes it against -inf).  Vectorized — no per-sample Python.
    """

    def __init__(self, threshold: float):
        self.threshold = float(threshold)
        self._left = -np.inf  # score left of the pending element
        # pending (offset, score, aux-row) awaiting its right neighbor
        self._pend: tuple[int, float, np.ndarray] | None = None
        self.offsets: list[int] = []
        self.scores: list[float] = []
        self.aux: list[np.ndarray] = []  # one row per hit (A columns)

    def feed(self, off0: int, scores: np.ndarray, aux: np.ndarray) -> None:
        scores = np.asarray(scores, dtype=np.float64)
        aux = np.asarray(aux, dtype=np.float64)
        if aux.ndim == 1:
            aux = aux[:, None]
        if len(scores) == 0:
            return
        if self._pend is not None:
            po, pv, pa = self._pend
            if off0 != po + 1:
                raise ValueError(f"non-contiguous feed: {off0} after {po}")
            ext = np.concatenate([[pv], scores])
            ext_aux = np.concatenate([pa[None, :], aux])
            ext_off0 = po
        else:
            ext, ext_aux, ext_off0 = scores, aux, off0
        if len(ext) >= 2:
            v = ext[:-1]
            lefts = np.concatenate([[self._left], ext[:-2]])
            rights = ext[1:]
            mask = (v >= self.threshold) & (v >= lefts) & (v >= rights)
            idx = np.nonzero(mask)[0]
            self.offsets.extend((ext_off0 + idx).tolist())
            self.scores.extend(v[idx].tolist())
            self.aux.extend(ext_aux[idx])
            self._left = float(ext[-2])
        self._pend = (ext_off0 + len(ext) - 1, float(ext[-1]), ext_aux[-1])

    @property
    def carry(self) -> float:
        """Score immediately left of the next feed's first element —
        the ``left`` input of a device-extracted dispatch."""
        return self._pend[1] if self._pend is not None else -np.inf

    def feed_extract(self, off0: int, m: int, res: tuple) -> bool:
        """Consume one device-extracted dispatch covering lags
        ``[off0, off0+m)`` (``res`` is the tuple a
        :func:`make_xcorr_post(extract=...)` program returns).  The
        dispatch decided positions ``0..m-2`` itself (its ``left``
        input must have been :attr:`carry`); this method decides the
        held-back pending element against the dispatch's first score
        and holds position ``m-1`` pending — byte-identical candidate
        streams to feeding the full score rows through :meth:`feed`.
        Returns False when the candidate count overflowed the program's
        top-k width (caller re-runs that dispatch full-score)."""
        (vals, idx, scl, rid, count, s_first, s_m2, s_last,
         scale_last, ridx_last) = res
        n = int(count)
        if n > len(np.asarray(vals)):
            return False
        if self._pend is not None:
            po, pv, pa = self._pend
            if off0 != po + 1:
                raise ValueError(f"non-contiguous feed: {off0} after {po}")
            if (
                pv >= self.threshold
                and pv >= self._left
                and pv >= float(s_first)
            ):
                self.offsets.append(po)
                self.scores.append(pv)
                self.aux.append(pa)
        if n:
            # all n real candidates sort ahead of the -1 padding, so
            # the first n rows ARE the hits; re-order by lag position
            idx = np.asarray(idx[:n], dtype=np.int64)
            order = np.argsort(idx, kind="stable")
            self.offsets.extend((off0 + idx[order]).tolist())
            self.scores.extend(
                np.asarray(vals[:n], dtype=np.float64)[order].tolist()
            )
            self.aux.extend(
                np.stack(
                    [
                        np.asarray(scl[:n], dtype=np.float64)[order],
                        np.asarray(rid[:n], dtype=np.float64)[order],
                    ],
                    axis=-1,
                )
            )
        self._left = float(s_m2)
        self._pend = (
            off0 + m - 1,
            float(s_last),
            np.array([float(scale_last), float(ridx_last)]),
        )
        return True

    def finish(self) -> None:
        if self._pend is not None:
            po, pv, pa = self._pend
            if pv >= self.threshold and pv >= self._left:
                self.offsets.append(po)
                self.scores.append(pv)
                self.aux.append(pa)
            self._pend = None


def suppress(
    offsets: np.ndarray,
    scores: np.ndarray,
    min_distance: int,
    max_matches: int | None = None,
) -> np.ndarray:
    """Greedy non-maximum suppression: keep candidates best-first,
    dropping any within ``min_distance`` of an accepted one.  Returns
    the accepted indices sorted by offset."""
    import bisect

    order = np.argsort(-scores, kind="stable")
    taken: list[int] = []  # accepted offsets, sorted
    chosen: list[int] = []
    for i in order:
        if max_matches is not None and len(chosen) >= max_matches:
            break  # checked first so max_matches=0 means zero matches
        o = int(offsets[i])
        j = bisect.bisect_left(taken, o)
        if j > 0 and o - taken[j - 1] < min_distance:
            continue
        if j < len(taken) and taken[j] - o < min_distance:
            continue
        taken.insert(j, o)
        chosen.append(int(i))
    chosen.sort(key=lambda i: int(offsets[i]))
    return np.asarray(chosen, dtype=np.int64)
