"""Batch executor: turns stream-graph pulls into jitted XLA programs.

One ``Executor`` owns one compiled program for a fixed window length
``n`` and batch width ``B``: the host stages the raw source span for a
batch of window offsets (zero-copy native-dtype views of the capture),
plans all offset math exactly, and the device computes every window in
one fused program.  Staged-buffer lengths are quantized to power-of-two
buckets so the number of distinct compilations stays logarithmic.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from quadrs_tpu.stream import Stream


def _round_up_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def window_batches(
    offsets: np.ndarray,
    width: int,
    budget: int = 1 << 20,
    span_cap: int = 1 << 26,
    root_step: int = 1,
) -> tuple[int, list[np.ndarray]]:
    """Split window offsets into executor-sized batches (one compiled
    program reused across them): ~``budget`` samples of output per batch,
    and no batch spanning more than ``span_cap`` ROOT-SOURCE samples (the
    executor stages each batch's whole root span densely, so huge strides
    would otherwise balloon staging memory).  ``root_step`` is how many
    root samples one output offset unit covers (the chain's total
    decimation — see :func:`root_step_of`)."""
    batch = max(1, min(len(offsets), budget // max(width, 1)))
    step = max(1, int(root_step))
    out = []
    i = 0
    n = len(offsets)
    while i < n:
        j = min(i + batch, n)
        while j - i > 1 and (offsets[j - 1] - offsets[i]) * step > span_cap:
            j = i + max(1, (j - i) // 2)
        out.append(offsets[i:j])
        i = j
    return batch, out


def root_step_of(stream) -> int:
    """Root-source samples per unit offset of ``stream`` (its chain's
    total decimation factor)."""
    return max(1, stream.span(1, 1)[0] - stream.span(0, 1)[0])


class Executor:
    def __init__(
        self,
        stream: Stream,
        n: int,
        batch: int | None = None,
        post: Callable[[jnp.ndarray], Any] | None = None,
        post_takes_aux: bool = False,
        post_whole_batch: bool = False,
    ):
        """``post``: optional traced transform of the (B, n) sample batch
        (e.g. windowed FFT norms) fused into the same program.

        ``post_takes_aux``: ``post`` is ``post(x, aux)`` — ``aux`` a
        small host value passed per :meth:`run` call (e.g. the carried
        boundary score of a device-side candidate scan).

        ``post_whole_batch``: ``post``'s outputs are batch-level (no
        per-window leading dim), so :meth:`run` must not strip padding
        rows; such a batch must fill the executor's full width."""
        self.stream = stream
        self.n = int(n)
        self.batch = batch
        self.post = post
        self.post_takes_aux = post_takes_aux
        self.post_whole_batch = post_whole_batch
        self.source = stream.root()

        def call(buf, prep, aux):
            out = stream.read_batch({"buf": buf}, prep, self.n)
            if post is not None:
                out = post(out, aux) if post_takes_aux else post(out)
            return out

        self._fn = jax.jit(call)

    def run(self, offs: np.ndarray, aux=None) -> tuple[Any, np.ndarray]:
        """Execute one batch of window offsets.

        Returns ``(outputs, valid)`` where ``outputs`` has leading dim
        ``len(offs)`` (padding rows stripped, unless the executor was
        built ``post_whole_batch``) and ``valid`` gives each window's
        true sample count per the reference's short-read semantics.
        """
        offs = np.asarray(offs, dtype=np.int64)
        b_real = len(offs)
        if b_real == 0:
            raise ValueError("empty offset batch")
        b = self.batch or b_real
        if b_real > b:
            raise ValueError(f"batch of {b_real} exceeds executor width {b}")
        if self.post_whole_batch and b_real != b:
            raise ValueError(
                f"whole-batch post needs a full batch ({b_real} of {b}): "
                "padding rows would duplicate the last window's outputs"
            )
        padded = np.concatenate([offs, np.repeat(offs[-1], b - b_real)])

        if getattr(self.source, "has_staging", False):
            lo, _ = self.stream.span(int(padded.min()), self.n)
            s_off, s_n = self.stream.span(int(padded.max()), self.n)
            lo = max(0, min(lo, self.source.length))
            hi = max(lo, min(s_off + s_n, self.source.length))
            if hi - lo >= (1 << 31) - 1:
                # staged-buffer offsets are int32; a batch spanning this
                # much of the stream would silently wrap
                raise ValueError(
                    f"window batch spans {hi - lo} source samples; split it "
                    "into smaller batches (see runtime.window_batches)"
                )
            staged = self.source.stage(lo, hi)  # (2, n) planes
            cap = _round_up_pow2(staged.shape[-1])
            if staged.shape[-1] < cap:
                staged = np.pad(staged, ((0, 0), (0, cap - staged.shape[-1])))
            base = lo
        else:
            staged = np.zeros((2, 2), dtype=np.float32)
            base = 0

        from quadrs_tpu.utils.profiling import PROFILER

        plan = self.stream.plan(padded, self.n, base)
        aux_in = (
            np.float32(0.0)
            if aux is None
            else np.asarray(aux, dtype=np.float32)
        )
        with PROFILER.stage(type(self.stream).__name__.lower(), b_real * self.n):
            out = jax.tree_util.tree_map(np.asarray, self._fn(staged, plan.prep, aux_in))
        if not self.post_whole_batch:
            out = jax.tree_util.tree_map(lambda a: a[:b_real], out)
        return out, plan.valid[:b_real]
