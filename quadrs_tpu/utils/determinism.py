"""Determinism auditing.

The reference's only concurrency-safety surface is Rust's type system
(SURVEY §5); the equivalents here are (a) re-execution equality
checks — jit programs are pure, so any nondeterminism indicates an
unsafe donation/aliasing or a hardware fault — and (b) cross-backend
comparison (CPU vs accelerator) within float tolerance.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np


def check_repeatable(fn: Callable, *args, runs: int = 2) -> bool:
    """Execute ``fn`` multiple times and assert bitwise-identical results."""
    first = jax.tree_util.tree_map(np.asarray, fn(*args))
    for _ in range(runs - 1):
        again = jax.tree_util.tree_map(np.asarray, fn(*args))
        pairs = zip(jax.tree_util.tree_leaves(first), jax.tree_util.tree_leaves(again))
        for a, b in pairs:
            if a.tobytes() != b.tobytes():
                raise AssertionError("nondeterministic execution detected")
    return True


def compare_backends(fn: Callable, *args, rtol: float = 1e-5, atol: float = 1e-5) -> bool:
    """Run ``fn`` on the default device and on an independent execution
    path; assert closeness.

    On an accelerator the second path is the CPU backend — the
    stand-in for the reference's missing multi-backend tests (SURVEY §4).
    When the default device already *is* the CPU (the test rig), the
    second path is op-by-op eager execution (``jax.disable_jit``), which
    exercises a genuinely different compilation pipeline instead of
    degenerating into CPU-vs-CPU.
    """
    default = jax.tree_util.tree_map(np.asarray, fn(*args))
    if jax.devices()[0].platform == "cpu":
        with jax.disable_jit():
            other = jax.tree_util.tree_map(np.asarray, fn(*args))
    else:
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            other = jax.tree_util.tree_map(np.asarray, fn(*args))
    for a, b in zip(jax.tree_util.tree_leaves(default), jax.tree_util.tree_leaves(other)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    return True
