"""Test helpers: complex arrays to and from the device as f32 planes."""

import jax
import jax.numpy as jnp
import numpy as np


def to_device_complex(x: np.ndarray) -> jax.Array:
    """Move a host complex array to the device via f32 planes."""
    x = np.asarray(x, dtype=np.complex64)
    return jax.lax.complex(
        jnp.asarray(np.ascontiguousarray(x.real)),
        jnp.asarray(np.ascontiguousarray(x.imag)),
    )


def from_device_complex(a: jax.Array) -> np.ndarray:
    """Fetch a device complex array as numpy via f32 planes."""
    re = np.asarray(jnp.real(a))
    im = np.asarray(jnp.imag(a))
    out = np.empty(re.shape, dtype=np.complex64)
    out.real = re
    out.imag = im
    return out

