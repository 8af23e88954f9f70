"""On-device runtime validation (sanitizer analog).

The reference's defensive checks are serial host-side raises
(``ivclab/entropy/zerorun.py:66-84``, ``ivclab/entropy/huffman.py:24-26``
— SURVEY.md §5 'Race detection / sanitizers'). On an accelerator,
data-dependent raises can't live inside jit; this module provides:

- ``checked(fn)``: wraps a jitted function with ``jax.experimental.checkify``
  so in-kernel ``checkify.check`` assertions surface as host errors;
- ``debug_mode()``: context that enables jax nan/inf checking;
- ``assert_finite``: functional check usable inside jitted pipelines.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked(fn, errors=checkify.user_checks):
    """Wrap ``fn`` so checkify.check failures raise on the host."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = checkify.checkify(fn, errors=errors)(*args, **kwargs)
        err.throw()
        return out

    return wrapper


def assert_finite(x, name: str = "tensor"):
    """In-jit finiteness check (active under :func:`checked`)."""
    checkify.check(jnp.all(jnp.isfinite(x)), f"non-finite values in {name}")
    return x


def assert_in_range(x, lo, hi, name: str = "tensor"):
    """In-jit range check (the Huffman alphabet-range analog)."""
    checkify.check(
        jnp.all((x >= lo) & (x < hi)), f"{name} outside [{lo}, {hi})"
    )
    return x


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Enable jax nan/inf interception for the enclosed region."""
    old_nans = jax.config.jax_debug_nans
    old_infs = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nans)
        jax.config.update("jax_debug_infs", old_infs)
