"""First-order semiring recurrences as parallel (associative) scans.

The reference's O(n·m) alignment-style DP loops
(/root/reference/stem_kernel_lite/string_kernel.cpp:66-132,
/root/reference/bpla_kernel/bpla_kernel.cpp:64-157) serialize along the inner
column index j through first-order recurrences such as

    G1[j] = v[j] + gap * G1[j-1]            (sum-product semiring)
    Y[j]  = max(q[j], Y[j-1] + ext)         (max-plus semiring)

We restructure every such row update as an associative scan over j,
turning each DP row into O(log m) depth of vectorized work instead of m
sequential steps.  The outer row loop stays a `lax.scan`; the batch of
sequence pairs rides along as a leading vectorized axis.

Both recurrences below scan along the LAST axis and accept arbitrary leading
batch axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def linear_recurrence(a: jax.Array, b: jax.Array, *, reverse: bool = False) -> jax.Array:
    """Solve x[t] = a[t] * x[t-1] + b[t] with x[-1] = 0, along the last axis.

    Element t of the result equals sum_{s<=t} b[s] * prod_{u=s+1..t} a[u].
    ``a`` may be a scalar/broadcastable array (e.g. a constant gap weight).
    """
    a = jnp.broadcast_to(a, b.shape).astype(b.dtype)

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l * a_r, b_r + a_r * b_l

    _, x = jax.lax.associative_scan(combine, (a, b), axis=b.ndim - 1, reverse=reverse)
    return x


def logsumexp_recurrence(a: jax.Array, b: jax.Array, *, reverse: bool = False) -> jax.Array:
    """Solve x[t] = logaddexp(x[t-1] + a[t], b[t]) with x[-1] = -inf.

    The log-semiring analogue of :func:`linear_recurrence`, used by log-space
    HMM forward/backward column recursions.
    """
    a = jnp.broadcast_to(a, b.shape).astype(b.dtype)

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l + a_r, jnp.logaddexp(b_l + a_r, b_r)

    _, x = jax.lax.associative_scan(combine, (a, b), axis=b.ndim - 1, reverse=reverse)
    return x


def maxplus_recurrence(a: jax.Array, b: jax.Array, *, reverse: bool = False) -> jax.Array:
    """Solve x[t] = max(x[t-1] + a[t], b[t]) with x[-1] = -inf, along the last axis.

    The (max, +) analogue of :func:`linear_recurrence`: element t equals
    max_{s<=t} ( b[s] + sum_{u=s+1..t} a[u] ).
    """
    a = jnp.broadcast_to(a, b.shape).astype(b.dtype)

    def combine(left, right):
        a_l, b_l = left
        a_r, b_r = right
        return a_l + a_r, jnp.maximum(b_l + a_r, b_r)

    _, x = jax.lax.associative_scan(combine, (a, b), axis=b.ndim - 1, reverse=reverse)
    return x
