"""BLAS1 for the CG solvers, in plain XLA.

The reference runs cuBLAS ``ddot`` / ``daxpy`` kernels (src/solvers/cg_solver.cu); here the
axpy-style updates are written inline where they are used and XLA fuses them with their
neighbours.  Only the dot needs a rule of its own, kept here.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a, b):
    """<a, b> accumulated in at least f32.

    Taken as an elementwise product and a ``jnp.sum``, never as a ``dot_general``: on the
    GPU an f32 ``dot_general`` at default precision may run in TF32 (about three decimal
    digits), which would move CG's α/β and its iteration count.  A reduction has no such
    mode.  bf16 fields accumulate in f32, so a narrow state cannot corrupt <p, Ap>."""
    acc = jnp.promote_types(jnp.result_type(a, b), jnp.float32)
    return jnp.sum(a.astype(acc) * b.astype(acc))
