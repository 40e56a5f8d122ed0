"""STENCIL5 SpMV and the CG passes built on it, in plain XLA.

Role parity: the reference's ``stencil5_csr_direct_kernel`` (src/spmv/spmv_stencil_csr_direct.cu:
76-123) computes CSR offsets and column indices *arithmetically* from grid coordinates so that no
``col_idx`` array is ever read — 48 B/row instead of CSR's 88 B/row.  Here the vector x is a
(g, g) field, the matrix is five (g, g) coefficient planes [N, W, C, E, S], and SpMV is five
shifted multiply-adds.  The reference's per-thread ``if interior / else boundary`` divergence
disappears: the shifts insert zeros at every grid edge, which IS the Dirichlet matrix, so one
uniform expression is correct everywhere.

Every function takes optional ``halo_prev`` / ``halo_next`` rows: the neighbour band's
boundary rows on the sharded path (zeros, or None, at a true grid edge).  XLA fuses the shifts,
the multiply-adds and, where a dot follows, the reduction into loop/reduction fusions; the
byte floor is 7 words/pt for the values-carrying SpMV and 2 for the constant one.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..formats import C, E, N, S, W
from .blas1 import dot


def _shifted(x, halo_prev=None, halo_next=None):
    """(north, south, west, east) neighbour fields of x, zero beyond the grid edges."""
    rows, g = x.shape
    top = jnp.zeros((1, g), x.dtype) if halo_prev is None else halo_prev.astype(x.dtype)
    bot = jnp.zeros((1, g), x.dtype) if halo_next is None else halo_next.astype(x.dtype)
    xn = jnp.concatenate([top, x[:-1, :]], axis=0)
    xs = jnp.concatenate([x[1:, :], bot], axis=0)
    zcol = jnp.zeros((rows, 1), x.dtype)
    xw = jnp.concatenate([zcol, x[:, :-1]], axis=1)
    xe = jnp.concatenate([x[:, 1:], zcol], axis=1)
    return xn, xs, xw, xe


def spmv_stencil5_xla(planes, x, halo_prev=None, halo_next=None):
    """y = A·x for a (5, rows, g) values-carrying operand and a (rows, g) field.

    Coefficient planes may be stored narrower than x (bf16 planes under an f32 field, the
    ``stencil5-bf16c`` mode); y takes x's dtype."""
    xn, xs, xw, xe = _shifted(x, halo_prev, halo_next)
    y = (planes[C] * x + planes[W] * xw + planes[E] * xe + planes[N] * xn
         + planes[S] * xs)
    return y.astype(x.dtype)


def spmv_stencil5_const_xla(x, diag, offdiag, halo_prev=None, halo_next=None):
    """Values-free constant-coefficient stencil: y = diag·x + offdiag·Σ neighbours.  No
    operand array at all (2 words/pt: x read, y write)."""
    xn, xs, xw, xe = _shifted(x, halo_prev, halo_next)
    return diag * x + offdiag * (xw + xe + xn + xs)


def spmv_dot_stencil5_xla(planes, x, halo_prev=None, halo_next=None):
    """(A·x, <x, A·x>) — the CG top-of-iteration pass."""
    y = spmv_stencil5_xla(planes, x, halo_prev, halo_next)
    return y, dot(x, y)


def spmv_dot_stencil5_const_xla(x, diag, offdiag, halo_prev=None, halo_next=None):
    y = spmv_stencil5_const_xla(x, diag, offdiag, halo_prev, halo_next)
    return y, dot(x, y)


# ---------------------------------------------------------------------------
# Recompute-Ap CG passes for the constant-coefficient operator.
#
# The classic iteration writes A·p and reads it back.  For the values-free stencil A·p is
# cheap to recompute from p, so the iteration becomes two passes and A·p is never stored:
#
#   pass A  (p', <p',Ap'>) = const_pupdate_dot(β, r, p)     — reads r, p; writes p'
#   pass B  (x', r', <r',r'>) = const_update_recompute(α, x, r, p')
#           with A·p' recomputed from p'                     — reads x, r, p'; writes x', r'
#
# 8 words/pt/iter against the classic loop's 11.  The algebra is unchanged; β = 0 with p = 0
# gives the first iteration (p' = r).  Halo rows are the neighbour's p' boundary rows.
# ---------------------------------------------------------------------------


def const_pupdate_dot(beta, r, p, diag, offdiag, halo_prev=None, halo_next=None):
    """Pass A: p' = r + β·p and <p', A·p'>."""
    pnew = r + jnp.asarray(beta, r.dtype) * p
    ap = spmv_stencil5_const_xla(pnew, diag, offdiag, halo_prev, halo_next)
    return pnew, dot(pnew, ap)


def const_update_recompute(alpha, x, r, p, diag, offdiag, halo_prev=None, halo_next=None):
    """Pass B: x' = x + α·p, r' = r − α·A·p and <r', r'>, A·p recomputed from p."""
    a = jnp.asarray(alpha, r.dtype)
    ap = spmv_stencil5_const_xla(p, diag, offdiag, halo_prev, halo_next)
    rnew = r - a * ap
    return x + a * p, rnew, dot(rnew, rnew)
