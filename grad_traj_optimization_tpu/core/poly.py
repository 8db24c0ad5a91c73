"""Quintic piecewise-polynomial core.

Batched redesign of the reference's polynomial machinery
(qp_generator.cpp:40-54 mapping matrix A, grad_traj_optimizer.cpp:451-551
evaluation/time matrices, polynomial_traj.hpp metrics).

Key deviation from the reference: the 6x6 Hermite mapping blocks are never
inverted at runtime.  The reference computes ``A.inverse()`` of a dense
6m x 6m float64 matrix (qp_generator.cpp:134,304) whose blocks contain
``T^5`` entries — poorly conditioned in float32.  Here every block inverse
is expressed through the **unit-time** Hermite matrix ``A1`` (constant,
inverted once in float64 at import) and diagonal powers of the segment
duration::

    A(T)    = diag(T^-ord) @ A1 @ diag(T^j)          (rows: derivative
    Ainv(T)[j, r] = A1INV[j, r] * T^(ord(r) - j)       order 0,0,1,1,2,2)

and the per-segment snap quadratic form ``M(T) = Ainv(T)^T Q(T) Ainv(T)``
collapses to a constant kernel scaled by powers of T::

    M(T)[r, c] = KSNAP[r, c] * T^(ord(r) + ord(c) - 5)

This is exact (not an approximation) and float32-stable, and it turns the
whole QP-seeding pipeline into small batched matmuls that vmap over
scenarios.

Derivative-slot ordering per segment (matches qp_generator.cpp:44-54):
row ``2*i``   = derivative order i at segment start,
row ``2*i+1`` = derivative order i at segment end, for i in {0:pos, 1:vel,
2:acc}.  Coefficients are ascending powers c0..c5 (position =
sum_j c_j t^j), as in grad_traj_optimizer.cpp:451-468.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax as _lax


def _einsum(subscripts, *operands):
    """einsum pinned to full f32 precision (no TF32/bf16 passes)."""
    return jnp.einsum(subscripts, *operands, precision=_lax.Precision.HIGHEST)

# ---------------------------------------------------------------------------
# Constant unit-time kernels (float64 at import, cast to f32 on use)
# ---------------------------------------------------------------------------

#: derivative order of each of the 6 per-segment derivative slots
DERIV_ORD = np.array([0, 0, 1, 1, 2, 2], dtype=np.int64)


def _unit_hermite() -> np.ndarray:
    """Unit-time (T=1) quintic Hermite mapping matrix A1 (6x6 f64).

    A1[2i, j]   = d^i/dt^i t^j |_{t=0} = i! * [j == i]
    A1[2i+1, j] = d^i/dt^i t^j |_{t=1} = j!/(j-i)!
    """
    a = np.zeros((6, 6), dtype=np.float64)
    fact = [1, 1, 2, 6, 24, 120]
    for i in range(3):
        a[2 * i, i] = fact[i]
        for j in range(i, 6):
            a[2 * i + 1, j] = fact[j] / fact[j - i]
    return a


def _unit_snap_hessian() -> np.ndarray:
    """Unit-time snap Hessian Q1 (qp_generator.cpp:99-110 with T=1).

    Q1[i, j] = i(i-1)(i-2) * j(j-1)(j-2) / (i+j-5) for i,j in 3..5.
    """
    q = np.zeros((6, 6), dtype=np.float64)
    for i in range(3, 6):
        for j in range(3, 6):
            q[i, j] = (
                i * (i - 1) * (i - 2) * j * (j - 1) * (j - 2) / (i + j - 5)
            )
    return q


A1 = _unit_hermite()
A1INV = np.linalg.inv(A1)
Q1 = _unit_snap_hessian()
#: KSNAP = A1^-T Q1 A1^-1 — unit-time snap quadratic form over derivatives.
KSNAP = A1INV.T @ Q1 @ A1INV

#: derivative-shift matrix V: (V c)_i = (i+1) c_{i+1}
#: (reference grad_traj_optimizer.cpp:59-60: V(i, i+1) = i+1).
VSHIFT = np.zeros((6, 6), dtype=np.float64)
for _i in range(5):
    VSHIFT[_i, _i + 1] = _i + 1
del _i


# ---------------------------------------------------------------------------
# Runtime (traced) builders — all pure jnp, shapes static in m
# ---------------------------------------------------------------------------


def segment_ainv(T):
    """Per-segment coefficient-from-derivative maps, batched over segments.

    Args:
      T: (m,) segment durations.
    Returns:
      (m, 6, 6) with ``Ainv[s] @ D6 -> c6`` where D6 is the 6-vector of
      endpoint derivatives in reference slot order and c6 the ascending
      power coefficients.  Exact float32-stable form of the reference's
      ``A.inverse()`` blocks (qp_generator.cpp:134).
    """
    T = jnp.asarray(T)
    ordv = jnp.asarray(DERIV_ORD, dtype=T.dtype)
    j = jnp.arange(6, dtype=T.dtype)
    # exponent[j, r] = ord(r) - j
    expo = ordv[None, :] - j[:, None]
    scale = T[:, None, None] ** expo[None, :, :]
    return jnp.asarray(A1INV, dtype=T.dtype)[None, :, :] * scale


def segment_snap_form(T):
    """Per-segment snap quadratic form M(T) over the 6 derivative slots.

    M(T) = Ainv(T)^T Q(T) Ainv(T), collapsed to KSNAP * T-powers.
    Returns (m, 6, 6).
    """
    T = jnp.asarray(T)
    ordv = jnp.asarray(DERIV_ORD, dtype=T.dtype)
    expo = ordv[:, None] + ordv[None, :] - 5.0
    scale = T[:, None, None] ** expo[None, :, :]
    return jnp.asarray(KSNAP, dtype=T.dtype)[None, :, :] * scale


def time_powers(t, dtype=None):
    """Position basis row T(t) = [1, t, t^2, ..., t^5].

    Reference: getTimeMatrix, grad_traj_optimizer.cpp:544-551.
    Broadcasts over any t shape; returns t.shape + (6,).
    """
    t = jnp.asarray(t, dtype=dtype)
    j = jnp.arange(6, dtype=t.dtype)
    return t[..., None] ** j


def vel_powers(t, dtype=None):
    """Velocity basis row = d/dt of time_powers: [0, 1, 2t, ..., 5t^4]."""
    t = jnp.asarray(t, dtype=dtype)
    j = jnp.arange(6, dtype=t.dtype)
    coef = j
    tp = jnp.concatenate(
        [jnp.zeros_like(t[..., None]), t[..., None] ** jnp.arange(5, dtype=t.dtype)],
        axis=-1,
    )
    return coef * tp


def acc_powers(t, dtype=None):
    """Acceleration basis row = [0, 0, 2, 6t, 12t^2, 20t^3]."""
    t = jnp.asarray(t, dtype=dtype)
    j = jnp.arange(6, dtype=t.dtype)
    coef = j * (j - 1)
    powr = jnp.maximum(j - 2, 0)
    return coef * t[..., None] ** powr


def jerk_powers(t, dtype=None):
    """Jerk basis row = [0, 0, 0, 6, 24t, 60t^2]."""
    t = jnp.asarray(t, dtype=dtype)
    j = jnp.arange(6, dtype=t.dtype)
    coef = j * (j - 1) * (j - 2)
    powr = jnp.maximum(j - 3, 0)
    return coef * t[..., None] ** powr


# ---------------------------------------------------------------------------
# Trajectory evaluation & metrics (reference: polynomial_traj.hpp)
# ---------------------------------------------------------------------------


def evaluate(coeff, T, t, deriv: int = 0):
    """Evaluate the piecewise trajectory at global times ``t``.

    Args:
      coeff: (m, 3, 6) ascending-power coefficients per segment/axis.
      T: (m,) segment durations.
      t: (...,) global times in [0, sum(T)].
      deriv: 0 position, 1 velocity, 2 acceleration.
    Returns:
      (..., 3) positions (or derivatives).

    Segment lookup is the branch-free analogue of the reference's
    ``while (times[idx] <= t)`` walk (polynomial_traj.hpp:45-64): a
    searchsorted over the cumulative times, fully batched.
    """
    T = jnp.asarray(T)
    t = jnp.asarray(t, dtype=T.dtype)
    edges = jnp.cumsum(T)
    # segment index: first s with cumsum(T)[s] > t   (times[idx] <= t walk)
    seg = jnp.searchsorted(edges, t, side="right")
    seg = jnp.clip(seg, 0, T.shape[0] - 1)
    t_local = t - jnp.where(seg > 0, edges[seg - 1], 0.0)
    basis_fn = (time_powers, vel_powers, acc_powers)[deriv]
    basis = basis_fn(t_local)  # (..., 6)
    c = coeff[seg]  # (..., 3, 6)
    return _einsum("...j,...xj->...x", basis, c)


def sample_uniform(coeff, T, n: int, deriv: int = 0):
    """Sample the whole trajectory at n uniformly spaced global times."""
    T = jnp.asarray(T)
    total = jnp.sum(T)
    ts = jnp.linspace(0.0, total, n)
    return evaluate(coeff, T, ts, deriv), ts


def length(coeff, T, n: int = 400):
    """Arc length by dense sampling (polynomial_traj.hpp:80-90 uses a
    0.01 s walk; we use a static n-point quadrature)."""
    pts, _ = sample_uniform(coeff, T, n)
    d = jnp.linalg.norm(jnp.diff(pts, axis=0), axis=-1)
    return jnp.sum(d)


def jerk_cost(coeff, T):
    """Integrated squared jerk, exact quadratic form per segment.

    Reference: polynomial_traj.hpp:108-138 builds mat_jerk with entries
    i(i-1)(i-2) j(j-1)(j-2) T^(i+j-5)/(i+j-5) — the jerk Gram matrix
    (integral of jerk^2 over the segment).  Note this is the same formula
    the reference uses for its "minimum snap" QP Hessian
    (qp_generator.cpp:99-110): despite the naming, the reference actually
    minimizes integrated JERK, and so does core.poly.KSNAP — replicated
    deliberately for parity.
    """
    T = jnp.asarray(T)
    coeff = jnp.asarray(coeff, dtype=T.dtype)
    i = jnp.arange(6, dtype=T.dtype)
    ci = i * (i - 1) * (i - 2)
    denom = i[:, None] + i[None, :] - 5.0
    num = ci[:, None] * ci[None, :]
    mask = (i[:, None] >= 3) & (i[None, :] >= 3)
    gram_unit = jnp.where(mask, num / jnp.where(mask, denom, 1.0), 0.0)
    tp = T[:, None, None] ** jnp.where(mask, denom, 0.0)[None]
    gram = gram_unit[None] * tp  # (m, 6, 6)
    return _einsum("mxi,mij,mxj->", coeff, gram, coeff)


def acc_cost(coeff, T):
    """Reference front-end metric: sum ||2 c2||^2 * T per segment
    (polynomial_traj.hpp:94-106 — 'um' is twice the quadratic coefficient,
    the constant acceleration of a 2nd-order segment)."""
    um = 2.0 * coeff[:, :, 2]  # (m, 3)
    return jnp.sum(jnp.sum(um * um, axis=-1) * jnp.asarray(T))


def mean_max_speed(coeff, T, n: int = 400):
    """Mean and max velocity magnitude over a dense sampling.

    (Reference getMeanAndMaxVel, polynomial_traj.hpp:140-171; note the
    reference evaluates the basis at the segment END time ``ts`` instead of
    the walking time — a bug we do not replicate.)
    """
    v, _ = sample_uniform(coeff, T, n, deriv=1)
    s = jnp.linalg.norm(v, axis=-1)
    return jnp.mean(s), jnp.max(s)


def mean_max_acc(coeff, T, n: int = 400):
    a, _ = sample_uniform(coeff, T, n, deriv=2)
    s = jnp.linalg.norm(a, axis=-1)
    return jnp.mean(s), jnp.max(s)
