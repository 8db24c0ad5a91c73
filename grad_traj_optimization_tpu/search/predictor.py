"""Moving-obstacle tracking and prediction.

Rebuild of the reference ``ObjPredictor`` / ``ObjHistory`` /
``PolynomialPrediction`` (obj_predictor.{h,cpp}) without ROS: histories
are plain arrays, the timer-driven refit becomes an explicit batched call,
and both fit modes are replicated:

* :func:`fit_const_vel` — the *active* mode (obj_predictor.cpp:174-218):
  a 2x2 solve through the last two history points per object, giving a
  linear polynomial per axis.
* :func:`fit_poly` — the implemented-but-disabled degree-5 least-squares
  fit with acceleration regulator lambda (obj_predictor.cpp:85-145).

All objects fit in one batched solve (vmap over the object axis); the
predictions are (n_obj, 6, 3) ascending-power polynomials in absolute
time, evaluated with :func:`predict_position`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ObjHistory:
    """Pose-history ring buffer with sample thinning.

    Host-side port of the reference ``ObjHistory``
    (obj_predictor.cpp:12-34): every ``skip_num``-th observed pose is
    recorded (the counter resets on record, so exactly 1 in skip_num
    observations lands, like the reference's ``++skip_; if (skip_ <
    skip_num_) return;`` gate) and the buffer keeps the most recent
    ``queue_size`` records.  Feed :func:`fit_const_vel` / :func:`fit_poly`
    with :meth:`arrays` (most recent last, as the fitters expect)."""

    def __init__(self, queue_size: int = 20, skip_num: int = 1,
                 obj_idx: int = 0):
        self.queue_size = queue_size
        self.skip_num = skip_num
        self.obj_idx = obj_idx
        self._skip = 0
        self._hist: list[tuple[float, float, float, float]] = []

    def observe(self, pos, t: float) -> bool:
        """Offer one observation; returns True when it was recorded."""
        self._skip += 1
        if self._skip < self.skip_num:
            return False
        p = [float(x) for x in pos]
        self._hist.append((p[0], p[1], p[2], float(t)))
        if len(self._hist) > self.queue_size:
            self._hist.pop(0)
        self._skip = 0
        return True

    def __len__(self) -> int:
        return len(self._hist)

    def arrays(self):
        """(H, 3) positions and (H,) times, oldest first."""
        import numpy as np

        h = np.asarray(self._hist, dtype=np.float32).reshape(-1, 4)
        return h[:, :3], h[:, 3]


def stack_histories(histories, scales):
    """Rectangular (n_obj, H, 3) / (n_obj, H) batch from ObjHistory
    objects (H = the shortest length, tails kept — the fitters read the
    most recent samples), ready for fit_const_vel / fit_poly."""
    import numpy as np

    H = min(len(h) for h in histories)
    if H < 2:
        raise ValueError("need >= 2 recorded poses per object")
    ps, ts = [], []
    for h in histories:
        p, t = h.arrays()
        ps.append(p[-H:])
        ts.append(t[-H:])
    return (
        jnp.asarray(np.stack(ps)), jnp.asarray(np.stack(ts)),
        jnp.asarray(scales, jnp.float32),
    )


class ObjPrediction(NamedTuple):
    poly: jnp.ndarray   # (n_obj, 6, 3) ascending-power coeffs per axis
    t1: jnp.ndarray     # (n_obj,) history start time
    t2: jnp.ndarray     # (n_obj,) history end time
    scale: jnp.ndarray  # (n_obj, 3) box dimensions


def fit_const_vel(history_pos, history_t, scale) -> ObjPrediction:
    """Constant-velocity fit from the last two history samples.

    Args:
      history_pos: (n_obj, H, 3); history_t: (n_obj, H) (H >= 2, most
        recent last — the reference reads the list tail,
        obj_predictor.cpp:185-196).
    """
    q1 = history_pos[:, -2, :]
    q2 = history_pos[:, -1, :]
    t1 = history_t[:, -2]
    t2 = history_t[:, -1]
    dt = t2 - t1
    # [p0; p1] = [[1, t1], [1, t2]]^-1 [q1; q2]
    vel = (q2 - q1) / jnp.maximum(dt, 1e-9)[:, None]
    p0 = q1 - vel * t1[:, None]
    poly = jnp.zeros((history_pos.shape[0], 6, 3), history_pos.dtype)
    poly = poly.at[:, 0, :].set(p0).at[:, 1, :].set(vel)
    return ObjPrediction(
        poly=poly, t1=history_t[:, 0], t2=t2, scale=jnp.asarray(scale)
    )


def fit_poly(history_pos, history_t, scale, lam: float = 1.0,
             valid=None) -> ObjPrediction:
    """Regularized degree-5 polynomial fit.

    Normal equations built exactly as obj_predictor.cpp:85-137: data rows
    ``A += 2 t^j [1, t, ..., t^5]``, ``b += 2 q t^j``, plus four
    acceleration-regulator rows weighted by lambda on coefficient rows
    2..5.  One batched 6x6 solve per object/axis.

    Args:
      valid: optional (n_obj, H) mask for ragged histories.
    """
    pos = jnp.asarray(history_pos)
    t = jnp.asarray(history_t)
    n_obj, H = t.shape
    w = jnp.ones_like(t) if valid is None else valid.astype(t.dtype)

    tp = t[..., None] ** jnp.arange(6, dtype=t.dtype)  # (n_obj, H, 6)
    hi = jax.lax.Precision.HIGHEST  # no TF32 passes on the GPU
    A = 2.0 * jnp.einsum("nhj,nhk,nh->njk", tp, tp, w, precision=hi)
    b = 2.0 * jnp.einsum("nhx,nhj,nh->njx", pos, tp, w, precision=hi)

    t1 = t[:, 0]
    t2 = t[:, -1]

    def reg_row(tt, coefs, powers):
        # sum_k coefs[k] * tt^powers[k] rows (zeros for j < 2)
        out = jnp.zeros((n_obj, 6), t.dtype)
        for j, (c, p) in enumerate(zip(coefs, powers)):
            out = out.at[:, j + 2].set(c * tt**p)
        return out

    def reg(tt):
        r2 = reg_row(tt, (2.0, 3.0, 4.0, 5.0), (1, 2, 3, 4))
        r3 = reg_row(tt, (1.0, 2.0, 3.0, 4.0), (2, 3, 4, 5))
        r4 = reg_row(tt, (20.0, 45.0, 72.0, 100.0), (3, 4, 5, 6))
        r5 = reg_row(tt, (35.0, 84.0, 140.0, 200.0), (4, 5, 6, 7))
        return r2, r3, r4, r5

    r2a, r3a, r4a, r5a = reg(t1)
    r2b, r3b, r4b, r5b = reg(t2)
    A = A.at[:, 2, :].add(-4.0 * lam * (r2a - r2b))
    A = A.at[:, 3, :].add(-12.0 * lam * (r3a - r3b))
    A = A.at[:, 4, :].add(-(4.0 / 5.0) * lam * (r4a - r4b))
    A = A.at[:, 5, :].add(-(4.0 / 7.0) * lam * (r5a - r5b))

    coef = jnp.linalg.solve(A, b)  # (n_obj, 6, 3)
    return ObjPrediction(
        poly=coef, t1=t1, t2=t2, scale=jnp.asarray(scale)
    )


def predict_position(pred: ObjPrediction, time):
    """Obstacle box centers at absolute ``time``.

    The reference's evaluateConstVel clamps nothing and evaluates the
    linear polynomial directly (obj_predictor.h:57-66); a full polynomial
    evaluates all 6 terms (obj_predictor.h:46-56).

    Args:
      time: scalar or (...,).
    Returns:
      (..., n_obj, 3).
    """
    t = jnp.asarray(time)
    tp = t[..., None] ** jnp.arange(6, dtype=pred.poly.dtype)  # (..., 6)
    return jnp.einsum(
        "...j,njx->...nx", tp, pred.poly, precision=jax.lax.Precision.HIGHEST
    )
