"""The lockstep Euler walk: the plain version of kernel D.

Counterpart of `jello_tpu/pipeline/flatten.py::lockstep_euler_pass` and
of the walk inside `jello_tpu/tpu/lockstep_pallas.py` (`lockstep_walk`,
`make_lockstep_call`): the adaptive subdivision of every work item's
cubic into Euler segments, run for all items at once as a fixed-length
masked loop (no host sync per iteration). Once an item is done an
iteration changes nothing for it but a zero record row. `cuda/lockstep.py`
wraps the kernel (`csrc/lockstep.cu`), which takes this version's place
for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import flatten_math as fm
from . import ops
from .ops import F32, I32, I64


def pq_at(P, t):
    """Point/derivative at t with the near-zero-derivative resampling."""
    px, py, qx, qy = fm.eval_cubic_and_deriv(*P, t)
    small = qx * qx + qy * qy < fm.DERIV_THRESH * fm.DERIV_THRESH
    ts = torch.where(t == 0.0, torch.full_like(t, fm.DERIV_EPS), t - fm.DERIV_EPS)
    px2, py2, qx2, qy2 = fm.eval_cubic_and_deriv(*P, ts)
    qx = torch.where(small, qx2, qx)
    qy = torch.where(small, qy2, qy)
    interior = small & (t > 0.0) & (t < 1.0)
    px = torch.where(interior, px2, px)
    py = torch.where(interior, py2, py)
    t_adj = torch.where(interior, t - fm.DERIV_EPS, t)
    return px, py, qx, qy, t_adj


def lockstep_walk(table, valid, IT):
    """Walk every work item for at most IT iterations.

    table: [NW, >=10] f32 work rows (cubic points 0..7, offset 8, scale
    9); valid: [NW] bool. Returns (rec [3, IT, NW] f32, the (t0, t1, n)
    record of each iteration, zero where nothing was emitted; count [NW]
    f32, the item's lines; not_done [NW] bool; iters, 0-dim int32: the
    iterations entered while some item was not done)."""
    N = table.shape[0]
    dev = table.device
    P = [table[:, i] for i in range(8)]
    offset, scale = table[:, 8], table[:, 9]
    degenerate = (
        (P[0] == P[2]) & (P[1] == P[3]) & (P[0] == P[4]) & (P[1] == P[5])
        & (P[0] == P[6]) & (P[1] == P[7])
    )
    done = ~(valid & ~degenerate)

    t0u = torch.zeros(N, dtype=I64, device=dev)
    dt = torch.ones(N, dtype=F32, device=dev)
    lpx, lpy = P[0], P[1]
    lqx, lqy = P[2] - P[0], P[3] - P[1]
    small = lqx * lqx + lqy * lqy < fm.DERIV_THRESH * fm.DERIV_THRESH
    _, _, q2x, q2y = fm.eval_cubic_and_deriv(*P, torch.full_like(lpx, fm.DERIV_EPS))
    lqx = torch.where(small, q2x, lqx)
    lqy = torch.where(small, q2y, lqy)
    last_t = torch.zeros(N, dtype=F32, device=dev)
    rec = torch.zeros((3, IT, N), dtype=F32, device=dev)
    iters = torch.zeros((), dtype=I32, device=dev)
    zero = torch.zeros_like(dt)

    for it in range(IT):
        iters = iters + (~done.all()).to(I32)
        t0 = t0u.to(F32) * dt
        done = done | (t0 == 1.0)
        t1 = t0 + dt
        p1x, p1y, q1x, q1y, t1 = pq_at(P, t1)
        actual_dt = t1 - last_t
        th0, th1, chord_len, err = fm.cubic_params_from_points_derivs(
            lpx, lpy, p1x, p1y, lqx, lqy, q1x, q1y, actual_dt
        )
        emit = (err * scale <= fm.FLATTEN_TOL) | (dt <= fm.SUBDIV_LIMIT)
        do_emit = emit & ~done

        k0, k1, ch = fm.euler_params_from_angles(th0, th1)
        n = fm.espc_subdivision(k0, k1, ch, chord_len, offset, scale)[0]
        n = torch.where(torch.isnan(n), torch.ones_like(n), n)

        rec[0, it] = torch.where(do_emit, last_t, zero)
        rec[1, it] = torch.where(do_emit, t1, zero)
        rec[2, it] = torch.where(do_emit, n, zero)

        lpx = torch.where(do_emit, p1x, lpx)
        lpy = torch.where(do_emit, p1y, lpy)
        lqx = torch.where(do_emit, q1x, lqx)
        lqy = torch.where(do_emit, q1y, lqy)
        last_t = torch.where(do_emit, t1, last_t)

        # Advance: t0u + 1 with its trailing zeros shifted out (u32
        # wrap-around kept); subdivide: clamped doubling.
        t0u_e = (t0u + 1) & 0xFFFFFFFF
        shift = ops.trailing_zeros32(t0u_e)
        t0u_e = t0u_e >> shift
        dt_e = dt * torch.exp2(shift.to(F32))
        t0u_s = torch.where(t0u > 0x7FFFFFFF, 0xFFFFFFFF, t0u * 2)
        dt_s = dt * 0.5

        advance = emit & ~done
        subdiv = ~emit & ~done
        t0u = torch.where(advance, t0u_e, torch.where(subdiv, t0u_s, t0u))
        dt = torch.where(advance, dt_e, torch.where(subdiv, dt_s, dt))
    # Line counts are small integers: exact in f32 in any order.
    return rec, rec[2].sum(0), ~done, iters
