"""Schedule tables for the interleaved (virtual-pipeline) 1F1B, a copy of
``paddle_tpu/distributed/fleet/meta_parallel/interleave_schedule.py``.

Upstream Paddle's ``PipelineParallelWithInterleave``: device s owns the
virtual stages ``d = c*pp + s`` for chunks ``c in [0, v)``; microbatches
advance in groups of ``pp`` a chunk, and the 1F1B steady state alternates
one forward with one backward a device.

:func:`_device_op_order` is each device's op order, which the port's
eager schedule runs as it is. :func:`build_interleaved_schedule`
simulates that order greedily into per-tick tables (the reference's
compiled schedule indexes them); the port keeps it so that
``pipeline_schedule_stats`` gives the reference's numbers, and its
completion shows that the order cannot deadlock when every device runs it
in order with sends that do not block.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["build_interleaved_schedule"]


def _device_op_order(pp: int, v: int, M: int, s: int):
    """Megatron interleaved order for device s: warmup fwds, 1F1B pairs,
    cooldown bwds.  Ops are ('F'|'B', chunk, microbatch)."""
    fwds = [("F", c, g * pp + r)
            for g in range(M // pp) for c in range(v) for r in range(pp)]
    bwds = [("B", c, g * pp + r)
            for g in range(M // pp) for c in reversed(range(v))
            for r in range(pp)]
    total = M * v
    warm = min((pp - s - 1) * 2 + (v - 1) * pp, total)
    seq = list(fwds[:warm])
    steady = total - warm
    for i in range(steady):
        seq.append(fwds[warm + i])
        seq.append(bwds[i])
    seq.extend(bwds[steady:])
    assert len(seq) == 2 * total
    return seq


def build_interleaved_schedule(pp: int, v: int, M: int) -> Dict[str, np.ndarray]:
    """Greedy-simulate the interleaved 1F1B op order into per-tick tables.

    Returns int32 arrays of shape [T, pp] (``*_valid`` are int32 0/1):
      f_valid/f_chunk/f_mb      — forward unit of each device per tick
      b_valid/b_chunk/b_mb      — backward unit
      ra_valid/ra_chunk/ra_slot — where the arriving activation is stashed
      rc_valid/rc_chunk/rc_slot — where the arriving cotangent is stashed
      f_slot / b_slot / bc_slot — in_buf slot the fwd reads, the bwd reads,
                                  and the cot_buf slot the bwd reads
    plus scalars ``T``, ``n_in_slots``, ``n_cot_slots``.
    """
    if M % pp != 0:
        raise ValueError(
            f"interleaved schedule needs accumulate_steps % pp == 0 "
            f"(got M={M}, pp={pp})")
    D = pp * v
    seqs = [_device_op_order(pp, v, M, s) for s in range(pp)]
    pos = [0] * pp
    done: Dict[tuple, int] = {}
    rows = []
    t = 0
    limit = 8 * M * v + 8 * pp * v + 16
    # The engine's tick body always executes one forward AND one backward
    # unit, so a tick that issues only one of the two wastes the other's
    # compute.  Issue up to one F and one B per device per tick (the Megatron
    # steady state is exactly F,B pairs; B units rematerialize from stashed
    # chunk inputs, so an F and a B of the same tick never feed each other —
    # readiness only consults ops completed on PRIOR ticks).
    while any(pos[s] < len(seqs[s]) for s in range(pp)):
        if t > limit:
            raise RuntimeError("interleave schedule failed to converge")
        row = []
        for s in range(pp):
            f_op = b_op = None
            take = 0
            for _ in range(2):
                i = pos[s] + take
                if i >= len(seqs[s]):
                    break
                kind, c, f = seqs[s][i]
                d = c * pp + s
                if kind == "F":
                    if f_op is not None:
                        break
                    ready = d == 0 or ("F", d - 1, f) in done
                    if not ready:
                        break
                    f_op = (kind, c, f)
                else:
                    if b_op is not None:
                        break
                    ready = (("F", d, f) in done if d == D - 1
                             else ("B", d + 1, f) in done)
                    if not ready:
                        break
                    b_op = (kind, c, f)
                take += 1
            row.append((f_op, b_op, take))
        for s, (f_op, b_op, take) in enumerate(row):
            for op in (f_op, b_op):
                if op is not None:
                    kind, c, f = op
                    done[(kind, c * pp + s, f)] = t
            pos[s] += take
        rows.append([(f_op, b_op) for f_op, b_op, _ in row])
        t += 1
    T = len(rows)

    # ---- buffer slot assignment with liveness verification.
    # in_buf[(s, c)] holds the INPUT of virtual stage d=c*pp+s for microbatch
    # f from its arrival (F(d-1,f)+1) until B(d,f).  d==0 reads tokens.
    def _assign_slots(intervals):
        """intervals: {(s, c, f): (t_start, t_end)} -> (n_slots, slot_of)"""
        R = 1
        while True:
            ok = True
            for (s, c, f), (a0, a1) in intervals.items():
                for f2 in range(f + R, M, R):
                    other = intervals.get((s, c, f2))
                    if other and not (other[0] > a1 or other[1] < a0):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                return R, {k: k[2] % R for k in intervals}
            R += 1
            if R > max(M, 1):
                raise RuntimeError("slot assignment failed")

    in_iv = {}
    cot_iv = {}
    for s in range(pp):
        for c in range(v):
            d = c * pp + s
            for f in range(M):
                if d > 0:
                    in_iv[(s, c, f)] = (done[("F", d - 1, f)] + 1,
                                        done[("B", d, f)])
                if d < D - 1:
                    cot_iv[(s, c, f)] = (done[("B", d + 1, f)] + 1,
                                         done[("B", d, f)])
    n_in, in_slot = _assign_slots(in_iv)
    n_cot, cot_slot = _assign_slots(cot_iv)

    z = lambda: np.zeros((T, pp), np.int32)
    tab = {k: z() for k in
           ("f_valid", "f_chunk", "f_mb", "f_slot",
            "b_valid", "b_chunk", "b_mb", "b_slot", "bc_slot",
            "ra_valid", "ra_chunk", "ra_slot",
            "rc_valid", "rc_chunk", "rc_slot")}
    for ti, row in enumerate(rows):
        for s, (f_op, b_op) in enumerate(row):
            if f_op is not None:
                _, c, f = f_op
                d = c * pp + s
                tab["f_valid"][ti, s] = 1
                tab["f_chunk"][ti, s] = c
                tab["f_mb"][ti, s] = f
                tab["f_slot"][ti, s] = in_slot.get((s, c, f), 0)
                # arrival at downstream neighbor next tick (unless last
                # virtual stage, whose fwd output is dummy)
                if d < D - 1 and ti + 1 < T:
                    s2 = (s + 1) % pp
                    c2 = (d + 1) // pp
                    tab["ra_valid"][ti + 1, s2] = 1
                    tab["ra_chunk"][ti + 1, s2] = c2
                    tab["ra_slot"][ti + 1, s2] = in_slot[(s2, c2, f)]
            if b_op is not None:
                _, c, f = b_op
                d = c * pp + s
                tab["b_valid"][ti, s] = 1
                tab["b_chunk"][ti, s] = c
                tab["b_mb"][ti, s] = f
                tab["b_slot"][ti, s] = in_slot.get((s, c, f), 0)
                tab["bc_slot"][ti, s] = cot_slot.get((s, c, f), 0)
                if d > 0 and ti + 1 < T:
                    s2 = (s - 1) % pp
                    c2 = (d - 1) // pp
                    tab["rc_valid"][ti + 1, s2] = 1
                    tab["rc_chunk"][ti + 1, s2] = c2
                    tab["rc_slot"][ti + 1, s2] = cot_slot[(s2, c2, f)]
    tab["T"] = T
    tab["n_in_slots"] = n_in
    tab["n_cot_slots"] = n_cot
    return tab
