"""The comparison that decides `correct`.

Every request of the window is compared with the plain reference's
answer for its pool batch. A cell's limits file names each number
compared: which output it reads (`of`), how it reduces the gaps over
every lane of every request (`stat`) and its limit; the number passes
when it is at most its limit.

    max_abs    the largest |program - reference|
    mean_abs   the mean |program - reference|
    share_ne   the share of the entries that differ
"""

from __future__ import annotations

import numpy as np


def _stat(stat: str, got, want, acc):
    got = np.asarray(got)
    if got.shape != want.shape:
        # an answer of another shape is wrong on every entry
        got = np.full(want.shape, np.nan)
    if stat == "share_ne":
        acc[0] += int(np.count_nonzero(got != want))
        acc[1] += got.size
        return
    # in the answer's own precision (float32 rounds a gap of values near 1
    # by 6e-8, far below every limit); a NaN is as far off as can be
    gap = np.abs(got - want.astype(got.dtype, copy=False))
    if stat == "max_abs":
        top = float(gap.max())
        acc[0] = max(acc[0], float("inf") if np.isnan(top) else top)
    elif stat == "mean_abs":
        total = float(gap.sum(dtype=np.float64))
        acc[0] += float("inf") if np.isnan(total) else total
        acc[1] += gap.size
    else:
        raise ValueError(f"unknown stat {stat!r}")


def numbers(limits: dict, records, expected: dict) -> dict:
    """{name: {"value": v, "limit": l}} over every request of `records`
    against `expected` {pool index: {output: array}}."""
    out = {}
    for name, spec in limits["numbers"].items():
        acc = [0.0, 0]
        for rec in records:
            _stat(spec["stat"], rec["out"][spec["of"]],
                  expected[rec["pool"]][spec["of"]], acc)
        value = acc[0] / acc[1] if acc[1] else acc[0]
        out[name] = dict(value=value, limit=spec["limit"])
    return out


def expected_answers(ref, problem, traffic: dict, batches: list,
                     arith) -> list:
    """The reference's answers to several pool batches, worked out in one
    solve of all their lanes (lanes are independent), split back into
    one dict of NumPy arrays a batch."""
    joined = [np.concatenate(parts) for parts in zip(*batches)]
    ans = ref.answers(problem, traffic, joined, arith)
    # closed-loop outputs are [steps, lanes, ...]
    axis = 1 if traffic["driver"] == "rollout" else 0
    cuts = np.cumsum([len(b[0]) for b in batches])[:-1]
    split = {key: np.split(val.cpu().numpy(), cuts, axis=axis)
             for key, val in ans.items()}
    return [{key: parts[i] for key, parts in split.items()}
            for i in range(len(batches))]


def passed(nums: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in nums.values())
