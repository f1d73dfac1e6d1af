"""Pieces shared by the plain references: the plant, the arithmetic they
run in, and the batched loop that stops each lane at its own iteration.

Everything here is plain NumPy, SciPy and PyTorch. Nothing imports the
program under test: the references build each lane's QP from the
configuration file and the lane's inputs alone.
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.linalg
import torch


def oscillating_masses(plant: dict):
    """Discrete-time (A, B) of a chain of masses between two walls,
    joined by springs, with forces on the masses that `forced` marks
    (Wang and Boyd, Fast MPC, IEEE TCST 2010; Spcies
    +sp_utils/gen_oscillating_masses.m), under a zero-order hold of
    period Ts. State: positions, then velocities."""
    M = np.asarray(plant["masses"], float)
    K = np.asarray(plant["springs"], float)
    F = np.asarray(plant["forced"], bool)
    p = M.size
    stiff = np.zeros((p, p))
    for i in range(p):
        stiff[i, i] = -(K[i] + K[i + 1]) / M[i]
        if i > 0:
            stiff[i, i - 1] = K[i] / M[i]
        if i < p - 1:
            stiff[i, i + 1] = K[i + 1] / M[i]
    Ac = np.block([[np.zeros((p, p)), np.eye(p)],
                   [stiff, np.zeros((p, p))]])
    Bc = np.vstack([np.zeros((p, p)), np.diag(1.0 / M)])[:, F]
    n, m = Ac.shape[0], Bc.shape[1]
    # zero-order hold: expm([[Ac, Bc], [0, 0]] Ts)
    big = np.zeros((n + m, n + m))
    big[:n, :n], big[:n, n:] = Ac, Bc
    E = scipy.linalg.expm(big * float(plant["Ts"]))
    return E[:n, :n], E[:n, n:]


def plant_matrices(config: dict):
    """(A, B) of the configuration's plant."""
    plant = config["plant"]
    if plant["kind"] != "oscillating_masses":
        raise ValueError(f"unknown plant kind {plant['kind']!r}")
    return oscillating_masses(plant)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 stored
    mantissa bits, ties to even): the operands a TF32 product reads."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


class Arith:
    """The arithmetic a reference runs in.

    "fp64": float64 throughout (the reference).
    "tf32": float32 element-wise work and TF32 products (the control): on
    a CUDA device the card's TF32 path, elsewhere float32 products of
    operands rounded to TF32 first, which is what a TF32 product reads.
    """

    def __init__(self, precision: str, device):
        if precision not in ("fp64", "tf32"):
            raise ValueError(f"precision is fp64 or tf32; got {precision!r}")
        self.precision = precision
        self.device = torch.device(device)
        self.dtype = torch.float64 if precision == "fp64" else torch.float32
        self._emulate = (precision == "tf32"
                         and self.device.type != "cuda")

    def tensor(self, a):
        if torch.is_tensor(a):
            return a.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def mm(self, a, b):
        if self._emulate:
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    @contextlib.contextmanager
    def products(self):
        """The process-wide float32 product setting this arithmetic
        needs, restored afterwards."""
        before = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision(
            "high" if self.precision == "tf32" else "highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(before)


def masked_loop(step, state: dict, consts: dict, k_max: int):
    """Run `step(state, consts) -> (new_state, converged)` on a batch of
    lanes until every lane has converged or k_max iterations have run.
    A lane converges at the first iteration whose `converged` is true;
    its state is frozen there. `consts` holds per-lane data the step
    reads and never changes. Every 16 iterations the host looks at the
    lanes: once half of those still held have converged, they are put
    aside and the step runs on the rest alone. Returns (state, k, e_flag):
    k the iteration at which each lane converged (k_max where it never
    did), e_flag 1 or -1."""
    first = next(iter(state.values()))
    batch, device = first.shape[0], first.device
    final = {key: val.clone() for key, val in state.items()}
    k_out = torch.full((batch,), k_max, dtype=torch.int64, device=device)
    e_out = torch.full((batch,), -1, dtype=torch.int64, device=device)
    idx = torch.arange(batch, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    k = torch.zeros(batch, dtype=torch.int64, device=device)

    def put_aside(mask, converged: bool):
        where = idx[mask]
        for key, val in state.items():
            final[key][where] = val[mask]
        k_out[where] = k[mask] if converged else k_max
        e_out[where] = 1 if converged else -1

    for it in range(1, k_max + 1):
        new, conv = step(state, consts)
        live = ~done
        for key, val in new.items():
            mask = live.reshape((-1,) + (1,) * (val.ndim - 1))
            state[key] = torch.where(mask, val, state[key])
        hit = live & conv
        k = torch.where(hit, it, k)
        done = done | hit
        if it % 16 and it != k_max:
            continue
        n_done = int(done.sum())
        if n_done == done.numel():
            break
        if 2 * n_done >= done.numel():
            put_aside(done, True)
            keep = ~done
            state = {key: val[keep] for key, val in state.items()}
            consts = {key: val[keep] for key, val in consts.items()}
            idx, k, done = idx[keep], k[keep], done[keep]
    put_aside(done, True)
    put_aside(~done, False)
    return final, k_out, e_out
