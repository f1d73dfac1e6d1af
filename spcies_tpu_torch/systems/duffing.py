"""Duffing-oscillator benchmark plant (nonlinear ODE + linearization).

Counterpart of spcies_tpu/systems/duffing.py (reference:
+sp_utils/Duffing_ode.m:17-19 and +sp_utils/Duffing_to_ss.m:13-23), used by
the t03 tutorial (examples/t03_real_systems.m) with the equMPC+FISTA
configuration of BASELINE.json. Plain numpy, as in the reference package.
"""

from __future__ import annotations

import numpy as np


def duffing_ode(t, x, u, *, alpha, beta, delta, gamma):
    """dx/dt of the controlled Duffing oscillator; x = (velocity, position),
    with the usual cos(w t) forcing replaced by a control input u."""
    x = np.asarray(x, dtype=float)
    return np.array([
        -delta * x[0] - alpha * x[1] - beta * x[1] ** 3 + gamma * float(u),
        x[0],
    ])


def duffing_to_ss(x0, u0, *, alpha, beta, delta, gamma):
    """Continuous-time linearization (A, B) of the Duffing oscillator about
    (x0, u0)."""
    x0 = np.asarray(x0, dtype=float)
    A = np.array([[-delta, -alpha - 3.0 * beta * x0[1] ** 2],
                  [1.0, 0.0]])
    B = np.array([[gamma], [0.0]])
    return A, B
