"""C source emission helpers — the analogue of the reference's codegen
engine (classes/Spcies_constructor.m template assembly +
platforms/+C_code/dec_var.m variable-declaration emitter).

Differences from the reference, deliberate:
  - values are formatted with %.17g (round-trip exact for doubles) instead
    of dec_var.m's %1.15f (platforms/+C_code/dec_var.m:237-262), so the
    generated C reproduces the offline fp64 ingredients bit-for-bit;
  - infinities are clamped to +-INF_VALUE like the reference clamps to
    +-1e20 (dec_var.m write_value).
"""

from __future__ import annotations

import numpy as np

INF_CLAMP = 1e20  # dec_var.m clamps +-inf to +-1e20


def fmt(x: float) -> str:
    x = float(x)
    if np.isinf(x):
        x = INF_CLAMP if x > 0 else -INF_CLAMP
    return f"{x:.17g}"


def c_define(name: str, value) -> str:
    """#define emission (dec_var.m 'define' option)."""
    if isinstance(value, float):
        return f"#define {name} {fmt(value)}\n"
    return f"#define {name} {value}\n"


def c_array(name: str, arr: np.ndarray, *, static: bool = True,
            const: bool = True) -> str:
    """Declaration of a (possibly multi-dimensional) initialized double
    array (dec_var.m scalar/vector/matrix/3D-matrix shapes)."""
    arr = np.asarray(arr, dtype=float)
    qual = ("static " if static else "") + ("const " if const else "")
    dims = "".join(f"[{d}]" for d in arr.shape)

    def body(a):
        if a.ndim == 1:
            return "{" + ", ".join(fmt(v) for v in a) + "}"
        return "{" + ",\n".join(body(row) for row in a) + "}"

    if arr.ndim == 0:
        return f"{qual}double {name} = {fmt(float(arr))};\n"
    return f"{qual}double {name}{dims} = {body(arr)};\n"


def c_int_define_block(defs: dict) -> str:
    return "".join(c_define(k, v) for k, v in defs.items())


def gen_var_declaration(name: str, value, *, as_define: bool = False,
                        static: bool = True, const: bool = True,
                        directory: str = ".",
                        save_name: str | None = None) -> str:
    """Standalone variable-declaration codegen — the analogue of the
    reference's spcies_gen_var_declaration.m (:38-96): emit the C
    declaration of one named scalar/vector/matrix/3D value to a .txt file
    and return the path.

    as_define=True emits a `#define` (scalars only), otherwise an
    initialized (static const) double array via c_array.
    """
    import os

    value = np.asarray(value, dtype=float)
    if as_define:
        if value.ndim != 0:
            raise ValueError("#define emission requires a scalar value")
        text = c_define(name, float(value))
    else:
        text = c_array(name, value, static=static, const=const)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{save_name or name}_declaration.txt")
    with open(path, "w") as f:
        f.write(text)
    return path
