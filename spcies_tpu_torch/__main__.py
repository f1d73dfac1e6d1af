"""Command-line entry point of the PyTorch/CUDA port — the analogue of the
reference's spcies.m dispatcher (subcommands version/install/uninstall/
generate/test/clear/root/help/license, spcies.m:39-174), with the
subcommands and aliases of `python -m spcies_tpu`.

    python -m spcies_tpu_torch version
    python -m spcies_tpu_torch gen --formulation laxMPC [--method M] [--submethod S] --demo
    python -m spcies_tpu_torch declare NAME 1.0,2.0,...   # variable-declaration codegen
    python -m spcies_tpu_torch test [pytest args...]      # tests/test_torch_*.py
    python -m spcies_tpu_torch clear [directory]
    python -m spcies_tpu_torch root
    python -m spcies_tpu_torch help [topic]               # docs_torch/
    python -m spcies_tpu_torch license
    python -m spcies_tpu_torch install | uninstall

No subcommand touches a device: `gen` writes and compiles plain C for the
host, the rest print or remove files.
"""

from __future__ import annotations

import glob
import os
import sys

# the repository's root: the directory that holds this package, docs_torch/,
# tests/ and LICENSE
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cmd_version(args):
    import spcies_tpu_torch
    print(spcies_tpu_torch.__version__)
    return 0


def _cmd_root(args):
    print(os.path.dirname(os.path.abspath(__file__)))
    return 0


def _cmd_test(args):
    import pytest
    files = sorted(glob.glob(os.path.join(_ROOT, "tests", "test_torch_*.py")))
    return pytest.main([*files, "-q", *args])


def _cmd_clear(args):
    from spcies_tpu_torch.codegen import clear_generated
    clear_generated(*args[:1])
    print("cleared generated solver artifacts")
    return 0


def _cmd_help(args):
    docs = os.path.join(_ROOT, "docs_torch")
    topic = args[0] if args else "topics"
    path = os.path.join(docs, f"{topic}.md")
    if not os.path.exists(path):
        print(f"no such help topic {topic!r}; available:")
        for f in sorted(os.listdir(docs)):
            if f.endswith(".md"):
                print("  " + f[:-3])
        return 1
    with open(path) as f:
        print(f.read())
    return 0


def demo_problem(formulation: str):
    """The oscillating-masses tutorial fixture (sys, param) with the
    adjustments `gen --demo` makes for each formulation family."""
    import numpy as np
    from spcies_tpu_torch.systems import tester_fixture

    sys_, param, _ = tester_fixture()
    param = dict(param)
    f = formulation
    if f == "equMPC":
        param.pop("T", None)
    elif f == "MPCT":
        param["T"] = 10.0 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
    elif f == "ellipMPC":
        param["T"] = np.diag(np.sum(param["T"], axis=1))
        n = param["Q"].shape[0]
        param.setdefault("P", np.eye(n))
        param.setdefault("c", np.zeros(n))
        param.setdefault("r", 0.5)
    elif f in ("HMPC", "ellipHMPC"):
        param.pop("T", None)
        param["w"] = 3 * 1.627 * 0.2
        param["Te"] = 10 * param["N"] * np.asarray(param["Q"])
        param["Th"] = param["Te"]
        param["Se"] = np.asarray(param["R"]).copy()
        param["Sh"] = 0.5 * param["Se"]
        if f == "ellipHMPC":
            n, m = param["Q"].shape[0], param["R"].shape[0]
            sys_ = dict(sys_, E=np.eye(3, n), F=np.zeros((3, m)),
                        LBy=-0.3 * np.ones(3), UBy=0.3 * np.ones(3))
    else:
        param["T"] = np.diag(np.sum(param["T"], axis=1))
    return sys_, param


def _cmd_gen(args):
    """Generate a plain-C solver (the embedded deployment backend) for any
    supported (formulation, method, submethod) triple. With --demo, uses
    the oscillating-masses tutorial fixture."""
    import argparse
    from spcies_tpu_torch.codegen import generate_embedded_solver

    ap = argparse.ArgumentParser(prog="spcies_tpu_torch gen")
    ap.add_argument("--formulation", default="laxMPC")
    ap.add_argument("--method", default="")
    ap.add_argument("--submethod", default="")
    ap.add_argument("--demo", action="store_true",
                    help="use the oscillating-masses tutorial fixture")
    ap.add_argument("--directory", default="generated_solvers")
    ap.add_argument("--save-name", default=None)
    ap.add_argument("--rho", type=float, default=None)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--k-max", type=int, default=None)
    ns = ap.parse_args(args)
    if not ns.demo:
        print("only --demo generation is supported from the CLI; use "
              "spcies_tpu_torch.codegen.generate_embedded_solver from "
              "Python for custom systems")
        return 1
    sys_, param = demo_problem(ns.formulation)
    kw = {}
    if ns.rho is not None:
        kw["rho"] = ns.rho
    if ns.tol is not None:
        kw["tol"] = ns.tol
    if ns.k_max is not None:
        kw["k_max"] = ns.k_max
    path = generate_embedded_solver(
        sys_, param, formulation=ns.formulation, method=ns.method,
        submethod=ns.submethod, directory=ns.directory,
        save_name=ns.save_name, **kw)
    print(f"generated {path} (+ header and shared library)")
    return 0


def _cmd_declare(args):
    """Standalone variable-declaration codegen
    (spcies_gen_var_declaration.m analogue)."""
    from spcies_tpu_torch.codegen.c_emitter import gen_var_declaration
    if len(args) < 2:
        print("usage: python -m spcies_tpu_torch declare NAME v1,v2,... "
              "[directory]")
        return 1
    name, values = args[0], args[1]
    vals = [float(v) for v in values.split(",")]
    directory = args[2] if len(args) > 2 else "."
    path = gen_var_declaration(name, vals if len(vals) > 1 else vals[0],
                               directory=directory)
    print(f"wrote {path}")
    return 0


def _cmd_license(args):
    path = os.path.join(_ROOT, "LICENSE")
    if not os.path.exists(path):
        print("Apache License 2.0 — http://www.apache.org/licenses/")
        return 0
    with open(path) as f:
        print(f.read())
    return 0


def _cmd_install(args):
    # the reference's install/uninstall manage the MATLAB path
    # (spcies.m:44-109); the Python analogue is pip. The port ships in the
    # spcies_tpu distribution, its dependencies under the "torch" extra.
    print(f"install this package with:  pip install -e {_ROOT}[torch]")
    return 0


def _cmd_uninstall(args):
    print("uninstall with:  pip uninstall spcies_tpu")
    return 0


COMMANDS = {
    "version": _cmd_version, "v": _cmd_version,
    "root": _cmd_root,
    "test": _cmd_test,
    "clear": _cmd_clear,
    "help": _cmd_help, "h": _cmd_help,
    "generate": _cmd_gen, "gen": _cmd_gen,
    "declare": _cmd_declare,
    "license": _cmd_license,
    "install": _cmd_install,
    "uninstall": _cmd_uninstall,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 0 if not argv else 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
