"""The port's examples, examples/torch_t0*.py: a port of
tests/test_api_misc.py:114-123 (test_examples_run) over torch_t00-torch_t04
with --device cpu (t05, the rollout at N=30, stays on the card, as the JAX
test leaves out t05); each example that builds a solver fails without a
card and without --device cpu; and t00, t01, t03 and t04 print the JAX
examples' numbers (run as test_examples_run runs them) to the digits
printed, iteration counts equal. t04's gaps to the numpy oracle are
rounding at 1e-13 in both packages: they are held to the fp64 parity bar,
1e-9, not digit for digit."""

import os
import re
import subprocess
import sys as _sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOLVER_EXAMPLES = ["torch_t00_basic_tutorial.py", "torch_t01_time_varying.py",
                   "torch_t03_real_systems.py",
                   "torch_t04_dev_solver_versions.py",
                   "torch_t05_serving_rollout.py"]
# examples whose printed numbers are held to the JAX example's
SAME_NUMBERS = ("t00", "t01", "t03", "t04")
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
GAP_BAR = 1e-9


def _start(script, cwd, *args, **env):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", **env)
    return subprocess.Popen(
        [_sys.executable, str(ROOT / "examples" / script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(cwd), env=env)


def _finish(proc):
    """(returncode, stdout, stderr) of a started example; killed past
    600 s."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err


def _same_numbers(ours: str, theirs: str):
    """Line by line, the same numbers: integers equal, decimals within one
    unit of the last digit printed; gap lines (t04) both within GAP_BAR."""
    lines_o, lines_t = ours.strip().splitlines(), theirs.strip().splitlines()
    assert len(lines_o) == len(lines_t), (ours, theirs)
    for lo, lt in zip(lines_o, lines_t):
        no, nt = NUMBER.findall(lo), NUMBER.findall(lt)
        assert len(no) == len(nt) and no, (lo, lt)
        for a, b in zip(no, nt):
            if lo.startswith("gap["):
                if "e" in a:
                    assert float(a) <= GAP_BAR and float(b) <= GAP_BAR, (lo,
                                                                         lt)
                continue
            if re.fullmatch(r"-?\d+", a):
                assert a == b, (lo, lt)
                continue
            digits = len(a.split(".")[1].split("e")[0]) if "." in a else 0
            scale = 10.0 ** int(a.split("e")[1]) if "e" in a else 1.0
            assert abs(float(a) - float(b)) <= scale * 10.0 ** -digits, (lo,
                                                                         lt)


@pytest.mark.parametrize("script", [
    "torch_t00_basic_tutorial.py", "torch_t01_time_varying.py",
    "torch_t02_plain_c.py", "torch_t03_real_systems.py",
    "torch_t04_dev_solver_versions.py"])
def test_examples_run(script, tmp_path):
    """Each example exits 0 on the CPU (t02 needs no device); t00, t01, t03
    and t04 print the JAX example's numbers."""
    args = () if "plain_c" in script else ("--device", "cpu")
    ref = None
    if script.split("_")[1] in SAME_NUMBERS:
        # the JAX example at once, in a directory of its own
        (tmp_path / "jax").mkdir()
        ref = _start(script[len("torch_"):], tmp_path / "jax",
                     JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    rc, out, err = _finish(_start(script, tmp_path, *args))
    ref = ref and _finish(ref)
    assert rc == 0, (out, err)
    if ref is not None:
        assert ref[0] == 0, ref
        _same_numbers(out, ref[1])


@pytest.mark.parametrize("script", SOLVER_EXAMPLES)
def test_example_needs_a_card(script, tmp_path):
    """Without a card and without --device cpu an example fails (make_solver
    raises), with no fallback to the CPU."""
    rc, out, err = _finish(_start(script, tmp_path, CUDA_VISIBLE_DEVICES=""))
    assert rc != 0
    assert "RuntimeError" in err and 'device="cpu"' in err
    assert out == ""
