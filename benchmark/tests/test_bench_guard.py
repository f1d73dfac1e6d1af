"""The import check compares top-level names whole, and nothing a run
loads is JAX or the JAX package."""

import subprocess
import sys

from harness.guard import forbidden_loaded
from harness.spec import BENCH, ROOT


def test_top_level_names_compared_whole():
    assert forbidden_loaded(["spcies_tpu_torch", "spcies_tpu_torch.api",
                             "numpy"]) == []
    assert forbidden_loaded(["spcies_tpu.api"]) == ["spcies_tpu"]
    assert forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert forbidden_loaded(["jaxtyping", "flaxx"]) == []


def test_a_run_loads_no_jax():
    """A fresh process that imports every module a run imports, and the
    program, holds none of the forbidden names."""
    code = (
        "import sys, runpy\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import torch, spcies_tpu_torch\n"
        "from spcies_tpu_torch.runtime import closed_loop_rollout\n"
        "from spcies_tpu_torch.kernels import fused_admm, fused_split\n"
        "from harness import runner, drivers, trace, compare\n"
        "from harness.spec import load_module, BENCH\n"
        "for kind in ('reference', 'work', 'metrics'):\n"
        "    for p in sorted((BENCH / kind).glob('*.py')):\n"
        "        if p.stem != '__init__': load_module(kind, p.stem)\n"
        "runpy.run_path(str(BENCH / 'run.py'), run_name='not_main')\n"
        "from harness.guard import forbidden_loaded\n"
        "print('FOUND', forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout, out.stdout
