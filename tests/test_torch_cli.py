"""The port's command line, `python -m spcies_tpu_torch`, against the JAX
package's: ports of tests/test_api_misc.py:72-111
(test_cli_version_root_help, test_cli_gen_demo,
test_cli_declare_license_install) as processes; the bytes of `gen --demo`
and `declare` against spcies_tpu.__main__.main run in this process into
another directory (both with one BLAS thread: the offline ingredients'
last bits depend on BLAS's threads); the subcommand table, the help topics
of docs_torch/, and what `test` hands pytest (pytest.main replaced: the
suite is never run from inside the suite)."""

import os
import subprocess
import sys as _sys
from pathlib import Path

import pytest
from threadpoolctl import threadpool_limits

import spcies_tpu.__main__ as jcli
import spcies_tpu_torch as tsp
import spcies_tpu_torch.__main__ as tcli

ROOT = Path(__file__).resolve().parent.parent
TOPICS = sorted(p.stem for p in (ROOT / "docs").glob("*.md"))
# gen --demo of each demo-fixture family (spcies_tpu/__main__.py:90-115);
# the first two also as processes
GEN_TRIPLES = [("laxMPC", "", ""), ("MPCT", "ADMM", "cs"),
               ("equMPC", "FISTA", ""), ("ellipMPC", "ADMM", "soc"),
               ("HMPC", "ADMM", "split"), ("ellipHMPC", "ADMM", "")]


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """One BLAS thread in this process, as in the CLI processes
    (OPENBLAS_NUM_THREADS=1), so that both generators round alike."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
                OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")


def _run_cli(*args, cwd=None):
    return subprocess.run([_sys.executable, "-m", "spcies_tpu_torch", *args],
                          capture_output=True, text=True, cwd=cwd,
                          env=_env(), timeout=300)


def _gen_args(f, m, s, directory):
    return ["gen", "--demo", "--formulation", f, "--method", m,
            "--submethod", s, "--directory", str(directory)]


def _same_sources(a: Path, b: Path):
    """Every .c and .h of directory b exists in a with the same bytes."""
    names = sorted(p.name for p in b.iterdir() if p.suffix in (".c", ".h"))
    assert names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


def test_cli_version_root_help():
    """tests/test_api_misc.py:78-88."""
    out = _run_cli("version")
    assert out.returncode == 0 and tsp.__version__ in out.stdout
    out = _run_cli("root")
    assert out.returncode == 0
    assert out.stdout.strip() == str(ROOT / "spcies_tpu_torch")
    out = _run_cli("help")
    assert out.returncode == 0 and "help topics" in out.stdout
    out = _run_cli("help", "codegen")
    assert out.returncode == 0 and "generate_c_solver" in out.stdout
    out = _run_cli("help", "nonexistent_topic")
    assert out.returncode == 1
    assert "no such help topic" in out.stdout and "  codegen" in out.stdout


def test_cli_gen_demo(tmp_path):
    """tests/test_api_misc.py:91-101, and the bytes of the JAX CLI's
    gen --demo for the same arguments."""
    out = _run_cli("gen", "--demo", "--directory", str(tmp_path / "g"),
                   "--rho", "15.0")
    assert out.returncode == 0, out.stderr
    assert os.path.exists(tmp_path / "g" / "laxmpc_admm.c")
    assert os.path.exists(tmp_path / "g" / "liblaxmpc_admm.so")
    out = _run_cli("gen", "--demo", "--formulation", "MPCT",
                   "--method", "ADMM", "--submethod", "cs",
                   "--directory", str(tmp_path / "g"))
    assert out.returncode == 0, out.stderr
    assert os.path.exists(tmp_path / "g" / "mpct_admm_cs.c")
    assert jcli.main(["gen", "--demo", "--directory",
                      str(tmp_path / "j"), "--rho", "15.0"]) == 0
    assert jcli.main(_gen_args("MPCT", "ADMM", "cs", tmp_path / "j")) == 0
    assert _same_sources(tmp_path / "g", tmp_path / "j") == [
        "laxmpc_admm.c", "laxmpc_admm.h", "mpct_admm_cs.c", "mpct_admm_cs.h"]


@pytest.mark.parametrize("triple", GEN_TRIPLES[2:],
                         ids=lambda t: "-".join(p for p in t if p))
def test_cli_gen_demo_bytes(triple, tmp_path, capsys):
    """gen --demo of the other demo-fixture families, both CLIs in this
    process: the same .c and .h."""
    assert tcli.main(_gen_args(*triple, tmp_path / "t")) == 0
    assert jcli.main(_gen_args(*triple, tmp_path / "j")) == 0
    assert len(_same_sources(tmp_path / "t", tmp_path / "j")) == 2
    assert "generated" in capsys.readouterr().out


def test_cli_gen_options_and_refusal(tmp_path, capsys):
    """--rho, --tol, --k-max and --save-name reach the generator as in the
    JAX CLI; without --demo both refuse with exit 1."""
    extra = ["--rho", "3.5", "--tol", "1e-6", "--k-max", "777",
             "--save-name", "custom"]
    assert tcli.main(_gen_args("laxMPC", "ADMM", "", tmp_path / "t")
                     + extra) == 0
    assert jcli.main(_gen_args("laxMPC", "ADMM", "", tmp_path / "j")
                     + extra) == 0
    assert _same_sources(tmp_path / "t", tmp_path / "j") == ["custom.c",
                                                             "custom.h"]
    assert "777" in (tmp_path / "t" / "custom.c").read_text()
    assert tcli.main(["gen"]) == 1
    assert "only --demo" in capsys.readouterr().out


def test_cli_declare_license_install(tmp_path):
    """tests/test_api_misc.py:104-111, and the bytes of the JAX CLI's
    declare for a vector and a scalar."""
    out = _run_cli("declare", "KVEC", "1.0,2.0", str(tmp_path / "t"))
    assert out.returncode == 0, out.stderr
    txt = open(tmp_path / "t" / "KVEC_declaration.txt").read()
    assert "static const double KVEC[2]" in txt
    out = _run_cli("declare", "RHO", "15.5", str(tmp_path / "t"))
    assert out.returncode == 0, out.stderr
    for args in (["KVEC", "1.0,2.0"], ["RHO", "15.5"]):
        assert jcli.main(["declare", *args, str(tmp_path / "j")]) == 0
    for name in ("KVEC_declaration.txt", "RHO_declaration.txt"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    out = _run_cli("license")
    assert out.returncode == 0 and "Apache License" in out.stdout
    for cmd in ("install", "uninstall"):
        out = _run_cli(cmd)
        assert out.returncode == 0 and "pip" in out.stdout
    out = _run_cli("install")
    assert f"pip install -e {ROOT}[torch]" in out.stdout
    assert "pip uninstall spcies_tpu" in _run_cli("uninstall").stdout


def test_cli_commands_and_usage(capsys):
    """The same subcommands and aliases as the JAX CLI; no argument prints
    the usage and exits 0, an unknown subcommand exits 1; declare without
    values exits 1."""
    assert set(tcli.COMMANDS) == set(jcli.COMMANDS)
    assert tcli.main([]) == 0
    assert "python -m spcies_tpu_torch gen" in capsys.readouterr().out
    assert tcli.main(["bogus"]) == 1
    assert tcli.main(["declare", "ONLY_NAME"]) == 1
    assert tcli.main(["v"]) == 0 and tcli.main(["h"]) == 0
    assert tsp.__version__ in capsys.readouterr().out


def test_cli_clear(tmp_path, capsys):
    """clear removes a generated directory, as the JAX CLI's does."""
    d = tmp_path / "g"
    assert tcli.main(_gen_args("laxMPC", "", "", d)) == 0
    assert (d / "laxmpc_admm.c").exists()
    assert tcli.main(["clear", str(d)]) == 0
    assert not d.exists()
    assert "cleared" in capsys.readouterr().out


@pytest.mark.parametrize("topic", TOPICS)
def test_cli_help_topics(topic, capsys):
    """Every help topic of docs/ has its port in docs_torch/, listed in
    topics.md, and `help <topic>` prints it."""
    assert tcli.main(["help", topic]) == 0
    text = capsys.readouterr().out
    assert text.strip() == (ROOT / "docs_torch" / f"{topic}.md").read_text(
        ).strip()
    if topic != "topics":
        topics = (ROOT / "docs_torch" / "topics.md").read_text()
        assert f"`{topic}`" in topics


def test_cli_help_topics_match():
    """docs_torch/ holds the topics of docs/ and no other."""
    port = sorted(p.stem for p in (ROOT / "docs_torch").glob("*.md"))
    assert port == TOPICS and len(TOPICS) == 14


def test_cli_test_runs_the_port_tests(monkeypatch):
    """`test` hands pytest the port's test files alone, then -q and the
    extra arguments, and returns pytest's exit code."""
    seen = []

    def fake_main(args):
        seen.append(list(args))
        return 7

    monkeypatch.setattr(pytest, "main", fake_main)
    assert tcli.main(["test", "-k", "cli", "-x"]) == 7
    (args,) = seen
    files = sorted(str(p) for p in (ROOT / "tests").glob("test_torch_*.py"))
    assert args == [*files, "-q", "-k", "cli", "-x"]
    assert all(Path(a).name.startswith("test_torch_") for a in args[:-4])
    assert str(ROOT / "tests" / "test_api_misc.py") not in args
