"""The port's CUDA sources ship with the package: every file that
kernels/_build.included_files reaches from each csrc/*.cu and
csrc/variants/*.cu (the source and the headers it includes) matches a glob
of pyproject.toml's package data for spcies_tpu_torch, as setuptools
expands them, so that an installed package can build every kernel."""

import tomllib
from pathlib import Path

import pytest

from spcies_tpu_torch.kernels import _build

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "spcies_tpu_torch"
SOURCES = sorted(p.relative_to(PKG).as_posix()
                 for p in [*PKG.glob("csrc/*.cu"), *PKG.glob("csrc/variants/*.cu")])


def shipped(pyproject: Path) -> set[Path]:
    """The files the package data's globs take from the package."""
    data = tomllib.loads(pyproject.read_text())
    globs = data["tool"]["setuptools"]["package-data"]["spcies_tpu_torch"]
    return {p.resolve() for g in globs for p in PKG.glob(g)}


@pytest.mark.parametrize("source", SOURCES)
def test_kernel_sources_ship(source):
    files = _build.included_files((PKG / source).resolve())
    missing = [f.relative_to(PKG).as_posix() for f in files
               if f not in shipped(ROOT / "pyproject.toml")]
    assert not missing, missing


def test_headers_are_included_and_sources_counted():
    """The seven kernels and the variants are all found, and the one
    header, the product stage, is reached from them."""
    assert len([s for s in SOURCES if "/variants/" not in s]) == 7
    reached = {f.name for s in SOURCES
               for f in _build.included_files((PKG / s).resolve())}
    assert {f for f in reached if f.endswith(".cuh")} == {"tile_product.cuh"}
