"""CLI verdicts on the committed real-structure matrices.

VERDICT/SURVEY parity: the reference harness's whole purpose is running
SuiteSparse ``.mtx`` files through the sample binaries
(``/root/reference/README.md:30-37``).  The committed fixtures are real
constructions (a P1 FEM stiffness matrix on an unstructured Delaunay
triangulation of an annulus, an L-shaped-domain 5-point Laplacian, a
zipf-degree circuit-class matrix), not the synthetic generators; networked
environments can additionally pull true SuiteSparse matrices through
``nsparse_jax.io.suitesparse.fetch``.
"""

import os

import pytest

from nsparse_jax import cli

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

FIXTURES = ["fem_annulus.mtx", "lshape_laplace.mtx", "circuit_zipf.mtx"]


@pytest.mark.parametrize("name", FIXTURES)
def test_cli_spmv_verdict(name, capsys):
    rc = cli.main(
        ["--precision", "double", "spmv", os.path.join(DATA, name),
         "--trials", "2"]
    )
    out = capsys.readouterr().out
    assert rc in (0, None) and "pass" in out, out


@pytest.mark.parametrize("name", ["fem_annulus.mtx", "lshape_laplace.mtx"])
def test_cli_spgemm_verdict(name, capsys):
    rc = cli.main(
        ["--precision", "double", "spgemm", os.path.join(DATA, name),
         "--trials", "2"]
    )
    out = capsys.readouterr().out
    assert rc in (0, None) and "pass" in out, out
