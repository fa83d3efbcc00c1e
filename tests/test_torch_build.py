"""The port's CUDA sources against ``build.py``'s table of launch entries.

Runs on the CPU (nothing is compiled): every ``<name>_launch`` in
``SIGNATURES`` must be defined as ``extern "C" int <name>_launch(`` in
exactly one ``csrc/*.cu``, namely ``csrc/<name>.cu``, with the parameters
that its ctypes signature declares; and ``product_fold.cu`` no longer holds
``product_accum``'s entry, which has its own source.
"""

import ctypes
import re

import pytest

from repro_torch.kernels import build

SOURCES = sorted(build.CSRC.glob("*.cu"))
ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _entries(source):
    """{entry name: its C parameter list} of the extern "C" functions."""
    return {name: params for name, params in ENTRY.findall(source.read_text())}


def _ctype(param):
    """The ctypes type a C parameter is passed as."""
    if "*" in param:
        return ctypes.c_void_p
    c_type = param.split()[-2]
    return {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}[c_type]


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_entry_is_defined_in_its_own_source(entry):
    owners = [src.name for src in SOURCES if entry in _entries(src)]
    assert owners == [entry[:-len("_launch")] + ".cu"]


@pytest.mark.parametrize("source", SOURCES, ids=lambda p: p.name)
def test_source_defines_only_its_own_entry(source):
    assert list(_entries(source)) == [source.stem + "_launch"]
    assert source.stem + "_launch" in build.SIGNATURES


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_ctypes_signature_matches_the_c_parameters(entry):
    source = build.CSRC / (entry[:-len("_launch")] + ".cu")
    params = [p.strip() for p in _entries(source)[entry].split(",")]
    assert tuple(_ctype(p) for p in params) == build.SIGNATURES[entry]


def test_product_accum_has_left_product_fold():
    assert list(_entries(build.CSRC / "product_fold.cu")) == [
        "product_fold_launch"]
    assert "product_accum_launch" in _entries(build.CSRC / "product_accum.cu")
    assert not hasattr(build, "SOURCE_OF")
