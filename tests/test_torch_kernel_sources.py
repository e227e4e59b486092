"""The CUDA sources read as text, without nvcc: every planted fault of the
fault tools still finds its anchor exactly once, and every ``extern "C"``
entry point takes the arguments ``_build.SIGNATURES`` binds with ctypes
(a mismatch would otherwise show only on the card, as a cut pointer or a
shifted argument)."""

import ctypes
import re

import pytest

from dstack_tpu_torch.ops import _build
from dstack_tpu_torch.tools import flash_faults, paged_decode_faults

FAULTS = [(name, src, edits)
          for name, (src, _, edits) in flash_faults.FAULTS.items()] + [
    (name, "paged_decode", edits)
    for name, (_, edits) in paged_decode_faults.FAULTS.items()]


@pytest.mark.parametrize("name,source,edits", FAULTS,
                         ids=[f"{s}:{n}" for n, s, _ in FAULTS])
def test_fault_anchor_occurs_once(name, source, edits):
    sound = (_build.CSRC / f"{source}.cu").read_text()
    planted = paged_decode_faults.planted_source(edits, source)
    assert (planted == sound) == (not edits), name
    for _, new in edits:
        assert new in planted


def test_flash_fault_sources_are_built_sources():
    assert {src for src, _, _ in flash_faults.FAULTS.values()} == set(
        flash_faults.SOURCES)
    assert set(flash_faults.SOURCES) <= set(_build.SIGNATURES)


#: C parameter type -> the ctypes type it must be bound as
_KINDS = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float, "longlong": ctypes.c_longlong}
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _entry_points(text: str):
    """{symbol: [ctypes type of each parameter]} of the source's C entry
    points (comments dropped, const ignored)."""
    text = re.sub(r"//[^\n]*", "", text)
    out = {}
    for symbol, params in _ENTRY.findall(text):
        kinds = []
        for param in params.split(","):
            words = param.replace("*", " * ").split()[:-1]  # drop the name
            ctype = "".join(w for w in words if w != "const")
            kinds.append(_KINDS[ctype])
        out[symbol] = kinds
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_point_matches_ctypes_signature(name):
    symbol, argtypes = _build.SIGNATURES[name]
    entries = _entry_points((_build.CSRC / f"{name}.cu").read_text())
    assert list(entries) == [symbol]
    assert entries[symbol] == list(argtypes)


def test_every_source_has_a_signature():
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(
        _build.SIGNATURES)


def test_entry_point_parser_reads_pointer_int_float():
    text = ('// extern "C" int commented(int a);\n'
            'extern "C" int f(const void* p, void *q, int n, float x,\n'
            '                 long long m, void* stream) {')
    assert _entry_points(text) == {"f": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_longlong, ctypes.c_void_p]}
