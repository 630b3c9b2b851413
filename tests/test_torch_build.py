"""The ctypes binding of the port's CUDA kernels against their C sources.

The sources compile only on a machine with ``nvcc``, and a ctypes call with
the wrong argument list is not refused: it passes garbage.  So each C entry
point that ``ops/build.py:KERNELS`` binds is parsed from its ``csrc`` source
here, and its parameter types are held against the ctypes argtypes, one by
one.  Needs no card.
"""
import ctypes
import pathlib
import re

import pytest

from pianobart_tpu_torch.ops.build import KERNELS

CSRC = pathlib.Path(__file__).resolve().parents[1] / "pianobart_tpu_torch" / "csrc"
C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "ll": ctypes.c_longlong,
           "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "uint32_t": ctypes.c_uint32}
ENTRIES = [(lib, entry) for lib, (_, _, entries) in KERNELS.items()
           for entry in entries]


def _c_params(source, entry):
    """Parameter types of ``extern "C" int entry(...)``, with the source's
    ``#define`` parameter lists expanded."""
    text = (CSRC / source).read_text()
    macros = {m.group(1): m.group(2).replace("\\\n", " ")
              for m in re.finditer(r"#define (\w+) ((?:.*\\\n)*.*)", text)}
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, f"{entry} not found in {source}"
    params = []
    for p in (x.strip() for x in m.group(1).split(",")):
        if p in macros:
            params += [x.strip() for x in macros[p].split(",")]
        else:
            params.append(p)
    types = []
    for p in params:
        t = re.sub(r"\bconst\b", "", p.rsplit(" ", 1)[0] if "*" not in p
                   else p[:p.index("*") + 1]).replace(" ", "")
        types.append(C_TYPES[{"longlong": "long long"}.get(t, t)])
    return types


@pytest.mark.parametrize("lib,entry", ENTRIES, ids=[e for _, e in ENTRIES])
def test_argtypes_match_the_c_entry(lib, entry):
    source, headers, entries = KERNELS[lib]
    assert all((CSRC / f).exists() for f in (source,) + headers)
    assert entries[entry] == _c_params(source, entry)
