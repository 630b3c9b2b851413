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


def _wgmma_wrappers():
    """(name, asm body) of each function in hopper.cuh that issues a
    ``wgmma.mma_async``."""
    text = (CSRC / "hopper.cuh").read_text()
    found = re.finditer(r"void (\w+)\([^{;]*\)\s*\{\s*asm volatile\((.*?)\);\n\}", text, re.S)
    return [(m.group(1), m.group(2)) for m in found if "wgmma.mma_async" in m.group(2)]


WGMMA = _wgmma_wrappers()


@pytest.mark.parametrize("name,body", WGMMA, ids=[n for n, _ in WGMMA])
def test_wgmma_operands_are_numbered_in_order(name, body):
    """An inline-asm operand numbered wrong compiles and computes garbage:
    the accumulators are %0.. in order, one per f32 of the m64nN tile, and
    the template reads every input after them in order, the predicate's
    last.  bf16 products are k16 deep, tf32 ones k8; both take a register
    A fragment of 4 registers a thread."""
    template, outs, ins = re.split(r"\n\s*:", body)
    template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', template))
    acc = [int(i) for i in re.findall(r'"\+f"\(d\[(\d+)\]\)', outs)]
    n_in = len(re.findall(r'"[rl]"\(', ins))
    shape = re.search(r"\.m64n(\d+)k(\d+)\.f32\.(\w+)\.(\w+) ", template)
    n, k, ta, tb = int(shape.group(1)), int(shape.group(2)), shape.group(3), shape.group(4)
    assert (ta, tb, k) in (("bf16", "bf16", 16), ("tf32", "tf32", 8)), name
    assert acc == list(range(n // 2))
    braces = re.search(ta + r" \{([^}]*)\}", template)
    assert [int(i) for i in re.findall(r"%(\d+)", braces.group(1))] == acc
    rest = [int(i) for i in re.findall(r"%(\d+)", template[braces.end():])]
    assert rest == sorted(rest), name    # A, B, ... in the order they are bound
    used = {int(i) for i in re.findall(r"%(\d+)", template)}
    assert used == set(range(len(acc) + n_in)), name
    assert re.search(r"setp\.ne\.b32 p, %(\d+)", template).group(1) == str(len(acc) + n_in - 1)
    if ta == "tf32":    # scale-a and scale-b only: tf32 has no transpose bits
        assert re.search(r", p, 1, 1;", template), name


BF16_WGMMA = [(n, b) for n, b in WGMMA if ".f32.bf16.bf16 " in b]


@pytest.mark.parametrize("name,body", BF16_WGMMA, ids=[n for n, _ in BF16_WGMMA])
def test_bf16_wgmma_transpose_bit_follows_the_name(name, body):
    """A bf16 product's last immediate is tnspB (after scale-d, the two
    scales and, from shared memory, tnspA): set in the ``_tb`` wrappers,
    which read B MN-major (V for O += P V, K^T for S = Q K^T), clear in the
    others.  A wrong bit compiles and multiplies by the transpose."""
    template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', re.split(r"\n\s*:", body)[0]))
    imm = re.search(r", p((?:, [01])+);", template).group(1).split(", ")[1:]
    from_smem = not re.search(r"\{%\d+, %\d+, %\d+, %\d+\}, %\d+, p", template)
    assert imm[:2] == ["1", "1"] and len(imm) == (4 if from_smem else 3), name
    if from_smem:
        assert imm[2] == "0", name         # A K-major
    assert imm[-1] == ("1" if name.endswith("_tb") else "0"), name


def _includes(name, seen=None):
    """The ``#include "..."`` files of a csrc file, transitively."""
    seen = set() if seen is None else seen
    for inc in re.findall(r'^#include "([^"]+)"', (CSRC / name).read_text(), re.M):
        if inc not in seen:
            seen.add(inc)
            _includes(inc, seen)
    return seen


@pytest.mark.parametrize("lib", list(KERNELS))
def test_kernel_headers_are_every_include_of_the_source(lib):
    """``_so_path`` hashes the source and the listed headers only: a header
    left out of the tuple leaves a stale library on the card after it
    changes."""
    source, headers, _ = KERNELS[lib]
    assert len(set(headers)) == len(headers)
    assert set(headers) == _includes(source)
