"""Each C entry point's declaration (``_build.Entry``) against its
``extern "C"`` prototype in ``csrc/``, on the CPU: the library it is
declared in, the count of its arguments and the kind of each (``int`` ->
``c_int``, ``float`` -> ``c_float``, ``long long`` -> ``c_longlong``, any
pointer -> ``c_void_p``), the launches' trailing ``void* stream``
included. One case for every symbol of ``csrc/`` and every declared one,
so that a symbol left undeclared, or declared but absent, fails too."""

import ctypes
import re

import pytest

from openmp_parallel_computing_tpu_torch import _build
# The modules that declare the entry points.
from openmp_parallel_computing_tpu_torch.models.mpc import (  # noqa: F401
    riccati_lanes, sampler, sweep)
from openmp_parallel_computing_tpu_torch.ops import (  # noqa: F401
    conv, grayscale, pipeline, reductions, sobel)

_PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
_KINDS = {"int": ctypes.c_int, "float": ctypes.c_float,
          "long long": ctypes.c_longlong}


def _kind(param: str):
    """The ctypes type of one C parameter declaration."""
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split() if w != "const"][:-1]   # less the name
    return _KINDS[" ".join(words)]


def _prototypes() -> dict:
    """``{symbol: (library stem, [ctypes type, ...])}`` of ``csrc/*.cu``."""
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for symbol, params in _PROTOTYPE.findall(path.read_text()):
            out[symbol] = (path.stem, [_kind(p) for p in params.split(",")])
    return out


PROTOTYPES = _prototypes()
SYMBOLS = sorted(set(PROTOTYPES) | set(_build.DECLARED))


@pytest.mark.parametrize("symbol", SYMBOLS)
def test_declaration_matches_the_prototype(symbol):
    assert symbol in PROTOTYPES, f"{symbol} is declared but not in csrc/"
    assert symbol in _build.DECLARED, f"{symbol} of csrc/ is not declared"
    lib, kinds = PROTOTYPES[symbol]
    entry = _build.DECLARED[symbol]
    assert entry.lib == lib
    assert list(entry.argtypes) == kinds
    if symbol.endswith("_launch"):
        assert kinds[-1] is ctypes.c_void_p        # the stream
    else:
        assert symbol.endswith("_smem_bytes")      # a query, not counted
