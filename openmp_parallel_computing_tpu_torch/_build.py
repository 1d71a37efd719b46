"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/torch_kernels/lib<name>-<hash>.so`` (the hash is of the
source, of every ``csrc`` header it includes and of the flags, so an
edited kernel or header rebuilds and a cached one is reused). The
build happens at first use, never at import. Flags: ``sm_90a``, ``-O3``,
no fast math (the Sobel's floor(sqrt) must be exact), and ``-Xptxas -v``
so the register and spill report of every kernel is kept in
``lib<name>-<hash>.log`` beside the library.

The wrappers reach ``csrc/`` only through here: an ``Entry`` a C entry
point, the device gate ``on_card``, and ``Entry.launch``, which counts
each launch in the metrics registry as ``launch.<kernel>``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from openmp_parallel_computing_tpu_torch.utils.metrics import registry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# Every declared entry point, by symbol (filled as the wrappers' modules
# are imported).
DECLARED: dict[str, "Entry"] = {}


def nvcc_path() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(cand)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    directly or through another header, in a fixed order."""
    found: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def _target(name: str) -> tuple[Path, Path]:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()[:12]
    stem = BUILD_DIR / f"lib{name}-{digest}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless it is built already.
    Returns ``(process, tmp_path, so_path, log_path, log_file)``, or None
    when the library exists."""
    so, log = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    logf = open(log, "w")
    try:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
    except OSError:
        logf.close()
        raise
    return proc, tmp, so, log, logf


def _finish(name: str, job) -> None:
    proc, tmp, so, log, logf = job
    try:
        rc = proc.wait()
    finally:
        logf.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {rc}):\n{log.read_text()}")
    os.replace(tmp, so)


def build(*names: str) -> dict[str, str]:
    """Compile the named kernels (all of ``csrc/*.cu`` when none are
    named), in parallel nvcc processes. Returns each kernel's ptxas
    report (empty for one that was already built)."""
    names = names or tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return {n: _target(n)[1].read_text() if _target(n)[1].exists() else ""
            for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build(name)
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)[0]))
        return _libs[name]


def on_card(t: torch.Tensor, what: str) -> bool:
    """The device gate of every kernel wrapper: False for a CPU tensor (the
    plain version runs), True for a CUDA tensor (the kernel launches);
    ``ValueError`` naming the kernel ``what`` on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cuda"


def launch_counts(*kernels: str) -> dict[str, int]:
    """The registry's ``launch.<kernel>`` counters of ``kernels``, 0 for a
    kernel never launched: read before and after a run, their difference
    is the run's launches."""
    counters = registry.snapshot()["counters"]
    return {k: int(counters.get("launch." + k, 0)) for k in kernels}


class Entry:
    """A C entry point of ``csrc/<lib>.cu``: its symbol and argument types
    (for a launch, the trailing stream included), declared once at module
    level. Its library is built and the symbol resolved at the first call,
    never at import; it returns an int (a ``cudaError_t`` for a launch)."""

    __slots__ = ("lib", "symbol", "argtypes", "kernel")

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib, self.symbol, self.argtypes = lib, symbol, tuple(argtypes)
        self.kernel = symbol.removesuffix("_launch")
        DECLARED[symbol] = self

    def _fn(self) -> ctypes._CFuncPtr:
        fn = getattr(_libs.get(self.lib) or load(self.lib), self.symbol)
        if fn.argtypes is None:           # the library's first use
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        return fn

    def __call__(self, *args) -> int:
        """A host query (``<kernel>_smem_bytes``): no stream, not counted."""
        return self._fn()(*args)

    def launch(self, tensor: torch.Tensor, *args,
               kernel: str | None = None) -> None:
        """Launch on ``tensor``'s card and its current stream (appended to
        ``args``); raise ``RuntimeError`` on a CUDA error, else count one
        ``launch.<kernel>`` (the symbol less ``_launch`` unless given)."""
        fn = self._fn()
        with torch.cuda.device(tensor.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        kernel = kernel or self.kernel
        if err:
            raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                               f"{err}")
        registry.inc("launch." + kernel)

