"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``kernels/_build/`` (listed in ``.gitignore``) under a name that
carries a digest of the source, of every ``csrc`` header it includes
(``hopper.cuh``) and of the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Sources are compiled in
parallel, one ``nvcc`` each, at first use -- never at import.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("paged_decode", "mpgemm", "quant_matmul", "limb_gemm",
           "ssd_intra", "ssd_intra_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel of the port did not build, load or launch.  The serving
    engine's step watchdog lets it propagate (it never retries it or
    fails requests for it): a broken kernel is a fault of the program,
    not of a request."""


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, the default
    toolkit location, or ``nvcc`` on PATH)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the port's CUDA kernels are "
                          "built on a machine with the CUDA toolkit")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc`` it includes,
    directly or through another header, in the order first reached."""
    order, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in order:
            continue
        order.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return order


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES, *, ptxas_info: bool = False) -> dict[str, str]:
    """Compile every named source whose library is missing, all in
    parallel, and wait for them.  Returns ``{name: compiler output}``
    (with ``ptxas_info`` the per-kernel register and shared-memory
    report).  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_info:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if ptxas_info:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)          # atomic: concurrent builders agree
    if failed:
        raise KernelError("nvcc failed for " + ", ".join(failed) + "\n"
                          + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures: dict[str, tuple[list, object]]
         ) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use), with
    ``argtypes``/``restype`` declared for each function in
    ``signatures``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                build([name])
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise KernelError(f"cannot load {name}: {e}") from e
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


class LaunchCounter:
    """Number of kernel launches a wrapper made (``reset`` before a run,
    read ``count`` after it)."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def check_launch(rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code (a launch
    the driver refused never runs, and no later synchronize reports it)."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")
