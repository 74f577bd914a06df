"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

plus the source's own flags in :data:`SOURCE_FLAGS`.  The library name
carries a hash of the source and its flags, so an edited source rebuilds
on its next use and a stale library is never loaded.  The
build directory lives inside the package and is listed in ``.gitignore``.
A failed build raises with the compiler's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# No --use_fast_math: __expf / tanh.approx would break the 1e-6 fp32 bar.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: Flags of one source on top of NVCC_FLAGS.  The fusion kernel must round
#: every float64 product on its own, as the C++ core on the CPU does: nvcc
#: contracts ``a * b + c`` into an FMA by default, which moves masks near a
#: threshold.
SOURCE_FLAGS = {"fusion_core.cu": ("-fmad=false",)}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels cannot be built"
    )


def _flags(source: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_flags(source)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _start(source: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *_flags(source), "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, out


def _finish(source: str, job) -> None:
    proc, tmp, out = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{source}:\n{err}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(sources: list[str] | None = None) -> list[Path]:
    """Build every source (default: all of ``csrc/*.cu``), one nvcc process
    per source, all started together.  Returns the library paths."""
    if sources is None:
        sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    jobs = {s: _start(s) for s in sources}
    try:
        for source, job in jobs.items():
            if job is not None:
                _finish(source, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return [library_path(s) for s in sources]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            (path,) = build_all([source])
            lib = ctypes.CDLL(str(path))
            _loaded[source] = lib
        return lib
