"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which
``ctypes`` loads.  The build writes into ``_build/`` beside this file
(listed in ``.gitignore``); a library is named after the hash of its
source and of the headers beside it (``csrc/*.cuh``), so an edited source
or header is rebuilt and an unchanged one is reused.
All sources are compiled at once, one ``nvcc`` process each.

Nothing here runs at import: the first kernel launch, or an explicit
:func:`build_all`, starts the build.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels.")


def _library_path(source: Path) -> Path:
    """The library of ``source``, named after the hash of the source, every
    header of ``csrc/`` (which a source may include) and the flags."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(SOURCE_DIR.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel source not yet built, all
    ``nvcc`` processes started together.  Returns ``{name: ptxas log}`` for
    the sources compiled by this call; raises if any compile fails."""
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    if names is not None:
        sources = [s for s in sources if s.stem in names]
    todo = [(s, _library_path(s)) for s in sources
            if not _library_path(s).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in todo:
        # compile to a private name, then rename: a concurrent or cut build
        # never leaves a half-written library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        source = SOURCE_DIR / f"{name}.cu"
        if not source.exists():
            raise FileNotFoundError(f"no kernel source {source}")
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(_library_path(source)))
    return lib
