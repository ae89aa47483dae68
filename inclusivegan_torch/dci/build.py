"""Build the port's host C++ libraries with ``g++`` at first use.

``build_dci_lib`` compiles ``csrc/dci.cpp`` and ``csrc/dci_c.cpp`` into
``libdci.so``; ``data/datakit.py`` builds ``libdatakit.so`` through
``build_library`` too. Each library goes to ``build/<name>/<key>/`` at the
root of the checkout, next to the CUDA library's ``build/torch_kernels/``,
where ``key`` hashes the sources, the flags and ``g++ --version``: a library
built from other sources is never loaded. ``g++`` writes to a temporary name
that ``os.replace`` moves into place, so that a build that is killed leaves
nothing half-written. A failed build raises; there is no fallback.
"""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
CSRC = Path(__file__).resolve().parent / "csrc"
DCI_SOURCES = ("dci.cpp", "dci_c.cpp")
DCI_HEADERS = ("dci.hpp",)
DCI_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp", "-march=native",
             "-funroll-loops")


def build_library(name: str, sources: Sequence[Path], headers: Sequence[Path],
                  flags: Sequence[str], verbose: bool = False) -> Path:
    """Compile ``sources`` into ``build/<name>/<key>/lib<name>.so`` unless a
    library built from the same sources, headers, flags and compiler exists;
    return its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: lib{name} cannot be built")
    version = subprocess.run([gxx, "--version"], check=True, capture_output=True,
                             text=True).stdout
    h = hashlib.sha256()
    for src in (*headers, *sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(version.encode())
    out_dir = BUILD_ROOT / name / h.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
    inc = sorted({str(s.parent) for s in (*headers, *sources)})
    cmd = [gxx, *flags, *(str(s) for s in sources),
           *(a for d in inc for a in ("-I", d)), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if verbose or proc.returncode != 0:
        print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}")
    os.replace(tmp, lib)
    return lib


def build_dci_lib(verbose: bool = False) -> Path:
    """Path of ``libdci.so``, built from ``csrc/`` if needed."""
    return build_library("dci", [CSRC / s for s in DCI_SOURCES],
                         [CSRC / s for s in DCI_HEADERS], DCI_FLAGS, verbose)
