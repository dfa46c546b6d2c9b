"""Builds the port's CUDA sources with plain ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each library is named by a hash of its source and flags, in ``build/`` at
the checkout root (listed in ``.gitignore``), so a changed source builds
anew and an unchanged one is reused.  :func:`build_many` starts one
``nvcc`` per missing library, all at once, and waits for all of them.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import time

#: kernel build directory (listed in .gitignore), at the checkout root
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"

#: flags every source is built with; ``-Xptxas -v`` reports registers,
#: shared memory and spills per kernel into the build log
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: what each build printed (nvcc/ptxas) and how long it took, by source name
BUILD_LOG: dict[str, dict] = {}


def lib_path(source: pathlib.Path, flags: tuple[str, ...],
             build_dir: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:12]
    return build_dir / f"{source.stem}-{digest}.so"


def build_many(jobs: list[tuple[pathlib.Path, tuple[str, ...], pathlib.Path]],
               force: bool = False) -> list[pathlib.Path]:
    """Compile each ``(source, flags, build_dir)`` whose library is missing
    (or every one, with ``force``), one ``nvcc`` process per source, all
    started together.  Returns the libraries' paths; raises if ``nvcc`` is
    missing or any compile fails."""
    paths = [lib_path(src, flags, bdir) for src, flags, bdir in jobs]
    todo = [(job, path) for job, path in zip(jobs, paths)
            if force or not path.exists()]
    if not todo:
        return paths
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    running = []
    t0 = time.perf_counter()
    for (src, flags, bdir), path in todo:
        bdir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *flags, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, path, tmp, proc))
    failed = []
    for src, path, tmp, proc in running:
        out, _ = proc.communicate()
        BUILD_LOG[src.stem] = {"seconds": time.perf_counter() - t0,
                               "output": out}
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                          f"{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths
