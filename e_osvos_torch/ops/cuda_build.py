"""Build and load the port's hand-written CUDA sources.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/e_osvos_torch_kernels/``,
named by the hash of its source and flags, then loaded with ctypes. The
compiler's report (registers, shared memory, spills) is kept beside the
library as ``<name>_<hash>.log``. A missing ``nvcc`` or a failed build raises.

``build_all`` starts one ``nvcc`` per source at once and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "e_osvos_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _target(name: str, extra_flags: Sequence[str]) -> Tuple[Path, Tuple[str, ...]]:
    flags = NVCC_FLAGS + tuple(extra_flags)
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so", flags


def _start(name: str, extra_flags: Sequence[str]
           ) -> Optional[Tuple[Path, str, list, subprocess.Popen]]:
    out, flags = _target(name, extra_flags)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *flags, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, tmp, cmd, proc


def _finish(out: Path, tmp: str, cmd: list, proc: subprocess.Popen) -> None:
    stdout, stderr = proc.communicate()
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout + stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{cmd[-1]}:\n{stderr}")
    os.replace(tmp, out)


def build_all(targets: Iterable[Tuple[str, Sequence[str]]]) -> Dict[str, Path]:
    """Compile every ``(name, extra_flags)`` not built yet, all at once;
    returns each name's library path."""
    targets = list(targets)
    running = [_start(name, flags) for name, flags in targets]
    errors = []
    for job in running:
        if job is not None:
            try:
                _finish(*job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _target(name, flags)[0] for name, flags in targets}


def build(name: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` if its hash is not built yet; returns the
    shared library's path."""
    return build_all([(name, extra_flags)])[name]


def load(name: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, loaded; the
    caller keeps it."""
    return ctypes.CDLL(str(build(name, extra_flags)))


def is_cpu(*tensors) -> bool:
    """True for CPU tensors (a wrapper then computes its plain twin), False
    for CUDA tensors (it launches its kernel); raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")
    return False


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
