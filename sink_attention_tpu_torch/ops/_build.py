"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``, with
the shared headers ``csrc/*.cuh``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries go to ``build/kernels/`` at the
root of the checkout, named by a hash of the sources and flags, so a changed
source is rebuilt and an unchanged one is loaded as it is. All sources are
compiled at once, one ``nvcc`` process each, on the first call of
:func:`load`. A failed build raises with the compiler's output; there is no
fallback.

Every C entry point takes pointers and the stream as ``void*``, sizes as
``int`` and returns ``cudaGetLastError()`` of its launch; :func:`check`
raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_fwd", "flash_bwd", "packed", "decode", "ablation")

_libs: Dict[str, ctypes.CDLL] = {}
# What the last build printed: {name: {"seconds": s, "ptxas": [lines]}}.
build_report: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from source on the machine with the card")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(log: str) -> List[str]:
    """ptxas' lines of each kernel: its name, registers, and its stack frame
    and spills (a line of its own, without the "ptxas info" prefix)."""
    return [ln.strip() for ln in log.splitlines()
            if ("ptxas info" in ln and ("registers" in ln
                                        or "Compiling entry" in ln))
            or "spill" in ln]


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library; returns paths.

    The compilers run in parallel. Raises RuntimeError naming each source
    that failed, with its compiler output.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths, procs = {}, {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = BUILD_DIR / f"lib{name}_{_digest(name)}.so"
        paths[name] = out
        if out.exists():
            build_report[name] = {"seconds": 0.0, "cached": True,
                                  "ptxas": []}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_report[name] = {"seconds": time.perf_counter() - t0,
                              "cached": False, "ptxas": _ptxas_lines(log)}
        if proc.returncode != 0:
            errors.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    if name not in _libs:
        paths = build_all()
        for n, p in paths.items():
            _libs.setdefault(n, ctypes.CDLL(str(p)))
    return _libs[name]


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


KERNEL_HEAD_DIMS = (64, 128)


def check_attention_inputs(q, k, v, s_aux) -> None:
    """What both attention kernels take: bf16 q/k/v, head_dim 64 or 128,
    every input on one device."""
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the CUDA attention kernels take bf16 q/k/v, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not supported by the CUDA "
                         f"kernels (supported: {KERNEL_HEAD_DIMS})")
    devs = {t.device for t in (q, k, v)}
    if s_aux is not None:
        devs.add(s_aux.device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
