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
import functools
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


# The head dims of the fixed-width instances; every head dim past the last
# runs in the wide instance (runtime depth and 512-column slices), whose
# host tables are keyed WIDE_INSTANCE: the smallest head dim it runs.
KERNEL_INSTANCES = (64, 128, 256, 512)
WIDE_INSTANCE = KERNEL_INSTANCES[-1] + 1
# The attention kernels' input types and their dtype codes (the C entry
# points' `dtype`, hopper.cuh's DtypeCode): fp32 is rounded to bf16 on the
# way in and written as fp32 (the TPU's matrix unit reads fp32 at bf16
# precision by default).
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def kernel_head_dim(d: int) -> int:
    """The key D_i of the kernel instance that runs head dim ``d``: the
    smallest of 64, 128, 256 and 512 that holds it, whose tiles are D_i
    wide (the columns past ``d`` read as zeros and are not written); or,
    for d > 512, ``WIDE_INSTANCE`` (513): the one wide instance, which
    counts its 64-column depth boxes and its 512-column output slices at
    run time.
    Host tables keyed on a head dim (the forward's, dQ's and dK/dV's tiles)
    key on D_i. (The forward, dQ and dK/dV compute d 65-96 in narrow
    instances of 80 and 96 columns that walk the 128 instance's tiles, so
    their tables key on 128 too: :func:`instance_of`.) Raises ValueError
    for d < 1."""
    d = int(d)
    if d < 1:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernels: "
                         "they take head_dim >= 1")
    return next((i for i in KERNEL_INSTANCES if d <= i), WIDE_INSTANCE)


# The split kernels' workspace (the split decode's, dK/dV's split key
# blocks'), per (device, stream): fp32 scratch for the partials (each launch
# writes what it reads) and the arrival counters, zeroed once and left zero
# by every launch (a unit's last piece resets its own); with their sizes
# and pointers. Launches on one stream run in order, so they share it; a
# warmed call allocates nothing.
_WORKSPACE: dict = {}


def workspace(device, stream: int, n_part: int, n_units: int):
    """The pointers of the workspace of ``device``'s ``stream``, grown to
    ``n_part`` floats and ``n_units`` counters where smaller."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[2] < n_part or ws[3] < n_units:
        part, counters = ws[:2] if ws is not None else (None, None)
        if part is None or part.numel() < n_part:
            part = torch.empty(max(n_part, 1 << 16), dtype=torch.float32,
                               device=device)
        if counters is None or counters.numel() < n_units:
            counters = torch.zeros(max(n_units, 1024), dtype=torch.int32,
                                   device=device)
        ws = (part, counters, part.numel(), counters.numel(),
              part.data_ptr(), counters.data_ptr())
        _WORKSPACE[key] = ws
    return ws[4], ws[5]


def padded_head_dim(d: int, elem_bytes: int = 2) -> int:
    """``d`` rounded up to whole 16-byte rows of ``elem_bytes`` elements:
    TMA's global strides and the decode kernel's cp.async rows are
    multiples of 16 bytes (8 bf16/fp16 elements, 16 int8 codes, 4 fp32)."""
    per = 16 // elem_bytes
    return -(-int(d) // per) * per


def pad_head_dim(t: torch.Tensor, d_pad: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``d_pad`` (itself if equal)."""
    if t.shape[-1] == d_pad:
        return t
    return torch.nn.functional.pad(t, (0, d_pad - t.shape[-1]))


def check_attention_inputs(q, k, v, s_aux) -> None:
    """What the attention kernels take: q/k/v of one type among bf16, fp16
    and fp32, any head_dim >= 1 (:func:`kernel_head_dim`), every input on
    one device."""
    if (q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(
            f"the CUDA attention kernels take q/k/v of one type among bf16, "
            f"fp16 and fp32, got {q.dtype}, {k.dtype}, {v.dtype}")
    kernel_head_dim(q.shape[-1])
    devs = {t.device for t in (q, k, v)}
    if s_aux is not None:
        devs.add(s_aux.device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def kernel_operands(*ts: torch.Tensor):
    """(operands, dtype code, padded head dim) of the attention kernels'
    16-bit inputs: each tensor rounded to bf16 if fp32, its head dim
    zero-padded to a multiple of 8 (:func:`padded_head_dim`), contiguous
    and 16-byte aligned. The padding is a copy, as the JAX package's
    ``_prep`` pads outside its kernels; the caller counts it (its
    ``padded_copies``) and slices its outputs back to the head dim."""
    code = KERNEL_DTYPES[ts[0].dtype]
    d_pad = padded_head_dim(ts[0].shape[-1])
    ops = []
    for t in ts:
        if t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        ops.append(aligned(pad_head_dim(t, d_pad)))
    return ops, code, d_pad


@functools.lru_cache(maxsize=None)
def instance_of(source: str, entry: str, d: int) -> int:
    """The instance head dim that runs (padded) head dim ``d``, as the
    library of ``csrc/<source>.cu`` reports it through its ``entry``
    (``sink_fwd_instance``, ``sink_dq_instance``, ...): the kernels own the
    rule (the forward, dQ and dK/dV run D 65-80 and 81-96 in their narrow
    80 and 96 instances; 513 is the wide instance)."""
    fn = getattr(load(source), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return int(fn(int(d)))


def note_launch(wrapper, head_dim: int, dtype: torch.dtype, padded: bool,
                instance: int) -> None:
    """Count one launch on ``wrapper``: ``launches``, the (head_dim, dtype)
    pairs it has run (``coverage``, kept for the process), the (head_dim,
    instance) pairs (``instances``: the instance as the library reports
    it, :func:`instance_of`) and, where the operands were padded to whole
    16-byte rows, ``padded_copies``."""
    wrapper.launches += 1
    wrapper.coverage.add((int(head_dim), str(dtype).replace("torch.", "")))
    wrapper.instances.add((int(head_dim), int(instance)))
    if padded:
        wrapper.padded_copies += 1


def counters(wrapper):
    """Give ``wrapper`` its zeroed ``launches`` and ``padded_copies`` and
    an empty ``coverage`` and ``instances``; returns it."""
    wrapper.launches = 0
    wrapper.padded_copies = 0
    wrapper.coverage = set()
    wrapper.instances = set()
    return wrapper
