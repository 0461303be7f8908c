"""Fused nearest-neighbour + correspondence gather (kernel K1).

Counterpart of `icra20_hand_object_pose_tpu/ops/knn_pallas.py`'s
`nn_gather_batched` and `make_corr_fn`. For each particle p and query
point s: the nearest reference point by exact FP32 squared distance, its
first minimal index, and the matched point and normal at that index.

Two versions of the same function live here:

  - `nn_gather_plain`: plain PyTorch, a dense [P,Ns,Nm] difference-square
    distance tensor, `argmin` and `gather`. The CPU path, and the reference
    the CUDA kernel is held against on the card.
  - the CUDA kernel in `csrc/nn_gather.cu`, built with nvcc for sm_90a into
    the package's `build/` directory at first use and bound with ctypes.
    It keeps the distance matrix out of device memory (see the source note).

`nn_gather_batched` picks by device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise. There is no fallback from one to
the other. `nn_gather_batched.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "nn_gather.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nn_gather_plain(
    query: torch.Tensor,        # [1|P, Ns, 3]
    ref_pts: torch.Tensor,      # [P, Nm, 3]
    ref_normals: torch.Tensor,  # [P, Nm, 3]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: (matched [P,Ns,3], mnormal [P,Ns,3], d2 [P,Ns],
    idx [P,Ns] int32). The same operations as the kernel (r - q, then
    dx*dx + dy*dy + dz*dz in FP32), so d2 agrees bitwise; `argmin` keeps the
    first minimal index."""
    dx = ref_pts[:, None, :, 0] - query[:, :, None, 0]
    dy = ref_pts[:, None, :, 1] - query[:, :, None, 1]
    dz = ref_pts[:, None, :, 2] - query[:, :, None, 2]
    d2_all = dx * dx + dy * dy + dz * dz                      # [P,Ns,Nm]
    idx = torch.argmin(d2_all, dim=-1)                        # [P,Ns]
    d2 = torch.gather(d2_all, -1, idx[..., None])[..., 0]
    sel = idx[..., None].expand(-1, -1, 3)
    matched = torch.gather(ref_pts, 1, sel)
    mnormal = torch.gather(ref_normals, 1, sel)
    return matched, mnormal, d2, idx.to(torch.int32)


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the K1 kernel cannot be built")
    return found


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/nn_gather.cu` (once per source content) and load it.
    Returns (library, compiler log). Raises if nvcc fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"nn_gather_{tag}.so"
    log = ""
    if not lib_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                capture_output=True, text=True,
            )
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.nn_gather_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, log


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nn_gather_batched(
    query: torch.Tensor,        # [1|P, Ns, 3] float32
    ref_pts: torch.Tensor,      # [P, Nm, 3] float32
    ref_normals: torch.Tensor,  # [P, Nm, 3] float32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused NN + correspondence gather: returns
    (matched [P,Ns,3], mnormal [P,Ns,3], d2 [P,Ns], idx [P,Ns] int32).

    A query with leading dim 1 is shared by every particle (the ICP case:
    one scene, P posed models). CPU tensors take `nn_gather_plain`; CUDA
    tensors launch the kernel."""
    if query.dim() != 3 or ref_pts.dim() != 3:
        raise ValueError("query and ref_pts must be [B, N, 3]")
    Pq, Ns, _ = query.shape
    P, Nm, _ = ref_pts.shape
    if Pq not in (1, P):
        raise ValueError(f"query batch {Pq} incompatible with ref batch {P}")
    device = ref_pts.device
    if device.type == "cpu":
        return nn_gather_plain(query, ref_pts, ref_normals)
    if device.type != "cuda":
        raise ValueError(f"K1 runs on CPU or CUDA tensors, not {device}")
    if Ns == 0 or Nm == 0 or P == 0:
        raise ValueError(f"empty input: P={P}, Ns={Ns}, Nm={Nm}")
    _check("query", query, (Pq, Ns, 3), torch.float32, device)
    _check("ref_pts", ref_pts, (P, Nm, 3), torch.float32, device)
    _check("ref_normals", ref_normals, (P, Nm, 3), torch.float32, device)
    lib, _ = build()
    matched = torch.empty((P, Ns, 3), dtype=torch.float32, device=device)
    mnormal = torch.empty((P, Ns, 3), dtype=torch.float32, device=device)
    d2 = torch.empty((P, Ns), dtype=torch.float32, device=device)
    idx = torch.empty((P, Ns), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nn_gather_launch(
            query.data_ptr(), ref_pts.data_ptr(), ref_normals.data_ptr(),
            matched.data_ptr(), mnormal.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), P, Pq, Ns, Nm, stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_gather kernel launch failed: cudaError_t {err}")
    nn_gather_batched.launches += 1
    return matched, mnormal, d2, idx


nn_gather_batched.launches = 0


def make_corr_fn():
    """A `corr_fn(scene [Ns,3] or [P,Ns,3], posed_pts [P,Nm,3],
    posed_normals [P,Nm,3]) -> (matched, mnormal, d2, idx)` drop-in for
    ops/icp.py, backed by K1."""

    def corr_fn(scene_pts, posed_pts, posed_normals):
        q = scene_pts[None] if scene_pts.dim() == 2 else scene_pts
        return nn_gather_batched(
            q.contiguous(), posed_pts.contiguous(), posed_normals.contiguous()
        )

    return corr_fn
