"""The nearest-neighbour kernels K1, K2 and K3, each beside its plain version.

Counterparts of `icra20_hand_object_pose_tpu/ops/knn_pallas.py`:

  - K1 `nn_gather_batched` (`make_corr_fn`): for each particle p and query
    point s, the nearest reference point by exact FP32 squared distance, its
    first minimal index, and the matched point and normal at that index;
  - K2 `nn_batched` (`make_nn_fn`): the same search without the gather;
  - K3 `nn_gn_batched` (`make_gn_fn`): the K1 search of an anchored scene
    against anchored posed model clouds, the correspondence gates of
    `icp.correspondence_weights`, and the point-to-plane normal equations
    (H, g, sum w, support hits, sum w r^2) per particle.

Two versions of each function live here:

  - `nn_gather_plain`, `nn_plain`, `nn_gn_plain`: plain PyTorch, built on a
    dense [P,Ns,Nm] difference-square distance tensor and `argmin`. The CPU
    path, and the reference each CUDA kernel is held against on the card.
  - the CUDA kernels in `csrc/` (`nn_gather.cu` holds K1 and K2, `nn_gn.cu`
    K3), built with nvcc for sm_90a into one library in the package's
    `build/` directory at first use and bound with ctypes. They keep the
    distance matrix out of device memory (see the source notes).

Each wrapper picks by device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. There is no fallback from one to the
other. `<wrapper>.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import icp

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def nn_plain(query: torch.Tensor, ref: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: query [1|P,Ns,3], ref [P,Nm,3] -> (idx [P,Ns]
    int32, d2 [P,Ns]). The same operations as the kernels (r - q, then
    dx*dx + dy*dy + dz*dz in FP32), so d2 agrees bitwise; `argmin` keeps the
    first minimal index."""
    dx = ref[:, None, :, 0] - query[:, :, None, 0]
    dy = ref[:, None, :, 1] - query[:, :, None, 1]
    dz = ref[:, None, :, 2] - query[:, :, None, 2]
    d2_all = dx * dx + dy * dy + dz * dz                      # [P,Ns,Nm]
    idx = torch.argmin(d2_all, dim=-1)                        # [P,Ns]
    d2 = torch.gather(d2_all, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), d2


def nn_gather_plain(
    query: torch.Tensor,        # [1|P, Ns, 3]
    ref_pts: torch.Tensor,      # [P, Nm, 3]
    ref_normals: torch.Tensor,  # [P, Nm, 3]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: (matched [P,Ns,3], mnormal [P,Ns,3], d2 [P,Ns],
    idx [P,Ns] int32): `nn_plain`, then a gather at the index."""
    idx, d2 = nn_plain(query, ref_pts)
    sel = idx.to(torch.int64)[..., None].expand(-1, -1, 3)
    matched = torch.gather(ref_pts, 1, sel)
    mnormal = torch.gather(ref_normals, 1, sel)
    return matched, mnormal, d2, idx


def nn_gn_plain(
    scene_c: torch.Tensor,        # [Ns,3] anchored scene points
    scene_normals: torch.Tensor,  # [Ns,3] (zeros allowed)
    scene_w: torch.Tensor,        # [Ns] weights (0 = padding)
    ref_c: torch.Tensor,          # [P,Nm,3] anchored posed model points
    ref_normals: torch.Tensor,    # [P,Nm,3] posed model normals
    *,
    maxd2: float,
    min_cos: float,
    tau2: float = 0.0,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch K3: (H [P,6,6], g [P,6], wsum [P], hits [P], wrr [P]).
    The K1 plain version, then `icp.correspondence_weights`, then the
    einsum build of the point-to-plane normal equations."""
    m, n, d2, _ = nn_gather_plain(scene_c[None], ref_c, ref_normals)
    w = icp.correspondence_weights(d2, scene_normals[None], n, scene_w[None],
                                   math.sqrt(maxd2), min_cos)   # [P,Ns]
    r = torch.sum(n * (scene_c[None] - m), dim=-1)
    J = torch.cat([torch.linalg.cross(m, n), n], dim=-1)       # [P,Ns,6]
    wJ = J * w[..., None]
    H = torch.einsum("pni,pnj->pij", wJ, J)
    g = torch.einsum("pni,pn->pi", wJ, r)
    hits = torch.sum(scene_w[None] * (d2 < tau2), dim=-1)
    return H, g, torch.sum(w, dim=-1), hits, torch.sum(w * r * r, dim=-1)


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _compile_and_link(lib_path: Path) -> str:
    """One nvcc per source, all started together, then one link into
    `lib_path`. Returns the compilers' output (with -Xptxas -v's register
    and spill report)."""
    nvcc = _nvcc()
    tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp_dir / (src.stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = tmp_dir / lib_path.name
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib_path.name}:\n{log}")
        os.replace(tmp_lib, lib_path)
        return log
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile every `csrc/*.cu` into one library (once per content of all
    sources) and load it. Returns (library, compiler log). Raises if nvcc
    fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"knn_kernels_{h.hexdigest()[:12]}.so"
    log = "" if lib_path.exists() else _compile_and_link(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nn_gather_launch.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.nn_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.nn_gn_launch.argtypes = [ptr] * 11 + [i32] * 3 + [f32] * 3 + [ptr]
    lib.nn_gn_query_tile.argtypes = []
    for fn in (lib.nn_gather_launch, lib.nn_launch, lib.nn_gn_launch,
               lib.nn_gn_query_tile):
        fn.restype = i32
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


def _route(kernel: str, device: torch.device, **sizes: int) -> bool:
    """True for a CUDA launch, False for the plain version on the CPU."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CPU or CUDA tensors, not {device}")
    if min(sizes.values()) <= 0:
        raise ValueError(f"{kernel}: empty input {sizes}")
    return True


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {err}")


def _batched_shapes(query: torch.Tensor, ref: torch.Tensor):
    if query.dim() != 3 or ref.dim() != 3:
        raise ValueError("query and ref must be [B, N, 3]")
    Pq, Ns, _ = query.shape
    P, Nm, _ = ref.shape
    if Pq not in (1, P):
        raise ValueError(f"query batch {Pq} incompatible with ref batch {P}")
    return Pq, Ns, P, Nm


def nn_gather_batched(
    query: torch.Tensor,        # [1|P, Ns, 3] float32
    ref_pts: torch.Tensor,      # [P, Nm, 3] float32
    ref_normals: torch.Tensor,  # [P, Nm, 3] float32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1, fused NN + correspondence gather: returns
    (matched [P,Ns,3], mnormal [P,Ns,3], d2 [P,Ns], idx [P,Ns] int32).

    A query with leading dim 1 is shared by every particle (the ICP case:
    one scene, P posed models). CPU tensors take `nn_gather_plain`; CUDA
    tensors launch the kernel."""
    Pq, Ns, P, Nm = _batched_shapes(query, ref_pts)
    device = ref_pts.device
    if not _route("K1", device, P=P, Ns=Ns, Nm=Nm):
        return nn_gather_plain(query, ref_pts, ref_normals)
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
    _raise_on(err, "nn_gather")
    nn_gather_batched.launches += 1
    return matched, mnormal, d2, idx


nn_gather_batched.launches = 0


def nn_batched(
    query: torch.Tensor,  # [1|P, Ns, 3] float32
    ref: torch.Tensor,    # [P, Nm, 3] float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2, NN only: returns (idx [P,Ns] int32, d2 [P,Ns]). A query with
    leading dim 1 is shared by every particle. CPU tensors take `nn_plain`;
    CUDA tensors launch the kernel."""
    Pq, Ns, P, Nm = _batched_shapes(query, ref)
    device = ref.device
    if not _route("K2", device, P=P, Ns=Ns, Nm=Nm):
        return nn_plain(query, ref)
    _check("query", query, (Pq, Ns, 3), torch.float32, device)
    _check("ref", ref, (P, Nm, 3), torch.float32, device)
    lib, _ = build()
    d2 = torch.empty((P, Ns), dtype=torch.float32, device=device)
    idx = torch.empty((P, Ns), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nn_launch(query.data_ptr(), ref.data_ptr(), d2.data_ptr(),
                            idx.data_ptr(), P, Pq, Ns, Nm, stream)
    _raise_on(err, "nn")
    nn_batched.launches += 1
    return idx, d2


nn_batched.launches = 0


def nn_gn_batched(
    scene_c: torch.Tensor,        # [Ns,3] float32
    scene_normals: torch.Tensor,  # [Ns,3]
    scene_w: torch.Tensor,        # [Ns]
    ref_c: torch.Tensor,          # [P,Nm,3]
    ref_normals: torch.Tensor,    # [P,Nm,3]
    *,
    maxd2: float,
    min_cos: float,
    tau2: float = 0.0,
) -> tuple[torch.Tensor, ...]:
    """K3, fused NN search + correspondence gates + normal equations:
    returns (H [P,6,6], g [P,6], wsum [P], hits [P], wrr [P]). CPU tensors
    take `nn_gn_plain`; CUDA tensors launch the kernel (two launches on
    the stream: the per-tile sums, then their sum in tile order)."""
    if scene_c.dim() != 2 or ref_c.dim() != 3:
        raise ValueError("scene_c must be [Ns,3] and ref_c [P,Nm,3]")
    Ns, P, Nm = scene_c.shape[0], ref_c.shape[0], ref_c.shape[1]
    device = ref_c.device
    if not _route("K3", device, P=P, Ns=Ns, Nm=Nm):
        return nn_gn_plain(scene_c, scene_normals, scene_w, ref_c, ref_normals,
                           maxd2=maxd2, min_cos=min_cos, tau2=tau2)
    f32 = torch.float32
    _check("scene_c", scene_c, (Ns, 3), f32, device)
    _check("scene_normals", scene_normals, (Ns, 3), f32, device)
    _check("scene_w", scene_w, (Ns,), f32, device)
    _check("ref_c", ref_c, (P, Nm, 3), f32, device)
    _check("ref_normals", ref_normals, (P, Nm, 3), f32, device)
    lib, _ = build()
    n_tiles = -(-Ns // lib.nn_gn_query_tile())
    partial = torch.empty((P, n_tiles, 30), dtype=f32, device=device)
    H = torch.empty((P, 6, 6), dtype=f32, device=device)
    g = torch.empty((P, 6), dtype=f32, device=device)
    wsum, hits, wrr = (torch.empty((P,), dtype=f32, device=device)
                       for _ in range(3))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nn_gn_launch(
            scene_c.data_ptr(), scene_normals.data_ptr(), scene_w.data_ptr(),
            ref_c.data_ptr(), ref_normals.data_ptr(), partial.data_ptr(),
            H.data_ptr(), g.data_ptr(), wsum.data_ptr(), hits.data_ptr(),
            wrr.data_ptr(), P, Ns, Nm, float(maxd2), float(min_cos),
            float(tau2), stream,
        )
    _raise_on(err, "nn_gn")
    nn_gn_batched.launches += 1
    return H, g, wsum, hits, wrr


nn_gn_batched.launches = 0


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


def make_nn_fn():
    """An `nn_fn(query, ref) -> (idx, d2)` drop-in for ops/icp.py, backed by
    K2. Takes [Ns,3] x [Nm,3] (-> [Ns]), [Ns,3] x [P,Nm,3] (a shared scene,
    -> [P,Ns]) and [P,Ns,3] x [P,Nm,3]."""

    def nn_fn(query, ref):
        if query.dim() == 2 and ref.dim() == 2:
            idx, d2 = nn_batched(query[None].contiguous(), ref[None].contiguous())
            return idx[0], d2[0]
        q = query[None] if query.dim() == 2 else query
        return nn_batched(q.contiguous(), ref.contiguous())

    return nn_fn


def make_gn_fn(*, maxd2: float, min_cos: float, tau2: float = 0.0):
    """A `gn_fn(scene_c, scene_normals, scene_w, ref_c [P,Nm,3],
    ref_normals) -> (H, g, wsum, hits, wrr)` drop-in for
    ops/icp.icp_batched(..., gn_fn=...), backed by K3. The gates are baked
    in and exposed as attributes, so icp_batched can check them against its
    own arguments."""

    def gn_fn(scene_c, scene_normals, scene_w, ref_c, ref_normals):
        return nn_gn_batched(
            scene_c.contiguous(), scene_normals.contiguous(),
            scene_w.contiguous(), ref_c.contiguous(), ref_normals.contiguous(),
            maxd2=maxd2, min_cos=min_cos, tau2=tau2,
        )

    gn_fn.maxd2 = float(maxd2)
    gn_fn.min_cos = float(min_cos)
    gn_fn.tau2 = float(tau2)
    return gn_fn
