"""The nearest-neighbour kernels K1, K2 and K3, the Gauss-Newton kernel K4 and
the scoring kernels K5 and K6, each beside its plain version.

Counterparts of `icra20_hand_object_pose_tpu/ops/knn_pallas.py`:

  - K1 `nn_gather_batched` (`make_corr_fn`): for each particle p and query
    point s, the nearest point of its object's model cloud posed by its pose,
    by exact FP32 squared distance, its first minimal index, and the matched
    point and normal (posed) at that index; the kernel poses the cloud
    itself, bitwise as `se3.transform_points` / `rotate_vectors` do;
  - K2 `nn_batched` (`make_nn_fn`): the same search without the gather;
  - K3 `nn_gn_batched` (`make_gn_fn`): the K1 search of an anchored scene
    against anchored posed model clouds, the correspondence gates of
    `icp.correspondence_weights`, and the point-to-plane normal equations
    (H, g, sum w, support hits, sum w r^2) per particle;
  - K4 `gn_iterate_batched`, which replaces no TPU kernel: what an ICP
    iteration does after its search (`icp.gn_iterate_plain`: the gates, the
    `gn_reps` damped solves, pose updates and re-posed pairs), one block
    per particle;
  - K5 `splat_compare_batched`, which replaces no TPU kernel either: the
    pixel-mode scorer (`ScoreConfig(mode="pixel")`), each particle's samples
    splatted into a z-buffer, min-filtered and compared with the observed
    depth pixel by pixel, one block per particle, without a [P,H,W] image;
  - K6 `project_compare_batched`, which replaces no TPU kernel either: the
    point-mode scorer (`score.compare_points` on the samples posed by each
    particle), one block per particle, without an [O,P,N] tensor.

Two versions of each function live here:

  - `nn_gather_plain`, `nn_plain`, `nn_gn_plain`: plain PyTorch, built on a
    dense [P,Ns,Nm] difference-square distance tensor and `argmin`;
    `icp.gn_iterate_plain`; `splat_compare_plain`, the ATen pair
    `render.splat_depth_batched` + `score.compare_depth`; and
    `project_compare_plain`, se3's posing + `score.compare_points`. The CPU
    path, and the reference each CUDA kernel is held against on the card.
  - the CUDA kernels in `csrc/` (`nn_gather.cu` holds K1 and K2, `nn_gn.cu`
    K3, `gn_iterate.cu` K4, `splat_compare.cu` K5, `project_compare.cu`
    K6), built with nvcc for sm_90a into one library in the package's
    `build/` directory at first use and bound with ctypes. They keep the
    distance matrix (K5: the rendered images, K6: the posed samples) out
    of device memory (see the source notes).

The query of K1/K2 and the scene of K3 come in B blocks, B any divisor of
the particle count P: particle p takes block p // (P // B). B = 1 is one
scene for every particle, B = P one per particle, and anything between one
scene per group of particles: a library of O objects with P/O particles
each, searched in one launch (parallel/sharding.py). K1's model clouds come
likewise, one for all particles or one per object of [O,P] poses.

Each wrapper picks by device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. There is no fallback from one to the
other. `KERNELS` declares each C entry point once (tests hold it to the
prototypes in `csrc/`): `build` binds them from it, and `launch` calls one
with its arguments by name and counts the launch by wrapper and shape (K1,
K2: (P, Pq, Ns, Nm); K3: (P, G, Ns, Nm); K4: (O*P, O, Ns); K5: (P, Nr, H,
W); K6: (P, N, H, W, rule, subpixel)), once per replay if a CUDA graph
recorded it (utils/profiling.py); `launch_counts` reads the counts.
Adding a kernel takes a `.cu` file, one `KERNELS` entry, and one wrapper
beside its plain version.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from ..utils import profiling, se3
from . import icp, render, score

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Launch plans (csrc/nn_search.cuh): a block is `groups` groups of `width`
# threads (at most MAX_GROUPS), each thread owns `q` queries. Chosen from
# device-time sweeps of the main-path shapes (`chip_smoke.py --sweep`) on an
# H100 with SMS streaming multiprocessors:
#   - where one block per tile of 4 x WIDTH queries gives 2 blocks per SM,
#     that is the plan (K1/K2 in-scan, K3 tracked and init scans);
#   - else K1/K2 take tiles of SMALL_WIDTH queries, split the reference
#     cloud over MAX_GROUPS groups (fewer while a group would get under
#     MIN_RANGE points) and give each thread 2 queries where a group's range
#     is under MIN_PAIRS points, 1 where it is longer;
#   - and K3 takes 1 scene point per thread, splits the model cloud over
#     GN_GROUPS groups where each keeps GN_MIN_RANGE points, and the scene
#     over up to MAX_SCENE_SPLIT blocks per particle.
WIDTH = 128
SMALL_WIDTH = 64
MAX_GROUPS = 4
SMS = 132
MIN_RANGE = 32
MIN_PAIRS = 128
GN_GROUPS = 2
GN_MIN_RANGE = 128
MAX_SCENE_SPLIT = 8


class Plan(NamedTuple):
    """How a kernel covers (P, Ns, Nm); see `nn_plan` and `gn_plan`."""

    q: int            # queries (scene points) per thread: 1, 2 or 4
    groups: int       # groups of a block, each sweeping 1/groups of the reference
    scene_split: int  # K3: blocks per particle that split the scene (K1/K2: 1)
    width: int = WIDTH  # threads per group (K1/K2: 64 or 128; K3: 128)


def _grouped(t: torch.Tensor, B: int) -> torch.Tensor:
    """[P, ...] -> [B, P // B, ...]: the particles beside their block."""
    return t.reshape((B, t.shape[0] // B) + tuple(t.shape[1:]))


def nn_plain(query: torch.Tensor, ref: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: query [Pq,Ns,3] (Pq a divisor of P), ref [P,Nm,3]
    -> (idx [P,Ns] int32, d2 [P,Ns]). The same operations as the kernels
    (r - q, then dx*dx + dy*dy + dz*dz in FP32), so d2 agrees bitwise;
    `argmin` keeps the first minimal index."""
    P, Nm = ref.shape[:2]
    Pq, Ns = query.shape[:2]
    r = _grouped(ref, Pq)[:, :, None]                         # [Pq,P/Pq,1,Nm,3]
    q = query[:, None, :, None]                               # [Pq,1,Ns,1,3]
    dx = r[..., 0] - q[..., 0]
    dy = r[..., 1] - q[..., 1]
    dz = r[..., 2] - q[..., 2]
    d2_all = (dx * dx + dy * dy + dz * dz).reshape(P, Ns, Nm)
    idx = torch.argmin(d2_all, dim=-1)                        # [P,Ns]
    d2 = torch.gather(d2_all, -1, idx[..., None])[..., 0]
    return idx.to(torch.int32), d2


def nn_gather_plain(
    query: torch.Tensor,        # [Pq, Ns, 3], Pq a divisor of P
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
    scene_c: torch.Tensor,        # [Ns,3] or [G,Ns,3] anchored scene points
    scene_normals: torch.Tensor,  # [Ns,3] or [G,Ns,3] (zeros allowed)
    scene_w: torch.Tensor,        # [Ns] or [G,Ns] weights (0 = padding)
    ref_c: torch.Tensor,          # [P,Nm,3] anchored posed model points
    ref_normals: torch.Tensor,    # [P,Nm,3] posed model normals
    *,
    maxd2: float,
    min_cos: float,
    tau2: float = 0.0,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch K3: (H [P,6,6], g [P,6], wsum [P], hits [P], wrr [P]).
    The K1 plain version, then `icp.correspondence_weights`, then the
    einsum build of the point-to-plane normal equations. With G scenes,
    particle p is matched against scene p // (P // G)."""
    if scene_c.dim() == 2:
        scene_c, scene_normals, scene_w = scene_c[None], scene_normals[None], scene_w[None]
    G, P = scene_c.shape[0], ref_c.shape[0]
    m, n, d2, _ = nn_gather_plain(scene_c, ref_c, ref_normals)

    def per_particle(t):                                       # [G,Ns,..] -> [P,Ns,..]
        return t[:, None].expand((G, P // G) + tuple(t.shape[1:])).reshape(
            (P,) + tuple(t.shape[1:]))

    sc, sn, sw = map(per_particle, (scene_c, scene_normals, scene_w))
    w = icp.correspondence_weights(d2, sn, n, sw, math.sqrt(maxd2), min_cos)  # [P,Ns]
    r = torch.sum(n * (sc - m), dim=-1)
    J = torch.cat([torch.linalg.cross(m, n), n], dim=-1)       # [P,Ns,6]
    wJ = J * w[..., None]
    H = torch.einsum("pni,pnj->pij", wJ, J)
    g = torch.einsum("pni,pn->pi", wJ, r)
    hits = torch.sum(sw * (d2 < tau2), dim=-1)
    return H, g, torch.sum(w, dim=-1), hits, torch.sum(w * r * r, dim=-1)


def _tiles(Ns: int, q: int, width: int = WIDTH) -> int:
    """Query tiles of q * width queries that cover Ns (the kernels' grid)."""
    return -(-Ns // (q * width))


@functools.lru_cache(maxsize=256)
def nn_plan(P: int, Ns: int, Nm: int) -> Plan:
    """K1/K2's launch plan; the kernel runs one block per tile of
    q * width queries of a particle."""
    if P * _tiles(Ns, 4) >= 2 * SMS:
        return Plan(4, 1, 1)
    groups = MAX_GROUPS
    while groups > 1 and -(-Nm // groups) < MIN_RANGE:
        groups //= 2
    q = 2 if -(-Nm // groups) < MIN_PAIRS else 1
    return Plan(q, groups, 1, SMALL_WIDTH)


@functools.lru_cache(maxsize=256)
def gn_plan(P: int, Ns: int, Nm: int) -> Plan:
    """K3's launch plan; the kernel runs `scene_split` blocks per particle,
    each walking the scene in chunks of scene_split * q * WIDTH points."""
    if P * _tiles(Ns, 4) >= 2 * SMS:
        return Plan(4, 1, 1)
    groups = GN_GROUPS if Nm >= GN_GROUPS * GN_MIN_RANGE else 1
    split = max(1, min(MAX_SCENE_SPLIT, _tiles(Ns, 1), -(-2 * SMS // P)))
    return Plan(1, groups, split)


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_name(csrc: Path = CSRC) -> str:
    """The library's file name: a hash of the nvcc flags and of every
    `*.cu` and `*.cuh` in `csrc`, so an edit to a header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return f"knn_kernels_{h.hexdigest()[:12]}.so"


def _compile_and_link(lib_path: Path) -> str:
    """One nvcc per `*.cu` source (the headers are included, not compiled
    alone), all started together, then one link into `lib_path`. Returns the
    compilers' output (with -Xptxas -v's register and spill report)."""
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp_dir / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
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


PTR, INT, LONG, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Kernel(NamedTuple):
    """One C entry point of `csrc/`."""

    name: str     # its wrapper's name, under which its launches are counted
    symbol: str   # the C function
    args: tuple   # (name, ctypes type) in the prototype's order, the stream last


def _kernel(name: str, symbol: str, *runs) -> Kernel:
    """A `Kernel` from runs of (ctypes type, the names of consecutive
    arguments of that type), the stream appended."""
    args = tuple((arg, ty) for ty, names in runs for arg in names.split())
    return Kernel(name, symbol, args + (("stream", PTR),))


K1 = _kernel("nn_gather_batched", "nn_gather_launch",
             (PTR, "query poses model_pts model_nrm matched mnormal d2 idx"),
             (LONG, "obj_stride"),
             (INT, "P Pq Ns Nm pts_div q width S"))
K2 = _kernel("nn_batched", "nn_launch",
             (PTR, "query ref_pts d2 idx"),
             (INT, "P Pq Ns Nm q width S"))
K3 = _kernel("nn_gn_batched", "nn_gn_launch",
             (PTR, "scene scene_nrm scene_w ref ref_nrm H g wsum hits wrr partial arrived"),
             (INT, "P G Ns Nm q S scene_split"),
             (FLOAT, "maxd2 min_cos tau2"))
K4 = _kernel("gn_iterate_batched", "gn_iterate_launch",
             (PTR, "poses frozen matched mnormal d2 scene_c scene_nrm scene_w anchor wsum "
                   "poses_out frozen_out rmse inliers support"),
             (INT, "O P Gn Ns reps"),
             (FLOAT, "maxd2 min_cos damping step_scale tol2 tau2"))
K5 = _kernel("splat_compare_batched", "splat_compare_launch",
             (PTR, "pts w obs valid enc hand n_obs fitness coverage support counted"),
             (INT, "rows Nr H W r w_div img_div hand_div"),
             (FLOAT, "fx fy cx cy tau pen inv_pen margin"))
K6 = _kernel("project_compare_batched", "project_compare_launch",
             (PTR, "poses pts nrm enc hand mask pv0 pu0 fitness coverage support counted"),
             (LONG, "obj_stride mask_stride"),
             (INT, "rows N H W rule subpixel pts_div img_div hand_div mask_div patch_div "
                   "size exempt"),
             (FLOAT, "fx fy cx cy tau inv_tau edge_tau pen inv_pen margin count_floor"))
KERNELS = (K1, K2, K3, K4, K5, K6)


@functools.cache
def build() -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/` into one library (once per content of its sources
    and headers), load it and bind each entry point of `KERNELS`. Returns
    (library, compiler log). Raises if nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / library_name()
    log = "" if lib_path.exists() else _compile_and_link(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for kernel in KERNELS:
        fn = getattr(lib, kernel.symbol)
        fn.argtypes = [ty for _, ty in kernel.args]
        fn.restype = INT
    return lib, log


def _check(device: torch.device, *specs) -> None:
    """One pass over (name, tensor, shape, dtype) specs: raises on the first
    tensor that is not on `device`, of `dtype`, of `shape` and contiguous."""
    for name, t, shape, dtype in specs:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.shape != shape:
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


def launch(kernel: Kernel, device: torch.device, shape: tuple, /, **args) -> None:
    """Launches `kernel` on `device`'s current stream with `args`, every
    declared argument by name (a tensor passes its data pointer, None a
    null pointer); raises if a name is missing or not declared, or if the
    launch failed. Counts the launch under (kernel.name, shape)."""
    names = [name for name, _ in kernel.args[:-1]]
    if args.keys() != set(names):
        raise TypeError(f"{kernel.symbol}: missing {sorted(set(names) - args.keys())}, "
                        f"not declared {sorted(args.keys() - set(names))}")
    _call(kernel, device, [v.data_ptr() if isinstance(v, torch.Tensor) else v
                           for v in map(args.__getitem__, names)])
    profiling.launched(kernel.name, shape)


def _call(kernel: Kernel, device: torch.device, values: list) -> None:
    """Calls the kernel's C entry point with `values` and the device's
    current stream, entering the device only when it is not the current
    one; raises if the launch failed."""
    fn = getattr(build()[0], kernel.symbol)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*values, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*values, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} kernel launch failed: cudaError_t {err}")


_ARRIVED: dict[torch.device, torch.Tensor] = {}


def _arrival_counts(device: torch.device, P: int) -> torch.Tensor:
    """K3's per-particle arrival counters on `device`: zero between launches
    (the kernel resets what it counts), made once and grown when P does.
    Shared by every eager K3 launch on the device, so those launches must
    not overlap: the port issues them on one stream. A launch captured into
    a CUDA graph gets counters of its own from the graph's pool instead:
    the shared tensor is replaced, and the old one freed, when a larger P
    appears, while a graph would go on writing the address it captured."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return torch.zeros((P,), dtype=torch.int32, device=device)
    counts = _ARRIVED.get(device)
    if counts is None or counts.numel() < P:
        counts = torch.zeros((max(P, 1024),), dtype=torch.int32, device=device)
        _ARRIVED[device] = counts
    return counts


def _batched_shapes(query: torch.Tensor, ref: torch.Tensor):
    if query.dim() != 3 or ref.dim() != 3:
        raise ValueError("query and ref must be [B, N, 3]")
    Pq, Ns, _ = query.shape
    P, Nm, _ = ref.shape
    if Pq < 1 or P % Pq:
        raise ValueError(f"query batch {Pq} does not divide ref batch {P}")
    return Pq, Ns, P, Nm


def nn_gather_batched(
    query: torch.Tensor,          # [Pq, Ns, 3] float32, Pq a divisor of P
    poses: torch.Tensor,          # [P,4,4] float32, or [O,P,4,4] for a library
    model_pts: torch.Tensor,      # [Nm,3], or [1|O,Nm,3]: model frame
    model_normals: torch.Tensor,  # as model_pts
    *,
    plan: Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1, posing + NN + correspondence gather: each particle's pose applied
    to its object's model cloud and normals, then searched. Returns (matched
    [...,Ns,3], mnormal [...,Ns,3], d2 [...,Ns], idx [...,Ns] int32) over
    the leading axes of `poses`.

    A query with leading dim 1 is shared by every particle (the ICP case:
    one scene, P poses); with leading dim Pq, particle p of the P (folded)
    searches query p // (P // Pq) (a library: one scene per object). With
    [O,P,4,4] poses, object o's particles take model cloud o (each cloud
    contiguous, the clouds at any stride: a slice of the points is read
    where it lies). CPU tensors take se3's posing and `nn_gather_plain`;
    CUDA tensors launch the kernel once with `plan` (default `nn_plan` of
    the folded shapes)."""
    lead = tuple(poses.shape[:-2])
    rows = math.prod(lead)
    if query.dim() != 3 or len(lead) not in (1, 2):
        raise ValueError("query must be [B, N, 3] and poses [P,4,4] or [O,P,4,4]")
    Pq, Ns, Nm = query.shape[0], query.shape[1], model_pts.shape[-2]
    if Pq < 1 or rows % Pq:
        raise ValueError(f"query batch {Pq} does not divide ref batch {rows}")
    device = poses.device
    if not _route("K1", device, P=rows, Ns=Ns, Nm=Nm):
        if len(lead) == 2 and model_pts.dim() == 3:   # each object's cloud beside its particles
            model_pts, model_normals = model_pts[:, None], model_normals[:, None]
        posed = se3.transform_points(poses, model_pts)
        posed_normals = se3.rotate_vectors(poses, model_normals)
        return _unfold(nn_gather_plain(query, _fold(posed), _fold(posed_normals)), poses)
    pts, n_obj, obj_stride = _object_rows(model_pts, 2, lead, "model_pts")
    nrm, n_nrm, nrm_stride = _object_rows(model_normals, 2, lead, "model_normals")
    if (n_nrm, nrm_stride) != (n_obj, obj_stride):
        pts, nrm = pts.contiguous(), nrm.contiguous()
        obj_stride = pts.stride(0) if n_obj > 1 else 0
    query, poses = query.contiguous(), poses.contiguous()
    f32 = torch.float32
    _check(device, ("query", query, (Pq, Ns, 3), f32),
           ("poses", poses, lead + (4, 4), f32),
           ("model_pts", pts[0], (Nm, 3), f32),
           ("model_normals", nrm[0], (Nm, 3), f32))
    plan = plan or nn_plan(rows, Ns, Nm)
    matched = torch.empty((rows, Ns, 3), dtype=f32, device=device)
    mnormal = torch.empty((rows, Ns, 3), dtype=f32, device=device)
    d2 = torch.empty((rows, Ns), dtype=f32, device=device)
    idx = torch.empty((rows, Ns), dtype=torch.int32, device=device)
    launch(K1, device, (rows, Pq, Ns, Nm), query=query, poses=poses, model_pts=pts,
           model_nrm=nrm, matched=matched, mnormal=mnormal, d2=d2, idx=idx,
           obj_stride=obj_stride, P=rows, Pq=Pq, Ns=Ns, Nm=Nm, pts_div=rows // n_obj,
           q=plan.q, width=plan.width, S=plan.groups)
    return _unfold((matched, mnormal, d2, idx), poses)


def nn_batched(
    query: torch.Tensor,  # [Pq, Ns, 3] float32, Pq a divisor of P
    ref: torch.Tensor,    # [P, Nm, 3] float32
    *,
    plan: Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2, NN only: returns (idx [P,Ns] int32, d2 [P,Ns]). The query
    blocks are K1's. CPU tensors take `nn_plain`; CUDA tensors launch the
    kernel with `plan` (default `nn_plan`)."""
    Pq, Ns, P, Nm = _batched_shapes(query, ref)
    device = ref.device
    if not _route("K2", device, P=P, Ns=Ns, Nm=Nm):
        return nn_plain(query, ref)
    _check(device, ("query", query, (Pq, Ns, 3), torch.float32),
           ("ref", ref, (P, Nm, 3), torch.float32))
    plan = plan or nn_plan(P, Ns, Nm)
    d2 = torch.empty((P, Ns), dtype=torch.float32, device=device)
    idx = torch.empty((P, Ns), dtype=torch.int32, device=device)
    launch(K2, device, (P, Pq, Ns, Nm), query=query, ref_pts=ref, d2=d2, idx=idx, P=P,
           Pq=Pq, Ns=Ns, Nm=Nm, q=plan.q, width=plan.width, S=plan.groups)
    return idx, d2


def nn_gn_batched(
    scene_c: torch.Tensor,        # [Ns,3] or [G,Ns,3] float32, G a divisor of P
    scene_normals: torch.Tensor,  # [Ns,3] or [G,Ns,3]
    scene_w: torch.Tensor,        # [Ns] or [G,Ns]
    ref_c: torch.Tensor,          # [P,Nm,3]
    ref_normals: torch.Tensor,    # [P,Nm,3]
    *,
    maxd2: float,
    min_cos: float,
    tau2: float = 0.0,
    plan: Plan | None = None,
) -> tuple[torch.Tensor, ...]:
    """K3, fused NN search + correspondence gates + normal equations:
    returns (H [P,6,6], g [P,6], wsum [P], hits [P], wrr [P]). With G
    scenes, particle p is matched against scene p // (P // G). CPU tensors
    take `nn_gn_plain`; CUDA tensors launch the kernel once with `plan`
    (default `gn_plan` of one group's shapes, P // G particles: the plan
    sets the order of each particle's sums, so a group launched alone, or
    in a library of any size, gets the same bits)."""
    if scene_c.dim() not in (2, 3) or ref_c.dim() != 3:
        raise ValueError("scene_c must be [Ns,3] or [G,Ns,3] and ref_c [P,Nm,3]")
    if scene_c.dim() == 2:
        scene_c, scene_normals, scene_w = scene_c[None], scene_normals[None], scene_w[None]
    G, Ns = scene_c.shape[:2]
    P, Nm = ref_c.shape[:2]
    if P % G:
        raise ValueError(f"scene batch {G} does not divide ref batch {P}")
    device = ref_c.device
    if not _route("K3", device, P=P, Ns=Ns, Nm=Nm):
        return nn_gn_plain(scene_c, scene_normals, scene_w, ref_c, ref_normals,
                           maxd2=maxd2, min_cos=min_cos, tau2=tau2)
    f32 = torch.float32
    _check(device, ("scene_c", scene_c, (G, Ns, 3), f32),
           ("scene_normals", scene_normals, (G, Ns, 3), f32),
           ("scene_w", scene_w, (G, Ns), f32),
           ("ref_c", ref_c, (P, Nm, 3), f32),
           ("ref_normals", ref_normals, (P, Nm, 3), f32))
    plan = plan or gn_plan(P // G, Ns, Nm)
    if plan.width != WIDTH:
        raise ValueError(f"K3 runs groups of {WIDTH} threads, not {plan.width}")
    H = torch.empty((P, 6, 6), dtype=f32, device=device)
    g = torch.empty((P, 6), dtype=f32, device=device)
    wsum, hits, wrr = (torch.empty((P,), dtype=f32, device=device)
                       for _ in range(3))
    partial = arrived = None   # the scene split's block sums and counters
    if plan.scene_split > 1:
        partial = torch.empty((P, plan.scene_split, 30), dtype=f32, device=device)
        arrived = _arrival_counts(device, P)
    launch(K3, device, (P, G, Ns, Nm), scene=scene_c, scene_nrm=scene_normals,
           scene_w=scene_w, ref=ref_c, ref_nrm=ref_normals, H=H, g=g, wsum=wsum, hits=hits,
           wrr=wrr, partial=partial, arrived=arrived, P=P, G=G, Ns=Ns, Nm=Nm, q=plan.q,
           S=plan.groups, scene_split=plan.scene_split, maxd2=float(maxd2),
           min_cos=float(min_cos), tau2=float(tau2))
    return H, g, wsum, hits, wrr


def gn_iterate_batched(
    poses: torch.Tensor,          # [O,P,4,4]
    frozen: torch.Tensor,         # [O,P] bool
    matched: torch.Tensor,        # [O,P,Ns,3]
    mnorm: torch.Tensor,          # [O,P,Ns,3]
    d2: torch.Tensor,             # [O,P,Ns]
    scene_c: torch.Tensor,        # [O,Ns,3] anchored
    scene_normals: torch.Tensor,  # [G,Ns,3], G a divisor of O (1: shared)
    scene_w: torch.Tensor,        # [O,Ns]
    anchor: torch.Tensor,         # [O,3]
    wsum: torch.Tensor,           # [O]
    *,
    max_corresp_dist: float,
    min_cos: float,
    damping: float,
    step_scale: float,
    converge_tol: float,
    gn_reps: int,
    support_tau: float,
) -> tuple[torch.Tensor, icp.IcpStats]:
    """K4, an ICP iteration's Gauss-Newton tail after its search: returns
    (poses [O,P,4,4], IcpStats of [O,P], `converged` the updated freeze).
    CPU tensors take `icp.gn_iterate_plain`; CUDA tensors launch the kernel
    once, one block per particle, whose size (and so the order of each
    particle's sums) follows Ns alone: object o of a library gets the bits
    of object o alone."""
    gn = dict(max_corresp_dist=max_corresp_dist, min_cos=min_cos, damping=damping,
              step_scale=step_scale, converge_tol=converge_tol, gn_reps=gn_reps,
              support_tau=support_tau)
    O, P = poses.shape[:2]
    Ns = d2.shape[-1]
    device = poses.device
    if not _route("K4", device, O=O, P=P, Ns=Ns):
        return icp.gn_iterate_plain(poses, frozen, matched, mnorm, d2, scene_c,
                                    scene_normals, scene_w, anchor, wsum, **gn)
    if gn_reps < 1:
        raise ValueError(f"K4 runs at least one Gauss-Newton rep, not {gn_reps}")
    G = scene_normals.shape[0]
    if O % G:
        raise ValueError(f"scene normal blocks {G} do not divide the objects {O}")
    f32 = torch.float32
    poses, frozen, matched, mnorm, d2, scene_c, scene_normals, scene_w, anchor, wsum = (
        t.contiguous() for t in (poses, frozen, matched, mnorm, d2, scene_c,
                                 scene_normals, scene_w, anchor, wsum))
    _check(device, ("poses", poses, (O, P, 4, 4), f32),
           ("frozen", frozen, (O, P), torch.bool),
           ("matched", matched, (O, P, Ns, 3), f32),
           ("mnorm", mnorm, (O, P, Ns, 3), f32),
           ("d2", d2, (O, P, Ns), f32),
           ("scene_c", scene_c, (O, Ns, 3), f32),
           ("scene_normals", scene_normals, (G, Ns, 3), f32),
           ("scene_w", scene_w, (O, Ns), f32),
           ("anchor", anchor, (O, 3), f32),
           ("wsum", wsum, (O,), f32))
    poses_out = torch.empty_like(poses)
    frozen_out = torch.empty_like(frozen)
    rmse, inliers, support = (torch.empty((O, P), dtype=f32, device=device)
                              for _ in range(3))
    tau2 = support_tau * support_tau if support_tau > 0 else 0.0
    launch(K4, device, (O * P, O, Ns), poses=poses, frozen=frozen, matched=matched,
           mnormal=mnorm, d2=d2, scene_c=scene_c, scene_nrm=scene_normals, scene_w=scene_w,
           anchor=anchor, wsum=wsum, poses_out=poses_out, frozen_out=frozen_out, rmse=rmse,
           inliers=inliers, support=support, O=O, P=P, Gn=G, Ns=Ns, reps=gn_reps,
           maxd2=float(max_corresp_dist * max_corresp_dist), min_cos=float(min_cos),
           damping=float(damping), step_scale=float(step_scale),
           tol2=float(converge_tol * converge_tol), tau2=float(tau2))
    return poses_out, icp.IcpStats(rmse=rmse, inliers=inliers, converged=frozen_out,
                                   support=support)


# the splat's largest radius (csrc/splat_compare.cu's kMaxRadius)
MAX_SPLAT_RADIUS = 16


def splat_compare_plain(
    pts_cam: torch.Tensor,         # [..., Nr, 3] camera-frame samples
    weights: torch.Tensor,         # broadcast to [..., Nr]; 0 disables a sample
    observed: torch.Tensor,        # [H,W], or [1|O,H,W] with [O,P] leading axes
    observed_valid: torch.Tensor,  # as observed, bool
    observed_enc: torch.Tensor | None,  # score.encode_observed's, as observed
    hand_depth: torch.Tensor | None,    # as observed, +inf where no hand
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    radius: int,
    **gates,
) -> score.ScoreTerms:
    """Plain PyTorch K5: one `render.splat_depth_batched` image [..., H, W]
    per particle, then `score.compare_depth` (`gates`: its depth_tau,
    wrong_side_penalty, occlusion_margin, invalid_penalty and
    ghost_dilate)."""
    lead, Nr = tuple(pts_cam.shape[:-2]), pts_cam.shape[-2]
    depths = render.splat_depth_batched(
        pts_cam.reshape(-1, Nr, 3), weights.expand(lead + (Nr,)).reshape(-1, Nr),
        fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width, radius=radius,
    ).reshape(lead + (height, width))
    return score.compare_depth(depths, observed, observed_valid, hand_depth,
                               observed_enc=observed_enc, **gates)


def _image_blocks(img: torch.Tensor, lead: tuple, rows: int) -> tuple[torch.Tensor, int]:
    """An image argument of K5 as [B,H,W] contiguous and the particles per
    block: [H,W] or [1,H,W] is one for all, [O,H,W] one per object of [O,P]
    leading axes."""
    img = img if img.dim() == 3 else img[None]
    B = img.shape[0]
    if B != 1 and (len(lead) != 2 or lead[0] != B):
        raise ValueError(f"{B} images do not match particles of shape {lead}")
    return img.contiguous(), rows // B


def _weight_rows(weights: torch.Tensor, lead: tuple, Nr: int) -> tuple[torch.Tensor, int]:
    """K5's weights as [B,Nr] float32 and the particles per row: B is the
    product of the leading axes the weights vary along, before the trailing
    ones they broadcast over ([Nr]: one row for all; [O,1,Nr] with [O,P]
    particles: one per object); any other broadcast is expanded."""
    shape = (1,) * (len(lead) + 1 - weights.dim()) + tuple(weights.shape[:-1])
    k = len(shape)
    while k and shape[k - 1] == 1:
        k -= 1
    rows = math.prod(lead)
    if shape[:k] == lead[:k]:
        B = math.prod(lead[:k])
        w = weights.reshape(B, Nr)
    else:
        B, w = rows, weights.expand(lead + (Nr,)).reshape(rows, Nr)
    return w.to(torch.float32).contiguous(), rows // B


def splat_compare_batched(
    pts_cam: torch.Tensor,         # [..., Nr, 3] float32 camera-frame samples
    weights: torch.Tensor,         # broadcast to [..., Nr]; 0 disables a sample
    observed: torch.Tensor,        # [H,W], or [1|O,H,W] with [O,P] leading axes
    observed_valid: torch.Tensor,  # as observed, bool
    observed_enc: torch.Tensor | None,  # score.encode_observed's (None: made here)
    hand_depth: torch.Tensor | None,    # as observed, +inf where no hand
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    radius: int,
    depth_tau: float,
    wrong_side_penalty: float,
    occlusion_margin: float,
    invalid_penalty: float,
    ghost_dilate: int,
) -> score.ScoreTerms:
    """K5, render-and-compare scoring: each particle's samples splatted into
    a z-buffer of radius `radius`, min-filtered and compared with the
    observation pixel by pixel. Returns `score.ScoreTerms` over the leading
    axes (fitness before any coverage weight, coverage, support, counted
    pixels), as `splat_compare_plain` does. With [O,P] leading axes and
    [O,H,W] images, object o's particles read image o. CPU tensors take
    `splat_compare_plain`; CUDA tensors launch the kernel once, one block
    per particle: a particle's result depends on its own inputs and the
    shapes alone, so object o of a library gets the bits of object o
    alone."""
    gates = dict(depth_tau=depth_tau, wrong_side_penalty=wrong_side_penalty,
                 occlusion_margin=occlusion_margin, invalid_penalty=invalid_penalty,
                 ghost_dilate=ghost_dilate)
    lead, Nr = tuple(pts_cam.shape[:-2]), pts_cam.shape[-2]
    rows = math.prod(lead)
    device = pts_cam.device
    if not _route("K5", device, P=rows, Nr=Nr, H=height, W=width):
        return splat_compare_plain(pts_cam, weights, observed, observed_valid,
                                   observed_enc, hand_depth, fx=fx, fy=fy, cx=cx, cy=cy,
                                   height=height, width=width, radius=radius, **gates)
    if not 0 <= radius <= MAX_SPLAT_RADIUS:
        raise ValueError(f"K5 splats a radius of 0 to {MAX_SPLAT_RADIUS}, not {radius}")
    if observed_enc is None:
        observed_enc = score.encode_observed(observed, observed_valid, ghost_dilate)
    obs, img_div = _image_blocks(observed, lead, rows)
    valid, _ = _image_blocks(observed_valid, lead, rows)
    enc, _ = _image_blocks(observed_enc, lead, rows)
    hand, hand_div = (_image_blocks(hand_depth, lead, rows) if hand_depth is not None
                      else (None, rows))
    w, w_div = _weight_rows(weights, lead, Nr)
    pts = pts_cam.reshape(rows, Nr, 3).contiguous()
    B, HW = obs.shape[0], (height, width)
    f32 = torch.float32
    _check(device, ("pts_cam", pts, (rows, Nr, 3), f32),
           ("weights", w, (rows // w_div, Nr), f32),
           ("observed", obs, (B,) + HW, f32),
           ("observed_valid", valid, (B,) + HW, torch.bool),
           ("observed_enc", enc, (B,) + HW, f32),
           *([("hand_depth", hand, (rows // hand_div,) + HW, f32)] if hand is not None
             else []))
    n_obs = valid.reshape(B, -1).sum(1, dtype=torch.int32)
    fitness, coverage, support, counted = (torch.empty((rows,), dtype=f32, device=device)
                                           for _ in range(4))
    launch(K5, device, (rows, Nr, height, width), pts=pts, w=w, obs=obs, valid=valid,
           enc=enc, hand=hand, n_obs=n_obs, fitness=fitness, coverage=coverage,
           support=support, counted=counted, rows=rows, Nr=Nr, H=height, W=width, r=radius,
           w_div=w_div, img_div=img_div, hand_div=hand_div, fx=float(fx), fy=float(fy),
           cx=float(cx), cy=float(cy), tau=float(depth_tau), pen=float(wrong_side_penalty),
           inv_pen=float(invalid_penalty), margin=float(occlusion_margin))
    return score.ScoreTerms(*(t.reshape(lead) for t in (fitness, coverage, support,
                                                          counted)))


# K6's lookup rules (csrc/project_compare.cu's Rule): "take" without
# `mxu_tables`, else the tables' first field
PC_RULES = {"take": 0, "image": 1, "patch": 2}


def project_compare_plain(
    poses: torch.Tensor,           # [P,4,4], or [O,P,4,4] for a library
    render_pts: torch.Tensor,      # [N,3], or [O,N,3]
    render_normals: torch.Tensor,  # as render_pts
    observed: torch.Tensor,        # [H,W], or [1|O,H,W]
    observed_valid: torch.Tensor,  # as observed, bool
    hand_depth: torch.Tensor | None = None,  # as observed, +inf where no hand
    **kw,
) -> score.ScoreTerms:
    """Plain PyTorch K6: the samples posed by `se3.transform_points` and
    `se3.rotate_vectors`, then `score.compare_points` (`kw`: its keyword
    arguments)."""
    if poses.dim() == 4:       # each object's samples beside its particle axis
        render_pts, render_normals = render_pts[:, None], render_normals[:, None]
    return score.compare_points(
        se3.transform_points(poses, render_pts), se3.rotate_vectors(poses, render_normals),
        observed, observed_valid, hand_depth, **kw)


def _object_rows(t: torch.Tensor, row_dims: int, lead: tuple, name: str
                 ) -> tuple[torch.Tensor, int, int]:
    """A per-object argument of K6 (a row of `row_dims` axes, [N] or [N,3]:
    one for all particles, or [O, ...] with [O,P] particles) as (tensor,
    rows, stride between rows in elements); each row contiguous, the rows
    at any stride (a slice of the samples is read where it lies)."""
    if t.dim() == row_dims:
        t = t[None]
    B = t.shape[0]
    if t.dim() != row_dims + 1 or (B != 1 and (len(lead) != 2 or lead[0] != B)):
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not match particles {lead}")
    if t[0].numel() and not t[0].is_contiguous():
        t = t.contiguous()
    return t, B, t.stride(0) if B > 1 else 0


def project_compare_batched(
    poses: torch.Tensor,           # [P,4,4] float32, or [O,P,4,4] for a library
    render_pts: torch.Tensor,      # [N,3], or [O,N,3]: object o's samples
    render_normals: torch.Tensor,  # as render_pts
    observed: torch.Tensor,        # [H,W], or [1|O,H,W] (one for all, or per object)
    observed_valid: torch.Tensor,  # as observed, bool
    hand_depth: torch.Tensor | None = None,  # as observed, +inf where no hand
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    depth_tau: float = 0.01,
    wrong_side_penalty: float = 2.0,
    occlusion_margin: float = 0.005,
    invalid_penalty: float = 0.3,
    subpixel: bool = False,
    ghost_dilate: int = 1,
    observed_enc: torch.Tensor | None = None,
    mxu_tables: tuple | None = None,
    neutral_cov_exempt: bool = False,
    sample_mask: torch.Tensor | None = None,  # [N] bool, or [O,N]
    mask_count_floor: float = 0.5,
) -> score.ScoreTerms:
    """K6, point-mode projective scoring: each particle's pose applied to
    its object's samples and normals, and `score.compare_points` on the
    posed samples (the lookup rule, `subpixel`, the sample mask and the
    rest as compare_points takes them). Returns `score.ScoreTerms` over the
    particle axes. CPU tensors take `project_compare_plain`; CUDA tensors
    launch the kernel once, one block per particle, whose size (and so the
    order of the support's sum) follows N alone: object o of a library gets
    the bits of object o alone."""
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
              depth_tau=depth_tau, wrong_side_penalty=wrong_side_penalty,
              occlusion_margin=occlusion_margin, invalid_penalty=invalid_penalty,
              subpixel=subpixel, ghost_dilate=ghost_dilate, observed_enc=observed_enc,
              mxu_tables=mxu_tables, neutral_cov_exempt=neutral_cov_exempt,
              sample_mask=sample_mask, mask_count_floor=mask_count_floor)
    lead, N = tuple(poses.shape[:-2]), render_pts.shape[-2]
    rows = math.prod(lead)
    device = poses.device
    if not _route("K6", device, P=rows, N=N, H=height, W=width):
        return project_compare_plain(poses, render_pts, render_normals, observed,
                                     observed_valid, hand_depth, **kw)
    if len(lead) not in (1, 2):
        raise ValueError(f"poses must be [P,4,4] or [O,P,4,4], not {tuple(poses.shape)}")
    rule = "take" if mxu_tables is None else mxu_tables[0]
    if rule not in PC_RULES:
        raise ValueError(f"K6 reads by the rules {sorted(PC_RULES)}, not {rule!r}")
    pv0 = pu0 = None
    size, n_patch = 0, 1
    if rule == "take":
        enc = (observed_enc if observed_enc is not None
               else score.encode_observed(observed, observed_valid, ghost_dilate))
        hand_img = hand_depth
    else:
        enc, hand_img = mxu_tables[1:3]
        if rule == "patch":
            pv0, pu0, size = mxu_tables[3:]
            pv0, n_patch, _ = _object_rows(pv0.contiguous(), 1, lead, "pv0")
            pu0 = _object_rows(pu0.contiguous(), 1, lead, "pu0")[0]
    pts, n_obj, obj_stride = _object_rows(render_pts, 2, lead, "render_pts")
    nrm, n_nrm, nrm_stride = _object_rows(render_normals, 2, lead, "render_normals")
    if (n_nrm, nrm_stride) != (n_obj, obj_stride):
        pts, nrm = pts.contiguous(), nrm.contiguous()
        obj_stride = pts.stride(0) if n_obj > 1 else 0
    enc, img_div = _image_blocks(enc, lead, rows)
    hand, hand_div = (_image_blocks(hand_img, lead, rows) if hand_img is not None
                      else (None, rows))
    mask, n_mask, mask_stride = (_object_rows(sample_mask, 1, lead, "sample_mask")
                                 if sample_mask is not None else (None, 1, 0))
    poses = poses.contiguous()
    f32 = torch.float32
    HW = (height, width)
    _check(device, ("poses", poses, lead + (4, 4), f32),
           ("render_pts", pts[0], (N, 3), f32),
           ("render_normals", nrm[0], (N, 3), f32),
           ("observed_enc", enc, (rows // img_div,) + HW, f32),
           *([("hand", hand, (rows // hand_div,) + HW, f32)] if hand is not None else []),
           *([("sample_mask", mask[0], (N,), torch.bool)] if mask is not None else []),
           *([("pv0", pv0, (n_patch, N), torch.int64), ("pu0", pu0, (n_patch, N), torch.int64)]
             if pv0 is not None else []))
    fitness, coverage, support, counted = (torch.empty((rows,), dtype=f32, device=device)
                                           for _ in range(4))
    launch(K6, device, (rows, N, height, width, rule, bool(subpixel)), poses=poses, pts=pts,
           nrm=nrm, enc=enc, hand=hand, mask=mask, pv0=pv0, pu0=pu0, fitness=fitness,
           coverage=coverage, support=support, counted=counted, obj_stride=obj_stride,
           mask_stride=mask_stride, rows=rows, N=N, H=height, W=width, rule=PC_RULES[rule],
           subpixel=int(bool(subpixel)), pts_div=rows // n_obj, img_div=img_div,
           hand_div=hand_div, mask_div=rows // n_mask, patch_div=rows // n_patch,
           size=int(size), exempt=int(bool(neutral_cov_exempt)), fx=float(fx), fy=float(fy),
           cx=float(cx), cy=float(cy), tau=float(depth_tau),
           # 1 / tau rounded once to FP32, the support's factor: ATen's CUDA
           # division by a Python scalar multiplies by it
           inv_tau=1.0 / depth_tau, edge_tau=float(3.0 * depth_tau),
           pen=float(wrong_side_penalty), inv_pen=float(invalid_penalty),
           margin=float(occlusion_margin), count_floor=float(mask_count_floor))
    return score.ScoreTerms(*(t.reshape(lead) for t in (fitness, coverage, support,
                                                          counted)))


def launch_counts() -> dict:
    """Each wrapper's launches as they stand, {name: (launches, Counter of
    shapes)} for K1-K6 (a kernel never launched: (0, Counter()))."""
    shapes = {kernel.name: collections.Counter() for kernel in KERNELS}
    for (name, shape), n in profiling.launches().items():
        shapes[name][shape] = n
    return {name: (sum(c.values()), c) for name, c in shapes.items()}


def _fold(t: torch.Tensor) -> torch.Tensor:
    """[O,P,N,3] -> [O*P,N,3] contiguous ([P,N,3] passes through)."""
    return t.reshape((-1,) + tuple(t.shape[-2:])).contiguous()


def _unfold(outs: tuple, like: torch.Tensor) -> tuple:
    """The kernels' [O*P,...] outputs back on the leading axes of `like`
    ([O,P,N,3] clouds or [O,P,4,4] poses; a [P,N,3] or [P,4,4] `like`
    leaves them as they are)."""
    if like.dim() == 3:
        return outs
    return tuple(t.reshape(tuple(like.shape[:2]) + tuple(t.shape[1:])) for t in outs)


def make_corr_fn():
    """A `corr_fn(scene, poses, model_pts, model_normals) -> (matched,
    mnormal, d2, idx)` drop-in for ops/icp.py, backed by K1: the model
    cloud posed by each pose and searched in one launch. Takes scene [Ns,3]
    (shared) or [Pq,Ns,3] with poses [P,4,4] and a model [Nm,3], and, for
    a library, scene [1|O,Ns,3] with poses [O,P,4,4] and models [O,Nm,3]:
    object o's particles search scene o in the same launch, and the outputs
    keep the [O,P] axes."""

    def corr_fn(scene_pts, poses, model_pts, model_normals):
        q = scene_pts[None] if scene_pts.dim() == 2 else scene_pts
        return nn_gather_batched(q, poses, model_pts, model_normals)

    return corr_fn


def make_nn_fn():
    """An `nn_fn(query, ref) -> (idx, d2)` drop-in for ops/icp.py, backed by
    K2. Takes [Ns,3] x [Nm,3] (-> [Ns]), [Ns,3] x [P,Nm,3] (a shared scene,
    -> [P,Ns]), [Pq,Ns,3] x [P,Nm,3], and for a library [1|O,Ns,3] x
    [O,P,Nm,3] (-> [O,P,Ns])."""

    def nn_fn(query, ref):
        if query.dim() == 2 and ref.dim() == 2:
            idx, d2 = nn_batched(query[None].contiguous(), ref[None].contiguous())
            return idx[0], d2[0]
        q = query[None] if query.dim() == 2 else query
        return _unfold(nn_batched(q.contiguous(), _fold(ref)), ref)

    return nn_fn


def make_gn_fn(*, maxd2: float, min_cos: float, tau2: float = 0.0):
    """A `gn_fn(scene_c, scene_normals, scene_w, ref_c, ref_normals) -> (H,
    g, wsum, hits, wrr)` drop-in for ops/icp.icp_batched(..., gn_fn=...),
    backed by K3: one scene ([Ns,...]) with ref_c [P,Nm,3], or for a library
    O scenes ([O,Ns,...]) with ref_c [O,P,Nm,3] (outputs [O,P,...]). The
    gates are baked in and exposed as attributes, so icp_batched can check
    them against its own arguments."""

    def gn_fn(scene_c, scene_normals, scene_w, ref_c, ref_normals):
        return _unfold(nn_gn_batched(
            scene_c.contiguous(), scene_normals.contiguous(),
            scene_w.contiguous(), _fold(ref_c), _fold(ref_normals),
            maxd2=maxd2, min_cos=min_cos, tau2=tau2,
        ), ref_c)

    gn_fn.maxd2 = float(maxd2)
    gn_fn.min_cos = float(min_cos)
    gn_fn.tau2 = float(tau2)
    return gn_fn
