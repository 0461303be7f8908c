"""icra20_hand_object_pose_tpu_torch — the PyTorch/CUDA port of
icra20_hand_object_pose_tpu, the occlusion-aware 6-DoF pose tracker of
objects grasped by adaptive hands.

It mirrors the JAX package's layout and names (utils/, ops/, models/,
datasets/, parallel/, cli, parity, visualize, evaluation) and runs a frame
(`Tracker.step`, init and track programs) on a CUDA device, with the
nearest-neighbour searches as hand-written CUDA kernels (ops/knn_cuda.py,
csrc/). `parallel.LibrarySweep` tracks a library of objects as one batched
program. `python -m icra20_hand_object_pose_tpu_torch.cli
demo|track|eval|sweep` drives recorded sequences end to end; `benchmarks`
(`cli bench`, the repo root's `bench_torch.py`) and `utils/profiling`
measure it. It imports torch, never jax.
"""
import torch

from .utils.config import (
    CameraIntrinsics,
    EstimatorConfig,
    HandConfig,
    IcpConfig,
    PsoConfig,
    ScoreConfig,
    TrackerConfig,
    load_yaml,
)

# Distances and GN sums stay in true FP32: TF32, like bf16, flips
# nearest neighbours at millimetre scale.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "CameraIntrinsics",
    "EstimatorConfig",
    "HandConfig",
    "IcpConfig",
    "PsoConfig",
    "ScoreConfig",
    "TrackerConfig",
    "load_yaml",
    "__version__",
]
