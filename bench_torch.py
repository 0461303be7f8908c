"""Bench entry of the PyTorch/CUDA port: delegates to
`icra20_hand_object_pose_tpu_torch.benchmarks`, the port's counterpart of
`bench.py`. Runs on the card and needs no jax.

    python3 bench_torch.py                   # headline: hypotheses/s, ms/frame
    python3 bench_torch.py --sweep           # library of 8 x 128 particles
    python3 bench_torch.py --sweep-scale     # 8 x 512 and 16 x 128
    python3 bench_torch.py --sweep-shared    # shared-scene library, both sizes
    python3 bench_torch.py --init            # init success per shape
    python3 bench_torch.py --init-realistic  # the same, sensor + calibration error
    python3 bench_torch.py --sweep-init      # init success in sweep mode

Each mode prints one JSON line per measurement.
"""
from icra20_hand_object_pose_tpu_torch import benchmarks

if __name__ == "__main__":
    benchmarks.cli()
