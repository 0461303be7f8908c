"""The benchmark of the PyTorch/CUDA port (`run.py`; cells under
`workloads/`). Imports neither JAX nor the JAX package."""
