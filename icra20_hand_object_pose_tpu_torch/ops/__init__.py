from . import camera, icp, knn, knn_cuda, preprocess, pso, render, score  # noqa: F401
