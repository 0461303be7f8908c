"""The system under test, built from the benchmark's own inputs.

The only module of the harness that imports the program (the PyTorch/CUDA
package). It turns a configuration's deployment and the benchmark's meshes
and hand description into the program's objects: an `EstimatorConfig`, one
`ObjectModel` per object, the `HandModel`. The program computes everything
else itself (its point samples, its kernels, its programs)."""
from __future__ import annotations

import dataclasses

PACKAGE = "icra20_hand_object_pose_tpu_torch"


def estimator_config(config: dict):
    """EstimatorConfig with the configuration's camera and its `estimator`
    overrides, nested groups as dicts of their fields."""
    from icra20_hand_object_pose_tpu_torch.utils.config import (
        CameraIntrinsics, EstimatorConfig)

    def override(obj, values: dict):
        fields = {}
        for k, v in values.items():
            cur = getattr(obj, k)
            fields[k] = override(cur, v) if dataclasses.is_dataclass(cur) else v
        return dataclasses.replace(obj, **fields)

    cam = {k: config["camera"][k] for k in ("fx", "fy", "cx", "cy", "width", "height")}
    return override(EstimatorConfig(camera=CameraIntrinsics(**cam)),
                    config.get("estimator", {}))


def hand_model(config: dict, links, device):
    from icra20_hand_object_pose_tpu_torch.models.hand import HandLink, HandModel
    from icra20_hand_object_pose_tpu_torch.utils.meshio import Mesh

    return HandModel(
        [HandLink(l.name, Mesh(l.mesh.vertices, l.mesh.faces), l.parent, l.origin,
                  l.axis, l.joint, l.coupling, l.rest) for l in links],
        n_joints=int(config["hand"]["n_joints"]),
        points_per_link=int(config["hand"]["points_per_link"]), device=device)


def object_models(config: dict, meshes, device) -> list:
    """One ObjectModel per mesh, object o sampled with seed o."""
    from icra20_hand_object_pose_tpu_torch.models import ObjectModel
    from icra20_hand_object_pose_tpu_torch.utils.meshio import Mesh

    return [ObjectModel(Mesh(m.vertices, m.faces, m.symmetries),
                        model_points=int(config["model_points"]),
                        render_points=int(config["render_points"]),
                        seed=o, device=device)
            for o, m in enumerate(meshes)]


def launch_counts() -> dict:
    """The kernels' launch counters: {wrapper: (launches, Counter of
    shapes)}."""
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda

    return knn_cuda.launch_counts()
