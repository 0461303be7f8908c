from .synthetic import (  # noqa: F401
    SensorModel,
    apply_sensor_model,
    default_object_pose,
    hand_base_for_grasp,
    render_frame_fast,
)
