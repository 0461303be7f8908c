from .synthetic import (  # noqa: F401
    default_object_pose,
    SensorModel,
    SyntheticFrame,
    SyntheticSequenceConfig,
    apply_sensor_model,
    generate_sequence,
    hand_base_for_grasp,
    render_frame,
    render_frame_fast,
)
