from .estimator import Estimator, FrameResult, Tracker, TrackerState, TrackResult  # noqa: F401
from .hand import (  # noqa: F401
    HandLink, HandModel, load_hand_spec, make_model_o_hand, make_t42_hand,
)
from .object_model import ObjectModel  # noqa: F401
