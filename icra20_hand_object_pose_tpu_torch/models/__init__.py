from .estimator import Estimator, FrameResult, Tracker, TrackerState, TrackResult  # noqa: F401
from .hand import HandLink, HandModel, make_t42_hand  # noqa: F401
from .object_model import ObjectModel  # noqa: F401
