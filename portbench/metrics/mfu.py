"""The whole frame's share of the card's FP32 peak: the operations the
window's object-frames need by the configuration's sizes (work.py: each
object-frame counted in the program it ran, track or init) over the
unprofiled window's length x 67 TFLOP/s. Moves frame_ms."""
from .. import kernels, work

UNIT = "%"


def read(r):
    if not r.window_s:
        return None
    est = r.config["estimator"]
    ops = (r.track_object_frames * work.frame_work(est, "track")["ops"]
           + r.init_object_frames * work.frame_work(est, "init")["ops"])
    if ops <= 0:
        return None
    return 100.0 * ops / (r.window_s * kernels.PEAK_FP32)
