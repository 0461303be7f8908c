"""K5: render-and-compare scoring, each particle's samples splatted into a
z-buffer, min-filtered and compared with the observation pixel by pixel.
Shape (P, Nr, H, W): P particles of Nr samples against H x W images."""
import re

from . import bound_s

PATTERN = re.compile(r"splat_compare_kernel(?:\b|E)")


def bound(shape) -> float:
    """13 operations a sample (the projection's 2 divisions, 2 products
    and 2 sums, 2 roundings, 4 range tests, the z-buffer's minimum); the
    samples (3 floats) and one row of weights read once, 4 floats a
    particle written. The images are left out: a particle reads the pixels
    of its footprint alone, which the shape does not give."""
    P, Nr, H, W = shape
    return bound_s(13.0 * P * Nr, 4.0 * (3 * P * Nr + Nr + 4 * P))
