"""K3: the K1 search of an anchored scene against anchored posed model
clouds, the correspondence gates and the point-to-plane normal equations
per particle. Shape (P, G, Ns, Nm): G scenes of Ns points, P posed model
clouds of Nm points."""
import re

from . import bound_s

PATTERN = re.compile(r"\bnn_gn_kernel<|_Z\d+nn_gn_kernelI")


def bound(shape) -> float:
    """The search's 9 operations per pair plus ~105 per (particle, scene
    point) for the gates, J, r, the 30 products and their sums; scenes (7
    floats a point) and posed models (6) read once, H, g, wsum, hits, wrr
    (45 floats a particle) written once."""
    P, G, Ns, Nm = shape
    return bound_s(9.0 * P * Ns * Nm + 105.0 * P * Ns,
                   4.0 * (7 * G * Ns + 6 * P * Nm + 45 * P))
