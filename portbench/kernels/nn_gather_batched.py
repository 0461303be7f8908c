"""K1: nearest model point of each scene point per particle, and the
matched point and normal gathered at its index. Shape (P, Pq, Ns, Nm): P
posed model clouds of Nm points, Pq query clouds of Ns points."""
import re

from . import bound_s

PATTERN = re.compile(r"\bnn_kernel<[^>]*\btrue>|_Z\d+nn_kernelI(?:Li\d+E)+Lb1E")


def bound(shape) -> float:
    """9 operations per (query, reference) pair (3 sub, 3 mul, 2 add, a
    compare); queries, points and normals read once, matched point, normal,
    d2 and index (8 words per query) written once."""
    P, Pq, Ns, Nm = shape
    return bound_s(9.0 * P * Ns * Nm, 4.0 * (3 * Pq * Ns + 6 * P * Nm + 8 * P * Ns))
