"""K2: K1's search without the gather. Shape (P, Pq, Ns, Nm)."""
import re

from . import bound_s

PATTERN = re.compile(r"\bnn_kernel<[^>]*\bfalse>|_Z\d+nn_kernelI(?:Li\d+E)+Lb0E")


def bound(shape) -> float:
    """9 operations per pair; queries and points read once, d2 and index
    written once."""
    P, Pq, Ns, Nm = shape
    return bound_s(9.0 * P * Ns * Nm, 4.0 * (3 * Pq * Ns + 3 * P * Nm + 2 * P * Ns))
