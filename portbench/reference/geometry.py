"""The benchmark's own geometry: test objects, the T42 hand, rigid motions.

A frozen, plain-NumPy copy of what the traffic needs: the eight catalogued
test objects with their symmetry groups, area-weighted surface sampling,
the hand's links (from the configuration file) with their forward
kinematics, and the SE(3) exponential. Imports nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    vertices: np.ndarray                  # [V,3] float32
    faces: np.ndarray                     # [F,3] int32
    symmetries: np.ndarray | None = None  # [S,4,4], identity first

    def transformed(self, T: np.ndarray) -> "Mesh":
        T = np.asarray(T, np.float32)
        return Mesh((self.vertices @ T[:3, :3].T + T[:3, 3]).astype(np.float32),
                    self.faces)

    def merged(self, other: "Mesh") -> "Mesh":
        return Mesh(
            np.concatenate([self.vertices, other.vertices]).astype(np.float32),
            np.concatenate([self.faces, other.faces + len(self.vertices)]
                           ).astype(np.int32))

    def centroid(self) -> np.ndarray:
        return self.vertices.mean(axis=0)

    def diameter(self) -> float:
        """Bounding-box diagonal (the repo's object diameter)."""
        return float(np.linalg.norm(self.vertices.max(0) - self.vertices.min(0)))

    def sample_surface(self, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Area-weighted surface samples -> (points [n,3], normals [n,3])."""
        rng = np.random.default_rng(seed)
        v, f = self.vertices, self.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        cross = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(cross, axis=-1)
        fidx = rng.choice(len(f), size=n, p=area / max(area.sum(), 1e-12))
        u = rng.random((n, 1))
        w = rng.random((n, 1))
        flip = (u + w) > 1.0
        u = np.where(flip, 1.0 - u, u)
        w = np.where(flip, 1.0 - w, w)
        pts = v[f[fidx, 0]] + u * e1[fidx] + w * e2[fidx]
        nrm = cross[fidx] / np.maximum(
            np.linalg.norm(cross[fidx], axis=-1, keepdims=True), 1e-12)
        return pts.astype(np.float32), nrm.astype(np.float32)


# -- primitives ---------------------------------------------------------------

def make_box(extents=(0.06, 0.04, 0.1), center=(0.0, 0.0, 0.0)) -> Mesh:
    ex, ey, ez = [e / 2.0 for e in extents]
    v = np.array([[sx * ex, sy * ey, sz * ez] for sx in (-1, 1) for sy in (-1, 1)
                  for sz in (-1, 1)], np.float32) + np.asarray(center, np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                 np.int32)
    return Mesh(v, f)


def make_cylinder(radius=0.02, height=0.1, segments=24, center=(0, 0, 0)) -> Mesh:
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    top = np.concatenate([ring, np.full((segments, 1), height / 2)], -1)
    bot = np.concatenate([ring, np.full((segments, 1), -height / 2)], -1)
    v = np.concatenate([top, bot, [[0, 0, height / 2]], [[0, 0, -height / 2]]]
                       ).astype(np.float32) + np.asarray(center, np.float32)
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces += [[i, segments + i, j], [j, segments + i, segments + j],
                  [2 * segments, i, j], [2 * segments + 1, segments + j, segments + i]]
    return Mesh(v, np.asarray(faces, np.int32))


def make_icosphere(radius=0.03, subdivisions=2, center=(0, 0, 0)) -> Mesh:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
                  [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
                  [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        cache: dict = {}
        verts = list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                cache[key] = len(verts)
                verts.append((verts[a] + verts[b]) / 2.0)
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True) * radius
    v = v + np.asarray(center, np.float64)
    return Mesh(v.astype(np.float32), f.astype(np.int32))


def make_capsule(radius=0.012, length=0.05, segments=12) -> Mesh:
    """Capsule along +z from 0 to length (the hand's phalanx)."""
    cyl = make_cylinder(radius, length, segments, center=(0, 0, length / 2))
    return (cyl.merged(make_icosphere(radius, 1, center=(0, 0, 0)))
            .merged(make_icosphere(radius, 1, center=(0, 0, length))))


def _extrude(poly, cap, height: float) -> Mesh:
    poly = np.asarray(poly, np.float32)
    cap = np.asarray(cap, np.int32)
    n = len(poly)
    v = np.concatenate([
        np.concatenate([poly, np.full((n, 1), height / 2, np.float32)], -1),
        np.concatenate([poly, np.full((n, 1), -height / 2, np.float32)], -1)])
    side = []
    for i in range(n):
        j = (i + 1) % n
        side += [[i, n + i, j], [j, n + i, n + j]]
    f = np.concatenate([cap, cap[:, ::-1] + n, np.asarray(side, np.int32)])
    m = Mesh(v.astype(np.float32), f.astype(np.int32))
    return Mesh(m.vertices - m.centroid().astype(np.float32), m.faces)


def _revolve(profile, segments: int) -> Mesh:
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)
    starts, sizes, verts, idx = [], [], [], 0
    for r, z in np.asarray(profile, np.float32):
        if abs(r) < 1e-9:
            verts.append(np.array([[0.0, 0.0, z]], np.float32))
            starts.append(idx); sizes.append(1); idx += 1
        else:
            verts.append(np.stack([r * ca, r * sa, np.full_like(ca, z)], -1)
                         .astype(np.float32))
            starts.append(idx); sizes.append(segments); idx += segments
    faces = []
    K = len(profile)
    for k in range(K):
        a0, asz = starts[k], sizes[k]
        b0, bsz = starts[(k + 1) % K], sizes[(k + 1) % K]
        if asz == 1 and bsz == 1:
            continue
        for i in range(segments):
            j = (i + 1) % segments
            if asz == 1:
                faces.append([a0, b0 + j, b0 + i])
            elif bsz == 1:
                faces.append([a0 + i, a0 + j, b0])
            else:
                faces += [[a0 + i, a0 + j, b0 + i], [a0 + j, b0 + j, b0 + i]]
    return Mesh(np.concatenate(verts).astype(np.float32), np.asarray(faces, np.int32))


def _mug(radius=0.035, height=0.09, wall=0.005, segments=32) -> Mesh:
    r_in = radius - wall
    m = _revolve([[0.0, 0.0], [radius, 0.0], [radius, height], [r_in, height],
                  [r_in, wall], [0.0, wall]], segments)
    th, reach = 0.008, 0.022
    z0, z1 = 0.25 * height, 0.75 * height
    for extents, center in (
            ((reach + th, th, th), (radius + (reach + th) / 2, 0, z1)),
            ((reach + th, th, th), (radius + (reach + th) / 2, 0, z0)),
            ((th, th, z1 - z0 + th), (radius + reach + th / 2, 0, (z0 + z1) / 2))):
        m = m.merged(make_box(extents, center=center))
    return Mesh(m.vertices - m.centroid().astype(np.float32), m.faces)


def _rot(axis: int, deg: float) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    w = np.zeros(3)
    w[axis] = np.radians(deg)
    T[:3, :3] = so3_exp(w)
    return T


def symmetry_group(kind: str) -> np.ndarray | None:
    """[S,4,4] proper-rotation symmetry group of a test object, identity
    first; None for a trivial or continuous group."""
    eye = np.eye(4, dtype=np.float32)
    if kind == "box":     # square prism: C4 about z, flips about x, y, diagonals
        g = [_rot(2, d) for d in (90.0, 180.0, 270.0)]
        g += [_rot(a, 180.0) for a in range(2)]
        g += [_rot(2, 90.0) @ _rot(0, 180.0), _rot(2, -90.0) @ _rot(0, 180.0)]
        return np.stack([eye] + g)
    if kind == "ellipsoid":
        return np.stack([eye] + [_rot(a, 180.0) for a in range(3)])
    if kind in ("cylinder", "sphere", "lbracket", "tee", "mug", "asym"):
        return None
    raise ValueError(f"unknown test object {kind!r}")


def make_test_object(kind: str) -> Mesh:
    """The eight catalogued grasp objects (box, cylinder, sphere, ellipsoid
    convex; lbracket, tee, mug concave; asym without symmetry)."""
    sym = symmetry_group(kind)
    if kind == "box":
        out = make_box((0.05, 0.05, 0.12))
    elif kind == "cylinder":
        out = make_cylinder(0.025, 0.12, 32)
    elif kind == "sphere":
        out = make_icosphere(0.035, 3)
    elif kind == "ellipsoid":
        m = make_icosphere(0.05, 3)
        out = Mesh((m.vertices * np.array([0.6, 1.0, 1.4], np.float32)
                    ).astype(np.float32), m.faces)
    elif kind == "lbracket":
        w, h, t = 0.08, 0.08, 0.025
        out = _extrude([[0, 0], [w, 0], [w, t], [t, t], [t, h], [0, h], [0, t]],
                       [[0, 1, 2], [0, 2, 3], [0, 3, 6], [6, 3, 4], [6, 4, 5]], 0.05)
    elif kind == "tee":
        w, h, t = 0.09, 0.08, 0.03
        x0, x1 = (w - t) / 2, (w + t) / 2
        out = _extrude([[x0, 0], [x1, 0], [x1, h - t], [w, h - t], [w, h], [0, h],
                        [0, h - t], [x0, h - t]],
                       [[0, 1, 2], [0, 2, 7], [7, 2, 3], [7, 3, 4], [7, 4, 5],
                        [7, 5, 6]], 0.05)
    elif kind == "mug":
        out = _mug()
    else:
        out = _extrude([[0, 0], [0.10, 0], [0.10, 0.015], [0.03, 0.02],
                        [0.03, 0.055], [0, 0.055]],
                       [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 5]], 0.05)
    out.symmetries = sym
    return out


# -- rigid motions -------------------------------------------------------------

def _hat(w) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def so3_exp(w) -> np.ndarray:
    """Rotation vector -> rotation matrix (Rodrigues), float64."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    W = _hat(w)
    if th < 1e-12:
        return np.eye(3) + W
    return np.eye(3) + np.sin(th) / th * W + (1.0 - np.cos(th)) / th ** 2 * W @ W


def se3_exp(w, v) -> np.ndarray:
    """Twist (omega, v) -> float32 [4,4] (the exponential with V)."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    W = _hat(w)
    if th < 1e-12:
        V = np.eye(3) + 0.5 * W
    else:
        V = (np.eye(3) + (1.0 - np.cos(th)) / th ** 2 * W
             + (th - np.sin(th)) / th ** 3 * W @ W)
    T = np.eye(4)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = V @ np.asarray(v, np.float64)
    return T.astype(np.float32)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A uniform rotation (a normalised Gaussian quaternion), float64."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def hand_base_for_grasp(object_pose: np.ndarray, offset: float = 0.10) -> np.ndarray:
    """Side grasp: palm on the camera's -x side of the object, fingers (hand
    +z) toward it, the finger-separation axis along the view axis."""
    R = np.stack([np.array([0.0, 0.0, -1.0]), np.array([0.0, 1.0, 0.0]),
                  np.array([1.0, 0.0, 0.0])], axis=1)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    out[:3, 3] = np.asarray(object_pose, np.float32)[:3, 3] - R[:, 2] * offset
    return out


# -- the hand ------------------------------------------------------------------

@dataclass
class Link:
    name: str
    mesh: Mesh
    parent: int
    origin: np.ndarray   # [4,4] parent frame -> joint frame
    axis: np.ndarray     # [3] revolute axis, zeros for a fixed link
    joint: int = -1
    coupling: float = 1.0
    rest: float = 0.0


_PRIMITIVES = {"box": make_box, "capsule": make_capsule,
               "cylinder": make_cylinder, "sphere": make_icosphere}


def hand_links(spec: dict) -> list[Link]:
    """The links of a hand description (the configuration's `hand`: links
    with a primitive, an origin, a parent and a joint each)."""
    names: dict = {}
    links = []
    for entry in spec["links"]:
        parent = entry.get("parent", -1)
        parent = names[parent] if isinstance(parent, str) else int(parent)
        origin = np.eye(4, dtype=np.float32)
        origin[:3, 3] = entry.get("origin", {}).get("xyz", (0.0, 0.0, 0.0))
        prim = dict(entry["primitive"])
        mesh = _PRIMITIVES[prim.pop("kind")](**prim)
        names[entry["name"]] = len(links)
        links.append(Link(entry["name"], mesh, parent, origin,
                          np.asarray(entry.get("axis", (0.0, 0.0, 0.0)), np.float32),
                          int(entry.get("joint", -1)),
                          float(entry.get("coupling", 1.0)),
                          float(entry.get("rest", 0.0))))
    return links


def hand_mesh(links: list[Link], q) -> Mesh:
    """The posed hand's merged mesh in its base frame (forward kinematics
    in float64)."""
    Ts: list[np.ndarray] = []
    out = None
    for link in links:
        local = link.origin.astype(np.float64)
        if link.joint >= 0:
            n = np.linalg.norm(link.axis)
            axis = link.axis / n if n > 0 else link.axis
            J = np.eye(4)
            J[:3, :3] = so3_exp(axis * (link.coupling * float(q[link.joint]) + link.rest))
            local = local @ J
        T = local if link.parent < 0 else Ts[link.parent] @ local
        Ts.append(T)
        m = link.mesh.transformed(T)
        out = m if out is None else out.merged(m)
    return out
