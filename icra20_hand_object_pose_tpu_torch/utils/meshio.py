"""Host-side mesh loading and preparation.

Rebuild of the reference's PCL/assimp mesh IO (SURVEY.md §3 "Dataset I/O",
L1 config & assets: object `.ply/.obj` meshes, hand meshes). Pure-NumPy
OBJ and PLY parsers (no trimesh in the image), plus procedural primitives
so tests and benchmarks run with zero dataset dependency. All outputs are
padded, fixed-size arrays ready for device transfer (static shapes are an
XLA requirement — SURVEY.md §8 hard part 1).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """Triangle mesh, float32/int32, host-side."""
    vertices: np.ndarray  # [V,3] float32
    faces: np.ndarray     # [F,3] int32
    symmetries: np.ndarray | None = None  # [S,4,4] discrete proper-rotation
                          # symmetry group of the shape (identity first),
                          # or None when unknown/trivial. Attached by
                          # make_test_object for the catalogued shapes;
                          # consumed by ObjectModel -> the tracker's
                          # symmetry-branch snap (ops/pso.snap_to_branch)
                          # and evaluation.add_sym_error.

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        return (n / np.maximum(norm, 1e-12)).astype(np.float32)

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals."""
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])  # area-weighted
        vn = np.zeros_like(v)
        for i in range(3):
            np.add.at(vn, f[:, i], fn)
        norm = np.linalg.norm(vn, axis=-1, keepdims=True)
        return (vn / np.maximum(norm, 1e-12)).astype(np.float32)

    def transformed(self, T: np.ndarray) -> "Mesh":
        v = self.vertices @ T[:3, :3].T + T[:3, 3]
        return Mesh(v.astype(np.float32), self.faces)

    def merged(self, other: "Mesh") -> "Mesh":
        return Mesh(
            np.concatenate([self.vertices, other.vertices]).astype(np.float32),
            np.concatenate([self.faces, other.faces + self.num_vertices]).astype(np.int32),
        )

    def centroid(self) -> np.ndarray:
        return self.vertices.mean(axis=0)

    def diameter(self) -> float:
        """Approximate model diameter (bounding-box diagonal)."""
        ext = self.vertices.max(0) - self.vertices.min(0)
        return float(np.linalg.norm(ext))

    def sample_surface(self, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Area-weighted surface sampling -> (points [n,3], normals [n,3]).

        This is the model cloud ICP matches against (the reference builds
        it via PCL's mesh sampling; SURVEY.md §4.1 "precompute model cloud").
        """
        rng = np.random.default_rng(seed)
        v, f = self.vertices, self.faces
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        cross = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(cross, axis=-1)
        prob = area / max(area.sum(), 1e-12)
        fidx = rng.choice(len(f), size=n, p=prob)
        u = rng.random((n, 1))
        w = rng.random((n, 1))
        flip = (u + w) > 1.0
        u = np.where(flip, 1.0 - u, u)
        w = np.where(flip, 1.0 - w, w)
        pts = v[f[fidx, 0]] + u * e1[fidx] + w * e2[fidx]
        nrm = cross[fidx] / np.maximum(np.linalg.norm(cross[fidx], axis=-1, keepdims=True), 1e-12)
        return pts.astype(np.float32), nrm.astype(np.float32)


# ---------------------------------------------------------------------------
# Parsers
# ---------------------------------------------------------------------------

def load_obj(path: str) -> Mesh:
    """Minimal Wavefront OBJ parser (v + f lines, polygon fan triangulation)."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(
        np.asarray(verts, dtype=np.float32),
        np.asarray(faces, dtype=np.int32).reshape(-1, 3),
    )


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> Mesh:
    """PLY parser: ascii and binary_little_endian, vertex xyz + face lists."""
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = "ascii"
    elements: list[tuple[str, int, list]] = []  # (name, count, props)
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append(("scalar", tok[1], tok[2]))

    verts = np.zeros((0, 3), np.float32)
    faces: list[list[int]] = []

    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = []
                names = [p[2] for p in props if p[0] == "scalar"]
                for _ in range(count):
                    vals = lines[li].split(); li += 1
                    d = dict(zip(names, vals))
                    rows.append([float(d["x"]), float(d["y"]), float(d["z"])])
                verts = np.asarray(rows, np.float32)
            elif name == "face":
                for _ in range(count):
                    vals = [int(x) for x in lines[li].split()]; li += 1
                    idx = vals[1 : 1 + vals[0]]
                    for k in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            else:
                li += count
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] == "scalar" for p in props):
                codes = "".join(_PLY_TYPES[p[1]][0] for p in props)
                names = [p[2] for p in props]
                size = struct.calcsize("<" + codes)
                raw = np.frombuffer(body, dtype=np.dtype([(n, "<" + c) for n, c in zip(names, codes)]), count=count, offset=off)
                off += size * count
                verts = np.stack([raw["x"], raw["y"], raw["z"]], -1).astype(np.float32)
            elif name == "face":
                for _ in range(count):
                    (cnt_t, idx_t) = (props[0][1], props[0][2])
                    ccode, csz = _PLY_TYPES[cnt_t]
                    icode, isz = _PLY_TYPES[idx_t]
                    (n_idx,) = struct.unpack_from("<" + ccode, body, off)
                    off += csz
                    idx = struct.unpack_from("<" + icode * n_idx, body, off)
                    off += isz * n_idx
                    for k in range(1, n_idx - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            else:
                # skip fixed-size element
                codes = "".join(_PLY_TYPES[p[1]][0] for p in props if p[0] == "scalar")
                off += struct.calcsize("<" + codes) * count
    else:
        raise ValueError(f"unsupported PLY format {fmt!r}")

    return Mesh(verts, np.asarray(faces, np.int32).reshape(-1, 3))


def load_mesh(path: str) -> Mesh:
    p = str(path).lower()
    if p.endswith(".obj"):
        return load_obj(path)
    if p.endswith(".ply"):
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def save_obj(mesh: Mesh, path: str) -> None:
    with open(path, "w") as fh:
        for v in mesh.vertices:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in mesh.faces:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


# ---------------------------------------------------------------------------
# Procedural primitives (synthetic objects + hand links)
# ---------------------------------------------------------------------------

def make_box(extents=(0.06, 0.04, 0.1), center=(0.0, 0.0, 0.0)) -> Mesh:
    ex, ey, ez = [e / 2.0 for e in extents]
    c = np.asarray(center, np.float32)
    v = np.array(
        [[sx * ex, sy * ey, sz * ez] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    ) + c
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    return Mesh(v, f)


def make_cylinder(radius=0.02, height=0.1, segments=24, center=(0, 0, 0)) -> Mesh:
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
    top = np.concatenate([ring, np.full((segments, 1), height / 2)], -1)
    bot = np.concatenate([ring, np.full((segments, 1), -height / 2)], -1)
    v = np.concatenate([top, bot, [[0, 0, height / 2]], [[0, 0, -height / 2]]]).astype(np.float32)
    v += np.asarray(center, np.float32)
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        # wound so face normals point OUTWARD (scoring back-face-culls on
        # sampled normals; inward winding silently inverts visibility)
        faces += [[i, segments + i, j], [j, segments + i, segments + j]]     # side
        faces += [[2 * segments, i, j]]                                       # top cap
        faces += [[2 * segments + 1, segments + j, segments + i]]             # bottom cap
    return Mesh(v, np.asarray(faces, np.int32))


def make_icosphere(radius=0.03, subdivisions=2, center=(0, 0, 0)) -> Mesh:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        cache: dict[tuple[int, int], int] = {}
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
    """Capsule along +z from 0 to length — the hand phalanx primitive."""
    cyl = make_cylinder(radius, length, segments, center=(0, 0, length / 2))
    s0 = make_icosphere(radius, 1, center=(0, 0, 0))
    s1 = make_icosphere(radius, 1, center=(0, 0, length))
    return cyl.merged(s0).merged(s1)


def extrude_polygon(
    poly: np.ndarray,        # [N,2] simple polygon, CCW in the xy plane
    cap_tris: np.ndarray,    # [T,3] triangulation of the polygon (CCW)
    height: float,
    center: tuple = (0.0, 0.0, 0.0),
) -> Mesh:
    """Watertight prism from a CCW polygon: top/bottom caps + side quads.

    CCW polygon + this winding gives outward normals everywhere — required
    by the scorer's back-face visibility test (see make_cylinder note).
    Used to build the CONCAVE test objects (L-bracket, T-shape) that
    exercise self-occlusion, which the convex primitives above cannot.
    """
    poly = np.asarray(poly, np.float32)
    cap = np.asarray(cap_tris, np.int32)
    n = len(poly)
    top = np.concatenate([poly, np.full((n, 1), height / 2, np.float32)], -1)
    bot = np.concatenate([poly, np.full((n, 1), -height / 2, np.float32)], -1)
    v = np.concatenate([top, bot]) + np.asarray(center, np.float32)
    faces = [cap]                                  # top cap, +z outward (CCW)
    faces.append(cap[:, ::-1] + n)                 # bottom cap, flipped
    side = []
    for i in range(n):
        j = (i + 1) % n
        # outward side winding for a CCW polygon viewed from +z
        side += [[i, n + i, j], [j, n + i, n + j]]
    faces.append(np.asarray(side, np.int32))
    return Mesh(v.astype(np.float32), np.concatenate(faces).astype(np.int32))


def revolve_profile(
    profile: np.ndarray,     # [K,2] (radius, z) polyline, closed loop
    segments: int = 32,
    center: tuple = (0.0, 0.0, 0.0),
) -> Mesh:
    """Surface of revolution around +z from a closed (radius, z) profile.

    The profile must be a closed CCW loop in the (r, z) half-plane
    (traversed so that the outward normal is to its right when walking
    the loop — e.g. bottom: axis->rim, up the outer wall, inward across
    the top, down the inner wall). Rings at r=0 collapse to an apex
    vertex. This is how the concave mug (hollow cavity) is built.
    """
    profile = np.asarray(profile, np.float32)
    K = len(profile)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ca, sa = np.cos(ang), np.sin(ang)
    ring_start: list[int] = []   # first vertex index of each ring
    ring_size: list[int] = []    # segments, or 1 for an apex
    verts: list[np.ndarray] = []
    idx = 0
    for r, z in profile:
        if abs(r) < 1e-9:
            verts.append(np.array([[0.0, 0.0, z]], np.float32))
            ring_start.append(idx); ring_size.append(1); idx += 1
        else:
            ring = np.stack([r * ca, r * sa, np.full_like(ca, z)], -1)
            verts.append(ring.astype(np.float32))
            ring_start.append(idx); ring_size.append(segments); idx += segments
    v = np.concatenate(verts) + np.asarray(center, np.float32)
    faces: list[list[int]] = []
    for k in range(K):
        k2 = (k + 1) % K
        a0, asz = ring_start[k], ring_size[k]
        b0, bsz = ring_start[k2], ring_size[k2]
        if asz == 1 and bsz == 1:
            continue  # degenerate segment on the axis
        for i in range(segments):
            j = (i + 1) % segments
            # winding chosen so the right-hand normal points outward for a
            # profile walked with "outside on the right" (signed-volume
            # verified in test_meshio)
            if asz == 1:       # apex -> ring fan
                faces.append([a0, b0 + j, b0 + i])
            elif bsz == 1:     # ring -> apex fan
                faces.append([a0 + i, a0 + j, b0])
            else:              # quad between consecutive rings
                faces += [[a0 + i, a0 + j, b0 + i], [a0 + j, b0 + j, b0 + i]]
    return Mesh(v.astype(np.float32), np.asarray(faces, np.int32))


def make_lbracket(w=0.08, h=0.08, t=0.025, depth=0.05) -> Mesh:
    """L-shaped bracket (extruded L polygon) — simplest concave test object:
    from most views one leg occludes part of the other."""
    # CCW L polygon with an extra boundary vertex at (0,t) so the cap
    # decomposes into two exact rectangles
    poly = np.array(
        [[0, 0], [w, 0], [w, t], [t, t], [t, h], [0, h], [0, t]], np.float32
    )
    # include edge (2,3) and share (3,6) so there is no T-junction at v3
    cap = np.array(
        [[0, 1, 2], [0, 2, 3], [0, 3, 6], [6, 3, 4], [6, 4, 5]], np.int32
    )
    m = extrude_polygon(poly, cap, depth)
    return Mesh(m.vertices - m.centroid().astype(np.float32), m.faces)


def make_tee(w=0.09, h=0.08, t=0.03, depth=0.05) -> Mesh:
    """T-shaped extrusion (concave on both sides of the stem)."""
    x0 = (w - t) / 2
    x1 = (w + t) / 2
    poly = np.array(
        [[x0, 0], [x1, 0], [x1, h - t], [w, h - t], [w, h], [0, h],
         [0, h - t], [x0, h - t]],
        np.float32,
    )
    cap = np.array(
        [[0, 1, 2], [0, 2, 7], [7, 2, 3], [7, 3, 4], [7, 4, 5], [7, 5, 6]],
        np.int32,
    )
    m = extrude_polygon(poly, cap, depth)
    return Mesh(m.vertices - m.centroid().astype(np.float32), m.faces)


def make_mug(
    radius=0.035, height=0.09, wall=0.005, segments=32, handle: bool = True
) -> Mesh:
    """Hollow mug (revolved cavity) with an optional square-C handle —
    the hardest concavity class VERDICT r1 called for: interior surfaces
    are visible only through the opening, so z-buffer visibility and
    back-face culling genuinely disagree on many samples."""
    r_in = radius - wall
    profile = np.array(
        [
            [0.0, 0.0],              # bottom center (apex)
            [radius, 0.0],           # bottom rim
            [radius, height],        # outer wall up
            [r_in, height],          # top rim inward
            [r_in, wall],            # inner wall down (cavity)
            [0.0, wall],             # inner bottom center (apex)
        ],
        np.float32,
    )
    m = revolve_profile(profile, segments)
    if handle:
        # square-C handle: three thin boxes on the +x side
        th = 0.008
        reach = 0.022
        z0, z1 = 0.25 * height, 0.75 * height
        top = make_box((reach + th, th, th),
                       center=(radius + (reach + th) / 2, 0, z1))
        bot = make_box((reach + th, th, th),
                       center=(radius + (reach + th) / 2, 0, z0))
        out = make_box((th, th, z1 - z0 + th),
                       center=(radius + reach + th / 2, 0, (z0 + z1) / 2))
        m = m.merged(top).merged(bot).merged(out)
    c = m.centroid().astype(np.float32)
    return Mesh(m.vertices - c, m.faces)


def make_asym(depth=0.05) -> Mesh:
    """Extruded unequal-leg step polygon — NO nontrivial rotational
    symmetry (every 180-degree principal flip displaces the surface by
    >10 mm mean; tested).

    Accuracy evaluations need this: every other primitive here has a
    180-degree symmetry whose flip renders an identical depth image, so
    sampled-cloud ADD-S bottoms out at ~half the sample spacing (~1 mm at
    8192 points) even for a perfect estimate. On this object plain ADD is
    valid and floor-free (measured r2: the 'residual ~0.97 mm ADD-S' on
    the ellipsoid was entirely the metric floor under a symmetry flip;
    true translation error was 0.1-0.2 mm).
    """
    poly = np.array(
        [[0, 0], [0.10, 0], [0.10, 0.015], [0.03, 0.02], [0.03, 0.055],
         [0, 0.055]],
        np.float32,
    )
    cap = np.array(
        [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 5]], np.int32
    )
    m = extrude_polygon(poly, cap, depth)
    return Mesh(m.vertices - m.centroid().astype(np.float32), m.faces)


def object_symmetry_group(kind: str) -> np.ndarray | None:
    """Discrete proper-rotation symmetry group of a catalogued test
    object: [S,4,4] float32, identity first, or None when the group is
    trivial ('asym', the concave set) or continuous and not enumerable
    ('cylinder'/'sphere' — use ADD-S there). Single source of truth for
    both the evaluation metrics (evaluation.symmetry_group) and the
    tracker's symmetry-branch snap (Mesh.symmetries -> ObjectModel)."""
    def rot(axis, deg):
        T = np.eye(4, dtype=np.float32)
        w = np.zeros(3)
        w[axis] = np.radians(deg)
        th = np.linalg.norm(w)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        return T

    if kind == "box":
        # make_test_object('box') is a SQUARE prism (0.05, 0.05, 0.12):
        # its proper rotation group is the square-prism group (order 8) —
        # C4 about z plus 180-degree flips about x, y, and both xy
        # diagonals (ADVICE r2: D2 alone reported a large ADD for a
        # correct 90-degree z-flip).
        group = [rot(2, d) for d in (90.0, 180.0, 270.0)]
        group += [rot(a, 180.0) for a in range(2)]
        group += [rot(2, 90.0) @ rot(0, 180.0), rot(2, -90.0) @ rot(0, 180.0)]
        return np.stack([np.eye(4, dtype=np.float32)] + group)
    if kind == "ellipsoid":
        # distinct semi-axes (0.6, 1.0, 1.4): D2 180-degree flips only
        return np.stack(
            [np.eye(4, dtype=np.float32)] + [rot(a, 180.0) for a in range(3)]
        )
    if kind in ("cylinder", "sphere", "lbracket", "tee", "mug", "asym"):
        return None
    raise ValueError(f"no symmetry group catalogued for {kind!r}")


def make_test_object(kind: str = "box") -> Mesh:
    """Canonical synthetic grasp objects used by tests/benchmarks.

    box/cylinder/sphere/ellipsoid are convex; lbracket/tee/mug are the
    concave validation set for the point-mode scorer (VERDICT r1 item 2);
    asym has no rotational symmetry (floor-free ADD accuracy evals).
    Shapes with a catalogued discrete symmetry carry it on
    Mesh.symmetries (identity first) so the tracker can snap its reported
    pose to the prior's symmetry branch (ops/pso.snap_to_branch)."""
    sym = object_symmetry_group(kind)  # validates `kind` for free
    if kind == "box":
        out = make_box((0.05, 0.05, 0.12))
    elif kind == "cylinder":
        out = make_cylinder(0.025, 0.12, 32)
    elif kind == "sphere":
        out = make_icosphere(0.035, 3)
    elif kind == "ellipsoid":
        m = make_icosphere(0.05, 3)
        out = Mesh((m.vertices * np.array([0.6, 1.0, 1.4], np.float32)).astype(np.float32), m.faces)
    elif kind == "lbracket":
        out = make_lbracket()
    elif kind == "tee":
        out = make_tee()
    elif kind == "mug":
        out = make_mug()
    else:
        out = make_asym()
    out.symmetries = sym
    return out
