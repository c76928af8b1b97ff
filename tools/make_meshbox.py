"""Generate the in-repo triangle Cornell box ("meshbox") as OBJ + MTL.

The box is the one of ``hijiki_tpu/scene/presets.py`` (x, z in [-1, 1],
y in [0, 2], open towards +z, framed for ``Camera.cbox_default``), built
from triangles only so that a render walks the BVH trace table:

* five walls as triangle grids (white floor/ceiling/back, red left, green
  right) with per-vertex normals pointing into the box;
* a ``light`` patch just under the ceiling (two triangles, ``Ke 15 15 15``);
* a torus lying on the floor, tessellated with smooth (``vn``) normals.

Only the MTL keys and name prefixes that the OBJ loaders parse are used
(``newmtl``, ``Kd``, ``Ke``; ``light*`` is emissive). The output is a pure
function of the size parameters, so re-running reproduces the committed
files byte for byte.

    python tools/make_meshbox.py                 # scenes/meshbox/meshbox.obj (6,274 tris)
    python tools/make_meshbox.py --size small    # meshbox_small.obj (306 tris)
"""

from __future__ import annotations

import argparse
import math
import os

# (wall grid cells per side, torus segments around the ring, around the tube)
SIZES = {"full": (16, 64, 29), "small": (4, 12, 6)}

MATERIALS = (
    ("white", (0.725, 0.71, 0.68), None),
    ("red", (0.63, 0.065, 0.05), None),
    ("green", (0.14, 0.45, 0.091), None),
    ("light", (0.0, 0.0, 0.0), (15.0, 15.0, 15.0)),
    ("torus", (0.8, 0.55, 0.2), None),
)

# torus: centre, ring radius, tube radius (clear of the --put-cbox-spheres
# spheres at (-0.42, 0.33, -0.28) and (0.45, 0.33, 0.38), radius 0.33)
TORUS = ((0.4, 0.12, -0.45), 0.3, 0.12)


def _grid(origin, e1, e2, normal, n):
    """An n x n grid of quads over origin + u*e1 + v*e2, two triangles each,
    wound so that (e1 x e2) faces ``normal``. Returns (verts, tris)."""
    verts = []
    for j in range(n + 1):
        for i in range(n + 1):
            u, v = i / n, j / n
            verts.append(tuple(origin[k] + u * e1[k] + v * e2[k] for k in range(3)))
    tris = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            b, c, d = a + 1, a + n + 2, a + n + 1
            tris += [(a, b, c), (a, c, d)]
    cross = (
        e1[1] * e2[2] - e1[2] * e2[1],
        e1[2] * e2[0] - e1[0] * e2[2],
        e1[0] * e2[1] - e1[1] * e2[0],
    )
    if sum(cross[k] * normal[k] for k in range(3)) < 0:
        tris = [(a, c, b) for a, b, c in tris]
    return verts, [normal] * len(verts), tris


def _torus(nu, nv):
    (cx, cy, cz), big, small = TORUS
    verts, normals, tris = [], [], []
    for i in range(nu):
        phi = 2.0 * math.pi * i / nu
        for j in range(nv):
            th = 2.0 * math.pi * j / nv
            nx, ny, nz = math.cos(th) * math.cos(phi), math.sin(th), math.cos(th) * math.sin(phi)
            ring = big + small * math.cos(th)
            verts.append((cx + ring * math.cos(phi), cy + small * math.sin(th), cz + ring * math.sin(phi)))
            normals.append((nx, ny, nz))
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d = i * nv + (j + 1) % nv
            tris += [(a, d, c), (a, c, b)]  # outward winding
    return verts, normals, tris


def build(size: str):
    """Return [(material, verts, normals, tris)] for one box."""
    n, nu, nv = SIZES[size]
    parts = [
        ("white", *_grid((-1, 0, -1), (2, 0, 0), (0, 0, 2), (0, 1, 0), n)),  # floor
        ("white", *_grid((-1, 2, -1), (0, 0, 2), (2, 0, 0), (0, -1, 0), n)),  # ceiling
        ("white", *_grid((-1, 0, -1), (0, 2, 0), (2, 0, 0), (0, 0, 1), n)),  # back
        ("red", *_grid((-1, 0, -1), (0, 0, 2), (0, 2, 0), (1, 0, 0), n)),  # left
        ("green", *_grid((1, 0, -1), (0, 2, 0), (0, 0, 2), (-1, 0, 0), n)),  # right
        ("light", *_grid((-0.25, 1.98, -0.25), (0.5, 0, 0), (0, 0, 0.5), (0, -1, 0), 1)),
        ("torus", *_torus(nu, nv)),
    ]
    return parts


def write(out_obj: str, size: str) -> int:
    """Write ``out_obj`` and its MTL beside it; returns the triangle count."""
    mtl_name = os.path.splitext(os.path.basename(out_obj))[0] + ".mtl"
    os.makedirs(os.path.dirname(out_obj) or ".", exist_ok=True)
    with open(os.path.join(os.path.dirname(out_obj), mtl_name), "w") as f:
        f.write("# meshbox materials (tools/make_meshbox.py)\n")
        for name, kd, ke in MATERIALS:
            f.write(f"newmtl {name}\nKd {kd[0]:.6f} {kd[1]:.6f} {kd[2]:.6f}\n")
            if ke is not None:
                f.write(f"Ke {ke[0]:.6f} {ke[1]:.6f} {ke[2]:.6f}\n")
    n_tris = 0
    base = 1
    with open(out_obj, "w") as f:
        f.write(f"# meshbox ({size}) generated by tools/make_meshbox.py\n")
        f.write(f"mtllib {mtl_name}\n")
        for k, (mat, verts, normals, tris) in enumerate(build(size)):
            f.write(f"o part{k}\nusemtl {mat}\n")
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for nrm in normals:
                f.write(f"vn {nrm[0]:.6f} {nrm[1]:.6f} {nrm[2]:.6f}\n")
            for a, b, c in tris:
                ia, ib, ic = a + base, b + base, c + base
                f.write(f"f {ia}//{ia} {ib}//{ib} {ic}//{ic}\n")
            base += len(verts)
            n_tris += len(tris)
    return n_tris


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--size", choices=sorted(SIZES), default="full")
    p.add_argument("-o", "--output", default=None, help="OBJ path (default: scenes/meshbox/)")
    args = p.parse_args(argv)
    name = "meshbox.obj" if args.size == "full" else f"meshbox_{args.size}.obj"
    out = args.output or os.path.join(here, "..", "scenes", "meshbox", name)
    print(f"{out}: {write(out, args.size)} triangles")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
