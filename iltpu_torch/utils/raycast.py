"""A ray caster over MuJoCo's abstract scene: the port's pixels for
gymnasium's `rgb_array` frames, in torch tensor ops on any device, with no
OpenGL.

`render_scenes(scenes, textures, ...)` takes the scenes that
`NativeVecEnv.scene` copies out of `mjv_updateScene` (geoms, lights, the two
GL cameras) and the model's textures (`NativeVecEnv.textures`), and returns
(N, H, W, 3) uint8 frames, row 0 at the top as gymnasium returns them. The
frames are cast in batches: every tensor of a batch lives on `device`, and
each batch goes to the host once, as uint8.

What it draws, after `mjr_render`'s fixed-function set-up:
- the camera: the average of the two stereo GL cameras (`mjv_averageCamera`,
  as `mjr_render` does in mono), one ray through each pixel's centre of the
  frustum; a frustum width of 0 takes the aspect ratio from the image;
  depth clipped to [near, far];
- the geoms: plane (one-sided, finite unless its size is 0), sphere,
  capsule, ellipsoid, cylinder, box, each hit from outside only (back
  faces are culled);
- lighting: OpenGL's Phong model per light (the headlight among them):
  emission, ambient, diffuse, and specular at `shininess * 128`, the
  texture modulating all but the specular (separate specular colour);
  directional, spot (cutoff, exponent) and point lights with their
  attenuation;
- textures: a plane's 2D texture repeated `texrepeat` times over the plane
  (per unit length when `texuniform`), mip-mapped by the pixel's footprint
  on the plane; a cube texture projected from the geom's centre; the
  skybox (a cube texture, its +Y face turned up to +Z as MuJoCo draws it)
  behind everything;
- shadows: one shadow ray per light that casts shadows, against every geom
  but planes; in shadow that light's diffuse and specular drop out;
- reflection: one bounce off a plane with reflectance r, blended as
  (1 - r) plane + r reflection; the reflected hit is lit without shadows,
  and a reflected ray that meets nothing shows the skybox.
Not drawn: anti-aliasing (MuJoCo's `offsamples`), the haze where a plane
meets the skybox, fog, transparency, meshes and height fields (a scene
holding one raises).

The rays of a batch are (B, P) tensors, so that a frame's camera, geoms
and lights broadcast over its P rays: the primary rays, the shadow rays and
the reflected rays are cast over every pixel under a mask, each geom tested
exactly on the rays that meet its bounding sphere only (gathered, then
scattered back); the shading gathers the hits. Vectors are kept as three
tensors (`V`), and all arithmetic is elementwise (no matmul, no fused
multiply-add op), so the CPU and the card round alike.
"""

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

# mjtGeom (1 is a height field)
PLANE, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX = 0, 2, 3, 4, 5, 6
DRAWN = (PLANE, SPHERE, CAPSULE, ELLIPSOID, CYLINDER, BOX)
# mjtTexture (1 is a cube)
TEX_2D, TEX_SKYBOX = 0, 2
# mjtLightType (2 is a point light)
SPOT, DIRECTIONAL = 0, 1
TEXROLE_RGB = 1  # mjtTextureRole
EPS = 1e-6       # least ray parameter of a hit
OFFSET = 1e-4    # secondary rays start this far off the surface

# columns of a geom row (`NativeVecEnv.scene`)
G_TYPE, G_MATID, G_SIZE, G_POS, G_MAT, G_RGBA = 0, 1, 2, 5, 8, 17
G_EMISSION, G_SPECULAR, G_SHININESS, G_REFLECTANCE = 21, 22, 23, 24
# columns of a light row
L_POS, L_DIR, L_TYPE, L_CASTSHADOW, L_HEADLIGHT = 0, 3, 6, 7, 8
L_ATTEN, L_CUTOFF, L_EXPONENT, L_AMBIENT, L_DIFFUSE, L_SPECULAR = 9, 12, 13, 14, 17, 20


class V:
    """A 3-vector of same-shaped tensors (or numbers)."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    @staticmethod
    def of(rows, col: int) -> "V":
        """Columns col..col+2 of (..., k) rows."""
        return V(rows[..., col], rows[..., col + 1], rows[..., col + 2])

    def __add__(self, o):
        return V(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        return V(self.x * s, self.y * s, self.z * s)

    def __truediv__(self, s):
        return V(self.x / s, self.y / s, self.z / s)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                 self.x * o.y - self.y * o.x)

    def norm(self):
        return torch.sqrt(self.dot(self))

    def unit(self):
        return self / self.norm()

    def __getitem__(self, idx):
        return V(self.x[idx], self.y[idx], self.z[idx])

    def put(self, idx, o):
        """In place: self[idx] = o."""
        self.x[idx] = o.x
        self.y[idx] = o.y
        self.z[idx] = o.z

    def where(self, cond, o):
        return V(torch.where(cond, self.x, o.x), torch.where(cond, self.y, o.y),
                 torch.where(cond, self.z, o.z))


def _to_local(v: V, m) -> V:
    """v in world axes -> the geom's axes: mat^T v, m the (..., 9)
    row-major rotation (world = mat @ local)."""
    return V(v.x * m[..., 0] + v.y * m[..., 3] + v.z * m[..., 6],
             v.x * m[..., 1] + v.y * m[..., 4] + v.z * m[..., 7],
             v.x * m[..., 2] + v.y * m[..., 5] + v.z * m[..., 8])


def _to_world(v: V, m) -> V:
    return V(v.x * m[..., 0] + v.y * m[..., 1] + v.z * m[..., 2],
             v.x * m[..., 3] + v.y * m[..., 4] + v.z * m[..., 5],
             v.x * m[..., 6] + v.y * m[..., 7] + v.z * m[..., 8])


def average_camera(cams: torch.Tensor) -> Dict[str, object]:
    """`mjv_averageCamera` of (B, 2, 16) GL camera rows: positions and
    frusta averaged, forward normalised, up made orthogonal to it and
    normalised."""
    mean = (cams[:, 0] + cams[:, 1]) * 0.5
    fwd = V.of(mean, 3).unit()
    up = V.of(mean, 6)
    up = (up - fwd * up.dot(fwd)).unit()
    return {"pos": V.of(mean, 0), "forward": fwd, "up": up, "center": mean[:, 9],
            "width": mean[:, 10], "bottom": mean[:, 11], "top": mean[:, 12],
            "near": mean[:, 13], "far": mean[:, 14], "orthographic": cams[:, 0, 15] > 0}


def _bound_radius(gtype: int, size):
    """Radius of the sphere about a geom's centre that holds it."""
    if gtype == SPHERE:
        return size[..., 0]
    if gtype == CAPSULE:
        return size[..., 0] + size[..., 2]
    if gtype == CYLINDER:
        return torch.sqrt(size[..., 0] * size[..., 0] + size[..., 2] * size[..., 2])
    if gtype == ELLIPSOID:
        return size.amax(-1)
    return torch.sqrt((size * size).sum(-1))  # box


def _inf(t, ok):
    return torch.where(ok, t, torch.full_like(t, math.inf))


def _sphere(lo: V, ld: V, r):
    """Entering hit of unit local rays with the sphere of radius r at the
    origin: t (inf: none) and the outward normal."""
    b = lo.dot(ld)
    disc = b * b - (lo.dot(lo) - r * r)
    t = _inf(-b - torch.sqrt(torch.clamp(disc, min=0.0)), disc >= 0)
    t = _inf(t, t > EPS)
    return t, (lo + ld * t) / r


def _side(lo: V, ld: V, r, h):
    """Entering hit with the side of the z-axis cylinder of radius r,
    |z| <= h."""
    a = ld.x * ld.x + ld.y * ld.y
    b = lo.x * ld.x + lo.y * ld.y
    c = lo.x * lo.x + lo.y * lo.y - r * r
    disc = b * b - a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
    z = lo.z + ld.z * t
    t = _inf(t, (disc >= 0) & (a > 0) & (t > EPS) & (z.abs() <= h))
    return t, V((lo.x + ld.x * t) / r, (lo.y + ld.y * t) / r, torch.zeros_like(t))


def _closest(*hits):
    t, n = hits[0]
    for t2, n2 in hits[1:]:
        better = t2 < t
        t = torch.where(better, t2, t)
        n = n2.where(better, n)
    return t, n


def _intersect(gtype: int, lo: V, ld: V, size):
    """Entering hit of local rays with a geom of `gtype`; `size` (M, 3) is
    the abstract geom's: (r, r, r) a sphere, (r, r, half-length) a capsule
    or a cylinder, semi-axes an ellipsoid or a box."""
    if gtype == SPHERE:
        return _sphere(lo, ld, size[:, 0])
    if gtype == CAPSULE:
        r, h = size[:, 0], size[:, 2]
        zero = torch.zeros_like(h)
        cap = V(zero, zero, h)
        return _closest(_side(lo, ld, r, h), _sphere(lo - cap, ld, r), _sphere(lo + cap, ld, r))
    if gtype == ELLIPSOID:
        s = V.of(size, 0)
        so = V(lo.x / s.x, lo.y / s.y, lo.z / s.z)
        sd = V(ld.x / s.x, ld.y / s.y, ld.z / s.z)
        a = sd.dot(sd)
        b = so.dot(sd)
        disc = b * b - a * (so.dot(so) - 1.0)
        t = _inf((-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a, disc >= 0)
        t = _inf(t, t > EPS)
        p = lo + ld * t
        return t, V(p.x / (s.x * s.x), p.y / (s.y * s.y), p.z / (s.z * s.z)).unit()
    if gtype == CYLINDER:
        r, h = size[:, 0], size[:, 2]
        hits = [_side(lo, ld, r, h)]
        zero = torch.zeros_like(h)
        for sign in (1.0, -1.0):
            t = (h * sign - lo.z) / ld.z
            px = lo.x + ld.x * t
            py = lo.y + ld.y * t
            ok = (t > EPS) & (ld.z * sign < 0) & (px * px + py * py <= r * r)
            hits.append((_inf(t, ok), V(zero, zero, zero + sign)))
        return _closest(*hits)
    if gtype == BOX:
        near, far = [], []
        for o, d, h in ((lo.x, ld.x, size[:, 0]), (lo.y, ld.y, size[:, 1]), (lo.z, ld.z, size[:, 2])):
            t1 = (-h - o) / d
            t2 = (h - o) / d
            near.append(torch.minimum(t1, t2))
            far.append(torch.maximum(t1, t2))
        tmin, axis = torch.stack(near, -1).max(-1)
        tmax = torch.minimum(torch.minimum(far[0], far[1]), far[2])
        t = _inf(tmin, (tmax >= tmin) & (tmin > EPS))
        zero = torch.zeros_like(t)
        n = V(torch.where(axis == 0, -torch.sign(ld.x), zero),
              torch.where(axis == 1, -torch.sign(ld.y), zero),
              torch.where(axis == 2, -torch.sign(ld.z), zero))
        return t, n
    raise ValueError(f"the ray caster draws no geom of type {gtype}")


class Textures:
    """The model's textures as float tensors in [0, 1] on `device`: a 2D
    texture as its mip pyramid (box-filtered levels down to 1 texel), a cube
    texture as (6, w, w, 3) faces (+X, -X, +Y, -Y, +Z, -Z)."""

    def __init__(self, tex: Dict[str, np.ndarray], device):
        self.device = torch.device(device)
        self.mat_texid = [int(t) for t in tex["mat_texid"][:, TEXROLE_RGB]]
        self.mat_texrepeat = [tuple(float(v) for v in r) for r in tex["mat_texrepeat"]]
        self.mat_texuniform = [bool(u) for u in tex["mat_texuniform"]]
        self.images, self.types = [], []
        self.skybox = None
        for ttype, h, w, nc, adr in tex["tex"].tolist():
            img = tex["data"][adr:adr + h * w * nc].reshape(h, w, nc)[..., :3]
            x = torch.from_numpy(img.astype(np.float32) / np.float32(255.0)).to(self.device)
            if ttype == TEX_2D:
                levels = [x]
                while min(levels[-1].shape[:2]) > 1:
                    lv = levels[-1].permute(2, 0, 1).unsqueeze(0)
                    lv = torch.nn.functional.avg_pool2d(lv, 2, ceil_mode=True)
                    levels.append(lv.squeeze(0).permute(1, 2, 0).contiguous())
                x = levels
            else:
                x = x.reshape(6, w, w, 3)
            self.images.append(x)
            self.types.append(ttype)
            if ttype == TEX_SKYBOX and self.skybox is None:
                self.skybox = x


def _bilinear(img, s, t):
    """(M, 3) samples of (h, w, 3) img at repeating texture coordinates
    (s, t), texel centres at (i + 0.5) / size."""
    h, w = img.shape[0], img.shape[1]
    x = s * w - 0.5
    y = t * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)
    x0 = torch.remainder(x0.long(), w)
    y0 = torch.remainder(y0.long(), h)
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.remainder(y0 + 1, h)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _sample_cube(faces, d: V):
    """(M, 3) samples of (6, w, w, 3) cube faces along directions d, in
    GL's cube-map convention, bilinear and clamped at each face's edge."""
    ax, ay, az = d.x.abs(), d.y.abs(), d.z.abs()
    mx = (ax >= ay) & (ax >= az)
    my = ~mx & (ay >= az)
    mz = ~mx & ~my
    ma = torch.where(mx, ax, torch.where(my, ay, az))
    neg = torch.where(mx, d.x < 0, torch.where(my, d.y < 0, d.z < 0))
    face = torch.where(mx, 0, torch.where(my, 2, 4)) + neg.long()
    # (sc, tc) per face: +X (-z, -y), -X (z, -y), +Y (x, z), -Y (x, -z), +Z (x, -y), -Z (-x, -y)
    sc = torch.where(mx, torch.where(neg, d.z, -d.z), torch.where(mz & neg, -d.x, d.x))
    tc = torch.where(my, torch.where(neg, -d.z, d.z), -d.y)
    w = faces.shape[1]
    s = torch.clamp((sc / ma + 1) * (0.5 * w) - 0.5, 0, w - 1)
    t = torch.clamp((tc / ma + 1) * (0.5 * w) - 0.5, 0, w - 1)
    s0 = torch.clamp(torch.floor(s), max=w - 2)
    t0 = torch.clamp(torch.floor(t), max=w - 2)
    fs = (s - s0).unsqueeze(-1)
    ft = (t - t0).unsqueeze(-1)
    s0 = s0.long()
    t0 = t0.long()
    top = faces[face, t0, s0] * (1 - fs) + faces[face, t0, s0 + 1] * fs
    bot = faces[face, t0 + 1, s0] * (1 - fs) + faces[face, t0 + 1, s0 + 1] * fs
    return top * (1 - ft) + bot * ft


class _Scenes:
    """A batch of scenes as tensors on the device: geoms (B, G, 25) and
    lights (B, L, 23); one model, so every scene has the same geom types in
    the same order and the same number of lights."""

    def __init__(self, scenes: Sequence[dict], device):
        first = scenes[0]
        for s in scenes:
            if s["geoms"].shape != first["geoms"].shape or s["lights"].shape != first["lights"].shape \
                    or not np.array_equal(s["geoms"][:, G_TYPE], first["geoms"][:, G_TYPE]):
                raise ValueError("the scenes of one batch must have the same geoms and lights")
        self.types = [int(t) for t in first["geoms"][:, G_TYPE]]
        for t in self.types:
            if t not in DRAWN:
                raise ValueError(f"the ray caster draws no geom of type {t}")
        lights = np.stack([s["lights"] for s in scenes])
        self.geoms = torch.from_numpy(np.stack([s["geoms"] for s in scenes])).to(device)
        self.lights = torch.from_numpy(lights).to(device)
        self.cam = average_camera(torch.from_numpy(np.stack([s["cameras"] for s in scenes])).to(device))
        self.directional = [bool((lights[:, l, L_TYPE] == DIRECTIONAL).all())
                            for l in range(lights.shape[1])]
        # the lights that cast shadows (the headlight never does)
        self.casts = [bool(((lights[:, l, L_CASTSHADOW] > 0) & (lights[:, l, L_HEADLIGHT] == 0)).any())
                      for l in range(lights.shape[1])]


class _Screen:
    """A pinhole's pixel grid, per frame: `mask` gives the pixels whose rays
    may meet a sphere (the bounding rectangle of its projection, a pixel
    wider each side), the whole frame where the sphere reaches behind the
    camera."""

    def __init__(self, pos: V, right: V, up: V, fwd: V, near, left, top, pixel_w, pixel_h,
                 height: int, width: int):
        self.pos, self.right, self.up, self.fwd = pos, right, up, fwd
        self.near, self.left, self.top, self.pixel_w, self.pixel_h = near, left, top, pixel_w, pixel_h
        dev = near.device
        self.rows = torch.arange(height, device=dev, dtype=torch.float32)
        self.cols = torch.arange(width, device=dev, dtype=torch.float32)

    def mask(self, c: V, radius):
        rel = c - self.pos
        cx, cy, cz = rel.dot(self.right), rel.dot(self.up), rel.dot(self.fwd)
        front = cz > radius

        def extent(a):  # the tangents' image coordinates along one axis
            dist = torch.sqrt(a * a + cz * cz)
            mid = torch.atan2(a, cz)
            half = torch.asin(torch.clamp(radius / dist, max=1.0))
            return self.near * torch.tan(mid - half), self.near * torch.tan(mid + half)

        x_lo, x_hi = extent(cx)
        y_lo, y_hi = extent(cy)
        j0 = torch.floor((x_lo - self.left) / self.pixel_w - 0.5) - 1
        j1 = torch.ceil((x_hi - self.left) / self.pixel_w - 0.5) + 1
        i0 = torch.floor((self.top - y_hi) / self.pixel_h - 0.5) - 1
        i1 = torch.ceil((self.top - y_lo) / self.pixel_h - 0.5) + 1
        big = float(max(len(self.rows), len(self.cols)))
        j0, i0 = (torch.where(front, v, -1.0) for v in (j0, i0))
        j1, i1 = (torch.where(front, v, big) for v in (j1, i1))
        rmask = (self.rows >= i0[:, None]) & (self.rows <= i1[:, None])
        cmask = (self.cols >= j0[:, None]) & (self.cols <= j1[:, None])
        return (rmask[:, :, None] & cmask[:, None, :]).reshape(len(rmask), -1)


class _Beam:
    """Rays of one direction L per frame (a directional light's shadow
    rays) from points p, (B, P): `mask` gives the rays whose line meets a
    sphere on the light's side, by their coordinates across L."""

    def __init__(self, p: V, L: V):
        a = V(torch.where(L.x.abs() < 0.9, 1.0, 0.0), torch.where(L.x.abs() < 0.9, 0.0, 1.0),
              torch.zeros_like(L.x))
        self.u = L.cross(a).unit()
        self.w = L.cross(self.u)
        self.L = L
        g = lambda v: V(v.x[:, None], v.y[:, None], v.z[:, None])  # noqa: E731
        self.pu, self.pw, self.pl = p.dot(g(self.u)), p.dot(g(self.w)), p.dot(g(L))

    def mask(self, c: V, radius):
        du = self.pu - c.dot(self.u)[:, None]
        dw = self.pw - c.dot(self.w)[:, None]
        r = radius[:, None]
        return (du * du + dw * dw <= r * r) & (self.pl - c.dot(self.L)[:, None] < r)


def _gather(v: V, idx, P: int) -> V:
    """The rays idx (into the flattened (B, P)) of components that are
    (B, P), or (B, 1) per frame."""
    return V(*(c.reshape(-1)[idx // P] if c.shape[1] == 1 else c.reshape(-1)[idx]
               for c in (v.x, v.y, v.z)))


def _trace(sc: _Scenes, o: V, d: V, active, skip_planes=False, any_hit=False, tmax=None,
           tmin=None, cull=None):
    """Cast the rays o + t d, (B, P) per frame (an origin may be (B, 1)),
    where `active`, with t in (tmin, tmax) where given. Returns the nearest
    hit's t (inf: none), geom index (-1), world normal and local point, each
    (B, P); with `any_hit`, whether any geom lies there. A frame's geom
    values broadcast over its rays. Each non-plane geom is tested exactly on
    the rays `cull.mask` keeps for its bounding sphere (else on those whose
    line meets it), gathered, and the results scattered back."""
    shape = active.shape
    B, P = shape
    dev = active.device
    t_best = torch.full(shape, math.inf, device=dev) if tmax is None else tmax.clone()
    gi = torch.full(shape, -1, dtype=torch.long, device=dev)
    n = V(*(torch.zeros(shape, device=dev) for _ in range(3)))
    local = V(*(torch.zeros(shape, device=dev) for _ in range(3)))
    for g, gtype in enumerate(sc.types):
        rows = sc.geoms[:, g]  # (B, 25)
        if gtype == PLANE:
            if skip_planes:
                continue
            col = lambda k: rows[:, k, None]  # noqa: E731  (B, 1): broadcasts over a frame's rays
            z = V(col(G_MAT + 2), col(G_MAT + 5), col(G_MAT + 8))  # the plane's normal
            rel = o - V(col(G_POS), col(G_POS + 1), col(G_POS + 2))
            ldz = d.dot(z)
            t = -rel.dot(z) / ldz
            q = rel + d * t
            px = q.x * col(G_MAT) + q.y * col(G_MAT + 3) + q.z * col(G_MAT + 6)
            py = q.x * col(G_MAT + 1) + q.y * col(G_MAT + 4) + q.z * col(G_MAT + 7)
            sx, sy = col(G_SIZE), col(G_SIZE + 1)
            ok = active & (ldz < 0) & (t > EPS) & (t < t_best) \
                & ((sx <= 0) | (px.abs() <= sx)) & ((sy <= 0) | (py.abs() <= sy))
            if tmin is not None:
                ok = ok & (t > tmin)
            t_best = torch.where(ok, t, t_best)
            gi = torch.where(ok, g, gi)
            if not any_hit:
                n = V(z.x.expand(shape), z.y.expand(shape), z.z.expand(shape)).where(ok, n)
                local = V(px, py, torch.zeros_like(px)).where(ok, local)
            continue
        c = V.of(rows, G_POS)
        rb = _bound_radius(gtype, rows[:, G_SIZE:G_SIZE + 3])
        if cull is not None:
            cand = active & cull.mask(c, rb)
        else:
            oc = o - V(c.x[:, None], c.y[:, None], c.z[:, None])
            b = oc.dot(d)
            cc = oc.dot(oc) - (rb * rb)[:, None]
            cand = active & (b * b - cc >= 0) & ((b < 0) | (cc <= 0))
        idx = cand.reshape(-1).nonzero().squeeze(-1)
        if idx.numel() == 0:
            continue
        r = rows[idx // P]
        m = r[:, G_MAT:G_MAT + 9]
        lo = _to_local(_gather(o, idx, P) - V.of(r, G_POS), m)
        ld = _to_local(_gather(d, idx, P), m)
        t, nl = _intersect(gtype, lo, ld, r[:, G_SIZE:G_SIZE + 3])
        tb = t_best.view(-1)
        better = t < tb[idx]
        if tmin is not None:
            better = better & (t > tmin.reshape(-1)[idx])
        sel = idx[better]
        tb[sel] = t[better]
        gi.view(-1)[sel] = g
        if not any_hit:
            V(n.x.view(-1), n.y.view(-1), n.z.view(-1)).put(sel, _to_world(nl[better], m[better]))
            V(local.x.view(-1), local.y.view(-1), local.z.view(-1)).put(sel, (lo + ld * t)[better])
    if any_hit:
        return gi >= 0
    return t_best, gi, n, local


def _sky(tex: Textures, d: V):
    if tex.skybox is None:
        return torch.zeros(d.x.shape + (3,), device=d.x.device)
    # MuJoCo turns the skybox so that its +Y face is up (+Z)
    return _sample_cube(tex.skybox, V(d.x, d.z, -d.y))


def _texture(tex: Textures, rows, local: V, foot=None):
    """Texture colour at each hit, (M, 3) (ones where untextured). `foot`,
    a plane hit's footprint (world length one pixel spans), picks the mip
    level (None: level 0)."""
    out = torch.ones(rows.shape[0], 3, device=rows.device)
    matid = rows[:, G_MATID]
    for mat, texid in enumerate(tex.mat_texid):
        if texid < 0:
            continue
        idx = (matid == mat).nonzero().squeeze(-1)
        if idx.numel() == 0:
            continue
        r = rows[idx]
        lp = local[idx]
        img = tex.images[texid]
        if tex.types[texid] == TEX_2D:
            rx, ry = tex.mat_texrepeat[mat]
            if tex.mat_texuniform[mat]:
                sx = torch.full_like(lp.x, rx)
                sy = torch.full_like(lp.x, ry)
            else:
                hx, hy = r[:, G_SIZE], r[:, G_SIZE + 1]
                sx = torch.where(hx > 0, rx / (2 * hx), torch.full_like(hx, rx))
                sy = torch.where(hy > 0, ry / (2 * hy), torch.full_like(hy, ry))
            s = lp.x * sx
            t = lp.y * sy
            s = s - torch.floor(s)
            t = t - torch.floor(t)
            if foot is None or len(img) == 1:
                col = _bilinear(img[0], s, t)
            else:
                texels = foot[idx] * torch.maximum(sx * img[0].shape[1], sy * img[0].shape[0])
                lod = torch.clamp(torch.log2(torch.clamp(texels, min=1.0)), max=len(img) - 1)
                l0 = torch.floor(lod)
                frac = lod - l0
                col = torch.zeros(idx.shape[0], 3, device=rows.device)
                for lv in range(len(img)):
                    w = torch.where(l0 == lv, 1 - frac, torch.where(l0 + 1 == lv, frac, 0.0))
                    on = (w > 0).nonzero().squeeze(-1)
                    if on.numel():
                        col[on] = col[on] + _bilinear(img[lv], s[on], t[on]) * w[on].unsqueeze(-1)
        else:
            if tex.mat_texuniform[mat]:
                dirn = lp
            else:
                size = V.of(r, G_SIZE)
                dirn = V(lp.x / size.x, lp.y / size.y, lp.z / size.z)
            col = _sample_cube(img, dirn)
        out[idx] = col
    return out


def _light(sc: _Scenes, f, rows, p: V, n: V, v: V, lit):
    """OpenGL's fixed-function lighting at hits of frames f: the primary
    colour (emission, ambient, diffuse) and the secondary (specular), (M, 3)
    each. `lit[l]`, where not None, is 0 where light l is shadowed, else 1."""
    rgb = rows[:, G_RGBA:G_RGBA + 3]
    spec_m = rows[:, G_SPECULAR].unsqueeze(-1)
    shin = rows[:, G_SHININESS] * 128.0
    primary = rows[:, G_EMISSION].unsqueeze(-1) * rgb
    secondary = torch.zeros_like(primary)
    for l in range(sc.lights.shape[1]):
        lt = sc.lights[f, l]  # (M, 23)
        toward = -V.of(sc.lights[:, l], L_DIR).unit()  # a directional light's L, per frame
        if sc.directional[l]:
            L = toward[f]
            k = 1.0
        else:
            ltype = lt[:, L_TYPE]
            to_light = V.of(lt, L_POS) - p
            dist = to_light.norm()
            directional = ltype == DIRECTIONAL
            L = toward[f].where(directional, to_light / dist)
            a = lt[:, L_ATTEN:L_ATTEN + 3]
            atten = torch.where(directional, 1.0, 1.0 / (a[:, 0] + a[:, 1] * dist + a[:, 2] * dist * dist))
            cos_spot = L.dot(toward[f])
            cutoff = lt[:, L_CUTOFF]
            spot = torch.where((ltype == SPOT) & (cutoff < 180),
                               torch.where(cos_spot >= torch.cos(cutoff * (math.pi / 180.0)),
                                           torch.pow(torch.clamp(cos_spot, min=0.0), lt[:, L_EXPONENT]),
                                           0.0),
                               1.0)
            k = (atten * spot).unsqueeze(-1)
        ndl = n.dot(L)
        diff = torch.clamp(ndl, min=0.0).unsqueeze(-1)
        ndh = torch.clamp(n.dot((L + v).unit()), min=0.0)
        spec = torch.where(ndl > 0, torch.pow(ndh, shin), 0.0).unsqueeze(-1)
        if lit[l] is not None:
            on = lit[l].unsqueeze(-1)
            diff = diff * on
            spec = spec * on
        primary = primary + k * (lt[:, L_AMBIENT:L_AMBIENT + 3] * rgb
                                 + diff * lt[:, L_DIFFUSE:L_DIFFUSE + 3] * rgb)
        secondary = secondary + k * spec * lt[:, L_SPECULAR:L_SPECULAR + 3] * spec_m
    return primary, secondary


def _shadows(sc: _Scenes, p: V, n: V, hit):
    """For each light, None if it casts no shadow, else (B, P) 1.0 where a
    shadow ray from each hit reaches it past every non-plane geom, 0.0 where
    one blocks it. A directional light's rays are culled as a beam."""
    out = []
    origin = p + n * OFFSET
    for l, casts in enumerate(sc.casts):
        if not casts:
            out.append(None)
            continue
        lt = sc.lights[:, l]
        col = lambda k: lt[:, k, None]  # noqa: E731
        directional = col(L_TYPE) == DIRECTIONAL
        to_light = V(col(L_POS), col(L_POS + 1), col(L_POS + 2)) - origin
        dist = to_light.norm()
        toward = -V.of(lt, L_DIR).unit()  # (B,) components
        dirn = V(toward.x[:, None], toward.y[:, None], toward.z[:, None]).where(
            directional, to_light / dist)
        far = torch.where(directional, math.inf, dist)
        ask = hit & (col(L_CASTSHADOW) > 0) & (col(L_HEADLIGHT) == 0) & (n.dot(dirn) > 0)
        beam = _Beam(origin, toward) if bool(directional.all()) else None
        blocked = _trace(sc, origin, dirn, ask, skip_planes=True, any_hit=True, tmax=far, cull=beam)
        out.append(torch.where(blocked, 0.0, 1.0))
    return out


def _shade(sc: _Scenes, tex: Textures, idx, o: V, d: V, t, gi, n: V, local: V, lit,
           pixel_angle=None):
    """Lit, textured colour (M, 3) of the hits idx (into the flattened
    (B, P) rays)."""
    P = gi.shape[1]
    f = idx // P
    o, d, n, local = (_gather(v, idx, P) for v in (o, d, n, local))
    t = t.reshape(-1)[idx]
    rows = sc.geoms[f, gi.reshape(-1)[idx]]
    p = o + d * t
    v = -d
    foot = None
    if pixel_angle is not None:  # world length a pixel spans on the surface
        foot = t * pixel_angle[f] / torch.clamp(n.dot(v).abs(), min=1e-3)
    texc = _texture(tex, rows, local, foot)
    primary, secondary = _light(sc, f, rows, p, n, v, [None if x is None else x.reshape(-1)[idx]
                                                          for x in lit])
    col = torch.clamp(primary, 0.0, 1.0) * texc + secondary
    return torch.clamp(col, 0.0, 1.0)


def _nonzero(mask):
    return mask.reshape(-1).nonzero().squeeze(-1)


def _reflect(v: V, nz: V) -> V:
    return v - nz * (v.dot(nz) * 2)


def render_batch(scenes: Sequence[dict], tex: Textures, width: int, height: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames of `scenes`, on the textures' device."""
    dev = tex.device
    sc = _Scenes(scenes, dev)
    cam = sc.cam
    B = len(scenes)
    half_h = (cam["top"] - cam["bottom"]) * 0.5
    half_w = torch.where(cam["width"] > 0, cam["width"] * 0.5, half_h * (width / height))
    left = cam["center"] - half_w
    j = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5) / width
    i = (torch.arange(height, device=dev, dtype=torch.float32) + 0.5) / height
    x = (left[:, None] + (2 * half_w)[:, None] * j[None, :])[:, None, :]
    y = (cam["top"][:, None] - (cam["top"] - cam["bottom"])[:, None] * i[None, :])[:, :, None]

    def grid(v: V) -> V:  # (B,) components -> (B, 1, 1)
        return V(v.x[:, None, None], v.y[:, None, None], v.z[:, None, None])

    fwd, up = cam["forward"], cam["up"]
    right = fwd.cross(up)
    plane = grid(right) * x + grid(up) * y  # the pixel's offset in the image plane, (B, H, W)
    d = (plane + grid(fwd) * cam["near"][:, None, None]).unit()
    o = grid(cam["pos"])
    ortho = bool(cam["orthographic"].any())
    if ortho:
        on = cam["orthographic"][:, None, None]
        d = grid(fwd).where(on, d)
        o = (o + plane).where(on, o)
    shape = (B, height * width)
    d = V(*(c.reshape(shape) for c in (d.x, d.y, d.z)))
    o = V(*(c.reshape(B, -1) for c in (o.x, o.y, o.z)))  # (B, 1), or (B, P) orthographic

    def screen(pos: V, r: V, u: V, f: V):
        if ortho:
            return None
        return _Screen(pos, r, u, f, cam["near"], left, cam["top"], 2 * half_w / width,
                       2 * half_h / height, height, width)

    t, gi, n, local = _trace(sc, o, d, torch.ones(shape, dtype=torch.bool, device=dev),
                             cull=screen(cam["pos"], right, up, fwd))
    depth = t * d.dot(V(fwd.x[:, None], fwd.y[:, None], fwd.z[:, None]))
    hit = (gi >= 0) & (depth >= cam["near"][:, None]) & (depth <= cam["far"][:, None])
    p = o + d * torch.where(hit, t, 0.0)
    lit = _shadows(sc, p, n, hit)
    col = torch.empty(B * height * width, 3, device=dev)
    miss = _nonzero(~hit)
    col[miss] = _sky(tex, _gather(d, miss, shape[1]))
    h = _nonzero(hit)
    if h.numel():
        pixel_angle = (cam["top"] - cam["bottom"]) / (cam["near"] * height)
        col[h] = _shade(sc, tex, h, o, d, t, gi, n, local, lit, pixel_angle)
    # one bounce off each reflective plane: the scene seen from the camera
    # mirrored in the plane, beyond the plane
    for g, gtype in enumerate(sc.types):
        refl = sc.geoms[:, g, G_REFLECTANCE]
        if gtype != PLANE or not bool((refl > 0).any()):
            continue
        mirror = hit & (gi == g) & (refl[:, None] > 0)
        if not bool(mirror.any()):
            continue
        rows = sc.geoms[:, g]
        nz = V(rows[:, G_MAT + 2], rows[:, G_MAT + 5], rows[:, G_MAT + 8])
        at = V.of(rows, G_POS)
        mpos = cam["pos"] - nz * ((cam["pos"] - at).dot(nz) * 2)
        nzb, atb = (V(v.x[:, None], v.y[:, None], v.z[:, None]) for v in (nz, at))
        rd = _reflect(d, nzb)
        ro = o - nzb * ((o - atb).dot(nzb) * 2)  # the origins mirrored in the plane
        rt, rgi, rn, rl = _trace(sc, ro, rd, mirror, skip_planes=True, tmin=t + OFFSET,
                                 cull=screen(mpos, _reflect(right, nz), _reflect(up, nz),
                                             _reflect(fwd, nz)))
        rc = torch.empty(B * height * width, 3, device=dev)
        rmiss = _nonzero(mirror & (rgi < 0))
        rc[rmiss] = _sky(tex, _gather(rd, rmiss, shape[1]))
        rhit = _nonzero(mirror & (rgi >= 0))
        if rhit.numel():
            rc[rhit] = _shade(sc, tex, rhit, ro, rd, rt, rgi, rn, rl, [None] * len(sc.casts))
        m = _nonzero(mirror)
        r = refl[m // shape[1]].unsqueeze(-1)
        col[m] = col[m] * (1 - r) + rc[m] * r
    img = torch.round(col * 255.0).to(torch.uint8)
    return img.reshape(B, height, width, 3)


def render_scenes(scenes: List[dict], textures, *, width: int = 480, height: int = 480,
                  device=None, batch: int = 8) -> np.ndarray:
    """(N, H, W, 3) uint8 frames of N scenes, cast on `device` (default the
    CPU) `batch` frames at a time, each batch copied to the host once.
    `textures` is `NativeVecEnv.textures()`'s dict or a `Textures`."""
    device = torch.device("cpu") if device is None else torch.device(device)
    tex = textures if isinstance(textures, Textures) else Textures(textures, device)
    out = np.empty((len(scenes), height, width, 3), np.uint8)
    for k in range(0, len(scenes), batch):
        out[k:k + batch] = render_batch(scenes[k:k + batch], tex, width, height).cpu().numpy()
    return out
