"""The plain reference: the renderer's estimator in plain PyTorch, from the
raw scene, for the pixels that a run checks.

It is the upstream path tracer's semantics (mad-s/hijiki
``shader/render.glsl:81-146`` and its callees: xorshift32 with Wang-hash
seeding, next-event estimation towards one uniformly picked emitter,
cosine-weighted diffuse sampling, mirrors, smooth dielectrics with
Beer-Lambert extinction, Russian roulette after the fourth bounce) and of
its image: the block schedule of per-pixel seeds and sweep jitter, the
bilateral reconstruction of each sweep (radius R, its block-boundary
quirks), the (rgb * w, w) film and its normalization. Each path is traced
in f32 with the expression order of the scalar transcription (every sum of
products left to right, no fused operation), so the program and the
reference agree to rounding except where a rounding flips a sampling
decision.

Closest hits are exact over every primitive: a bounding-box hierarchy,
built here from the raw triangles and spheres (Morton order, 8 children a
node, boxes padded so that no hit is culled), only prunes the pairs
tested; the winner is the least t, the lowest primitive index on a tie.

``dtype`` computes every float in another precision (the control runs the
reference in bfloat16). Imports numpy, torch and the benchmark's own
``scene_input``, nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scene_input import RawScene

M_EPS = 1e-4
PI = float(np.float32(math.pi))
TWO_PI = float(np.float32(2.0) * np.float32(math.pi))
MASK32 = 0xFFFFFFFF
TAGS = {"diffuse": 0, "checkerboard": 1, "mirror": 2, "dielectric": 3, "emissive": 4}
FAN = 8  # children a hierarchy node, primitives a leaf
RAY_CHUNK = 8192


def emitter_pick_thresholds(pdf: np.ndarray) -> np.ndarray:
    """Upstream picks the first emitter i at which ``u - pdf_0 - ... - pdf_i``
    (f32, left to right) goes negative, emitter 0 where none does. That is
    ``u < C_i`` for the least f32 C_i with a non-negative chain: found by
    bisection on the f32 chain itself."""
    E = len(pdf)
    pdf = np.asarray(pdf, np.float32)

    def chains_ge0(u):
        r = u.astype(np.float32).copy()
        for j in range(E):
            r[j:] -= pdf[j]
        return r >= 0

    lo = np.zeros(E, np.float32)
    hi = np.full(E, 2.0, np.float32)
    ge_lo = chains_ge0(lo)
    out = np.where(ge_lo, lo, hi)
    active = ~ge_lo & chains_ge0(hi)
    while active.any():
        mid = ((lo.astype(np.float64) + hi.astype(np.float64)) / 2.0).astype(np.float32)
        done = active & ((mid == lo) | (mid == hi))
        out[done] = hi[done]
        active &= ~done
        ge = chains_ge0(mid)
        hi = np.where(active & ge, mid, hi)
        lo = np.where(active & ~ge, mid, lo)
    return out


# --- small vector helpers: (..., 3) tensors, sums left to right ------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a):
    return a / torch.sqrt(dot(a, a))[..., None]


def wang_hash(s):
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & MASK32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & MASK32
    return s ^ (s >> 15)


class Reference:
    """The estimator over one raw scene on ``device`` in ``dtype``."""

    def __init__(self, raw: RawScene, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(self.device, dtype)
        S, T = len(raw.spheres), len(raw.tris)
        self.num_spheres = S
        # primitives in the upstream shape order: spheres, then triangles
        a = np.zeros((S + T, 3), np.float32)
        b = np.zeros((S + T, 3), np.float32)
        c = np.zeros((S + T, 3), np.float32)
        mat = np.zeros(S + T, np.int64)
        for i, (center, radius, m) in enumerate(raw.spheres):
            a[i], b[i, 0], mat[i] = center, radius, m
        v0 = raw.positions[raw.tris[:, 0]]
        a[S:] = v0
        b[S:] = raw.positions[raw.tris[:, 1]] - v0
        c[S:] = raw.positions[raw.tris[:, 2]] - v0
        mat[S:] = raw.tri_mat
        self.a, self.b, self.c = f(a), f(b), f(c)
        self.plane_n = cross(self.b, self.c)
        self.prim_mat = torch.as_tensor(mat, device=self.device)
        self.tri_idx = torch.as_tensor(raw.tris.astype(np.int64), device=self.device)
        self.vpos, self.vnrm, self.vuv = f(raw.positions), f(raw.normals), f(raw.uvs)

        mats = raw.materials
        n_m = len(mats)
        tag = np.array([TAGS[m["type"]] for m in mats], np.int64)
        col = np.zeros((n_m, 3), np.float32)
        cb1, cb2 = np.zeros((n_m, 3), np.float32), np.zeros((n_m, 3), np.float32)
        cbs = np.ones((n_m, 2), np.float32)
        ext, eta = np.zeros((n_m, 3), np.float32), np.ones(n_m, np.float32)
        power = np.zeros((n_m, 3), np.float32)
        for i, m in enumerate(mats):
            if m["type"] == "diffuse":
                col[i] = m["color"]
            elif m["type"] == "checkerboard":
                cb1[i], cb2[i], cbs[i] = m["color1"], m["color2"], (m["scale_u"], m["scale_v"])
            elif m["type"] == "dielectric":
                ext[i], eta[i] = m.get("extinction", (0.0, 0.0, 0.0)), m["eta"]
            elif m["type"] == "emissive":
                power[i] = m["power"]
        self.mat_tag = torch.as_tensor(tag, device=self.device)
        self.mat_color, self.mat_cb1, self.mat_cb2 = f(col), f(cb1), f(cb2)
        self.mat_cbs, self.mat_ext, self.mat_eta, self.mat_power = f(cbs), f(ext), f(eta), f(power)

        emitters = np.nonzero(tag[mat] == TAGS["emissive"])[0]
        if len(emitters) == 0:
            raise ValueError("the scene has no emitter")
        pdf = np.full(len(emitters), 1.0 / len(emitters), np.float32)
        self.em_prim = torch.as_tensor(emitters, device=self.device)
        self.em_pdf = float(pdf[0])
        self.em_cdf = f(emitter_pick_thresholds(pdf))
        self._build_hierarchy(a, b, c, S)

    # --- the box hierarchy (prunes pairs only) ------------------------------

    def _build_hierarchy(self, a, b, c, S):
        a64, b64, c64 = a.astype(np.float64), b.astype(np.float64), c.astype(np.float64)
        lo, hi = a64.copy(), a64.copy()
        r = b64[:S, 0:1]
        lo[:S], hi[:S] = a64[:S] - r, a64[:S] + r
        for e in (a64[S:] + b64[S:], a64[S:] + c64[S:]):
            lo[S:] = np.minimum(lo[S:], e)
            hi[S:] = np.maximum(hi[S:], e)
        extent = float(np.max(hi.max(0) - lo.min(0)))
        pad = 1e-4 * extent + 1e-5
        lo, hi = lo - pad, hi + pad
        cen = (lo + hi) * 0.5
        g = np.clip(((cen - cen.min(0)) / max(np.ptp(cen, 0).max(), 1e-30) * 1023).astype(np.int64), 0, 1023)
        code = np.zeros(len(g), np.int64)
        for bit in range(10):
            for ax in range(3):
                code |= ((g[:, ax] >> bit) & 1) << (3 * bit + (2 - ax))
        order = np.argsort(code, kind="stable")
        P = len(order)
        n_leaf = -(-P // FAN)
        slots = np.full(n_leaf * FAN, -1, np.int64)
        slots[:P] = order
        self.leaf_prims = torch.as_tensor(slots, device=self.device)
        lvl_lo = np.where(slots[:, None] >= 0, lo[slots], np.inf).reshape(n_leaf, FAN, 3).min(1)
        lvl_hi = np.where(slots[:, None] >= 0, hi[slots], -np.inf).reshape(n_leaf, FAN, 3).max(1)
        self.levels = []  # leaves first
        while True:
            f = lambda x: torch.as_tensor(x.astype(np.float32)).to(self.device, self.dtype)
            self.levels.append((f(lvl_lo), f(lvl_hi)))
            n = len(lvl_lo)
            if n <= FAN:
                break
            m = -(-n // FAN)
            pl = np.full((m * FAN, 3), np.inf)
            ph = np.full((m * FAN, 3), -np.inf)
            pl[:n], ph[:n] = lvl_lo, lvl_hi
            lvl_lo, lvl_hi = pl.reshape(m, FAN, 3).min(1), ph.reshape(m, FAN, 3).max(1)

    def _box_hits(self, ray, node, level, o, inv, tmin, tmax):
        lo, hi = self.levels[level][0][node], self.levels[level][1][node]
        oo, ii = o[ray], inv[ray]
        t1, t2 = (lo - oo) * ii, (hi - oo) * ii
        bad = torch.isnan(t1) | torch.isnan(t2)  # on a slab's plane with d = 0
        tn = torch.where(bad, -math.inf, torch.minimum(t1, t2)).amax(-1)
        tf = torch.where(bad, math.inf, torch.maximum(t1, t2)).amin(-1)
        return torch.maximum(tn, tmin[ray]) <= torch.minimum(tf, tmax[ray])

    def _candidates(self, o, d, tmin, tmax):
        """(ray, prim) pairs whose boxes the rays pass within [tmin, tmax]."""
        dev = self.device
        inv = 1.0 / d
        top = len(self.levels) - 1
        n_top = self.levels[top][0].shape[0]
        R = o.shape[0]
        ray = torch.arange(R, device=dev).repeat_interleave(n_top)
        node = torch.arange(n_top, device=dev).repeat(R)
        keep = self._box_hits(ray, node, top, o, inv, tmin, tmax)
        ray, node = ray[keep], node[keep]
        kids = torch.arange(FAN, device=dev)
        for level in range(top - 1, -1, -1):
            n = self.levels[level][0].shape[0]
            ray = ray.repeat_interleave(FAN)
            node = (node[:, None] * FAN + kids).reshape(-1)
            ok = node < n
            ray, node = ray[ok], node[ok]
            keep = self._box_hits(ray, node, level, o, inv, tmin, tmax)
            ray, node = ray[keep], node[keep]
        prim = self.leaf_prims[(node[:, None] * FAN + kids).reshape(-1)]
        ray = ray.repeat_interleave(FAN)
        ok = prim >= 0
        return ray[ok], prim[ok]

    def _prim_tests(self, ray, prim, o, d, tmin, tmax):
        """(hit, t, u, v) of each pair: the scalar transcription's tests."""
        oo, dd_, a = o[ray], d[ray], self.a[prim]
        lo_t, hi_t = tmin[ray], tmax[ray]
        ro = oo - a
        sph = prim < self.num_spheres
        # sphere
        r = self.b[prim][:, 0]
        sb = 2.0 * dot(dd_, ro)
        sc = ro[:, 0] * ro[:, 0] + ro[:, 1] * ro[:, 1] + ro[:, 2] * ro[:, 2] - r * r
        disc = sb * sb - 4.0 * sc
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        st0, st1 = -0.5 * (sb + sq), -0.5 * (sb - sq)
        ok0 = (lo_t <= st0) & (st0 <= hi_t)
        ok1 = (lo_t <= st1) & (st1 <= hi_t)
        s_hit = (disc >= 0.0) & (ok0 | ok1)
        s_t = torch.where(ok0, st0, st1)
        # triangle
        n = self.plane_n[prim]
        denom = dot(dd_, n)
        inv = 1.0 / denom
        t = inv * -dot(n, ro)
        q = cross(ro, dd_)
        u = inv * -dot(q, self.c[prim])
        v = inv * dot(q, self.b[prim])
        t_hit = (lo_t <= t) & (t <= hi_t) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        hit = torch.where(sph, s_hit, t_hit)
        zero = torch.zeros_like(u)
        return hit, torch.where(sph, s_t, t), torch.where(sph, zero, u), torch.where(sph, zero, v)

    def closest(self, o, d, tmin, tmax):
        """(found, t, prim, u, v) per ray: the least t, lowest index on a tie."""
        R = o.shape[0]
        dev = self.device
        out_t = torch.full((R,), math.inf, device=dev, dtype=self.dtype)
        out_p = torch.full((R,), -1, device=dev, dtype=torch.int64)
        out_u = torch.zeros((R,), device=dev, dtype=self.dtype)
        out_v = torch.zeros((R,), device=dev, dtype=self.dtype)
        for s in range(0, R, RAY_CHUNK):
            sl = slice(s, min(s + RAY_CHUNK, R))
            ray, prim = self._candidates(o[sl], d[sl], tmin[sl], tmax[sl])
            hit, t, u, v = self._prim_tests(ray, prim, o[sl], d[sl], tmin[sl], tmax[sl])
            ray, prim, t, u, v = ray[hit], prim[hit], t[hit], u[hit], v[hit]
            n = sl.stop - sl.start
            best = torch.full((n,), math.inf, device=dev, dtype=self.dtype)
            best = best.scatter_reduce(0, ray, t, "amin")
            win = t == best[ray]
            big = torch.iinfo(torch.int64).max
            bp = torch.full((n,), big, device=dev, dtype=torch.int64)
            bp = bp.scatter_reduce(0, ray[win], prim[win], "amin")
            sel = win & (prim == bp[ray])
            rs = ray[sel] + s
            out_t[rs], out_p[rs], out_u[rs], out_v[rs] = t[sel], prim[sel], u[sel], v[sel]
        return out_p >= 0, out_t, out_p, out_u, out_v

    def occluded(self, o, d, tmin, tmax):
        R = o.shape[0]
        out = torch.zeros(R, dtype=torch.bool, device=self.device)
        for s in range(0, R, RAY_CHUNK):
            sl = slice(s, min(s + RAY_CHUNK, R))
            ray, prim = self._candidates(o[sl], d[sl], tmin[sl], tmax[sl])
            hit = self._prim_tests(ray, prim, o[sl], d[sl], tmin[sl], tmax[sl])[0]
            out[ray[hit] + s] = True
        return out

    # --- the estimator ------------------------------------------------------

    def camera_rays(self, px, py, raw: RawScene, width: int, height: int):
        """Pinhole rays through image positions (px, py): upstream's
        quaternion as a rotation matrix in double, each entry and the pixel
        scale rounded to f32 at use."""
        qx, qy, qz, qw = (float(x) for x in raw.cam_rotation)
        R = (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw),
             2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw),
             2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy))
        R = [float(np.float32(x)) for x in R]
        scale = float(np.float32(math.tan(math.radians(0.5 * raw.cam_fov)) / (0.5 * width)))
        lx = (px - float(np.float32(0.5 * width))) * scale
        ly = -(py - float(np.float32(0.5 * height))) * scale
        d = torch.stack([R[0] * lx + R[1] * ly - R[2], R[3] * lx + R[4] * ly - R[5],
                         R[6] * lx + R[7] * ly - R[8]], -1)
        inv = 1.0 / torch.sqrt(dot(d, d))
        d = d * inv[:, None]
        o = torch.as_tensor(raw.cam_position, device=self.device, dtype=self.dtype).expand_as(d)
        return o.contiguous(), d

    def _uniform(self, st, idx):
        s = st[idx]
        s = s ^ ((s << 13) & MASK32)
        s = s ^ (s >> 17)
        s = s ^ ((s << 5) & MASK32)
        st[idx] = s
        return s.to(self.dtype) * (1.0 / 4294967296.0)

    def _checker(self, m, uvx, uvy):
        sc = self.mat_cbs[m]
        stx = 0.5 * uvx / sc[:, 0]
        sty = 0.5 * uvy / sc[:, 1]
        stx = stx - torch.floor(stx)
        sty = sty - torch.floor(sty)
        flip = (stx < 0.5) ^ (sty < 0.5)
        return torch.where(flip[:, None], self.mat_cb2[m], self.mat_cb1[m])

    def trace(self, o, d, seeds, max_bounces: int):
        """Trace one path per ray from u32 ``seeds`` (int64 tensor): returns
        (radiance (N, 3), first-hit normal (N, 3), zero where none)."""
        dev, dt = self.device, self.dtype
        N = o.shape[0]
        o, d = o.clone(), d.clone()
        tmin = torch.full((N,), M_EPS, device=dev, dtype=dt)
        total = torch.zeros((N, 3), device=dev, dtype=dt)
        thr = torch.ones((N, 3), device=dev, dtype=dt)
        ext = torch.zeros((N, 3), device=dev, dtype=dt)
        discrete = torch.ones(N, dtype=torch.bool, device=dev)
        normal = torch.zeros((N, 3), device=dev, dtype=dt)
        st = wang_hash(seeds.to(dev, torch.int64) & MASK32)
        act = torch.arange(N, device=dev)
        inf = torch.full((N,), math.inf, device=dev, dtype=dt)
        for bounce in range(max_bounces):
            if act.numel() == 0:
                break
            found, t, prim, u, v = self.closest(o[act], d[act], tmin[act], inf[act])
            act, t, prim, u, v = act[found], t[found], prim[found], u[found], v[found]
            if act.numel() == 0:
                break
            oa, da = o[act], d[act]
            p = oa + t[:, None] * da
            # populate: the surface frame and uv at the hit
            sph = prim < self.num_spheres
            a = self.a[prim]
            ns = (p - a) / self.b[prim][:, 0:1]
            ts = normalize(torch.stack([-ns[:, 2], torch.zeros_like(ns[:, 0]), ns[:, 0]], -1))
            bs = cross(ns, ts)
            su = 0.5 + torch.atan2(ns[:, 2], ns[:, 0]) / TWO_PI
            su = torch.where(torch.isnan(su), 0.0, su)
            sv = 0.5 + torch.asin(torch.clamp(ns[:, 1], -1.0, 1.0)) / PI
            ti = self.tri_idx[torch.clamp_min(prim - self.num_spheres, 0)]
            l0 = 1.0 - u - v
            vn = [self.vnrm[ti[:, k]] for k in range(3)]
            nt = normalize(vn[0] * l0[:, None] + vn[1] * u[:, None] + vn[2] * v[:, None])
            uvs = [self.vuv[ti[:, k]] for k in range(3)]
            tu = uvs[0][:, 0] * l0 + uvs[1][:, 0] * u + uvs[2][:, 0] * v
            tv = uvs[0][:, 1] * l0 + uvs[1][:, 1] * u + uvs[2][:, 1] * v
            use_y = torch.abs(nt[:, 0]) > torch.abs(nt[:, 1])
            seed_v = torch.zeros_like(nt)
            seed_v[:, 1] = use_y.to(dt)
            seed_v[:, 0] = (~use_y).to(dt)
            tt = normalize(cross(nt, seed_v))
            bt = cross(nt, tt)
            s3 = sph[:, None]
            n = torch.where(s3, ns, nt)
            fr_t, fr_b = torch.where(s3, ts, tt), torch.where(s3, bs, bt)
            uvx, uvy = torch.where(sph, su, tu), torch.where(sph, sv, tv)
            if bounce == 0:
                normal[act] = n
            m = self.prim_mat[prim]
            tag = self.mat_tag[m]
            dv = p - oa
            dist = torch.sqrt(dot(dv, dv))
            th = thr[act] * torch.exp(-ext[act] * dist[:, None])
            tot = total[act]
            em = (tag == TAGS["emissive"]) & discrete[act]
            tot = torch.where(em[:, None], tot + th * self.mat_power[m], tot)
            difish = (tag == TAGS["diffuse"]) | (tag == TAGS["checkerboard"])
            color = torch.where((tag == TAGS["checkerboard"])[:, None],
                                self._checker(m, uvx, uvy), self.mat_color[m])

            # next-event estimation (diffuse surfaces: three draws)
            di = torch.nonzero(difish).squeeze(1)
            if di.numel():
                gi = act[di]
                u_pick = self._uniform(st, gi)
                u1, u2 = self._uniform(st, gi), self._uniform(st, gi)
                e = torch.sum(u_pick[:, None] >= self.em_cdf[None, :], 1)
                e = torch.where(e >= self.em_cdf.numel(), 0, e)
                ep = self.em_prim[e]
                ps, nsf, pdf_s = self._emitter_point(ep, u1, u2)
                pw = self.mat_power[self.prim_mat[ep]]
                ref = p[di]
                dvec = ps - ref
                sdist = torch.sqrt(dot(dvec, dvec))
                sdir = dvec / sdist[:, None]
                cos_t = -dot(sdir, nsf)
                pdf = self.em_pdf * pdf_s * sdist * sdist / cos_t
                imp = torch.where((cos_t < 0.0)[:, None], 0.0, pw / pdf[:, None])
                nd = n[di]
                gate = (torch.sqrt(dot(imp, imp)) > M_EPS) & (dot(sdir, nd) > 0.0)
                gj = torch.nonzero(gate).squeeze(1)
                if gj.numel():
                    occ = self.occluded(ref[gj], sdir[gj],
                                        torch.full((gj.numel(),), 2.0 * M_EPS, device=dev, dtype=dt),
                                        sdist[gj] - M_EPS)
                    add = gj[~occ]
                    k = di[add]
                    ev = dot(nd[add], sdir[add])[:, None] * color[k] / PI
                    tot[k] = tot[k] + th[k] * ev * imp[add]

            # BSDF sampling
            wo = da.clone()
            w = torch.zeros_like(th)
            if di.numel():
                gi = act[di]
                b1, b2 = self._uniform(st, gi), self._uniform(st, gi)
                rad = torch.sqrt(b1)
                theta = TWO_PI * b2
                lx, ly = rad * torch.cos(theta), rad * torch.sin(theta)
                lz = torch.sqrt(torch.clamp_min(1.0 - b1, 0.0))
                wo[di] = fr_t[di] * lx[:, None] + fr_b[di] * ly[:, None] + n[di] * lz[:, None]
                w[di] = color[di]
            mi = torch.nonzero(tag == TAGS["mirror"]).squeeze(1)
            if mi.numel():
                nm, im = n[mi], da[mi]
                wo[mi] = im - (2.0 * dot(nm, im))[:, None] * nm
                w[mi] = 1.0
            ne = ext[act]
            li = torch.nonzero(tag == TAGS["dielectric"]).squeeze(1)
            if li.numel():
                wo_l, ext_l = self._dielectric(m[li], n[li], da[li], act[li], st, ne[li])
                wo[li], ne[li] = wo_l, ext_l
                w[li] = 1.0
            th = th * w
            # Russian roulette after the fourth bounce
            live = torch.ones(act.numel(), dtype=torch.bool, device=dev)
            if bounce > 3:
                q = torch.clamp_max(th.amax(1), 0.99)
                live = self._uniform(st, act) <= q
                th = torch.where(live[:, None], th / q[:, None], th)
            total[act], thr[act], ext[act] = tot, th, ne
            o[act], d[act] = p, wo
            tmin[act] = 2.0 * M_EPS
            discrete[act] = ~difish
            act = act[live]
        return total, normal

    def _emitter_point(self, ep, u1, u2):
        """A point on each picked emitter: (point, unit normal, area pdf)."""
        sph = ep < self.num_spheres
        a = self.a[ep]
        r = self.b[ep][:, 0]
        z = 2.0 * u1 - 1.0
        theta = TWO_PI * u2
        rr = torch.sqrt(1.0 - z * z)
        n_s = torch.stack([rr * torch.cos(theta), rr * torch.sin(theta), z], -1)
        p_s = a + r[:, None] * n_s
        pdf_sph = 1.0 / (r * r * 4.0 * PI)
        ti = self.tri_idx[torch.clamp_min(ep - self.num_spheres, 0)]
        fu = torch.where(u1 + u2 > 1.0, 1.0 - u2, u1)
        l0, l1 = fu, u2
        l2 = 1.0 - fu - u2
        vp = [self.vpos[ti[:, k]] for k in range(3)]
        vn = [self.vnrm[ti[:, k]] for k in range(3)]
        cr = cross(vp[1] - vp[0], vp[2] - vp[0])
        area = torch.sqrt(dot(cr, cr)) / 2.0
        n_t = normalize(vn[0] * l0[:, None] + vn[1] * l1[:, None] + vn[2] * l2[:, None])
        p_t = vp[0] * l0[:, None] + vp[1] * l1[:, None] + vp[2] * l2[:, None]
        s3 = sph[:, None]
        return (torch.where(s3, p_s, p_t), torch.where(s3, n_s, n_t),
                torch.where(sph, pdf_sph, 1.0 / area))

    def _dielectric(self, m, n, wi, gidx, st, ext):
        """Smooth dielectric (upstream's material.glsl, its quirks kept):
        returns (wo, extinction)."""
        eta0 = self.mat_eta[m]
        eta_inv0 = 1.0 / eta0
        cos_i0 = -dot(n, wi)
        flip = cos_i0 < 0.0
        eta = torch.where(flip, eta_inv0, eta0)
        eta_inv = torch.where(flip, 1.0 / eta_inv0, eta_inv0)
        nn = torch.where(flip[:, None], -n, n)
        cos_i = torch.where(flip, -cos_i0, cos_i0)
        k = 1.0 - eta_inv * eta_inv * (1.0 - cos_i * cos_i)
        tir = k <= 0.0
        cos_o = torch.sqrt(torch.clamp_min(k, 0.0))
        rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o)
        rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o)
        f_r = 0.5 * (rho_par * rho_par + rho_orth * rho_orth)
        u = torch.ones_like(f_r)
        draw = torch.nonzero(~tir).squeeze(1)
        if draw.numel():
            u[draw] = self._uniform(st, gidx[draw])
        refl = tir | (u < f_r)
        dn = dot(wi, nn)
        wr = wi - (2.0 * dn)[:, None] * nn
        wt = eta_inv[:, None] * (wi - dn[:, None] * nn) - cos_o[:, None] * nn
        inside = (cos_i0 > 0.0) ^ (~refl)
        ext = torch.where(inside[:, None], self.mat_ext[m], ext)
        return torch.where(refl[:, None], wr, wt), ext


# --- the image: block schedule, reconstruction, film ------------------------

def block_schedule(seed: int, width: int, height: int, block: int, spp: int):
    """Each sweep's jitter (spp, 2) f32 and block seeds (spp, nby, nbx) u32,
    drawn sweep by sweep from numpy's PCG64 seeded with the job's seed."""
    rng = np.random.default_rng(np.uint64(int(seed) & (2**64 - 1)))
    nbx, nby = -(-width // block), -(-height // block)
    offs, seeds = [], []
    for _ in range(spp):
        offs.append(rng.random(2, dtype=np.float32))
        seeds.append(rng.integers(0, 1 << 32, size=(nby, nbx), dtype=np.uint32))
    return np.stack(offs), np.stack(seeds)


def pixel_seeds(block_seeds, xs, ys, width: int, block: int):
    """Per-pixel seed of pixels (xs, ys): block seed + lx + ly * (the
    block's width clipped to the image), mod 2^32 (int64 arrays)."""
    bx, by = xs // block, ys // block
    lx, ly = xs - bx * block, ys - by * block
    bw = np.minimum(block, width - bx * block)
    return (block_seeds[..., by, bx].astype(np.int64) + lx + ly * bw) & MASK32


def spatial_weights(offset, radius: int, stddev: float):
    """(2R+1)^2 weights exp(gf |delta + offset - 0.5|^2) - exp(gf R^2), f32,
    dy-major; negative ones are skipped."""
    f32 = torch.float32
    gf = float(np.float32(-1.0 / (2.0 * stddev * stddev)))
    co = torch.exp(torch.tensor(gf * (radius * radius), dtype=f32))
    so = torch.as_tensor(np.asarray(offset, np.float32)) - 0.5
    out = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            off = torch.stack([dx + so[0], dy + so[1]])
            out.append(torch.exp(gf * (off[0] * off[0] + off[1] * off[1])) - co)
    return torch.stack(out)


def image_pixels(ref: Reference, raw: RawScene, job: dict, corners, patch: int):
    """The normalized image at ``patch`` x ``patch`` pixels from each
    (x0, y0) of ``corners``: (len(corners), patch, patch, 3) in the
    reference's dtype. ``job``: width, height, spp, block_size, seed,
    max_bounces, reconstruction_radius, reconstruction_stddev."""
    W, H, spp, B = job["width"], job["height"], job["spp"], job["block_size"]
    Rr = job["reconstruction_radius"]
    dev, dt = ref.device, ref.dtype
    offs, bseeds = block_schedule(job["seed"], W, H, B, spp)
    side = patch + 2 * Rr
    # every halo pixel of every patch (clamped into the image; a clamped
    # pixel's samples are never read)
    hy, hx = np.mgrid[0:side, 0:side]
    xs = np.concatenate([np.clip(x0 - Rr + hx, 0, W - 1).ravel() for x0, _ in corners])
    ys = np.concatenate([np.clip(y0 - Rr + hy, 0, H - 1).ravel() for _, y0 in corners])
    seeds = pixel_seeds(bseeds, xs, ys, W, B).reshape(-1)  # (spp * n) sweep-major
    n = xs.size
    px = torch.as_tensor(xs, dtype=torch.float32).repeat(spp) + torch.as_tensor(
        offs[:, 0]).repeat_interleave(n)
    py = torch.as_tensor(ys, dtype=torch.float32).repeat(spp) + torch.as_tensor(
        offs[:, 1]).repeat_interleave(n)
    o, d = ref.camera_rays(px.to(dev, dt), py.to(dev, dt), raw, W, H)
    rad, nrm = ref.trace(o, d, torch.as_tensor(seeds, device=dev), job["max_bounces"])
    rad = rad.reshape(spp, len(corners), side, side, 3)
    nrm = nrm.reshape(spp, len(corners), side, side, 3)
    # reconstruction of each sweep at the patches' pixels, summed in sweep order
    film = torch.zeros((len(corners), patch, patch, 4), device=dev, dtype=dt)
    x0s = torch.as_tensor([c[0] for c in corners], device=dev).view(-1, 1, 1)
    y0s = torch.as_tensor([c[1] for c in corners], device=dev).view(-1, 1, 1)
    ar = torch.arange(patch, device=dev)
    ppx, ppy = x0s + ar.view(1, 1, -1), y0s + ar.view(1, -1, 1)
    for s in range(spp):
        wsp = spatial_weights(offs[s], Rr, job["reconstruction_stddev"]).tolist()
        n_c = nrm[s][:, Rr:Rr + patch, Rr:Rr + patch]
        delta = torch.zeros_like(film)
        for dy in range(-Rr, Rr + 1):
            for dx in range(-Rr, Rr + 1):
                w_sp = wsp[(dy + Rr) * (2 * Rr + 1) + (dx + Rr)]
                qx, qy = ppx + dx, ppy + dy
                in_img = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
                ox, oy = torch.div(qx, B, rounding_mode="floor") * B, torch.div(qy, B, rounding_mode="floor") * B
                dw, dh = torch.clamp_max(W - ox, B), torch.clamp_max(H - oy, B)
                lx, ly = ppx - ox, ppy - oy
                in_splat = (lx >= 0) & (ly >= 0) & (lx < dw + Rr) & (ly < dh + Rr)
                center = ((lx < dw) & (ly < dh))[..., None]
                sl = (slice(None), slice(Rr + dy, Rr + dy + patch), slice(Rr + dx, Rr + dx + patch))
                dn = nrm[s][sl] - torch.where(center, n_c, 0.0)
                w = w_sp * torch.exp(-(dot(dn, dn) * 2.0))
                cw = torch.cat([rad[s][sl], torch.ones_like(rad[s][sl][..., :1])], -1)
                contrib = w[..., None] * cw
                ok = (w_sp >= 0.0) & in_img & in_splat & ~torch.isnan(contrib).any(-1)
                delta = delta + torch.where(ok[..., None], contrib, 0.0)
        film = film + delta
    return film[..., :3] / film[..., 3:4]
