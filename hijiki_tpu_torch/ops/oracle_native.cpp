// Native scalar oracle: a C++ twin of the numpy reference integrator
// (ops/oracle.py + tools/oracle_mse.py's prims-vectorized closest-hit),
// itself a per-path transcription of the reference megakernel
// (shader/render.glsl:81-146 and callees, shader/rand.glsl:1-50,
// shader/material.glsl, shader/scene.glsl's brute-force variant).
//
// Purpose: the equal-seed MSE gate (BASELINE north star) needs thousands of
// oracle spp; the numpy oracle costs ~15-30 s/sweep at 64^2 on this host's
// single core, the C++ twin ~milliseconds. Float semantics mirror the numpy
// expression trees exactly (same association order, f32 throughout, no FMA
// contraction — compiled -ffp-contract=off, no fast-math). The only
// divergence class is libm-vs-numpy 1-ulp differences in sinf/cosf/asinf/
// atan2f/expf (sqrtf is bitwise); tests/test_oracle_native.py pins the
// resulting equal-seed agreement (bitwise for most pixels, ~1e-9 MSE).
//
// Plain C ABI; bound via ctypes (ops/oracle_native.py).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

typedef float f32;
typedef uint32_t u32;
typedef int32_t i32;

const f32 M_EPS = 1e-4f;
const f32 PI_F = 3.14159274101257324219f;       // float32(pi)
const f32 TWO_PI_F = 6.28318548202514648438f;   // float32(2.0)*float32(pi)

struct V3 {
    f32 x, y, z;
};

inline V3 v3(f32 x, f32 y, f32 z) { return V3{x, y, z}; }
inline V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
inline V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
inline V3 operator*(V3 a, f32 s) { return v3(a.x * s, a.y * s, a.z * s); }
inline V3 operator*(f32 s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
inline V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
inline V3 operator/(V3 a, f32 s) { return v3(a.x / s, a.y / s, a.z / s); }
inline V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
// sequential left-to-right sum, matching numpy's elementwise x0*y0+x1*y1+x2*y2
inline f32 dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
    return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x);
}
inline f32 norm(V3 a) { return sqrtf(dot(a, a)); }
inline V3 normalize(V3 a) { return a / norm(a); }
inline f32 maxc(V3 a) {
    f32 m = a.x;
    if (a.y > m) m = a.y;
    if (a.z > m) m = a.z;
    return m;
}

// --- RNG: xorshift32 + Wang hash (shader/rand.glsl:1-20) ---------------
struct Rng {
    u32 state;
};

inline u32 wang_hash(u32 seed) {
    seed = (seed ^ 61u) ^ (seed >> 16);
    seed = seed * 9u;
    seed = seed ^ (seed >> 4);
    seed = seed * 0x27D4EB2Du;
    seed = seed ^ (seed >> 15);
    return seed;
}

inline f32 rng_uniform(Rng &r) {
    u32 s = r.state;
    s ^= s << 13;
    s ^= s >> 17;
    s ^= s << 5;
    r.state = s;
    // float(u32) rounds to nearest: 0xFFFFFFFF -> exactly 2^32 -> 1.0f
    return (f32)s * (f32)(1.0 / 4294967296.0);
}

// --- scene ---------------------------------------------------------------
// prim-kind and material-tag constants are passed in from Python (the
// scene/compile.py and scene/model.py values), not hardcoded here.

struct Scene {
    const f32 *prim_a, *prim_b, *prim_c;   // (P,3)
    const i32 *prim_kind;                  // (P,)
    const i32 *prim_shape_id;              // (P,)
    const i32 *prim_tri;                   // (P,3)
    i32 num_prims;
    i32 kind_sphere, kind_tri;             // KIND_* constants
    const u32 *materials;                  // (num_shapes,)
    const f32 *vtx_pos, *vtx_nrm;          // (V,3)
    const f32 *vtx_uv;                     // (V,2)
    const f32 *emitter_cdf, *emitter_pdf;  // (E,)
    const i32 *emitter_shape;              // (E,)
    i32 num_emitters;
    i32 num_spheres, num_quads;
    const f32 *sphere_pos_radius;          // (S,4)
    const f32 *quad_origin, *quad_e1, *quad_e2;  // (Q,3)
    const i32 *tri_indices;                // (T,3)
    const f32 *diffuse_color;              // (D,3)
    const f32 *cb_color1, *cb_color2;      // (C,3)
    const f32 *cb_scale;                   // (C,2)
    const f32 *emissive_power;             // (M,3)
    const f32 *dielectric_ext_eta;         // (L,4)
    i32 material_tag_shift;
    i32 tag_diffuse, tag_mirror, tag_dielectric, tag_emissive, tag_cboard;
    const f32 *plane_n;  // (P,3) precomputed cross(b,c), f32
};

inline V3 ld3(const f32 *p, i32 i) { return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]); }

// prims-vectorized closest-hit semantics (tools/oracle_mse.FastScene):
// every prim tested against the ORIGINAL (tmin, tmax), winner = first
// minimum (strict < keeps the earliest slot, matching np.argmin).
struct Hit {
    i32 slot;
    f32 t, u, v;
};

// tmax is the VALIDITY bound (FastScene semantics: every prim tested
// against the original ray range). `bound` <= tmax is an acceptance-only
// cutoff for the tri/quad early-out: a planar candidate with t > bound
// can never beat the current winner, so skipping its u/v work never
// changes the argmin. Spheres always use the full tmax — their t is
// ok0 ? st0 : st1, and shrinking the range check could flip which root
// is presented.
inline bool prim_candidate(const Scene &S, i32 i, V3 o, V3 d, f32 tmin,
                           f32 tmax, f32 bound, f32 &t, f32 &u, f32 &v) {
    V3 a = ld3(S.prim_a, i);
    i32 kind = S.prim_kind[i];
    V3 ro = o - a;
    if (kind == S.kind_sphere) {
        f32 r = S.prim_b[3 * i];
        f32 sb = 2.0f * dot(d, ro);
        f32 sc = ro.x * ro.x + ro.y * ro.y + ro.z * ro.z - r * r;
        f32 disc = sb * sb - 4.0f * sc;
        f32 sq = sqrtf(disc > 0.0f ? disc : 0.0f);
        f32 st0 = -0.5f * (sb + sq);
        f32 st1 = -0.5f * (sb - sq);
        bool ok0 = (tmin <= st0) && (st0 <= tmax);
        bool ok1 = (tmin <= st1) && (st1 <= tmax);
        t = ok0 ? st0 : st1;
        u = 0.0f;
        v = 0.0f;
        return (disc >= 0.0f) && (ok0 || ok1);
    }
    // tri/quad: Lagrange identity test (FastScene.candidates); plane
    // normals are precomputed per prim (S.plane_n = cross(b,c) in f32 —
    // bitwise the value FastScene caches). t first, u/v only if in range.
    V3 n = v3(S.plane_n[3 * i], S.plane_n[3 * i + 1], S.plane_n[3 * i + 2]);
    f32 denom = d.x * n.x + d.y * n.y + d.z * n.z;
    f32 dd = 1.0f / denom;
    t = dd * -(n.x * ro.x + n.y * ro.y + n.z * ro.z);
    if (!((tmin <= t) && (t <= bound))) return false;
    V3 b = ld3(S.prim_b, i), c = ld3(S.prim_c, i);
    V3 q = cross(ro, d);
    u = dd * -(q.x * c.x + q.y * c.y + q.z * c.z);
    v = dd * (q.x * b.x + q.y * b.y + q.z * b.z);
    if (kind == S.kind_tri)
        return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
    return (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (v <= 1.0f);
}

inline bool closest(const Scene &S, V3 o, V3 d, f32 tmin, f32 tmax, Hit &h) {
    f32 best = INFINITY;
    i32 slot = -1;
    f32 bu = 0, bv = 0;
    f32 bound = tmax;
    for (i32 i = 0; i < S.num_prims; i++) {
        f32 t, u, v;
        if (prim_candidate(S, i, o, d, tmin, tmax, bound, t, u, v) &&
            t < best) {
            best = t;
            slot = i;
            bu = u;
            bv = v;
            bound = best < tmax ? best : tmax;
        }
    }
    if (slot < 0) return false;
    h.slot = slot;
    h.t = best;
    h.u = bu;
    h.v = bv;
    return true;
}

inline bool occluded(const Scene &S, V3 o, V3 d, f32 tmin, f32 tmax) {
    for (i32 i = 0; i < S.num_prims; i++) {
        f32 t, u, v;
        if (prim_candidate(S, i, o, d, tmin, tmax, tmax, t, u, v)) return true;
    }
    return false;
}

// --- populate (ops/oracle._populate) ------------------------------------
struct Surf {
    V3 p, n, tang, bt;
    f32 uvx, uvy;
};

inline Surf populate(const Scene &S, V3 o, V3 d, f32 t, i32 slot, f32 u,
                     f32 v) {
    Surf s;
    V3 a = ld3(S.prim_a, slot), b = ld3(S.prim_b, slot), c = ld3(S.prim_c, slot);
    i32 kind = S.prim_kind[slot];
    s.p = o + t * d;
    if (kind == S.kind_sphere) {
        V3 n = (s.p - a) / b.x;
        s.n = n;
        s.tang = normalize(v3(-n.z, 0.0f, n.x));
        s.bt = cross(n, s.tang);
        f32 uvx = 0.5f + atan2f(n.z, n.x) / TWO_PI_F;
        if (std::isnan(uvx)) uvx = 0.0f;
        f32 cy = n.y;
        if (cy < -1.0f) cy = -1.0f;
        if (cy > 1.0f) cy = 1.0f;
        s.uvx = uvx;
        s.uvy = 0.5f + asinf(cy) / PI_F;
        return s;
    }
    if (kind == S.kind_tri) {
        const i32 *tri = S.prim_tri + 3 * slot;
        f32 l0 = 1.0f - u - v, l1 = u, l2 = v;
        V3 vn0 = ld3(S.vtx_nrm, tri[0]), vn1 = ld3(S.vtx_nrm, tri[1]),
           vn2 = ld3(S.vtx_nrm, tri[2]);
        s.n = normalize(vn0 * l0 + vn1 * l1 + vn2 * l2);
        const f32 *uv0 = S.vtx_uv + 2 * tri[0], *uv1 = S.vtx_uv + 2 * tri[1],
                  *uv2 = S.vtx_uv + 2 * tri[2];
        s.uvx = uv0[0] * l0 + uv1[0] * l1 + uv2[0] * l2;
        s.uvy = uv0[1] * l0 + uv1[1] * l1 + uv2[1] * l2;
        V3 seed = (fabsf(s.n.x) > fabsf(s.n.y)) ? v3(0, 1, 0) : v3(1, 0, 0);
        s.tang = normalize(cross(s.n, seed));
        s.bt = cross(s.n, s.tang);
        return s;
    }
    s.tang = normalize(b);
    s.bt = normalize(c);
    s.n = cross(s.tang, s.bt);
    s.uvx = u;
    s.uvy = v;
    return s;
}

inline V3 checkerboard(const Scene &S, i32 idx, f32 uvx, f32 uvy) {
    f32 su = S.cb_scale[2 * idx], sv = S.cb_scale[2 * idx + 1];
    f32 stx = 0.5f * uvx / su;
    f32 sty = 0.5f * uvy / sv;
    stx = stx - floorf(stx);
    sty = sty - floorf(sty);
    if ((stx < 0.5f) != (sty < 0.5f)) return ld3(S.cb_color2, idx);
    return ld3(S.cb_color1, idx);
}

// --- emitter sampling (ops/oracle._sample_emitter) ----------------------
struct ShadowRay {
    V3 o, d;
    f32 tmin, tmax;
};

inline V3 sample_emitter(const Scene &S, Rng &r, V3 ref_p, ShadowRay &shadow) {
    f32 u_pick = rng_uniform(r);
    i32 emitter = 0;
    for (i32 i = 0; i < S.num_emitters; i++) {
        if (u_pick < S.emitter_cdf[i]) {
            emitter = i;
            break;
        }
    }
    i32 shape = S.emitter_shape[emitter];
    f32 em_pdf = S.emitter_pdf[emitter];
    f32 u1 = rng_uniform(r), u2 = rng_uniform(r);
    i32 Sn = S.num_spheres, Qn = S.num_quads;
    V3 p_s, n_s;
    f32 pdf_s;
    if (shape < Sn) {
        const f32 *sp = S.sphere_pos_radius + 4 * shape;
        f32 z = 2.0f * u1 - 1.0f;
        f32 theta = TWO_PI_F * u2;
        f32 rr = sqrtf(1.0f - z * z);
        n_s = v3(rr * cosf(theta), rr * sinf(theta), z);
        p_s = v3(sp[0], sp[1], sp[2]) + sp[3] * n_s;
        pdf_s = 1.0f / (sp[3] * sp[3] * 4.0f * PI_F);
    } else if (shape < Sn + Qn) {
        i32 qi = shape - Sn;
        V3 qo = ld3(S.quad_origin, qi), e1 = ld3(S.quad_e1, qi),
           e2 = ld3(S.quad_e2, qi);
        n_s = cross(e1, e2);
        f32 area = norm(n_s);
        n_s = n_s / area;
        p_s = qo + u1 * e1 + u2 * e2;
        pdf_s = 1.0f / area;
    } else {
        i32 ti = shape - Sn - Qn;
        const i32 *tri = S.tri_indices + 3 * ti;
        if (u1 + u2 > 1.0f) u1 = 1.0f - u2;  // fold quirk (rand.glsl:44-47)
        f32 l0 = u1, l1 = u2, l2 = 1.0f - u1 - u2;
        V3 vp0 = ld3(S.vtx_pos, tri[0]), vp1 = ld3(S.vtx_pos, tri[1]),
           vp2 = ld3(S.vtx_pos, tri[2]);
        V3 ab = vp1 - vp0, ac = vp2 - vp0;
        f32 area = norm(cross(ab, ac)) / 2.0f;
        V3 vn0 = ld3(S.vtx_nrm, tri[0]), vn1 = ld3(S.vtx_nrm, tri[1]),
           vn2 = ld3(S.vtx_nrm, tri[2]);
        n_s = normalize(vn0 * l0 + vn1 * l1 + vn2 * l2);
        p_s = vp0 * l0 + vp1 * l1 + vp2 * l2;
        pdf_s = 1.0f / area;
    }
    u32 handle = S.materials[shape];
    i32 midx = (i32)(handle & ((1u << S.material_tag_shift) - 1u));
    V3 power = ld3(S.emissive_power, midx);
    V3 dvec = p_s - ref_p;
    f32 dist = norm(dvec);
    V3 direction = dvec / dist;
    f32 cos_theta = -dot(direction, n_s);
    shadow.o = ref_p;
    shadow.d = direction;
    shadow.tmin = 2.0f * M_EPS;
    shadow.tmax = dist - M_EPS;
    if (cos_theta < 0.0f) return v3(0, 0, 0);
    f32 pdf = em_pdf * pdf_s * dist * dist / cos_theta;
    return v3(power.x / pdf, power.y / pdf, power.z / pdf);
}

// --- BSDF (ops/oracle._eval_bsdf / _sample_bsdf) ------------------------
inline V3 eval_bsdf(const Scene &S, u32 handle, V3 wi, V3 n, f32 uvx,
                    f32 uvy) {
    i32 tag = (i32)(handle >> S.material_tag_shift);
    i32 idx = (i32)(handle & ((1u << S.material_tag_shift) - 1u));
    if (tag == S.tag_diffuse) {
        V3 color = ld3(S.diffuse_color, idx);
        return (dot(n, wi) * color) / PI_F;
    }
    if (tag == S.tag_cboard) {
        V3 color = checkerboard(S, idx, uvx, uvy);
        return (dot(n, wi) * color) / PI_F;
    }
    return v3(0, 0, 0);
}

inline V3 reflect(V3 i, V3 n) { return i - (2.0f * dot(n, i)) * n; }

struct BsdfSample {
    V3 wo, weight;
};

inline BsdfSample sample_bsdf_full(const Scene &S, u32 handle, V3 wi, V3 n,
                                   f32 uvx, f32 uvy, V3 frame_t, V3 frame_b,
                                   Rng &r, V3 &extinction) {
    i32 tag = (i32)(handle >> S.material_tag_shift);
    i32 idx = (i32)(handle & ((1u << S.material_tag_shift) - 1u));
    BsdfSample out;
    if (tag == S.tag_diffuse || tag == S.tag_cboard) {
        f32 u1 = rng_uniform(r), u2 = rng_uniform(r);
        f32 rad = sqrtf(u1);
        f32 theta = TWO_PI_F * u2;
        f32 lx = rad * cosf(theta), ly = rad * sinf(theta);
        f32 k = 1.0f - u1;
        f32 lz = sqrtf(k > 0.0f ? k : 0.0f);
        out.wo = frame_t * lx + frame_b * ly + n * lz;
        out.weight = (tag == S.tag_diffuse) ? ld3(S.diffuse_color, idx)
                                            : checkerboard(S, idx, uvx, uvy);
        return out;
    }
    if (tag == S.tag_mirror) {
        out.wo = reflect(wi, n);
        out.weight = v3(1, 1, 1);
        return out;
    }
    if (tag == S.tag_dielectric) {
        const f32 *ee = S.dielectric_ext_eta + 4 * idx;
        f32 eta = ee[3];
        f32 eta_inv = 1.0f / eta;
        f32 cos_i = -dot(n, wi);
        V3 normal = n;
        bool inside = cos_i > 0.0f;
        if (cos_i < 0.0f) {
            // swap via double reciprocal (the reference quirk: the new eta
            // is 1/eta_inv, not the original eta)
            f32 old_inv = eta_inv;
            eta = old_inv;
            eta_inv = 1.0f / old_inv;
            normal = -normal;
            cos_i = -cos_i;
        }
        f32 k = 1.0f - eta_inv * eta_inv * (1.0f - cos_i * cos_i);
        V3 wo;
        if (k <= 0.0f) {
            wo = reflect(wi, normal);
        } else {
            f32 cos_o = sqrtf(k);
            f32 rho_par = (eta * cos_i - cos_o) / (eta * cos_i + cos_o);
            f32 rho_orth = (cos_i - eta * cos_o) / (cos_i + eta * cos_o);
            f32 f_r = 0.5f * (rho_par * rho_par + rho_orth * rho_orth);
            if (rng_uniform(r) < f_r) {
                wo = reflect(wi, normal);
            } else {
                inside = !inside;
                V3 parallel = wi - dot(wi, normal) * normal;
                wo = eta_inv * parallel - sqrtf(k) * normal;
            }
        }
        if (inside) extinction = v3(ee[0], ee[1], ee[2]);
        out.wo = wo;
        out.weight = v3(1, 1, 1);
        return out;
    }
    // emissive: zero weight, wo := wi
    out.wo = wi;
    out.weight = v3(0, 0, 0);
    return out;
}

// --- per-path integrator (tools/oracle_mse.integrate_path_fast) ----------
inline V3 integrate_path(const Scene &S, V3 o, V3 d, u32 seed,
                         i32 max_bounces) {
    Rng r{wang_hash(seed)};
    f32 tmin = M_EPS, tmax = INFINITY;
    V3 total = v3(0, 0, 0);
    V3 throughput = v3(1, 1, 1);
    V3 extinction = v3(0, 0, 0);
    bool was_discrete = true;
    for (i32 bounce = 0; bounce < max_bounces; bounce++) {
        Hit h;
        if (!closest(S, o, d, tmin, tmax, h)) break;
        Surf sf = populate(S, o, d, h.t, h.slot, h.u, h.v);
        u32 handle = S.materials[S.prim_shape_id[h.slot]];
        i32 tag = (i32)(handle >> S.material_tag_shift);

        f32 dist = norm(sf.p - o);
        V3 atten = v3(expf(-extinction.x * dist), expf(-extinction.y * dist),
                      expf(-extinction.z * dist));
        throughput = throughput * atten;

        if (tag == S.tag_emissive && was_discrete) {
            i32 midx = (i32)(handle & ((1u << S.material_tag_shift) - 1u));
            total = total + throughput * ld3(S.emissive_power, midx);
        }

        bool is_diffuse = (tag == S.tag_diffuse || tag == S.tag_cboard);
        if (is_diffuse) {
            ShadowRay shadow;
            V3 importance = sample_emitter(S, r, sf.p, shadow);
            if (norm(importance) > M_EPS && dot(shadow.d, sf.n) > 0.0f) {
                if (!occluded(S, shadow.o, shadow.d, shadow.tmin,
                              shadow.tmax)) {
                    total = total + throughput *
                                        eval_bsdf(S, handle, shadow.d, sf.n,
                                                  sf.uvx, sf.uvy) *
                                        importance;
                }
            }
        }

        BsdfSample bs = sample_bsdf_full(S, handle, d, sf.n, sf.uvx, sf.uvy,
                                         sf.tang, sf.bt, r, extinction);
        throughput = throughput * bs.weight;
        d = bs.wo;
        o = sf.p;
        tmin = 2.0f * M_EPS;
        tmax = INFINITY;
        was_discrete = !is_diffuse;

        if (bounce > 3) {
            f32 q = maxc(throughput);
            if (q > 0.99f) q = 0.99f;
            if (rng_uniform(r) > q) break;
            throughput = throughput / q;
        }
    }
    return total;
}

// --- camera (tools/oracle_mse.camera_ray) --------------------------------
// R matrix in double (camera_static is f64), rounded to f32 at use.
struct Cam {
    double cx, cy, cz;
    double R[9];
    f32 scale;
};

inline Cam make_cam(const double *cam8, i32 W, i32 /*H*/) {
    Cam c;
    c.cx = cam8[0];
    c.cy = cam8[1];
    c.cz = cam8[2];
    double qx = cam8[3], qy = cam8[4], qz = cam8[5], qw = cam8[6];
    c.R[0] = 1 - 2 * (qy * qy + qz * qz);
    c.R[1] = 2 * (qx * qy - qz * qw);
    c.R[2] = 2 * (qx * qz + qy * qw);
    c.R[3] = 2 * (qx * qy + qz * qw);
    c.R[4] = 1 - 2 * (qx * qx + qz * qz);
    c.R[5] = 2 * (qy * qz - qx * qw);
    c.R[6] = 2 * (qx * qz - qy * qw);
    c.R[7] = 2 * (qy * qz + qx * qw);
    c.R[8] = 1 - 2 * (qx * qx + qy * qy);
    double fov = cam8[7];
    c.scale = (f32)(tan(fov * (3.141592653589793 / 180.0) * 0.5) / (0.5 * W));
    return c;
}

inline void camera_ray(const Cam &c, f32 px, f32 py, i32 W, i32 H, V3 &o,
                       V3 &d) {
    f32 lx = (px - (f32)(0.5 * W)) * c.scale;
    f32 ly = -(py - (f32)(0.5 * H)) * c.scale;
    f32 dx = (f32)c.R[0] * lx + (f32)c.R[1] * ly - (f32)c.R[2];
    f32 dy = (f32)c.R[3] * lx + (f32)c.R[4] * ly - (f32)c.R[5];
    f32 dz = (f32)c.R[6] * lx + (f32)c.R[7] * ly - (f32)c.R[8];
    f32 inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    o = v3((f32)c.cx, (f32)c.cy, (f32)c.cz);
    d = v3(dx * inv, dy * inv, dz * inv);
}

}  // namespace

extern "C" {

// Renders n_sweeps full sweeps, accumulating radiance (f64) into
// acc[H][W][3]. seeds: (n_sweeps, W*H) u32; offsets: (n_sweeps, 2) f32.
void hijiki_oracle_render(
    const f32 *prim_a, const f32 *prim_b, const f32 *prim_c,
    const i32 *prim_kind, const i32 *prim_shape_id, const i32 *prim_tri,
    i32 num_prims, i32 kind_sphere, i32 kind_tri, const u32 *materials,
    const f32 *vtx_pos, const f32 *vtx_nrm, const f32 *vtx_uv,
    const f32 *emitter_cdf, const f32 *emitter_pdf, const i32 *emitter_shape,
    i32 num_emitters, i32 num_spheres, i32 num_quads,
    const f32 *sphere_pos_radius, const f32 *quad_origin, const f32 *quad_e1,
    const f32 *quad_e2, const i32 *tri_indices, const f32 *diffuse_color,
    const f32 *cb_color1, const f32 *cb_color2, const f32 *cb_scale,
    const f32 *emissive_power, const f32 *dielectric_ext_eta,
    i32 material_tag_shift, i32 tag_diffuse, i32 tag_mirror,
    i32 tag_dielectric, i32 tag_emissive, i32 tag_cboard, const double *cam8,
    i32 W, i32 H, i32 max_bounces, const u32 *seeds, const f32 *offsets,
    i32 n_sweeps, double *acc) {
    Scene S;
    S.prim_a = prim_a;
    S.prim_b = prim_b;
    S.prim_c = prim_c;
    S.prim_kind = prim_kind;
    S.prim_shape_id = prim_shape_id;
    S.prim_tri = prim_tri;
    S.num_prims = num_prims;
    S.kind_sphere = kind_sphere;
    S.kind_tri = kind_tri;
    S.materials = materials;
    S.vtx_pos = vtx_pos;
    S.vtx_nrm = vtx_nrm;
    S.vtx_uv = vtx_uv;
    S.emitter_cdf = emitter_cdf;
    S.emitter_pdf = emitter_pdf;
    S.emitter_shape = emitter_shape;
    S.num_emitters = num_emitters;
    S.num_spheres = num_spheres;
    S.num_quads = num_quads;
    S.sphere_pos_radius = sphere_pos_radius;
    S.quad_origin = quad_origin;
    S.quad_e1 = quad_e1;
    S.quad_e2 = quad_e2;
    S.tri_indices = tri_indices;
    S.diffuse_color = diffuse_color;
    S.cb_color1 = cb_color1;
    S.cb_color2 = cb_color2;
    S.cb_scale = cb_scale;
    S.emissive_power = emissive_power;
    S.dielectric_ext_eta = dielectric_ext_eta;
    S.material_tag_shift = material_tag_shift;
    S.tag_diffuse = tag_diffuse;
    S.tag_mirror = tag_mirror;
    S.tag_dielectric = tag_dielectric;
    S.tag_emissive = tag_emissive;
    S.tag_cboard = tag_cboard;

    // precompute per-prim plane normals (FastScene caches the same value)
    f32 *plane_n = new f32[(size_t)num_prims * 3];
    for (i32 i = 0; i < num_prims; i++) {
        V3 b = ld3(prim_b, i), c = ld3(prim_c, i);
        V3 n = cross(b, c);
        plane_n[3 * i] = n.x;
        plane_n[3 * i + 1] = n.y;
        plane_n[3 * i + 2] = n.z;
    }
    S.plane_n = plane_n;

    Cam cam = make_cam(cam8, W, H);
    for (i32 s = 0; s < n_sweeps; s++) {
        const u32 *sw_seeds = seeds + (size_t)s * W * H;
        f32 offx = offsets[2 * s], offy = offsets[2 * s + 1];
        for (i32 y = 0; y < H; y++) {
            for (i32 x = 0; x < W; x++) {
                V3 o, d;
                camera_ray(cam, (f32)x + offx, (f32)y + offy, W, H, o, d);
                V3 rad =
                    integrate_path(S, o, d, sw_seeds[y * W + x], max_bounces);
                double *px = acc + 3 * ((size_t)y * W + x);
                px[0] += (double)rad.x;
                px[1] += (double)rad.y;
                px[2] += (double)rad.z;
            }
        }
    }
    delete[] plane_n;
}
}
