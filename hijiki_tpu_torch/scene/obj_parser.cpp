// Native OBJ/MTL parser — C ABI twin of hijiki_tpu/scene/obj.py.
//
// The reference links tobj (a native Rust OBJ loader, src/main.rs:415); this
// is the rebuild's native data loader: one pass over the OBJ (plus minimal
// MTL parses for material names/Kd/Ke), reproducing obj.py's semantics
// exactly — per-model (v,vt,vn[,smoothing-group]) triple dedup, fan
// triangulation, faces-before-usemtl skipped, negative indices, smoothing
// -group normal generation (area-weighted within groups, flat otherwise).
// Python keeps the material name-prefix dispatch and Scene assembly; tests
// assert bit-identical arrays against the pure-Python parser.
//
// Exposed via ctypes (no pybind11 in this environment): parse to an opaque
// handle, query sizes, copy out, free.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct V3 { float x, y, z; };
struct V2 { float u, v; };

struct Material {
  std::string name;
  // double: the Python reference parser stores these as python floats (f64),
  // and material tuples must compare equal across backends
  double kd[3] = {0., 0., 0.};
  double ke[3] = {0., 0., 0.};
  int has_ke = 0;
};

struct Parsed {
  std::vector<V3> positions;   // out vertices
  std::vector<V3> normals;
  std::vector<V2> uvs;
  std::vector<int32_t> tris;     // 3 per triangle
  std::vector<int32_t> tri_mat;  // per-triangle material index
  std::vector<Material> materials;
  bool ok = false;
};

struct Key {
  int64_t vi, ti, ni, sg;
  bool operator==(const Key& o) const {
    return vi == o.vi && ti == o.ti && ni == o.ni && sg == o.sg;
  }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) {
      h ^= v;
      h *= 1099511628211ull;
    };
    mix((uint64_t)k.vi); mix((uint64_t)k.ti);
    mix((uint64_t)k.ni); mix((uint64_t)k.sg);
    return (size_t)h;
  }
};

// whitespace-split tokenizer over one line (in place)
static int split(char* line, char** toks, int max_toks) {
  int n = 0;
  char* p = line;
  while (*p && n < max_toks) {
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) break;
    toks[n++] = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
    if (*p) *p++ = '\0';
  }
  return n;
}

static int64_t resolve_index(const char* tok, int64_t len) {
  long long i = strtoll(tok, nullptr, 10);
  return i > 0 ? i - 1 : len + i;
}

static std::string dir_of(const std::string& path) {
  size_t p = path.find_last_of('/');
  return p == std::string::npos ? std::string() : path.substr(0, p + 1);
}

static void parse_mtl(const std::string& path, std::vector<Material>& mats,
                      std::unordered_map<std::string, int32_t>& index) {
  FILE* f = fopen(path.c_str(), "r");
  if (!f) return;
  char line[4096];
  char* toks[16];
  Material* cur = nullptr;
  // sink for duplicate-named materials: obj.py keeps only the FIRST
  // occurrence of a name (mtl_index check in load_obj_scene) and discards
  // later ones entirely, so their Kd/Ke lines must not touch the kept entry
  Material discard{};
  while (fgets(line, sizeof line, f)) {
    int n = split(line, toks, 16);
    if (!n || toks[0][0] == '#') continue;
    if (!strcmp(toks[0], "newmtl")) {
      std::string name = n > 1 ? toks[1] : "";
      if (index.count(name)) {
        // duplicate newmtl (same file, or an mtllib referenced twice):
        // obj.py drops it — parse into a throwaway so backends stay
        // bit-identical (same materials list, same indices)
        discard = Material{};
        cur = &discard;
        continue;
      }
      mats.push_back(Material{});
      cur = &mats.back();
      cur->name = name;
      index.emplace(name, (int32_t)mats.size() - 1);
    } else if (!cur) {
      continue;
    } else if (!strcmp(toks[0], "Kd") && n > 3) {
      cur->kd[0] = strtod(toks[1], nullptr);
      cur->kd[1] = strtod(toks[2], nullptr);
      cur->kd[2] = strtod(toks[3], nullptr);
    } else if (!strcmp(toks[0], "Ke") && n > 3) {
      cur->ke[0] = strtod(toks[1], nullptr);
      cur->ke[1] = strtod(toks[2], nullptr);
      cur->ke[2] = strtod(toks[3], nullptr);
      cur->has_ke = 1;
    }
  }
  fclose(f);
}

}  // namespace

extern "C" {

void* hijiki_obj_parse(const char* path_c) {
  std::string path(path_c);
  FILE* f = fopen(path_c, "r");
  if (!f) return nullptr;
  auto* out = new Parsed();

  std::vector<V3> raw_pos, raw_nrm;
  std::vector<V2> raw_uv;
  std::unordered_map<std::string, int32_t> mtl_index;
  std::unordered_map<Key, int32_t, KeyHash> triple_cache;
  int32_t current_material = -1;
  int64_t smoothing_group = 0;
  bool bad_index = false;  // out-of-range f indices: fail the whole parse
                           // (obj.py raises; the wrapper then falls back to
                           // it so both backends error loudly, never
                           // silently alias a wrong vertex)
  std::vector<int32_t> gen_normal;            // out-vertex ids needing normals
  std::vector<int32_t> gen_faces;             // 3 ids per fan triangle

  char line[65536];
  char* toks[512];
  std::vector<int32_t> idxs;
  while (fgets(line, sizeof line, f)) {
    int n = split(line, toks, 512);
    if (!n || toks[0][0] == '#') continue;
    const char* key = toks[0];
    // (float)strtod, not strtof: the Python parser parses to f64 then
    // narrows to f32 via numpy, and double rounding can differ from a
    // direct correctly-rounded f32 parse by 1 ULP on boundary inputs —
    // backends must match bitwise
    if (!strcmp(key, "v") && n > 3) {
      raw_pos.push_back({(float)strtod(toks[1], nullptr),
                         (float)strtod(toks[2], nullptr),
                         (float)strtod(toks[3], nullptr)});
    } else if (!strcmp(key, "vn") && n > 3) {
      raw_nrm.push_back({(float)strtod(toks[1], nullptr),
                         (float)strtod(toks[2], nullptr),
                         (float)strtod(toks[3], nullptr)});
    } else if (!strcmp(key, "vt") && n > 2) {
      raw_uv.push_back({(float)strtod(toks[1], nullptr),
                        (float)strtod(toks[2], nullptr)});
    } else if (!strcmp(key, "o") || !strcmp(key, "g")) {
      triple_cache.clear();
    } else if (!strcmp(key, "mtllib") && n > 1) {
      parse_mtl(dir_of(path) + toks[1], out->materials, mtl_index);
    } else if (!strcmp(key, "usemtl")) {
      auto it = n > 1 ? mtl_index.find(toks[1]) : mtl_index.end();
      current_material = it == mtl_index.end() ? -1 : it->second;
    } else if (!strcmp(key, "s")) {
      const char* tok = n > 1 ? toks[1] : "off";
      smoothing_group =
          (!strcmp(tok, "off") || !strcmp(tok, "0")) ? 0 : strtoll(tok, nullptr, 10);
    } else if (!strcmp(key, "f")) {
      if (current_material < 0) continue;
      idxs.clear();
      bool has_gen = false;
      for (int t = 1; t < n; ++t) {
        char* tok = toks[t];
        // split v/vt/vn
        char* s1 = strchr(tok, '/');
        char* s2 = s1 ? strchr(s1 + 1, '/') : nullptr;
        int64_t vi, ti = -1, ni = -1;
        if (s1) *s1 = '\0';
        if (s2) *s2 = '\0';
        vi = resolve_index(tok, (int64_t)raw_pos.size());
        if (s1 && s1[1] != '\0') {
          ti = resolve_index(s1 + 1, (int64_t)raw_uv.size());
          if (ti < 0 || ti >= (int64_t)raw_uv.size()) bad_index = true;
        }
        if (s2 && s2[1] != '\0') {
          ni = resolve_index(s2 + 1, (int64_t)raw_nrm.size());
          if (ni < 0 || ni >= (int64_t)raw_nrm.size()) bad_index = true;
        }
        if (ni < 0) has_gen = true;
        if (vi < 0 || vi >= (int64_t)raw_pos.size()) bad_index = true;
        if (bad_index) { idxs.clear(); break; }

        Key k{vi, ti, ni, ni < 0 ? smoothing_group : -1};
        int32_t idx;
        bool dedup = ni >= 0 || smoothing_group != 0;
        auto it = dedup ? triple_cache.find(k) : triple_cache.end();
        if (dedup && it != triple_cache.end()) {
          idx = it->second;
        } else {
          idx = (int32_t)out->positions.size();
          out->positions.push_back(raw_pos[vi]);
          out->uvs.push_back(ti >= 0 && ti < (int64_t)raw_uv.size()
                                 ? raw_uv[ti]
                                 : V2{0.f, 0.f});
          if (ni >= 0 && ni < (int64_t)raw_nrm.size()) {
            out->normals.push_back(raw_nrm[ni]);
          } else {
            out->normals.push_back({0.f, 0.f, 0.f});
            gen_normal.push_back(idx);
          }
          if (dedup) triple_cache.emplace(k, idx);
        }
        idxs.push_back(idx);
      }
      for (size_t t = 1; t + 1 < idxs.size(); ++t) {  // fan triangulation
        out->tris.push_back(idxs[0]);
        out->tris.push_back(idxs[t]);
        out->tris.push_back(idxs[t + 1]);
        out->tri_mat.push_back(current_material);
        if (has_gen) {
          gen_faces.push_back(idxs[0]);
          gen_faces.push_back(idxs[t]);
          gen_faces.push_back(idxs[t + 1]);
        }
      }
    }
  }
  fclose(f);
  if (bad_index) {
    delete out;
    return nullptr;
  }

  if (!gen_normal.empty()) {
    // area-weighted accumulation (see obj.py): unnormalized face cross sums
    // per needy vertex, normalized at the end
    // all-f32 with the Python parser's op order, for bitwise array parity
    std::vector<uint8_t> need(out->positions.size(), 0);
    for (int32_t i : gen_normal) need[i] = 1;
    std::vector<float> acc(3 * out->positions.size(), 0.f);
    for (size_t t = 0; t + 2 < gen_faces.size() + 1; t += 3) {
      int32_t ia = gen_faces[t], ib = gen_faces[t + 1], ic = gen_faces[t + 2];
      const V3 &a = out->positions[ia], &b = out->positions[ib],
               &c = out->positions[ic];
      float e1x = b.x - a.x, e1y = b.y - a.y, e1z = b.z - a.z;
      float e2x = c.x - a.x, e2y = c.y - a.y, e2z = c.z - a.z;
      float fx = e1y * e2z - e1z * e2y;
      float fy = e1z * e2x - e1x * e2z;
      float fz = e1x * e2y - e1y * e2x;
      for (int32_t iv : {ia, ib, ic}) {
        if (need[iv]) {
          acc[3 * iv] += fx;
          acc[3 * iv + 1] += fy;
          acc[3 * iv + 2] += fz;
        }
      }
    }
    for (size_t i = 0; i < out->positions.size(); ++i) {
      if (!need[i]) continue;
      float nx = acc[3 * i], ny = acc[3 * i + 1], nz = acc[3 * i + 2];
      float len = std::sqrt(nx * nx + ny * ny + nz * nz);
      if (len > 0) {
        out->normals[i] = {nx / len, ny / len, nz / len};
      } else {
        out->normals[i] = {0.f, 0.f, 0.f};
      }
    }
  }

  out->ok = true;
  return out;
}

void hijiki_obj_counts(void* h, int64_t* counts) {
  auto* p = (Parsed*)h;
  counts[0] = (int64_t)p->positions.size();
  counts[1] = (int64_t)(p->tris.size() / 3);
  counts[2] = (int64_t)p->materials.size();
  int64_t name_bytes = 0;
  for (auto& m : p->materials) name_bytes += (int64_t)m.name.size() + 1;
  counts[3] = name_bytes;
}

void hijiki_obj_fill(void* h, float* pos, float* nrm, float* uv, int32_t* tris,
                     int32_t* tmat, double* mat_kd, double* mat_ke,
                     int32_t* mat_has_ke, char* names) {
  auto* p = (Parsed*)h;
  memcpy(pos, p->positions.data(), p->positions.size() * sizeof(V3));
  memcpy(nrm, p->normals.data(), p->normals.size() * sizeof(V3));
  memcpy(uv, p->uvs.data(), p->uvs.size() * sizeof(V2));
  memcpy(tris, p->tris.data(), p->tris.size() * sizeof(int32_t));
  memcpy(tmat, p->tri_mat.data(), p->tri_mat.size() * sizeof(int32_t));
  char* np_ = names;
  for (size_t i = 0; i < p->materials.size(); ++i) {
    const Material& m = p->materials[i];
    memcpy(mat_kd + 3 * i, m.kd, sizeof m.kd);
    memcpy(mat_ke + 3 * i, m.ke, sizeof m.ke);
    mat_has_ke[i] = m.has_ke;
    memcpy(np_, m.name.c_str(), m.name.size() + 1);
    np_ += m.name.size() + 1;
  }
}

void hijiki_obj_free(void* h) { delete (Parsed*)h; }

}  // extern "C"
