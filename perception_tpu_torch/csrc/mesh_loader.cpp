// Native mesh loading + decimation for the model bank (host code, no CUDA).
//
// A copy of perception_tpu/native/mesh_loader.cpp, so that the PyTorch port
// builds the same banks (the same QEM collapses in the same order) without
// importing the JAX package. It replaces the reference's assimp-based loader
// (cuda_renderer/src/model.cpp LoadModel + recursive_render flattening) and
// streams the buffer once, which keeps real YCB meshes (~100-250k faces)
// fast to load.
//
// Exposed as a plain C ABI consumed via ctypes. Built with the host C++
// compiler on first use by perception_tpu_torch/core/native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <queue>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Mesh {
  std::vector<double> verts;     // 3 * n_verts
  std::vector<int64_t> faces;    // 3 * n_faces (fan-triangulated)
  std::vector<uint8_t> colors;   // 3 * n_verts or empty
};

struct PlyProp {
  std::string name;
  int size = 0;        // bytes (scalar)
  bool is_list = false;
  int count_size = 0;  // bytes of list count
  int item_size = 0;   // bytes of list item
  bool item_float = false;
  bool is_float = false;
};

struct PlyElement {
  std::string name;
  long count = 0;
  std::vector<PlyProp> props;
};

int type_size(const std::string &t, bool *is_float) {
  *is_float = false;
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32") return 4;
  if (t == "float" || t == "float32") { *is_float = true; return 4; }
  if (t == "double" || t == "float64") { *is_float = true; return 8; }
  return 0;
}

double read_scalar(const uint8_t *p, int size, bool is_float) {
  if (is_float) {
    if (size == 4) { float v; memcpy(&v, p, 4); return v; }
    double v; memcpy(&v, p, 8); return v;
  }
  // Unsigned interpretation is fine for counts/indices/colors in practice;
  // signed small ints don't appear in mesh data we consume. Counts must be
  // unsigned: a corrupt 4-byte count read as signed int32 would go negative
  // and walk the cursor backwards past the truncation checks.
  switch (size) {
    case 1: return *p;
    case 2: { uint16_t v; memcpy(&v, p, 2); return v; }
    case 4: { uint32_t v; memcpy(&v, p, 4); return v; }
  }
  return 0;
}

bool parse_ply(const std::string &path, Mesh *out, std::string *err) {
  std::ifstream f(path, std::ios::binary);
  if (!f) { *err = "cannot open " + path; return false; }
  std::string data((std::istreambuf_iterator<char>(f)),
                   std::istreambuf_iterator<char>());

  size_t hdr_end = data.find("end_header");
  if (hdr_end == std::string::npos) { *err = "no end_header"; return false; }
  hdr_end = data.find('\n', hdr_end) + 1;

  std::istringstream header(data.substr(0, hdr_end));
  std::string line, format;
  std::vector<PlyElement> elements;
  while (std::getline(header, line)) {
    std::istringstream ls(line);
    std::string tok;
    ls >> tok;
    if (tok == "format") {
      ls >> format;
    } else if (tok == "element") {
      PlyElement e;
      ls >> e.name >> e.count;
      elements.push_back(e);
    } else if (tok == "property" && !elements.empty()) {
      PlyProp p;
      std::string t1;
      ls >> t1;
      if (t1 == "list") {
        std::string ct, it;
        ls >> ct >> it >> p.name;
        p.is_list = true;
        bool dummy;
        p.count_size = type_size(ct, &dummy);
        p.item_size = type_size(it, &p.item_float);
      } else {
        ls >> p.name;
        p.size = type_size(t1, &p.is_float);
      }
      elements.back().props.push_back(p);
    }
  }

  bool binary = format == "binary_little_endian";
  if (!binary && format != "ascii") { *err = "unsupported format " + format; return false; }

  const uint8_t *ptr = reinterpret_cast<const uint8_t *>(data.data()) + hdr_end;
  const uint8_t *end = reinterpret_cast<const uint8_t *>(data.data()) + data.size();
  std::istringstream body;
  if (!binary) body.str(data.substr(hdr_end));

  for (const auto &e : elements) {
    bool is_vertex = e.name == "vertex";
    bool is_face = e.name == "face";
    int xi = -1, yi = -1, zi = -1, ri = -1, gi = -1, bi = -1;
    for (size_t i = 0; i < e.props.size(); ++i) {
      const auto &n = e.props[i].name;
      if (n == "x") xi = i; else if (n == "y") yi = i; else if (n == "z") zi = i;
      else if (n == "red") ri = i; else if (n == "green") gi = i;
      else if (n == "blue") bi = i;
    }
    bool has_color = ri >= 0 && gi >= 0 && bi >= 0;
    if (is_vertex) {
      if (xi < 0 || yi < 0 || zi < 0) {
        *err = "vertex element missing x/y/z properties";
        return false;
      }
      out->verts.reserve(3 * e.count);
      if (has_color) out->colors.reserve(3 * e.count);
    }

    std::vector<double> row(e.props.size());
    std::vector<long> list_vals;
    for (long r = 0; r < e.count; ++r) {
      list_vals.clear();
      if (binary) {
        for (size_t i = 0; i < e.props.size(); ++i) {
          const auto &p = e.props[i];
          if (p.is_list) {
            if (ptr + p.count_size > end) { *err = "truncated"; return false; }
            long n = (long)read_scalar(ptr, p.count_size, false);
            ptr += p.count_size;
            // Reject corrupt counts before advancing the cursor: compare as
            // sizes (a huge n could overflow the pointer arithmetic).
            if (n < 0 || (size_t)n > (size_t)(end - ptr) / (size_t)p.item_size) {
              *err = "corrupt list count";
              return false;
            }
            for (long k = 0; k < n; ++k) {
              list_vals.push_back(
                  (long)read_scalar(ptr + k * p.item_size, p.item_size,
                                    p.item_float));
            }
            ptr += n * p.item_size;
          } else {
            if (ptr + p.size > end) { *err = "truncated"; return false; }
            row[i] = read_scalar(ptr, p.size, p.is_float);
            ptr += p.size;
          }
        }
      } else {
        std::string ln;
        do {
          if (!std::getline(body, ln)) { *err = "truncated ascii"; return false; }
        } while (ln.find_first_not_of(" \t\r") == std::string::npos);
        std::istringstream ls(ln);
        for (size_t i = 0; i < e.props.size(); ++i) {
          const auto &p = e.props[i];
          if (p.is_list) {
            long n; ls >> n;
            for (long k = 0; k < n; ++k) {
              long v; ls >> v;
              list_vals.push_back(v);
            }
          } else {
            ls >> row[i];
          }
        }
      }
      if (is_vertex) {
        out->verts.push_back(row[xi]);
        out->verts.push_back(row[yi]);
        out->verts.push_back(row[zi]);
        if (has_color) {
          out->colors.push_back((uint8_t)row[ri]);
          out->colors.push_back((uint8_t)row[gi]);
          out->colors.push_back((uint8_t)row[bi]);
        }
      } else if (is_face && list_vals.size() >= 3) {
        long n_verts_so_far = (long)(out->verts.size() / 3);
        for (long v : list_vals) {
          if (v < 0 || v >= n_verts_so_far) {
            *err = "face index out of range";
            return false;
          }
        }
        for (size_t k = 1; k + 1 < list_vals.size(); ++k) {  // fan
          out->faces.push_back(list_vals[0]);
          out->faces.push_back(list_vals[k]);
          out->faces.push_back(list_vals[k + 1]);
        }
      }
    }
  }
  return true;
}

bool parse_obj(const std::string &path, Mesh *out, std::string *err) {
  std::ifstream f(path);
  if (!f) { *err = "cannot open " + path; return false; }
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ls(line);
    std::string tok;
    ls >> tok;
    if (tok == "v") {
      double x, y, z;
      ls >> x >> y >> z;
      out->verts.insert(out->verts.end(), {x, y, z});
    } else if (tok == "f") {
      std::vector<long> idx;
      std::string v;
      while (ls >> v) {
        idx.push_back(strtol(v.c_str(), nullptr, 10) - 1);
      }
      for (size_t k = 1; k + 1 < idx.size(); ++k) {
        out->faces.insert(out->faces.end(), {idx[0], idx[k], idx[k + 1]});
      }
    }
  }
  return true;
}

// Vertex-clustering decimation (binary search on grid cells; cluster means;
// degenerate/duplicate face removal): QEM's fallback when its heap runs out
// above the target.
void decimate(const std::vector<double> &verts,
              const std::vector<int64_t> &faces,
              const std::vector<uint8_t> &colors, long target_faces,
              Mesh *out) {
  long n_faces = faces.size() / 3;
  long n_verts = verts.size() / 3;
  if (n_faces <= target_faces) {
    out->verts = verts;
    out->faces = faces;
    out->colors = colors;
    return;
  }
  double mn[3] = {1e30, 1e30, 1e30}, mx[3] = {-1e30, -1e30, -1e30};
  for (long i = 0; i < n_verts; ++i) {
    for (int d = 0; d < 3; ++d) {
      double v = verts[3 * i + d];
      if (v < mn[d]) mn[d] = v;
      if (v > mx[d]) mx[d] = v;
    }
  }
  double extent = 0;
  for (int d = 0; d < 3; ++d) extent = std::max(extent, mx[d] - mn[d]);

  auto cluster = [&](long cells, Mesh *res) {
    double cell = extent / cells;
    std::map<std::tuple<long, long, long>, long> ids;
    std::vector<long> inverse(n_verts);
    for (long i = 0; i < n_verts; ++i) {
      std::tuple<long, long, long> key(
          (long)std::floor((verts[3 * i] - mn[0]) / cell),
          (long)std::floor((verts[3 * i + 1] - mn[1]) / cell),
          (long)std::floor((verts[3 * i + 2] - mn[2]) / cell));
      auto it = ids.find(key);
      if (it == ids.end()) it = ids.emplace(key, (long)ids.size()).first;
      inverse[i] = it->second;
    }
    long k = ids.size();
    std::vector<double> sums(3 * k, 0.0), csums(3 * k, 0.0);
    std::vector<long> counts(k, 0);
    bool has_color = !colors.empty();
    for (long i = 0; i < n_verts; ++i) {
      long c = inverse[i];
      counts[c]++;
      for (int d = 0; d < 3; ++d) {
        sums[3 * c + d] += verts[3 * i + d];
        if (has_color) csums[3 * c + d] += colors[3 * i + d];
      }
    }
    res->verts.assign(3 * k, 0.0);
    if (has_color) res->colors.assign(3 * k, 0);
    for (long c = 0; c < k; ++c) {
      for (int d = 0; d < 3; ++d) {
        res->verts[3 * c + d] = sums[3 * c + d] / counts[c];
        if (has_color)
          res->colors[3 * c + d] = (uint8_t)(csums[3 * c + d] / counts[c]);
      }
    }
    std::map<std::tuple<long, long, long>, bool> seen;
    res->faces.clear();
    for (long i = 0; i < n_faces; ++i) {
      long a = inverse[faces[3 * i]], b = inverse[faces[3 * i + 1]],
           c = inverse[faces[3 * i + 2]];
      if (a == b || b == c || a == c) continue;
      std::tuple<long, long, long> key(a, b, c);
      if (seen.count(key)) continue;
      seen[key] = true;
      res->faces.insert(res->faces.end(), {a, b, c});
    }
  };

  long lo = 2, hi = 512;
  Mesh best;
  bool have_best = false;
  while (lo <= hi) {
    long mid = (lo + hi) / 2;
    Mesh trial;
    cluster(mid, &trial);
    if ((long)trial.faces.size() / 3 <= target_faces) {
      best = std::move(trial);
      have_best = true;
      lo = mid + 1;
    } else {
      hi = mid - 1;
    }
  }
  if (!have_best) {
    cluster(2, &best);
    if ((long)best.faces.size() / 3 > target_faces)
      best.faces.resize(3 * target_faces);
  }
  *out = std::move(best);
}

// Quadric-error-metric edge-collapse decimation (Garland-Heckbert):
// area-weighted plane quadrics, boundary constraint quadrics on open rims,
// normal-flip rejection, lazy heap invalidation.
struct Quadric {
  double q[16] = {0};
  void add_plane(const double p[4], double w) {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) q[4 * i + j] += w * p[i] * p[j];
  }
  void add(const Quadric &o) {
    for (int i = 0; i < 16; ++i) q[i] += o.q[i];
  }
  double eval(const double v[3]) const {
    double h[4] = {v[0], v[1], v[2], 1.0};
    double s = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) s += h[i] * q[4 * i + j] * h[j];
    return s;
  }
};

void decimate_qem(const std::vector<double> &in_verts,
                  const std::vector<int64_t> &in_faces,
                  const std::vector<uint8_t> &in_colors, long target_faces,
                  Mesh *out) {
  long nf = (long)in_faces.size() / 3;
  long nv = (long)in_verts.size() / 3;
  if (nf <= target_faces) {
    out->verts = in_verts;
    out->faces = in_faces;
    out->colors = in_colors;
    return;
  }
  std::vector<double> pos(in_verts);
  std::vector<Quadric> quad(nv);
  std::vector<double> fnrm(3 * nf, 0.0);

  auto cross = [](const double *a, const double *b, double *o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
  };

  std::vector<char> face_ok(nf, 1);
  for (long f = 0; f < nf; ++f) {
    const double *a = &pos[3 * in_faces[3 * f]];
    const double *b = &pos[3 * in_faces[3 * f + 1]];
    const double *c = &pos[3 * in_faces[3 * f + 2]];
    double ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    double ac[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    double n[3];
    cross(ab, ac, n);
    double area2 = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (area2 < 1e-18) {
      face_ok[f] = 0;
      continue;
    }
    double inv = 1.0 / area2;
    for (int d = 0; d < 3; ++d) fnrm[3 * f + d] = n[d] * inv;
    double p[4] = {fnrm[3 * f], fnrm[3 * f + 1], fnrm[3 * f + 2],
                   -(fnrm[3 * f] * a[0] + fnrm[3 * f + 1] * a[1] +
                     fnrm[3 * f + 2] * a[2])};
    for (int c3 = 0; c3 < 3; ++c3)
      quad[in_faces[3 * f + c3]].add_plane(p, area2);
  }

  // Boundary constraint quadrics: edges incident to exactly ONE face.
  // Incidence counted on UNDIRECTED edges — a reverse-twin test would
  // misclassify every edge of an inconsistently-wound mesh (e.g. a
  // scipy ConvexHull triangulation) as boundary and shrink it under
  // bogus constraints (matches core/mesh.py decimate_qem).
  {
    std::map<std::pair<long, long>, int> incidence;
    for (long f = 0; f < nf; ++f)
      for (int e = 0; e < 3; ++e) {
        long a = in_faces[3 * f + e], b = in_faces[3 * f + (e + 1) % 3];
        if (a > b) std::swap(a, b);
        ++incidence[{a, b}];
      }
    for (long f = 0; f < nf; ++f) {
      if (!face_ok[f]) continue;
      for (int e = 0; e < 3; ++e) {
        long a = in_faces[3 * f + e], b = in_faces[3 * f + (e + 1) % 3];
        long ua = a < b ? a : b, ub = a < b ? b : a;
        if (incidence[{ua, ub}] != 1) continue;   // interior/non-manifold
        double ev[3] = {pos[3 * b] - pos[3 * a], pos[3 * b + 1] - pos[3 * a + 1],
                        pos[3 * b + 2] - pos[3 * a + 2]};
        double cn[3];
        cross(ev, &fnrm[3 * f], cn);
        double ln = std::sqrt(cn[0] * cn[0] + cn[1] * cn[1] + cn[2] * cn[2]);
        if (ln < 1e-18) continue;
        for (int d = 0; d < 3; ++d) cn[d] /= ln;
        double p[4] = {cn[0], cn[1], cn[2],
                       -(cn[0] * pos[3 * a] + cn[1] * pos[3 * a + 1] +
                         cn[2] * pos[3 * a + 2])};
        double w = (ev[0] * ev[0] + ev[1] * ev[1] + ev[2] * ev[2]) * 100.0;
        quad[a].add_plane(p, w);
        quad[b].add_plane(p, w);
      }
    }
  }

  bool has_color = !in_colors.empty();
  std::vector<double> vcol(has_color ? 3 * nv : 0);
  std::vector<double> vweight(nv, 1.0);
  for (long i = 0; i < (long)vcol.size(); ++i) vcol[i] = in_colors[i];

  std::vector<std::set<long>> vfaces(nv);
  std::vector<int64_t> fvert(in_faces);
  for (long f = 0; f < nf; ++f)
    if (face_ok[f])
      for (int c3 = 0; c3 < 3; ++c3) vfaces[fvert[3 * f + c3]].insert(f);
  std::vector<char> alive_f(face_ok);
  std::vector<char> alive_v(nv, 1);
  std::vector<long> version(nv, 0);
  long n_alive = 0;
  for (long f = 0; f < nf; ++f) n_alive += alive_f[f];

  // Optimal contraction point + cost for an edge's merged quadric.
  auto edge_cost = [&](long a, long b, double vbar[3]) {
    Quadric q = quad[a];
    q.add(quad[b]);
    const double *m = q.q;
    double det = m[0] * (m[5] * m[10] - m[6] * m[9]) -
                 m[1] * (m[4] * m[10] - m[6] * m[8]) +
                 m[2] * (m[4] * m[9] - m[5] * m[8]);
    double scale = m[0] + m[5] + m[10] + 1e-30;
    double best = 1e300;
    double cands[4][3];
    int nc = 0;
    if (std::fabs(det) > 1e-12 * scale * scale * scale) {
      double bx = -m[3], by = -m[7], bz = -m[11];
      // Cramer's rule on the symmetric 3x3 block.
      double inv = 1.0 / det;
      cands[nc][0] = inv * (bx * (m[5] * m[10] - m[6] * m[9]) -
                            m[1] * (by * m[10] - m[6] * bz) +
                            m[2] * (by * m[9] - m[5] * bz));
      cands[nc][1] = inv * (m[0] * (by * m[10] - m[6] * bz) -
                            bx * (m[4] * m[10] - m[6] * m[8]) +
                            m[2] * (m[4] * bz - by * m[8]));
      cands[nc][2] = inv * (m[0] * (m[5] * bz - by * m[9]) -
                            m[1] * (m[4] * bz - by * m[8]) +
                            bx * (m[4] * m[9] - m[5] * m[8]));
      ++nc;
    }
    for (int d = 0; d < 3; ++d)
      cands[nc][d] = 0.5 * (pos[3 * a + d] + pos[3 * b + d]);
    ++nc;
    for (int d = 0; d < 3; ++d) cands[nc][d] = pos[3 * a + d];
    ++nc;
    for (int d = 0; d < 3; ++d) cands[nc][d] = pos[3 * b + d];
    ++nc;
    for (int i = 0; i < nc; ++i) {
      double c = q.eval(cands[i]);
      if (c < best) {
        best = c;
        for (int d = 0; d < 3; ++d) vbar[d] = cands[i][d];
      }
    }
    return best;
  };

  struct Entry {
    double cost;
    long a, b, va, vb;
    bool operator>(const Entry &o) const {
      if (cost != o.cost) return cost > o.cost;
      if (a != o.a) return a > o.a;
      return b > o.b;
    }
  };
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  {
    std::set<std::pair<long, long>> pushed;
    for (long f = 0; f < nf; ++f) {
      if (!alive_f[f]) continue;
      for (int e = 0; e < 3; ++e) {
        long a = fvert[3 * f + e], b = fvert[3 * f + (e + 1) % 3];
        if (a > b) std::swap(a, b);
        if (!pushed.emplace(a, b).second) continue;
        double vbar[3];
        heap.push({edge_cost(a, b, vbar), a, b, 0, 0});
      }
    }
  }

  while (n_alive > target_faces && !heap.empty()) {
    Entry e = heap.top();
    heap.pop();
    long a = e.a, b = e.b;
    if (!alive_v[a] || !alive_v[b] || version[a] != e.va ||
        version[b] != e.vb)
      continue;
    double vbar[3];
    edge_cost(a, b, vbar);
    // Shared faces = the faces the collapse removes.
    std::vector<long> shared;
    for (long f : vfaces[a])
      if (vfaces[b].count(f)) shared.push_back(f);
    if (shared.empty()) continue;
    // Reject if any surviving incident face flips.
    bool flip = false;
    for (const auto &vset : {vfaces[a], vfaces[b]}) {
      for (long f : vset) {
        if (!alive_f[f]) continue;
        if (std::find(shared.begin(), shared.end(), f) != shared.end())
          continue;
        double oldv[3][3], newv[3][3];
        for (int c3 = 0; c3 < 3; ++c3) {
          long v = fvert[3 * f + c3];
          for (int d = 0; d < 3; ++d) {
            oldv[c3][d] = pos[3 * v + d];
            newv[c3][d] = (v == a || v == b) ? vbar[d] : pos[3 * v + d];
          }
        }
        double oab[3] = {oldv[1][0] - oldv[0][0], oldv[1][1] - oldv[0][1],
                         oldv[1][2] - oldv[0][2]};
        double oac[3] = {oldv[2][0] - oldv[0][0], oldv[2][1] - oldv[0][1],
                         oldv[2][2] - oldv[0][2]};
        double nab[3] = {newv[1][0] - newv[0][0], newv[1][1] - newv[0][1],
                         newv[1][2] - newv[0][2]};
        double nac[3] = {newv[2][0] - newv[0][0], newv[2][1] - newv[0][1],
                         newv[2][2] - newv[0][2]};
        double on[3], nn[3];
        cross(oab, oac, on);
        cross(nab, nac, nn);
        if (on[0] * nn[0] + on[1] * nn[1] + on[2] * nn[2] <= 0) {
          flip = true;
          break;
        }
      }
      if (flip) break;
    }
    if (flip) continue;
    // Merge b into a at vbar.
    for (int d = 0; d < 3; ++d) pos[3 * a + d] = vbar[d];
    quad[a].add(quad[b]);
    if (has_color) {
      double wa = vweight[a], wb = vweight[b];
      for (int d = 0; d < 3; ++d)
        vcol[3 * a + d] =
            (wa * vcol[3 * a + d] + wb * vcol[3 * b + d]) / (wa + wb);
      vweight[a] = wa + wb;
    }
    alive_v[b] = 0;
    for (long f : shared) {
      if (alive_f[f]) {
        alive_f[f] = 0;
        --n_alive;
      }
      for (int c3 = 0; c3 < 3; ++c3) vfaces[fvert[3 * f + c3]].erase(f);
    }
    for (long f : std::vector<long>(vfaces[b].begin(), vfaces[b].end())) {
      for (int c3 = 0; c3 < 3; ++c3)
        if (fvert[3 * f + c3] == b) fvert[3 * f + c3] = a;
      vfaces[a].insert(f);
    }
    vfaces[b].clear();
    ++version[a];
    ++version[b];
    std::set<long> nbrs;
    for (long f : vfaces[a]) {
      if (!alive_f[f]) continue;
      for (int c3 = 0; c3 < 3; ++c3) {
        long v = fvert[3 * f + c3];
        if (v != a) nbrs.insert(v);
      }
    }
    for (long b2 : nbrs) {
      long ea = a, eb = b2;
      if (ea > eb) std::swap(ea, eb);
      double vbar2[3];
      heap.push({edge_cost(ea, eb, vbar2), ea, eb, version[ea], version[eb]});
    }
  }

  // Compact output, dropping degenerates.
  std::vector<long> remap(nv, -1);
  out->verts.clear();
  out->faces.clear();
  out->colors.clear();
  long next = 0;
  for (long f = 0; f < nf; ++f) {
    if (!alive_f[f]) continue;
    long a = fvert[3 * f], b = fvert[3 * f + 1], c = fvert[3 * f + 2];
    if (a == b || b == c || a == c) continue;
    for (long v : {a, b, c}) {
      if (remap[v] < 0) {
        remap[v] = next++;
        for (int d = 0; d < 3; ++d) out->verts.push_back(pos[3 * v + d]);
        if (has_color)
          for (int d = 0; d < 3; ++d) {
            double cv = vcol[3 * v + d];
            out->colors.push_back(
                (uint8_t)std::min(255.0, std::max(0.0, cv)));
          }
      }
      out->faces.push_back(remap[v]);
    }
  }
  if ((long)out->faces.size() / 3 > target_faces) {
    // Heap exhausted above target: clustering finishes the remainder.
    Mesh tmp = std::move(*out);
    decimate(tmp.verts, tmp.faces, tmp.colors, target_faces, out);
  }
}

std::string g_error;

}  // namespace

extern "C" {

// Loads a mesh, optionally decimates to <= target_faces (0 = no decimation).
// Returns 0 on success. Arrays are malloc'd; caller frees via pt_free.
int pt_load_mesh(const char *path, long target_faces,
                 double **verts, long *n_verts,
                 int64_t **faces, long *n_faces,
                 uint8_t **colors, int *has_colors) {
  Mesh mesh;
  std::string p(path);
  bool ok;
  if (p.size() > 4 && p.substr(p.size() - 4) == ".obj") {
    ok = parse_obj(p, &mesh, &g_error);
  } else {
    ok = parse_ply(p, &mesh, &g_error);
  }
  if (!ok) return 1;

  Mesh result;
  if (target_faces > 0) {
    decimate(mesh.verts, mesh.faces, mesh.colors, target_faces, &result);
  } else {
    result = std::move(mesh);
  }

  *n_verts = result.verts.size() / 3;
  *n_faces = result.faces.size() / 3;
  *verts = (double *)malloc(result.verts.size() * sizeof(double));
  memcpy(*verts, result.verts.data(), result.verts.size() * sizeof(double));
  *faces = (int64_t *)malloc(result.faces.size() * sizeof(int64_t));
  memcpy(*faces, result.faces.data(), result.faces.size() * sizeof(int64_t));
  *has_colors = result.colors.empty() ? 0 : 1;
  if (*has_colors) {
    *colors = (uint8_t *)malloc(result.colors.size());
    memcpy(*colors, result.colors.data(), result.colors.size());
  } else {
    *colors = nullptr;
  }
  return 0;
}

// Standalone QEM decimation of an in-memory mesh (colors may be null).
// Returns 0 on success; arrays are malloc'd, caller frees via pt_free.
int pt_decimate_qem(const double *verts, long n_verts, const int64_t *faces,
                    long n_faces, const uint8_t *colors, long target_faces,
                    double **out_verts, long *out_n_verts,
                    int64_t **out_faces, long *out_n_faces,
                    uint8_t **out_colors, int *out_has_colors) {
  std::vector<double> v(verts, verts + 3 * n_verts);
  std::vector<int64_t> f(faces, faces + 3 * n_faces);
  std::vector<uint8_t> c;
  if (colors) c.assign(colors, colors + 3 * n_verts);
  Mesh result;
  decimate_qem(v, f, c, target_faces, &result);
  *out_n_verts = result.verts.size() / 3;
  *out_n_faces = result.faces.size() / 3;
  *out_verts = (double *)malloc(result.verts.size() * sizeof(double));
  memcpy(*out_verts, result.verts.data(),
         result.verts.size() * sizeof(double));
  *out_faces = (int64_t *)malloc(result.faces.size() * sizeof(int64_t));
  memcpy(*out_faces, result.faces.data(),
         result.faces.size() * sizeof(int64_t));
  *out_has_colors = result.colors.empty() ? 0 : 1;
  if (*out_has_colors) {
    *out_colors = (uint8_t *)malloc(result.colors.size());
    memcpy(*out_colors, result.colors.data(), result.colors.size());
  } else {
    *out_colors = nullptr;
  }
  return 0;
}

void pt_free(void *p) { free(p); }

const char *pt_last_error() { return g_error.c_str(); }

}  // extern "C"
