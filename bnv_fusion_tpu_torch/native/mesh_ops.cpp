// Native mesh runtime: batched marching tetrahedra + vertex welding.
//
// Copy of bnv_fusion_tpu/native/mesh_ops.cpp (the JAX package's host mesher),
// its code unchanged (two comments reworded), so that the PyTorch port builds
// it without importing the JAX package.  The port's mesh.py references below mean
// bnv_fusion_tpu_torch/mesh.py, which keeps the same numpy fallback.
//
// The reference's host-side meshing leans on external C libraries (skimage
// marching_cubes per 500-voxel batch, Open3D vertex merging — reference
// src/models/sparse_volume.py:697-766, src/utils/o3d_helper.py:220-241).
// This framework's equivalent native component extracts the iso-surface from
// sparse unit cells in one pass: the same 6-tetrahedra decomposition and
// case tables as the numpy implementation in bnv_fusion_tpu/mesh.py (which
// remains the portable fallback), at C++ speed with a fused weld step.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: cc -O3 -march=native -shared -fPIC mesh_ops.cpp -o libmesh_ops.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__GLIBC__)
#include <malloc.h>
#endif

namespace {

// Keep freed pages in the process (measured: the lattice build +
// marching tets allocate ~400 MB of >32 MB vectors per call; glibc mmaps
// those and munmaps them on free, so EVERY mesh extraction re-page-faults
// the lot — 3.2 s vs 0.45 s per lattice build on the 1-vCPU build host).
// M_MMAP_MAX=0 routes big allocations to the sbrk heap and
// M_TRIM_THRESHOLD=-1 never returns it, so repeat meshes reuse warm pages
// — this also covers numpy's buffers (same glibc malloc).  RSS holds its
// high-water mark; opt out via BNV_NATIVE_NO_MALLOC_TUNE=1 on
// memory-constrained hosts.
#if defined(__GLIBC__)
__attribute__((constructor)) void tune_malloc() {
  if (!std::getenv("BNV_NATIVE_NO_MALLOC_TUNE")) {
    mallopt(M_MMAP_MAX, 0);
    mallopt(M_TRIM_THRESHOLD, -1);
  }
}
#endif

// cube corners in (4*dx + 2*dy + dz) order
const int kCorner[8][3] = {{0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
                           {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1}};
// six tetrahedra around the main diagonal c0-c7
const int kTets[6][4] = {{0, 4, 5, 7}, {0, 5, 1, 7}, {0, 1, 3, 7},
                         {0, 3, 2, 7}, {0, 2, 6, 7}, {0, 6, 4, 7}};
const int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// 16-case table filled at init from the same orientation rule as mesh.py
int g_tet_table[16][2][3];
// per-case bitmask of the tet edges the triangles reference (lazy interp:
// cut tets use 3-4 of the 6 edges; computing all 6 wastes ~40% of the
// interpolation work in the hot loop)
int g_edges_needed[16];
bool g_table_ready = false;

void cross3(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

void build_table() {
  const double verts[4][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int mask = 0; mask < 16; ++mask)
    for (int t = 0; t < 2; ++t)
      for (int e = 0; e < 3; ++e) g_tet_table[mask][t][e] = -1;

  for (int mask = 1; mask < 15; ++mask) {
    int inside[4], outside[4], n_in = 0, n_out = 0;
    for (int v = 0; v < 4; ++v) {
      if (mask & (1 << v))
        inside[n_in++] = v;
      else
        outside[n_out++] = v;
    }
    int cut[6], n_cut = 0;
    double pts[6][3];
    for (int e = 0; e < 6; ++e) {
      const bool a_in = (mask >> kTetEdges[e][0]) & 1;
      const bool b_in = (mask >> kTetEdges[e][1]) & 1;
      if (a_in != b_in) {
        cut[n_cut] = e;
        for (int d = 0; d < 3; ++d)
          pts[e][d] = 0.5 * (verts[kTetEdges[e][0]][d] +
                             verts[kTetEdges[e][1]][d]);
        ++n_cut;
      }
    }
    double in_c[3] = {0, 0, 0}, out_c[3] = {0, 0, 0}, out_dir[3];
    for (int i = 0; i < n_in; ++i)
      for (int d = 0; d < 3; ++d) in_c[d] += verts[inside[i]][d] / n_in;
    for (int i = 0; i < n_out; ++i)
      for (int d = 0; d < 3; ++d) out_c[d] += verts[outside[i]][d] / n_out;
    for (int d = 0; d < 3; ++d) out_dir[d] = out_c[d] - in_c[d];

    auto orient = [&](int tri[3]) {
      double ab[3], ac[3], n[3];
      for (int d = 0; d < 3; ++d) {
        ab[d] = pts[tri[1]][d] - pts[tri[0]][d];
        ac[d] = pts[tri[2]][d] - pts[tri[0]][d];
      }
      cross3(ab, ac, n);
      const double dot =
          n[0] * out_dir[0] + n[1] * out_dir[1] + n[2] * out_dir[2];
      // the 6 cube tets are left-handed vs this canonical tet: invert
      if (dot >= 0) {
        const int tmp = tri[1];
        tri[1] = tri[2];
        tri[2] = tmp;
      }
    };

    if (n_in == 1 || n_in == 3) {
      int tri[3] = {cut[0], cut[1], cut[2]};
      orient(tri);
      for (int e = 0; e < 3; ++e) g_tet_table[mask][0][e] = tri[e];
    } else {  // 2-2: quad over edges (i0,o0),(i0,o1),(i1,o1),(i1,o0)
      auto edge_id = [&](int a, int b) {
        if (a > b) {
          const int t = a;
          a = b;
          b = t;
        }
        for (int e = 0; e < 6; ++e)
          if (kTetEdges[e][0] == a && kTetEdges[e][1] == b) return e;
        return -1;
      };
      const int quad[4] = {edge_id(inside[0], outside[0]),
                           edge_id(inside[0], outside[1]),
                           edge_id(inside[1], outside[1]),
                           edge_id(inside[1], outside[0])};
      int t1[3] = {quad[0], quad[1], quad[2]};
      int t2[3] = {quad[0], quad[2], quad[3]};
      orient(t1);
      orient(t2);
      for (int e = 0; e < 3; ++e) {
        g_tet_table[mask][0][e] = t1[e];
        g_tet_table[mask][1][e] = t2[e];
      }
    }
  }
  for (int mask = 0; mask < 16; ++mask) {
    int need = 0;
    for (int t = 0; t < 2; ++t)
      for (int e = 0; e < 3; ++e)
        if (g_tet_table[mask][t][e] >= 0) need |= 1 << g_tet_table[mask][t][e];
    g_edges_needed[mask] = need;
  }
  g_table_ready = true;
}

// Open-addressing weld table (linear probing, power-of-2 capacity).  The
// previous std::unordered_map paid a node allocation + pointer chase per
// vertex — the dominant cost of the weld pass at multi-million-vertex
// scale.  Vertex ids are assigned in first-encounter order either way, so
// the output is bit-identical to the map-based version.
struct WeldTable {
  struct Slot {
    int64_t a, b, c;
    int32_t id;  // -1 == empty
  };
  std::vector<Slot> slots;
  size_t mask = 0, count = 0, grow_at = 0;
  int shift = 63;

  // Fibonacci hashing: the SLOT must come from the high bits of the
  // product ((h * C) >> shift) — masking the low bits drops every key
  // bit at or above log2(capacity), which for structured lattice keys
  // collapses whole coordinate planes into one probe chain.
  static size_t hash3(int64_t a, int64_t b, int64_t c) {
    size_t h = static_cast<size_t>(a) * 0x9E3779B97F4A7C15ull;
    h ^= static_cast<size_t>(b) * 0xC2B2AE3D27D4EB4Full + (h << 6);
    h ^= static_cast<size_t>(c) * 0x165667B19E3779F9ull + (h << 6);
    return (h * 0x9E3779B97F4A7C15ull);
  }

  void init(size_t expected) {
    size_t cap = 1024;
    while (cap < expected * 2) cap <<= 1;
    slots.assign(cap, Slot{0, 0, 0, -1});
    mask = cap - 1;
    shift = 64 - __builtin_ctzll(cap);
    count = 0;
    grow_at = cap - cap / 4;  // 0.75 load factor
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot{0, 0, 0, -1});
    mask = slots.size() - 1;
    shift = 64 - __builtin_ctzll(slots.size());
    grow_at = slots.size() - slots.size() / 4;
    for (const Slot& s : old) {
      if (s.id < 0) continue;
      size_t i = hash3(s.a, s.b, s.c) >> shift;
      while (slots[i].id >= 0) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  // Returns existing id, or inserts new_id and returns it.
  int32_t find_or_insert(int64_t a, int64_t b, int64_t c, int32_t new_id) {
    size_t i = hash3(a, b, c) >> shift;
    while (true) {
      Slot& s = slots[i];
      if (s.id < 0) {
        s = Slot{a, b, c, new_id};
        if (++count >= grow_at) grow();
        return new_id;
      }
      if (s.a == a && s.b == b && s.c == c) return s.id;
      i = (i + 1) & mask;
    }
  }
};

// Packed variant: the three quantized weld coordinates ride one int64
// (21-bit biased fields — valid whenever |q| < 2^20, which covers every
// real lattice at the production weld tolerance of 0.5 lattice units).
// 16-byte slots halve the probe cache footprint vs the 3-key table; the
// caller prechecks the coordinate range and falls back otherwise.
struct WeldTable1 {
  struct Slot {
    int64_t key;  // -1 == empty (valid packed keys are non-negative)
    int32_t id;
  };
  std::vector<Slot> slots;
  size_t mask = 0, count = 0, grow_at = 0;
  int shift = 63;

  void init(size_t expected) {
    size_t cap = 1024;
    while (cap < expected * 2) cap <<= 1;
    slots.assign(cap, Slot{-1, 0});
    mask = cap - 1;
    shift = 64 - __builtin_ctzll(cap);
    count = 0;
    grow_at = cap - cap / 4;
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot{-1, 0});
    mask = slots.size() - 1;
    shift = 64 - __builtin_ctzll(slots.size());
    grow_at = slots.size() - slots.size() / 4;
    for (const Slot& s : old) {
      if (s.key < 0) continue;
      size_t i = (static_cast<size_t>(s.key) * 0x9E3779B97F4A7C15ull) >> shift;
      while (slots[i].key >= 0) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  int32_t find_or_insert(int64_t key, int32_t new_id) {
    size_t i = (static_cast<size_t>(key) * 0x9E3779B97F4A7C15ull) >> shift;
    while (true) {
      Slot& s = slots[i];
      if (s.key < 0) {
        s = Slot{key, new_id};
        if (++count >= grow_at) grow();
        return new_id;
      }
      if (s.key == key) return s.id;
      i = (i + 1) & mask;
    }
  }
};

struct MeshOut {
  std::vector<float> verts;
  std::vector<int32_t> faces;
  // source cell index per face (filled by the indexed variant only; the
  // incremental mesher keys its triangle cache by cell)
  std::vector<int64_t> face_cells;
};

MeshOut* g_last = nullptr;

// --- sample-lattice construction state (mesh.build_sample_lattice twin) -
struct LatticeOut {
  std::vector<int64_t> points;      // [P,3] lattice coords
  std::vector<int64_t> corner_idx;  // [M,8] indices into points
  std::vector<int64_t> cells;       // [M,3] cell origins
};

LatticeOut* g_lattice = nullptr;

// Same packing as mesh.coord_key3: lexicographic int64 key with 21-bit
// fields biased by 2^20.  Key order == numpy's sort order, so outputs are
// bit-identical to the numpy path.
inline int64_t lat_key(int64_t x, int64_t y, int64_t z) {
  return (x + (int64_t(1) << 20)) * (int64_t(1) << 42) +
         (y + (int64_t(1) << 20)) * (int64_t(1) << 21) +
         (z + (int64_t(1) << 20));
}
// delta form (mesh.off_key): multiplication, not shifts — offsets are signed
inline int64_t lat_off_key(int64_t x, int64_t y, int64_t z) {
  return x * (int64_t(1) << 42) + y * (int64_t(1) << 21) + z;
}

// LSD radix sort on non-negative int64 keys, 4 passes of 16 bits (all
// lattice keys fit in 63 bits and are positive).  ~2-3x std::sort on the
// single-core host at the 5M-key scale that dominates mesh extraction.
void radix_sort64(std::vector<int64_t>& a, std::vector<int64_t>& tmp) {
  const size_t n = a.size();
  if (n < (1 << 14)) {  // small arrays: introsort wins
    std::sort(a.begin(), a.end());
    return;
  }
  tmp.resize(n);
  int64_t* src = a.data();
  int64_t* dst = tmp.data();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 16;
    // skip passes whose digit is constant (common for the high bits)
    const int64_t first = (src[0] >> shift) & 0xFFFF;
    bool constant = true;
    for (size_t i = 1; i < n; ++i)
      if (((src[i] >> shift) & 0xFFFF) != first) {
        constant = false;
        break;
      }
    if (constant) continue;
    size_t count[65536] = {0};
    for (size_t i = 0; i < n; ++i) ++count[(src[i] >> shift) & 0xFFFF];
    size_t pos = 0;
    for (int d = 0; d < 65536; ++d) {
      const size_t c = count[d];
      count[d] = pos;
      pos += c;
    }
    for (size_t i = 0; i < n; ++i)
      dst[count[(src[i] >> shift) & 0xFFFF]++] = src[i];
    std::swap(src, dst);
  }
  if (src != a.data()) std::memcpy(a.data(), src, n * sizeof(int64_t));
}

// One cell's 6-tetrahedra extraction: corner coords from the cell origin,
// per-tet case lookup, lazy edge interpolation, triangle emission through
// the caller's welding emit_vertex.  Shared by the plain and the indexed
// (fused gather + crossing gate) entry points.
template <class EmitV>
inline void mc_cell(const int64_t* o, const float* s, EmitV&& emit_vertex,
                    std::vector<int32_t>& faces) {
  // cube corner coordinates, hoisted out of the tet loop
  double cv[8][3];
  for (int c = 0; c < 8; ++c)
    for (int d = 0; d < 3; ++d) cv[c][d] = double(o[d]) + kCorner[c][d];
  for (int t = 0; t < 6; ++t) {
    float ts[4];
    int mask = 0;
    for (int v = 0; v < 4; ++v) {
      ts[v] = s[kTets[t][v]];
      if (ts[v] < 0) mask |= 1 << v;
    }
    if (mask == 0 || mask == 15) continue;
    double epts[6][3];
    int need = g_edges_needed[mask];
    for (int e = 0; e < 6; ++e) {
      if (!((need >> e) & 1)) continue;
      const int a = kTetEdges[e][0], b = kTetEdges[e][1];
      const double denom = double(ts[b]) - double(ts[a]);
      double frac = denom != 0 ? -double(ts[a]) / denom : 0.5;
      if (frac < 0) frac = 0;
      if (frac > 1) frac = 1;
      const double* va = cv[kTets[t][a]];
      const double* vb = cv[kTets[t][b]];
      for (int d = 0; d < 3; ++d)
        epts[e][d] = va[d] + frac * (vb[d] - va[d]);
    }
    for (int tri = 0; tri < 2; ++tri) {
      const int* te = g_tet_table[mask][tri];
      if (te[0] < 0) continue;
      const int32_t i0 = emit_vertex(epts[te[0]]);
      const int32_t i1 = emit_vertex(epts[te[1]]);
      const int32_t i2 = emit_vertex(epts[te[2]]);
      if (i0 == i1 || i1 == i2 || i0 == i2) continue;  // welded degenerate
      faces.push_back(i0);
      faces.push_back(i1);
      faces.push_back(i2);
    }
  }
}

}  // namespace

extern "C" {

// Extract the iso-surface from M sparse cells.
//   origins: [M,3] int64 lattice cell origins
//   sdf:     [M,8] float corner SDF in (4dx+2dy+dz) order
//   weld_tol: vertex weld tolerance in lattice units (<=0 disables welding)
// Returns number of triangles; call mesh_ops_get to copy the buffers out.
int64_t mesh_ops_marching_tets(const int64_t* origins, const float* sdf,
                               int64_t m, double weld_tol) {
  if (!g_table_ready) build_table();
  delete g_last;
  g_last = new MeshOut();
  WeldTable weld;
  WeldTable1 weld1;
  const bool do_weld = weld_tol > 0;
  const double inv_tol = do_weld ? 1.0 / weld_tol : 0.0;
  // packed-key precheck: every vertex lies within [origin-1, origin+2] of
  // some cell, so bounding the origins bounds the quantized coordinates
  bool packed = false;
  if (do_weld) {
    int64_t lo = 0, hi = 0;
    for (int64_t i = 0; i < m * 3; ++i) {
      if (origins[i] < lo) lo = origins[i];
      if (origins[i] > hi) hi = origins[i];
    }
    const double bound = (double(hi < -lo ? -lo : hi) + 2.0) * inv_tol + 1.0;
    packed = bound < double(int64_t(1) << 20);
    if (packed)
      weld1.init(static_cast<size_t>(m) + 1024);
    else
      weld.init(static_cast<size_t>(m) + 1024);
  }

  auto emit_vertex = [&](const double p[3]) -> int32_t {
    const int32_t id = static_cast<int32_t>(g_last->verts.size() / 3);
    if (do_weld) {
      const int64_t a =
          static_cast<int64_t>(p[0] * inv_tol + (p[0] >= 0 ? .5 : -.5));
      const int64_t b =
          static_cast<int64_t>(p[1] * inv_tol + (p[1] >= 0 ? .5 : -.5));
      const int64_t c =
          static_cast<int64_t>(p[2] * inv_tol + (p[2] >= 0 ? .5 : -.5));
      const int32_t got =
          packed ? weld1.find_or_insert(lat_key(a, b, c), id)
                 : weld.find_or_insert(a, b, c, id);
      if (got != id) return got;
    }
    g_last->verts.push_back(static_cast<float>(p[0]));
    g_last->verts.push_back(static_cast<float>(p[1]));
    g_last->verts.push_back(static_cast<float>(p[2]));
    return id;
  };

  for (int64_t ci = 0; ci < m; ++ci) {
    const float* s = sdf + ci * 8;
    float mn = s[0], mx = s[0];
    for (int k = 1; k < 8; ++k) {
      if (s[k] < mn) mn = s[k];
      if (s[k] > mx) mx = s[k];
    }
    if (mn >= 0 || mx <= 0) continue;
    mc_cell(origins + ci * 3, s, emit_vertex, g_last->faces);
  }
  return static_cast<int64_t>(g_last->faces.size() / 3);
}

// Fused variant: gathers corner SDF through an index array, applies the
// observed-crossing gate, and meshes in one pass — replacing mesh.py's
// numpy block (sdf[corner_idx] gather + NaN mask + crossing compaction,
// ~1.2 s/mesh of host time at the 48-frame scene's 1.5M-cell scale) with
// a single streaming read.
//   cells:      [M,3] int64 lattice cell origins (ALL lattice cells)
//   corner_idx: [M,8] int64 indices into sdf
//   sdf:        [P] float corner SDF; NaN marks "no data" when
//               use_sentinel != 0 (mesh.py mask_sentinel semantics:
//               a cell meshes only if its OBSERVED corners cross the
//               level set; NaN corners interpolate as nan_fallback)
int64_t mesh_ops_marching_tets_indexed(const int64_t* cells,
                                       const int64_t* corner_idx,
                                       const float* sdf, int64_t m,
                                       int use_sentinel, float nan_fallback,
                                       double weld_tol) {
  if (!g_table_ready) build_table();
  delete g_last;
  g_last = new MeshOut();
  WeldTable weld;
  WeldTable1 weld1;
  const bool do_weld = weld_tol > 0;
  const double inv_tol = do_weld ? 1.0 / weld_tol : 0.0;

  // pass 1: crossing gate per cell (observed corners only when sentinel
  // semantics are on) — sizes the weld table before any emission
  std::vector<uint8_t> crossing(static_cast<size_t>(m));
  int64_t n_cross = 0;
  for (int64_t ci = 0; ci < m; ++ci) {
    const int64_t* ix = corner_idx + ci * 8;
    float mn = 0, mx = 0;
    bool any = false;
    for (int k = 0; k < 8; ++k) {
      const float v = sdf[ix[k]];
      if (use_sentinel && v != v) continue;  // NaN = unobserved
      if (!any) {
        mn = mx = v;
        any = true;
      } else {
        if (v < mn) mn = v;
        if (v > mx) mx = v;
      }
    }
    const bool c = any && mn < 0 && mx > 0;
    crossing[ci] = c;
    n_cross += c;
  }

  bool packed = false;
  if (do_weld) {
    int64_t lo = 0, hi = 0;
    for (int64_t ci = 0; ci < m; ++ci) {
      if (!crossing[ci]) continue;
      for (int d = 0; d < 3; ++d) {
        const int64_t v = cells[ci * 3 + d];
        if (v < lo) lo = v;
        if (v > hi) hi = v;
      }
    }
    const double bound = (double(hi < -lo ? -lo : hi) + 2.0) * inv_tol + 1.0;
    packed = bound < double(int64_t(1) << 20);
    if (packed)
      weld1.init(static_cast<size_t>(n_cross) + 1024);
    else
      weld.init(static_cast<size_t>(n_cross) + 1024);
  }

  auto emit_vertex = [&](const double p[3]) -> int32_t {
    const int32_t id = static_cast<int32_t>(g_last->verts.size() / 3);
    if (do_weld) {
      const int64_t a =
          static_cast<int64_t>(p[0] * inv_tol + (p[0] >= 0 ? .5 : -.5));
      const int64_t b =
          static_cast<int64_t>(p[1] * inv_tol + (p[1] >= 0 ? .5 : -.5));
      const int64_t c =
          static_cast<int64_t>(p[2] * inv_tol + (p[2] >= 0 ? .5 : -.5));
      const int32_t got =
          packed ? weld1.find_or_insert(lat_key(a, b, c), id)
                 : weld.find_or_insert(a, b, c, id);
      if (got != id) return got;
    }
    g_last->verts.push_back(static_cast<float>(p[0]));
    g_last->verts.push_back(static_cast<float>(p[1]));
    g_last->verts.push_back(static_cast<float>(p[2]));
    return id;
  };

  // pass 2: gather + fallback-substitute + mesh the crossing cells
  for (int64_t ci = 0; ci < m; ++ci) {
    if (!crossing[ci]) continue;
    const int64_t* ix = corner_idx + ci * 8;
    float s[8];
    for (int k = 0; k < 8; ++k) {
      const float v = sdf[ix[k]];
      s[k] = (use_sentinel && v != v) ? nan_fallback : v;
    }
    mc_cell(cells + ci * 3, s, emit_vertex, g_last->faces);
    g_last->face_cells.resize(g_last->faces.size() / 3, ci);
  }
  return static_cast<int64_t>(g_last->faces.size() / 3);
}

// Source cell index of every face from the last indexed extraction
// (parallel to mesh_ops_get's faces; incremental-mesh cache keying).
void mesh_ops_get_face_cells(int64_t* out) {
  if (!g_last) return;
  std::memcpy(out, g_last->face_cells.data(),
              g_last->face_cells.size() * sizeof(int64_t));
}

int64_t mesh_ops_num_vertices() {
  return g_last ? static_cast<int64_t>(g_last->verts.size() / 3) : 0;
}

void mesh_ops_get(float* verts_out, int32_t* faces_out) {
  if (!g_last) return;
  std::memcpy(verts_out, g_last->verts.data(),
              g_last->verts.size() * sizeof(float));
  std::memcpy(faces_out, g_last->faces.data(),
              g_last->faces.size() * sizeof(int32_t));
}

void mesh_ops_free() {
  delete g_last;
  g_last = nullptr;
}

// Build the dedup sub-voxel sample lattice (mesh.build_sample_lattice
// twin; reference samples the 3x3x3 half-voxel grid per active corner,
// src/models/sparse_volume.py:717-731).  coords: [N,3] int64 active voxel
// coordinates; scale: 2 = half-voxel (reference), 4 = quarter-voxel.
// Output order is bit-identical to the numpy path (same key sort).
// Returns M (number of cells); fetch via mesh_ops_lattice_get.
int64_t mesh_ops_build_lattice(const int64_t* coords, int64_t n, int scale) {
  delete g_lattice;
  g_lattice = new LatticeOut();
  const int half = scale / 2;

  if (half > 7) return -1;  // per-axis merge fan-in bound (scale <= 14)

  std::vector<int64_t> base(n);
  for (int64_t i = 0; i < n; ++i)
    base[i] = lat_key(coords[i * 3] * scale, coords[i * 3 + 1] * scale,
                      coords[i * 3 + 2] * scale);

  std::vector<int64_t> tmp;
  radix_sort64(base, tmp);
  base.erase(std::unique(base.begin(), base.end()), base.end());

  // Dilation by separable cascade: base (+) Dz (+) Dy (+) Dx, deduping
  // after each axis.  Each stage is a k-way merge-walk of k SHIFTED copies
  // of an already-sorted unique list — linear, cache-sequential, and the
  // output is the sorted unique dilated set by construction (bit-identical
  // to the old "materialize 27n keys + radix sort + unique", which at the
  // 48-frame scene radix-sorted 5.2M keys to keep ~1.3M).
  auto dilate = [&](std::vector<int64_t>& a, const int64_t* deltas, int k) {
    std::vector<int64_t> out;
    out.reserve(a.size() * k);
    size_t idx[16] = {0};
    const size_t sz = a.size();
    int64_t last = INT64_MIN;
    while (true) {
      int64_t best = INT64_MAX;
      int bj = -1;
      for (int j = 0; j < k; ++j)
        if (idx[j] < sz) {
          const int64_t v = a[idx[j]] + deltas[j];
          if (v < best) {
            best = v;
            bj = j;
          }
        }
      if (bj < 0) break;
      ++idx[bj];
      if (best != last) {
        out.push_back(best);
        last = best;
      }
    }
    a.swap(out);
  };

  // per-axis shift deltas (ascending key order: axis strides are positive)
  int64_t dz_p[16], dy_p[16], dx_p[16], dz_c[16], dy_c[16], dx_c[16];
  int kp = 0, kc = 0;
  for (int d = -half; d <= half; ++d, ++kp) {
    dz_p[kp] = lat_off_key(0, 0, d);
    dy_p[kp] = lat_off_key(0, d, 0);
    dx_p[kp] = lat_off_key(d, 0, 0);
  }
  for (int d = -half; d < half; ++d, ++kc) {
    dz_c[kc] = lat_off_key(0, 0, d);
    dy_c[kc] = lat_off_key(0, d, 0);
    dx_c[kc] = lat_off_key(d, 0, 0);
  }

  std::vector<int64_t> pts_keys = base;
  dilate(pts_keys, dz_p, kp);
  dilate(pts_keys, dy_p, kp);
  dilate(pts_keys, dx_p, kp);
  std::vector<int64_t> cell_keys = base;
  dilate(cell_keys, dz_c, kc);
  dilate(cell_keys, dy_c, kc);
  dilate(cell_keys, dx_c, kc);

  // corner lookup: cell_keys + corner offset stays sorted, so each corner
  // is one linear merge-walk over (cells, points) instead of M binary
  // searches (the numpy path's 8 searchsorted calls)
  const size_t m_all = cell_keys.size(), p = pts_keys.size();
  std::vector<int64_t> cidx(m_all * 8);
  std::vector<uint8_t> hit_all(m_all, 1);
  for (int c = 0; c < 8; ++c) {
    const int64_t off = lat_off_key(kCorner[c][0], kCorner[c][1],
                                    kCorner[c][2]);
    size_t j = 0;
    for (size_t i = 0; i < m_all; ++i) {
      const int64_t want = cell_keys[i] + off;
      while (j < p && pts_keys[j] < want) ++j;
      if (j < p && pts_keys[j] == want) {
        cidx[i * 8 + c] = static_cast<int64_t>(j);
      } else {
        hit_all[i] = 0;
        cidx[i * 8 + c] = 0;
      }
    }
  }

  g_lattice->points.resize(p * 3);
  for (size_t i = 0; i < p; ++i) {
    const int64_t k = pts_keys[i];
    g_lattice->points[i * 3] = (k >> 42) - (int64_t(1) << 20);
    g_lattice->points[i * 3 + 1] =
        ((k >> 21) & ((int64_t(1) << 21) - 1)) - (int64_t(1) << 20);
    g_lattice->points[i * 3 + 2] =
        (k & ((int64_t(1) << 21) - 1)) - (int64_t(1) << 20);
  }
  size_t m = 0;
  for (size_t i = 0; i < m_all; ++i) m += hit_all[i];
  g_lattice->corner_idx.resize(m * 8);
  g_lattice->cells.resize(m * 3);
  size_t w = 0;
  for (size_t i = 0; i < m_all; ++i) {
    if (!hit_all[i]) continue;
    std::memcpy(g_lattice->corner_idx.data() + w * 8, cidx.data() + i * 8,
                8 * sizeof(int64_t));
    const int64_t k = cell_keys[i];
    g_lattice->cells[w * 3] = (k >> 42) - (int64_t(1) << 20);
    g_lattice->cells[w * 3 + 1] =
        ((k >> 21) & ((int64_t(1) << 21) - 1)) - (int64_t(1) << 20);
    g_lattice->cells[w * 3 + 2] =
        (k & ((int64_t(1) << 21) - 1)) - (int64_t(1) << 20);
    ++w;
  }
  return static_cast<int64_t>(m);
}

int64_t mesh_ops_lattice_num_points() {
  return g_lattice ? static_cast<int64_t>(g_lattice->points.size() / 3) : 0;
}

void mesh_ops_lattice_get(int64_t* points_out, int64_t* corner_out,
                          int64_t* cells_out) {
  if (!g_lattice) return;
  std::memcpy(points_out, g_lattice->points.data(),
              g_lattice->points.size() * sizeof(int64_t));
  std::memcpy(corner_out, g_lattice->corner_idx.data(),
              g_lattice->corner_idx.size() * sizeof(int64_t));
  std::memcpy(cells_out, g_lattice->cells.data(),
              g_lattice->cells.size() * sizeof(int64_t));
}

void mesh_ops_lattice_free() {
  delete g_lattice;
  g_lattice = nullptr;
}

}  // extern "C"
