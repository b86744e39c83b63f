// Native topological H1 dof numbering for hex meshes.
//
// lpfem_torch's copy of lpfem/native/dofs.cpp (the same code, so that the
// port numbers dofs as lpfem does wherever lpfem's native library is
// built): the host-side dof-table builder that replaces MFEM's
// FiniteElementSpace construction (reference: H1_FECollection /
// ParFiniteElementSpace, Solvers/PF_linear_par_partial.cpp:276-285).
// Vertex/edge/face/interior dofs with min-id-anchored face-orientation
// canonicalization, edge and face ids in first-encounter order (the NumPy
// numbering of lpfem_torch.space.build_hex_dofs uses sorted-unique order:
// the ids differ by a permutation). Exposed via a C ABI for ctypes
// (lpfem_torch/native.py).
//
// Built with vtuio.cpp by lpfem_torch.kernels._build.load_host_library:
//   g++ -O3 -shared -fPIC -std=c++17 dofs.cpp vtuio.cpp -o lib....so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// MFEM/VTK hex local vertex lattice coords
static const int HEX_VERTS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
static const int HEX_EDGES[12][2] = {
    {0, 1}, {1, 2}, {3, 2}, {0, 3}, {4, 5}, {5, 6}, {7, 6}, {4, 7},
    {0, 4}, {1, 5}, {2, 6}, {3, 7}};
static const int HEX_FACES[6][4] = {
    {0, 3, 2, 1}, {0, 1, 5, 4}, {1, 2, 6, 5},
    {2, 3, 7, 6}, {3, 0, 4, 7}, {4, 5, 6, 7}};

struct PairHash {
  size_t operator()(const std::pair<int64_t, int64_t> &p) const {
    return std::hash<int64_t>()(p.first * 1000003 + p.second);
  }
};

struct QuadKey {
  int64_t v[4];
  bool operator==(const QuadKey &o) const {
    return !memcmp(v, o.v, sizeof(v));
  }
};
struct QuadHash {
  size_t operator()(const QuadKey &q) const {
    size_t h = 1469598103934665603ull;
    for (int i = 0; i < 4; i++) {
      h ^= (size_t)q.v[i];
      h *= 1099511628211ull;
    }
    return h;
  }
};

}  // namespace

extern "C" {

// elems: [ne, 8] int64. elem_dofs out: [ne, (p+1)^3] int64 (lattice-lex,
// x fastest). Returns total dof count, or -1 on error.
int64_t lpfem_build_hex_dofs(const int64_t *elems, int64_t ne,
                             int64_t n_verts, int64_t p, int64_t *elem_dofs) {
  const int64_t p1 = p + 1;
  const int64_t L = p1 * p1 * p1;
  auto lat = [&](int64_t ix, int64_t iy, int64_t iz) {
    return ix + p1 * (iy + p1 * iz);
  };

  // vertices
  for (int64_t e = 0; e < ne; e++) {
    for (int v = 0; v < 8; v++) {
      elem_dofs[e * L + lat(HEX_VERTS[v][0] * p, HEX_VERTS[v][1] * p,
                            HEX_VERTS[v][2] * p)] = elems[e * 8 + v];
    }
  }
  if (p < 2) return n_verts;

  // unique edges (insertion-order ids; the numbering differs from NumPy's
  // sorted-unique ids by a permutation only — tests compare canonical
  // invariants, not raw ids)
  std::unordered_map<std::pair<int64_t, int64_t>, int64_t, PairHash> edge_ids;
  edge_ids.reserve(ne * 12);
  std::unordered_map<QuadKey, int64_t, QuadHash> face_ids;
  face_ids.reserve(ne * 6);

  int64_t n_edges = 0;
  for (int64_t e = 0; e < ne; e++)
    for (int ei = 0; ei < 12; ei++) {
      int64_t a = elems[e * 8 + HEX_EDGES[ei][0]];
      int64_t b = elems[e * 8 + HEX_EDGES[ei][1]];
      if (a > b) std::swap(a, b);
      auto r = edge_ids.emplace(std::make_pair(a, b), n_edges);
      if (r.second) n_edges++;
    }
  int64_t n_faces = 0;
  for (int64_t e = 0; e < ne; e++)
    for (int fi = 0; fi < 6; fi++) {
      QuadKey k;
      for (int c = 0; c < 4; c++) k.v[c] = elems[e * 8 + HEX_FACES[fi][c]];
      // sort 4
      for (int i = 0; i < 3; i++)
        for (int j = i + 1; j < 4; j++)
          if (k.v[i] > k.v[j]) std::swap(k.v[i], k.v[j]);
      auto r = face_ids.emplace(k, n_faces);
      if (r.second) n_faces++;
    }

  const int64_t edge_base = n_verts;
  const int64_t face_base = edge_base + n_edges * (p - 1);
  const int64_t int_base = face_base + n_faces * (p - 1) * (p - 1);

  for (int64_t e = 0; e < ne; e++) {
    // edges
    for (int ei = 0; ei < 12; ei++) {
      int64_t ga = elems[e * 8 + HEX_EDGES[ei][0]];
      int64_t gb = elems[e * 8 + HEX_EDGES[ei][1]];
      int64_t a = ga, b = gb;
      bool flip = a > b;
      if (flip) std::swap(a, b);
      int64_t eid = edge_ids[{a, b}];
      const int *c0 = HEX_VERTS[HEX_EDGES[ei][0]];
      int dx = HEX_VERTS[HEX_EDGES[ei][1]][0] - c0[0];
      int dy = HEX_VERTS[HEX_EDGES[ei][1]][1] - c0[1];
      int dz = HEX_VERTS[HEX_EDGES[ei][1]][2] - c0[2];
      for (int64_t m = 1; m < p; m++) {
        int64_t mm = flip ? p - m : m;
        elem_dofs[e * L + lat(c0[0] * p + m * dx, c0[1] * p + m * dy,
                              c0[2] * p + m * dz)] =
            edge_base + eid * (p - 1) + (mm - 1);
      }
    }
    // faces
    for (int fi = 0; fi < 6; fi++) {
      int64_t ids[4];
      for (int c = 0; c < 4; c++) ids[c] = elems[e * 8 + HEX_FACES[fi][c]];
      QuadKey k;
      memcpy(k.v, ids, sizeof(ids));
      for (int i = 0; i < 3; i++)
        for (int j = i + 1; j < 4; j++)
          if (k.v[i] > k.v[j]) std::swap(k.v[i], k.v[j]);
      int64_t fid = face_ids[k];
      // canonical frame: argmin corner, smaller neighbor first
      int kpos = 0;
      for (int c = 1; c < 4; c++)
        if (ids[c] < ids[kpos]) kpos = c;
      bool fwd = ids[(kpos + 1) % 4] < ids[(kpos + 3) % 4];
      const int *c0 = HEX_VERTS[HEX_FACES[fi][0]];
      int e1[3], e2[3];
      for (int d = 0; d < 3; d++) {
        e1[d] = HEX_VERTS[HEX_FACES[fi][1]][d] - c0[d];
        e2[d] = HEX_VERTS[HEX_FACES[fi][3]][d] - c0[d];
      }
      int64_t fbase = face_base + fid * (p - 1) * (p - 1);
      for (int64_t s = 1; s < p; s++)
        for (int64_t r = 1; r < p; r++) {
          int64_t uf, vf;
          switch (kpos) {
            case 0: uf = r;     vf = s;     break;
            case 1: uf = s;     vf = p - r; break;
            case 2: uf = p - r; vf = p - s; break;
            default: uf = p - s; vf = r;    break;
          }
          int64_t u = fwd ? uf : vf;
          int64_t v = fwd ? vf : uf;
          elem_dofs[e * L + lat(c0[0] * p + r * e1[0] + s * e2[0],
                                c0[1] * p + r * e1[1] + s * e2[1],
                                c0[2] * p + r * e1[2] + s * e2[2])] =
              fbase + (u - 1) + (p - 1) * (v - 1);
        }
    }
    // interior
    int64_t ib = int_base + e * (p - 1) * (p - 1) * (p - 1);
    int64_t idx = 0;
    for (int64_t iz = 1; iz < p; iz++)
      for (int64_t iy = 1; iy < p; iy++)
        for (int64_t ix = 1; ix < p; ix++)
          elem_dofs[e * L + lat(ix, iy, iz)] = ib + idx++;
  }
  return int_base + ne * (p - 1) * (p - 1) * (p - 1);
}

// 8-way uniform hex refinement: returns child connectivity given unique
// edge/face numbering built internally. children: [ne*8, 8] int64.
// new vertex ids: edges get n_verts + edge_id, faces n_verts + nE + face_id,
// centers n_verts + nE + nF + e. Returns total new vertex count or -1.
int64_t lpfem_refine_hex(const int64_t *elems, int64_t ne, int64_t n_verts,
                         int64_t *children, int64_t *n_edges_out,
                         int64_t *n_faces_out, int64_t *edge_pairs_out,
                         int64_t *face_quads_out) {
  std::unordered_map<std::pair<int64_t, int64_t>, int64_t, PairHash> edge_ids;
  std::unordered_map<QuadKey, int64_t, QuadHash> face_ids;
  int64_t nE = 0, nF = 0;
  std::vector<std::pair<int64_t, int64_t>> epairs;
  std::vector<QuadKey> fquads;
  for (int64_t e = 0; e < ne; e++) {
    for (int ei = 0; ei < 12; ei++) {
      int64_t a = elems[e * 8 + HEX_EDGES[ei][0]];
      int64_t b = elems[e * 8 + HEX_EDGES[ei][1]];
      if (a > b) std::swap(a, b);
      if (edge_ids.emplace(std::make_pair(a, b), nE).second) {
        epairs.push_back({a, b});
        nE++;
      }
    }
    for (int fi = 0; fi < 6; fi++) {
      QuadKey k;
      for (int c = 0; c < 4; c++) k.v[c] = elems[e * 8 + HEX_FACES[fi][c]];
      for (int i = 0; i < 3; i++)
        for (int j = i + 1; j < 4; j++)
          if (k.v[i] > k.v[j]) std::swap(k.v[i], k.v[j]);
      if (face_ids.emplace(k, nF).second) {
        fquads.push_back(k);
        nF++;
      }
    }
  }
  for (int64_t i = 0; i < nE; i++) {
    edge_pairs_out[2 * i] = epairs[i].first;
    edge_pairs_out[2 * i + 1] = epairs[i].second;
  }
  for (int64_t i = 0; i < nF; i++)
    for (int c = 0; c < 4; c++) face_quads_out[4 * i + c] = fquads[i].v[c];
  *n_edges_out = nE;
  *n_faces_out = nF;

  for (int64_t e = 0; e < ne; e++) {
    int64_t latv[3][3][3];
    for (int v = 0; v < 8; v++)
      latv[2 * HEX_VERTS[v][0]][2 * HEX_VERTS[v][1]][2 * HEX_VERTS[v][2]] =
          elems[e * 8 + v];
    for (int ei = 0; ei < 12; ei++) {
      int64_t a = elems[e * 8 + HEX_EDGES[ei][0]];
      int64_t b = elems[e * 8 + HEX_EDGES[ei][1]];
      if (a > b) std::swap(a, b);
      int mx = HEX_VERTS[HEX_EDGES[ei][0]][0] + HEX_VERTS[HEX_EDGES[ei][1]][0];
      int my = HEX_VERTS[HEX_EDGES[ei][0]][1] + HEX_VERTS[HEX_EDGES[ei][1]][1];
      int mz = HEX_VERTS[HEX_EDGES[ei][0]][2] + HEX_VERTS[HEX_EDGES[ei][1]][2];
      latv[mx][my][mz] = n_verts + edge_ids[{a, b}];
    }
    for (int fi = 0; fi < 6; fi++) {
      QuadKey k;
      for (int c = 0; c < 4; c++) k.v[c] = elems[e * 8 + HEX_FACES[fi][c]];
      for (int i = 0; i < 3; i++)
        for (int j = i + 1; j < 4; j++)
          if (k.v[i] > k.v[j]) std::swap(k.v[i], k.v[j]);
      int mx = 0, my = 0, mz = 0;
      for (int c = 0; c < 4; c++) {
        mx += HEX_VERTS[HEX_FACES[fi][c]][0];
        my += HEX_VERTS[HEX_FACES[fi][c]][1];
        mz += HEX_VERTS[HEX_FACES[fi][c]][2];
      }
      latv[mx / 2][my / 2][mz / 2] = n_verts + nE + face_ids[k];
    }
    latv[1][1][1] = n_verts + nE + nF + e;

    for (int ci = 0; ci < 8; ci++) {
      const int *o = HEX_VERTS[ci];
      for (int vi = 0; vi < 8; vi++) {
        const int *v = HEX_VERTS[vi];
        children[(e * 8 + ci) * 8 + vi] =
            latv[o[0] + v[0]][o[1] + v[1]][o[2] + v[2]];
      }
    }
  }
  return n_verts + nE + nF + ne;
}

}  // extern "C"
