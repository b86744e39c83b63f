// Native host I/O: binary-appended VTU writer + Gmsh v2.2 parser.
//
// lpfem_torch's copy of lpfem/native/vtuio.cpp (the same code). The
// reference leans on MFEM's C++ for both (ParaViewDataCollection,
// Solvers/PF_linear_par.cpp:433-449; the Gmsh reader behind Mesh(file),
// Solvers/cylinder-diffraction.cpp:225,259). The ASCII writer of
// lpfem_torch/io.py formats every value as text; here the appended blocks
// are a handful of fwrite()s of raw little-endian data (VTK "appended raw"
// encoding), and the parser is one buffered scan.
//
// C API only (loaded via ctypes, lpfem_torch/native.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- VTU write

// Appended raw block: UInt64 byte count followed by the bytes.
static int write_block(FILE *f, const void *data, uint64_t nbytes) {
  if (fwrite(&nbytes, 8, 1, f) != 1) return -1;
  if (nbytes && fwrite(data, 1, nbytes, f) != nbytes) return -1;
  return 0;
}

// Write a complete UnstructuredGrid VTU with appended raw binary data.
//   points  [npts*3] f64
//   conn    [ncell*nverts] i64
//   cell_type: VTK cell id (12 = hex, 9 = quad)
//   fields  nfields dof arrays [npts] f64, names NUL-separated in fnames
// Returns 0 on success.
int64_t lpfem_write_vtu(const char *path, const double *points, int64_t npts,
                        const int64_t *conn, int64_t ncell, int64_t nverts,
                        int32_t cell_type, const char *fnames,
                        const double *const *fields, int64_t nfields) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return -1;

  const uint64_t pts_b = (uint64_t)npts * 3 * 8;
  const uint64_t conn_b = (uint64_t)ncell * nverts * 8;
  const uint64_t offs_b = (uint64_t)ncell * 8;
  const uint64_t type_b = (uint64_t)ncell;
  const uint64_t fld_b = (uint64_t)npts * 8;

  std::string head;
  head.reserve(2048);
  char buf[512];
  head += "<?xml version=\"1.0\"?>\n"
          "<VTKFile type=\"UnstructuredGrid\" version=\"1.0\" "
          "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n"
          "<UnstructuredGrid>\n";
  std::snprintf(buf, sizeof buf,
                "<Piece NumberOfPoints=\"%lld\" NumberOfCells=\"%lld\">\n",
                (long long)npts, (long long)ncell);
  head += buf;
  uint64_t off = 0;
  std::snprintf(buf, sizeof buf,
                "<Points>\n<DataArray type=\"Float64\" "
                "NumberOfComponents=\"3\" format=\"appended\" "
                "offset=\"%llu\"/>\n</Points>\n",
                (unsigned long long)off);
  head += buf;
  off += 8 + pts_b;
  std::snprintf(buf, sizeof buf,
                "<Cells>\n<DataArray type=\"Int64\" Name=\"connectivity\" "
                "format=\"appended\" offset=\"%llu\"/>\n",
                (unsigned long long)off);
  head += buf;
  off += 8 + conn_b;
  std::snprintf(buf, sizeof buf,
                "<DataArray type=\"Int64\" Name=\"offsets\" "
                "format=\"appended\" offset=\"%llu\"/>\n",
                (unsigned long long)off);
  head += buf;
  off += 8 + offs_b;
  std::snprintf(buf, sizeof buf,
                "<DataArray type=\"UInt8\" Name=\"types\" "
                "format=\"appended\" offset=\"%llu\"/>\n</Cells>\n",
                (unsigned long long)off);
  head += buf;
  off += 8 + type_b;
  head += "<PointData>\n";
  const char *nm = fnames;
  for (int64_t i = 0; i < nfields; ++i) {
    std::snprintf(buf, sizeof buf,
                  "<DataArray type=\"Float64\" Name=\"%s\" "
                  "format=\"appended\" offset=\"%llu\"/>\n",
                  nm, (unsigned long long)off);
    head += buf;
    off += 8 + fld_b;
    nm += std::strlen(nm) + 1;
  }
  head += "</PointData>\n</Piece>\n</UnstructuredGrid>\n"
          "<AppendedData encoding=\"raw\">\n_";

  int rc = 0;
  if (fwrite(head.data(), 1, head.size(), f) != head.size()) rc = -1;
  if (!rc) rc = write_block(f, points, pts_b);
  if (!rc) rc = write_block(f, conn, conn_b);
  if (!rc) {
    std::vector<int64_t> offsets((size_t)ncell);
    for (int64_t i = 0; i < ncell; ++i) offsets[(size_t)i] = (i + 1) * nverts;
    rc = write_block(f, offsets.data(), offs_b);
  }
  if (!rc) {
    std::vector<uint8_t> types((size_t)ncell, (uint8_t)cell_type);
    rc = write_block(f, types.data(), type_b);
  }
  for (int64_t i = 0; !rc && i < nfields; ++i)
    rc = write_block(f, fields[i], fld_b);
  if (!rc) {
    const char *tail = "\n</AppendedData>\n</VTKFile>\n";
    if (fwrite(tail, 1, std::strlen(tail), f) != std::strlen(tail)) rc = -1;
  }
  if (std::fclose(f) != 0) rc = -1;
  return rc;
}

// --------------------------------------------------------------- Gmsh parse

// Gmsh v2.2 ASCII, the subset MFEM's reader exercises for the committed
// tank meshes: $Nodes (id x y z), $Elements rows "id etype ntags tags...
// conn..." keeping 8-node hexes (etype 5) and 4-node quads (etype 3, first
// tag = physical surface -> boundary attribute). Node ids may be sparse;
// output node order is ascending id (matches lpfem.mesh.load_gmsh).
struct GmshData {
  std::vector<double> nodes;   // [nn*3], ascending-id order
  std::vector<int64_t> hex;    // [nh*8], remapped indices
  std::vector<int64_t> quad;   // [nq*4]
  std::vector<int64_t> qtag;   // [nq]
};

void *lpfem_gmsh_open(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string text((size_t)sz, '\0');
  if (sz && std::fread(&text[0], 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  std::vector<int64_t> ids;
  std::vector<double> xyz;
  std::vector<std::vector<int64_t>> hex_raw, quad_raw;
  std::vector<int64_t> qtag;

  const char *p = text.c_str();
  const char *end = p + text.size();
  auto next_line = [&](const char *q) {
    while (q < end && *q != '\n') ++q;
    return q < end ? q + 1 : end;
  };
  while (p < end) {
    if (std::strncmp(p, "$Nodes", 6) == 0) {
      p = next_line(p);
      char *q;
      long long n = std::strtoll(p, &q, 10);
      p = next_line(q);
      ids.reserve((size_t)n);
      xyz.reserve((size_t)n * 3);
      for (long long i = 0; i < n; ++i) {
        long long id = std::strtoll(p, &q, 10);
        double x = std::strtod(q, &q);
        double y = std::strtod(q, &q);
        double z = std::strtod(q, &q);
        ids.push_back(id);
        xyz.push_back(x);
        xyz.push_back(y);
        xyz.push_back(z);
        p = next_line(q);
      }
    } else if (std::strncmp(p, "$Elements", 9) == 0) {
      p = next_line(p);
      char *q;
      long long n = std::strtoll(p, &q, 10);
      p = next_line(q);
      for (long long i = 0; i < n; ++i) {
        std::strtoll(p, &q, 10);                     // element id
        long long etype = std::strtoll(q, &q, 10);
        long long ntags = std::strtoll(q, &q, 10);
        long long phys = 0;
        for (long long t = 0; t < ntags; ++t) {
          long long v = std::strtoll(q, &q, 10);
          if (t == 0) phys = v;
        }
        int nv = etype == 5 ? 8 : (etype == 3 ? 4 : 0);
        if (nv) {
          std::vector<int64_t> conn((size_t)nv);
          for (int v = 0; v < nv; ++v) conn[(size_t)v] = std::strtoll(q, &q, 10);
          if (etype == 5) {
            hex_raw.push_back(std::move(conn));
          } else {
            quad_raw.push_back(std::move(conn));
            qtag.push_back(phys);
          }
        }
        p = next_line(q);
      }
    } else {
      p = next_line(p);
    }
  }
  if (ids.empty()) return nullptr;

  // ascending-id remap
  std::vector<size_t> order(ids.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](size_t a, size_t b) { return ids[a] < ids[b]; });
  std::unordered_map<int64_t, int64_t> remap;
  remap.reserve(ids.size() * 2);
  auto *d = new GmshData;
  d->nodes.resize(ids.size() * 3);
  for (size_t k = 0; k < order.size(); ++k) {
    size_t i = order[k];
    remap[ids[i]] = (int64_t)k;
    d->nodes[k * 3 + 0] = xyz[i * 3 + 0];
    d->nodes[k * 3 + 1] = xyz[i * 3 + 1];
    d->nodes[k * 3 + 2] = xyz[i * 3 + 2];
  }
  d->hex.reserve(hex_raw.size() * 8);
  for (auto &c : hex_raw)
    for (auto v : c) d->hex.push_back(remap.at(v));
  d->quad.reserve(quad_raw.size() * 4);
  for (auto &c : quad_raw)
    for (auto v : c) d->quad.push_back(remap.at(v));
  d->qtag = std::move(qtag);
  return d;
}

// out: [nnodes, nhex, nquad]
int64_t lpfem_gmsh_counts(void *h, int64_t *out) {
  if (!h) return -1;
  auto *d = (GmshData *)h;
  out[0] = (int64_t)(d->nodes.size() / 3);
  out[1] = (int64_t)(d->hex.size() / 8);
  out[2] = (int64_t)(d->quad.size() / 4);
  return 0;
}

int64_t lpfem_gmsh_fill(void *h, double *nodes, int64_t *hex, int64_t *quad,
                        int64_t *qtag) {
  if (!h) return -1;
  auto *d = (GmshData *)h;
  std::memcpy(nodes, d->nodes.data(), d->nodes.size() * 8);
  std::memcpy(hex, d->hex.data(), d->hex.size() * 8);
  std::memcpy(quad, d->quad.data(), d->quad.size() * 8);
  std::memcpy(qtag, d->qtag.data(), d->qtag.size() * 8);
  return 0;
}

void lpfem_gmsh_free(void *h) { delete (GmshData *)h; }

}  // extern "C"
