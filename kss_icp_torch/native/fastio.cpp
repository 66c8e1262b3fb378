// Fast point-cloud file parsing: the native reader of kss_icp_torch, a copy
// of kss_icp_tpu/native/fastio.cpp (its C symbols keep their names).
//
// The reference's loaders (PlyLoad.cpp sscanf-per-line, LoadPointCloud.hpp
// ifstream>>double) are single-threaded C++; this is the equivalent native
// component: mmap'd, branch-light text parsing plus a std::thread batch
// loader so a multi-pair sweep can overlap file I/O with device compute.
// Exposed as a plain C ABI for ctypes (kss_icp_torch/native/__init__.py).
//
// Formats: count-format text (.xyz/.gird/.wlop/.normal/.txt: first token =
// N, then rows), plain whitespace xyz, OFF, OBJ ('v' lines), PLY ascii +
// binary_little_endian (x/y/z float or double properties).

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap(Mapped& m) {
  if (m.data) ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
  m.data = nullptr;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
  return p;
}

inline const char* skip_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Parse all whitespace-separated doubles from [p, end) into out.
void parse_doubles(const char* p, const char* end, std::vector<double>& out) {
  while (true) {
    p = skip_ws(p, end);
    if (p >= end) break;
    char* next = nullptr;
    double v = strtod(p, &next);
    if (next == p) {  // non-numeric token (e.g. 'v' in OBJ) — skip it
      while (p < end && !isspace(static_cast<unsigned char>(*p))) ++p;
      continue;
    }
    out.push_back(v);
    p = next;
  }
}

double* to_heap(const std::vector<double>& v) {
  double* buf = static_cast<double*>(malloc(v.size() * sizeof(double)));
  if (buf) memcpy(buf, v.data(), v.size() * sizeof(double));
  return buf;
}

// --- format-specific parsers, each returning rows of `cols` doubles ---

long parse_count_text(const Mapped& m, double** out, long* cols_out) {
  const char* p = m.data;
  const char* end = m.data + m.size;
  std::vector<double> vals;
  vals.reserve(1 << 16);
  parse_doubles(p, end, vals);
  if (vals.empty()) return -1;
  // Count format: first value is an integer N and the rest divides by N.
  double first = vals[0];
  size_t rest = vals.size() - 1;
  long n = static_cast<long>(first);
  long cols = 3;
  if (n > 0 && first == static_cast<double>(n) && rest >= static_cast<size_t>(n) * 3) {
    cols = static_cast<long>(rest / static_cast<size_t>(n));
    if (cols < 3) cols = 3;
    std::vector<double> pts(vals.begin() + 1, vals.begin() + 1 + n * cols);
    *out = to_heap(pts);
    *cols_out = cols;
    return n;
  }
  // Plain whitespace cloud.
  if (vals.size() % 3 == 0) cols = 3;
  else if (vals.size() % 6 == 0) cols = 6;
  else return -1;
  *out = to_heap(vals);
  *cols_out = cols;
  return static_cast<long>(vals.size() / cols);
}

long parse_off(const Mapped& m, double** out, long* cols_out) {
  const char* p = m.data;
  const char* end = m.data + m.size;
  p = skip_ws(p, end);
  if (end - p >= 3 && strncmp(p, "OFF", 3) == 0) p += 3;
  std::vector<double> header;
  // nv nf ne
  const char* q = p;
  std::vector<double> vals;
  vals.reserve(1 << 16);
  parse_doubles(q, end, vals);
  if (vals.size() < 3) return -1;
  long nv = static_cast<long>(vals[0]);
  if (nv <= 0 || vals.size() < 3 + static_cast<size_t>(nv) * 3) return -1;
  std::vector<double> pts(vals.begin() + 3, vals.begin() + 3 + nv * 3);
  *out = to_heap(pts);
  *cols_out = 3;
  return nv;
}

long parse_obj(const Mapped& m, double** out, long* cols_out) {
  const char* p = m.data;
  const char* end = m.data + m.size;
  std::vector<double> pts;
  pts.reserve(1 << 16);
  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' &&
        (p[1] == ' ' || p[1] == '\t')) {
      char* next = nullptr;
      const char* q = p + 2;
      double x = strtod(q, &next);
      q = next;
      double y = strtod(q, &next);
      q = next;
      double z = strtod(q, &next);
      if (next != q) {
        pts.push_back(x);
        pts.push_back(y);
        pts.push_back(z);
      }
    }
    p = skip_line(p, end);
  }
  if (pts.empty()) return -1;
  *out = to_heap(pts);
  *cols_out = 3;
  return static_cast<long>(pts.size() / 3);
}

struct PlyProp {
  std::string type;
  std::string name;
  bool is_list = false;
  std::string count_type, elem_type;
};

int type_size(const std::string& t) {
  if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
  if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
  if (t == "int" || t == "uint" || t == "int32" || t == "uint32" ||
      t == "float" || t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

long parse_ply(const Mapped& m, double** out, long* cols_out) {
  const char* end = m.data + m.size;
  const char* p = m.data;
  std::string format;
  struct Elem {
    std::string name;
    long count = 0;
    std::vector<PlyProp> props;
  };
  std::vector<Elem> elems;
  // --- header ---
  while (p < end) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    std::string line(p, line_end - p);
    p = line_end < end ? line_end + 1 : end;
    if (line.rfind("format", 0) == 0) {
      format = line.substr(7, line.find(' ', 7) - 7);
    } else if (line.rfind("element", 0) == 0) {
      char name[64];
      long cnt;
      if (sscanf(line.c_str(), "element %63s %ld", name, &cnt) == 2)
        elems.push_back({name, cnt, {}});
    } else if (line.rfind("property", 0) == 0 && !elems.empty()) {
      char a[64], b[64], c[64], d[64];
      PlyProp prop;
      if (sscanf(line.c_str(), "property list %63s %63s %63s", a, b, c) == 3) {
        prop.is_list = true;
        prop.count_type = a;
        prop.elem_type = b;
        prop.name = c;
      } else if (sscanf(line.c_str(), "property %63s %63s", a, d) == 2) {
        prop.type = a;
        prop.name = d;
      }
      elems.back().props.push_back(prop);
    } else if (line.rfind("end_header", 0) == 0) {
      break;
    }
  }
  const Elem* vertex = nullptr;
  for (auto& e : elems)
    if (e.name == "vertex") vertex = &e;
  if (!vertex) return -1;

  std::vector<double> pts;
  pts.reserve(vertex->count * 3);

  if (format == "ascii") {
    std::vector<double> vals;
    vals.reserve(vertex->count * vertex->props.size());
    parse_doubles(p, end, vals);
    long stride = static_cast<long>(vertex->props.size());
    int ix = -1, iy = -1, iz = -1;
    for (size_t i = 0; i < vertex->props.size(); ++i) {
      if (vertex->props[i].name == "x") ix = i;
      if (vertex->props[i].name == "y") iy = i;
      if (vertex->props[i].name == "z") iz = i;
    }
    if (ix < 0 || iy < 0 || iz < 0) return -1;
    if (vals.size() < static_cast<size_t>(vertex->count) * stride) return -1;
    for (long i = 0; i < vertex->count; ++i) {
      pts.push_back(vals[i * stride + ix]);
      pts.push_back(vals[i * stride + iy]);
      pts.push_back(vals[i * stride + iz]);
    }
  } else if (format == "binary_little_endian") {
    // Vertex must be the first element for a blind offset walk of others.
    for (auto& e : elems) {
      if (e.name == "vertex") break;
      for (long i = 0; i < e.count; ++i)
        for (auto& prop : e.props) {
          if (prop.is_list) {
            long n = 0;
            int cs = type_size(prop.count_type);
            memcpy(&n, p, cs < 8 ? cs : 8);
            p += cs + n * type_size(prop.elem_type);
          } else {
            p += type_size(prop.type);
          }
        }
    }
    long stride = 0;
    long offx = -1, offy = -1, offz = -1;
    std::string tx;
    for (auto& prop : vertex->props) {
      if (prop.is_list) return -1;
      if (prop.name == "x") { offx = stride; tx = prop.type; }
      if (prop.name == "y") offy = stride;
      if (prop.name == "z") offz = stride;
      stride += type_size(prop.type);
    }
    if (offx < 0 || offy < 0 || offz < 0) return -1;
    if (p + static_cast<size_t>(vertex->count) * stride > end) return -1;
    bool is_double = (tx == "double" || tx == "float64");
    for (long i = 0; i < vertex->count; ++i) {
      const char* row = p + i * stride;
      if (is_double) {
        double x, y, z;
        memcpy(&x, row + offx, 8);
        memcpy(&y, row + offy, 8);
        memcpy(&z, row + offz, 8);
        pts.push_back(x); pts.push_back(y); pts.push_back(z);
      } else {
        float x, y, z;
        memcpy(&x, row + offx, 4);
        memcpy(&y, row + offy, 4);
        memcpy(&z, row + offz, 4);
        pts.push_back(x); pts.push_back(y); pts.push_back(z);
      }
    }
  } else {
    return -1;
  }
  *out = to_heap(pts);
  *cols_out = 3;
  return vertex->count;
}

bool ends_with(const char* path, const char* suffix) {
  size_t lp = strlen(path), ls = strlen(suffix);
  return lp >= ls && strcasecmp(path + lp - ls, suffix) == 0;
}

long parse_dispatch(const char* path, double** out, long* cols) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  long n;
  if (ends_with(path, ".ply")) n = parse_ply(m, out, cols);
  else if (ends_with(path, ".off")) n = parse_off(m, out, cols);
  else if (ends_with(path, ".obj")) n = parse_obj(m, out, cols);
  else n = parse_count_text(m, out, cols);
  unmap(m);
  return n;
}

}  // namespace

extern "C" {

// Returns row count (or -1); *out = malloc'd row-major doubles, *cols set.
long ksstpu_parse_points(const char* path, double** out, long* cols) {
  return parse_dispatch(path, out, cols);
}

void ksstpu_free(double* buf) { free(buf); }

// Write a count-format .xyz ("N\n" then one "x y z" row per point, %.6g,
// truncating — the deliberate fix of the reference's ios::app duplicate-
// append, Main_KSS_ICP.cpp:49-59). Returns 0 on success, -1 on I/O error.
int ksstpu_write_xyz(const char* path, const double* pts, long n) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  std::vector<char> buf(1 << 20);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  fprintf(f, "%ld\n", n);
  for (long i = 0; i < n; ++i) {
    fprintf(f, "%.6g %.6g %.6g\n", pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]);
  }
  int rc = ferror(f) ? -1 : 0;
  if (fclose(f) != 0) rc = -1;
  return rc;
}

// Threaded batch load: paths[i] -> outs[i]/ns[i]/cols[i]. Returns 0 on
// success (individual failures leave ns[i] = -1).
int ksstpu_parse_batch(const char** paths, long count, double** outs,
                       long* ns, long* cols) {
  long hw = static_cast<long>(std::thread::hardware_concurrency());
  long n_threads = hw > 0 ? (hw < count ? hw : count) : 1;
  std::vector<std::thread> workers;
  std::atomic_long next(0);
  for (long t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      while (true) {
        long i = next.fetch_add(1);
        if (i >= count) break;
        ns[i] = parse_dispatch(paths[i], &outs[i], &cols[i]);
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

}  // extern "C"
