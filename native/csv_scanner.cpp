// Native bulk text scanner.
//
// Host-side equivalent of the reference's TextScanOperator
// (relational_operators/TextScanOperator.cpp: file split into 256KB segments, one
// WorkOrder per segment, parsed in parallel by Worker threads). Here the same
// parallel-segment design runs as std::threads inside one shared library, writing
// straight into caller-provided (numpy) buffers — no Python in the inner loop.
//
// Protocol (two-pass, caller allocates):
//   1. qs_count_rows(path, delim)            -> row count (parallel newline scan)
//   2. qs_parse_csv(path, delim, ncols, column type codes, output pointers)
//      type codes: 0=int64, 1=double, 2=date(packed int32 y<<9|m<<5|d),
//                  3=string (byte offsets into a string-bytes arena + arena fill)
//      Every column writes null flags (empty field or \N).
//
// Build: quickstep_tpu/storage/native_io.py compiles this file at first use
// into native/build/ (g++ -O3 -shared -fPIC -pthread).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

MappedFile map_file(const char* path) {
  MappedFile m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    if (st.st_size == 0) { m.data = ""; m.size = 0; }
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) return m;
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap_file(MappedFile& m) {
  if (m.data && m.size) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
}

int num_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw == 0 ? 4 : static_cast<int>(hw);
}

// Segment boundaries aligned to line starts (the 256KB-segment WorkOrder split).
std::vector<size_t> segment_starts(const char* data, size_t size, int nseg) {
  std::vector<size_t> starts;
  starts.push_back(0);
  for (int i = 1; i < nseg; ++i) {
    size_t pos = size * i / nseg;
    const void* nl = memchr(data + pos, '\n', size - pos);
    if (!nl) break;
    size_t next = static_cast<const char*>(nl) - data + 1;
    if (next > starts.back() && next < size) starts.push_back(next);
  }
  starts.push_back(size);
  return starts;
}

int64_t count_lines(const char* data, size_t begin, size_t end) {
  int64_t n = 0;
  const char* p = data + begin;
  const char* stop = data + end;
  while (p < stop) {
    const void* nl = memchr(p, '\n', stop - p);
    if (!nl) {
      // last line without trailing newline
      if (stop > p) ++n;
      break;
    }
    ++n;
    p = static_cast<const char*>(nl) + 1;
  }
  return n;
}

inline int32_t parse_date(const char* s, const char* e) {
  // YYYY-MM-DD -> (y<<9)|(m<<5)|d
  int y = 0, m = 0, d = 0;
  const char* p = s;
  while (p < e && *p != '-') y = y * 10 + (*p++ - '0');
  ++p;
  while (p < e && *p != '-') m = m * 10 + (*p++ - '0');
  ++p;
  while (p < e) d = d * 10 + (*p++ - '0');
  return (y << 9) | (m << 5) | d;
}

struct ColumnOut {
  int type;          // 0 int64, 1 double, 2 date, 3 string
  void* data;        // int64_t* / double* / int32_t* / int64_t* (offsets)
  uint8_t* nulls;    // 1 = null
};

}  // namespace

extern "C" {

// Parallel row count (pass 1).
int64_t qs_count_rows(const char* path) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int nt = num_threads();
  auto starts = segment_starts(m.data, m.size, nt);
  std::vector<int64_t> counts(starts.size() - 1, 0);
  std::vector<std::thread> ts;
  for (size_t i = 0; i + 1 < starts.size(); ++i) {
    ts.emplace_back([&, i] {
      counts[i] = count_lines(m.data, starts[i], starts[i + 1]);
    });
  }
  for (auto& t : ts) t.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  unmap_file(m);
  return total;
}

// Pass 2: parse into caller buffers. string_arena must hold >= file size bytes.
// string columns write (start_offset << 20 | length)? No — two arrays:
// offsets[row] into arena and len via next offset is fragile across threads, so
// string cells write arena chunks per segment; offsets/lengths packed into
// int64: (offset << 16) | min(len, 65535).
// Returns rows parsed, or -1 on error, -2 on malformed row.
int64_t qs_parse_csv(const char* path, char delim, int ncols,
                     const int* col_types, void** col_data,
                     uint8_t** col_nulls, char* string_arena,
                     int64_t* row_starts_out /* per-segment first row index,
                                                size >= threads+1 */) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int nt = num_threads();
  auto starts = segment_starts(m.data, m.size, nt);
  int nseg = static_cast<int>(starts.size()) - 1;

  // per-segment row counts -> global row offsets
  std::vector<int64_t> seg_rows(nseg, 0);
  {
    std::vector<std::thread> ts;
    for (int i = 0; i < nseg; ++i)
      ts.emplace_back([&, i] {
        seg_rows[i] = count_lines(m.data, starts[i], starts[i + 1]);
      });
    for (auto& t : ts) t.join();
  }
  std::vector<int64_t> row_base(nseg + 1, 0);
  for (int i = 0; i < nseg; ++i) row_base[i + 1] = row_base[i] + seg_rows[i];
  if (row_starts_out)
    for (int i = 0; i <= nseg; ++i) row_starts_out[i] = row_base[i];

  // string arena: give each segment a slice proportional to its byte span
  // (strings can't exceed their source bytes)
  std::vector<size_t> arena_base(nseg + 1, 0);
  for (int i = 0; i < nseg; ++i)
    arena_base[i + 1] = arena_base[i] + (starts[i + 1] - starts[i]);

  std::atomic<int64_t> status{0};
  std::vector<std::thread> ts;
  for (int seg = 0; seg < nseg; ++seg) {
    ts.emplace_back([&, seg] {
      const char* p = m.data + starts[seg];
      const char* stop = m.data + starts[seg + 1];
      int64_t row = row_base[seg];
      char* arena = string_arena + arena_base[seg];
      size_t arena_off = arena_base[seg];
      while (p < stop) {
        const char* line_end =
            static_cast<const char*>(memchr(p, '\n', stop - p));
        if (!line_end) line_end = stop;
        const char* f = p;
        for (int c = 0; c < ncols; ++c) {
          const char* fe = static_cast<const char*>(
              memchr(f, delim, line_end - f));
          if (!fe || fe > line_end) fe = line_end;
          bool is_null =
              (fe == f) || (fe - f == 2 && f[0] == '\\' && f[1] == 'N');
          col_nulls[c][row] = is_null ? 1 : 0;
          switch (col_types[c]) {
            case 0: {  // int64
              int64_t v = 0;
              if (!is_null) {
                bool neg = (*f == '-');
                const char* q = f + (neg ? 1 : 0);
                while (q < fe) v = v * 10 + (*q++ - '0');
                if (neg) v = -v;
              }
              static_cast<int64_t*>(col_data[c])[row] = v;
              break;
            }
            case 1: {  // double
              double v = 0.0;
              if (!is_null) {
                char buf[64];
                size_t len = fe - f < 63 ? fe - f : 63;
                memcpy(buf, f, len);
                buf[len] = 0;
                v = strtod(buf, nullptr);
              }
              static_cast<double*>(col_data[c])[row] = v;
              break;
            }
            case 2: {  // date
              static_cast<int32_t*>(col_data[c])[row] =
                  is_null ? 0 : parse_date(f, fe);
              break;
            }
            case 3: {  // string -> arena copy + packed (offset<<16 | len)
              size_t len = fe - f;
              if (len > 65535) len = 65535;
              memcpy(arena, f, len);
              static_cast<int64_t*>(col_data[c])[row] =
                  (static_cast<int64_t>(arena_off) << 16) |
                  static_cast<int64_t>(len);
              arena += len;
              arena_off += len;
              break;
            }
          }
          f = fe < line_end ? fe + 1 : line_end;
        }
        ++row;
        p = line_end + 1;
      }
    });
  }
  for (auto& t : ts) t.join();
  int64_t total = row_base[nseg];
  unmap_file(m);
  return status.load() < 0 ? status.load() : total;
}

}  // extern "C"
