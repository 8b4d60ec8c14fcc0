// Native data-ingest runtime for lightgbm_tpu_torch: the JAX package's
// parser, copied unchanged below this header.
//
// The analog of the reference's C++ ingest pipeline: the text parsers
// (src/io/parser.cpp — CSV/TSV/LibSVM), the pipelined file reader
// (include/LightGBM/utils/pipeline_reader.h) and the feature-extraction hot
// loop (DatasetLoader::ExtractFeaturesFromFile, src/io/dataset_loader.cpp:1254),
// re-designed as a flat C ABI for ctypes: the host parses + bins with
// std::thread row-block parallelism, then hands dense arrays straight to
// device upload (no per-row virtual dispatch, no FeatureGroup push path).
//
// Exposed entry points (all extern "C"):
//   ParseDelimited  — CSV/TSV -> dense double matrix (+count pass)
//   ParseLibSVM     — sparse text -> dense double matrix
//   BinValues       — raw doubles -> per-feature bin ids (uint16) via
//                     upper-bound binary search (BinMapper::ValueToBin,
//                     include/LightGBM/bin.h:464-502)
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// fast strtod-compatible float parse; falls back to strtod for exotic forms
inline double fast_atof(const char* p, const char** end) {
  while (*p == ' ' || *p == '\t') ++p;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') { ++p; }
  if ((p[0] == 'n' || p[0] == 'N') && (p[1] == 'a' || p[1] == 'A')) {
    *end = p + 3;
    return std::nan("");
  }
  double value = 0.0;
  int digits = 0;
  while (*p >= '0' && *p <= '9') {
    value = value * 10.0 + (*p - '0');
    ++p; ++digits;
  }
  if (*p == '.') {
    ++p;
    double frac = 0.1;
    while (*p >= '0' && *p <= '9') {
      value += (*p - '0') * frac;
      frac *= 0.1;
      ++p; ++digits;
    }
  }
  if (digits == 0) {  // not a plain number; delegate
    char* e;
    double v = std::strtod(p, &e);
    *end = e;
    return neg ? -v : v;
  }
  if (*p == 'e' || *p == 'E') {
    ++p;
    bool eneg = false;
    if (*p == '-') { eneg = true; ++p; }
    else if (*p == '+') { ++p; }
    int ex = 0;
    while (*p >= '0' && *p <= '9') { ex = ex * 10 + (*p - '0'); ++p; }
    value *= std::pow(10.0, eneg ? -ex : ex);
  }
  *end = p;
  return neg ? -value : value;
}

// read whole file into memory (the reference double-buffers via
// PipelineReader; a single read keeps the ABI simple and saturates page
// cache for benchmark-sized files)
bool read_file(const char* path, std::vector<char>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size) + 1);
  size_t got = std::fread(out->data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  if (got != static_cast<size_t>(size)) return false;
  (*out)[got] = '\0';
  return true;
}

// ---- PipelineReader: double-buffered read-ahead --------------------------
// Analog of the reference's PipelineReader
// (include/LightGBM/utils/pipeline_reader.h): a background thread reads
// section k+1 while the caller parses section k, so IO and parsing overlap
// and peak memory is two sections, not the whole file.
class PipelineReader {
 public:
  PipelineReader(const char* path, size_t section_bytes)
      : f_(std::fopen(path, "rb")), section_(section_bytes) {}
  ~PipelineReader() {
    if (io_.joinable()) io_.join();
    if (f_) std::fclose(f_);
  }
  bool ok() const { return f_ != nullptr; }
  // true if any fread failed mid-stream (EOF is not an error)
  bool io_error() const { return error_; }

  // Hand the caller the next section; the following section's read is
  // already in flight when this returns.  False at EOF.  The returned
  // pointer stays valid until the next acquire() call.
  bool acquire(const char** data, size_t* n) {
    if (!started_) {
      fill(front_);
      started_ = true;
    } else {
      if (io_.joinable()) io_.join();   // no thread after a short-read skip
      front_ ^= 1;              // the prefetched buffer becomes current
    }
    if (len_[front_] == 0) {
      len_[front_ ^ 1] = 0;     // EOF is sticky: further acquires stay false
      return false;
    }
    *data = buf_[front_].data();
    *n = len_[front_];
    // a short read means EOF was reached: the prefetch would only perform a
    // guaranteed zero-byte fread, so don't spawn it
    if (len_[front_] == section_) {
      int back = front_ ^ 1;
      io_ = std::thread([this, back] { fill(back); });
    } else {
      len_[front_ ^ 1] = 0;
    }
    return true;
  }

 private:
  void fill(int idx) {
    buf_[idx].resize(section_);
    len_[idx] = f_ ? std::fread(buf_[idx].data(), 1, section_, f_) : 0;
    if (f_ && len_[idx] < section_ && std::ferror(f_)) error_ = true;
  }
  FILE* f_;
  size_t section_;
  std::vector<char> buf_[2];
  size_t len_[2] = {0, 0};
  int front_ = 0;
  bool started_ = false;
  bool error_ = false;
  std::thread io_;
};

// mutable: tests shrink it via SetParserSectionBytes to stress boundaries
size_t g_section_bytes = 64 << 20;           // two in flight -> 128MB peak

// newline-aligned split of [0, len) into nt chunks
std::vector<size_t> chunk_starts(const char* buf, size_t len, int nt) {
  std::vector<size_t> starts{0};
  for (int t = 1; t < nt; ++t) {
    size_t pos = len * static_cast<size_t>(t) / nt;
    while (pos < len && buf[pos] != '\n') ++pos;
    if (pos < len) ++pos;
    starts.push_back(pos);
  }
  starts.push_back(len);
  return starts;
}

}  // namespace

extern "C" {

// Test hook: override the pipeline section size (0 restores the default).
void SetParserSectionBytes(int64_t n) {
  g_section_bytes = n > 0 ? static_cast<size_t>(n) : (64 << 20);
}

// First pass: count data rows and columns, streamed through the pipelined
// reader (no whole-file buffer).  Returns 0 on success.
int CountDelimited(const char* path, char delim, int skip_rows,
                   int64_t* out_rows, int64_t* out_cols) {
  PipelineReader reader(path, g_section_bytes);
  if (!reader.ok()) return 1;
  int64_t rows = 0, cols = 0;
  int skipped = 0;
  std::vector<char> carry;
  const char* data;
  size_t n;
  auto count_line = [&](const char* p, const char* line_end) {
    if (line_end <= p) return;               // empty line
    if (skipped < skip_rows) {
      ++skipped;
      return;
    }
    if (rows == 0) {
      cols = 1;
      for (const char* q = p; q < line_end; ++q)
        if (*q == delim) ++cols;
    }
    ++rows;
  };
  while (reader.acquire(&data, &n)) {
    const char* p = data;
    const char* end = data + n;
    if (!carry.empty()) {
      // finish the line split across the section boundary
      const char* nl = static_cast<const char*>(std::memchr(p, '\n', n));
      size_t take = nl ? static_cast<size_t>(nl - p) : n;
      carry.insert(carry.end(), p, p + take);
      if (!nl) continue;                     // line still not complete
      count_line(carry.data(), carry.data() + carry.size());
      carry.clear();
      p = nl + 1;
    }
    while (p < end) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!nl) {
        carry.assign(p, end);
        break;
      }
      count_line(p, nl);
      p = nl + 1;
    }
  }
  if (reader.io_error()) return 1;
  if (!carry.empty())
    count_line(carry.data(), carry.data() + carry.size());
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

namespace {

// Parse the newline-terminated region [base, base+len) into out rows
// starting at row_off; thread-parallel over newline-aligned chunks.
// Returns the number of rows parsed.
int64_t parse_region(const char* base, size_t len, char delim, int64_t rows,
                     int64_t cols, int64_t row_off, double* out) {
  if (len == 0) return 0;
  int nt = hardware_threads();
  auto starts = chunk_starts(base, len, nt);
  std::vector<int64_t> row_at(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    // count NON-BLANK lines only — the parse loop skips blank lines, so
    // counting raw newlines would drift every later row's offset
    int64_t cnt = 0;
    const char* p = base + starts[t];
    const char* cend = base + starts[t + 1];
    while (p < cend) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(cend - p)));
      if (!nl) nl = cend;
      if (nl > p) ++cnt;
      p = nl + 1;
    }
    row_at[t + 1] = row_at[t] + cnt;
  }
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([&, t]() {
      const char* p = base + starts[t];
      const char* chunk_end = base + starts[t + 1];
      int64_t r = row_off + row_at[t];
      while (p < chunk_end && r < rows) {
        const char* line_end = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(chunk_end - p)));
        if (!line_end) line_end = chunk_end;
        if (line_end > p) {
          double* dst = out + r * cols;
          const char* q = p;
          for (int64_t c = 0; c < cols; ++c) {
            const char* e;
            dst[c] = fast_atof(q, &e);
            q = e;
            while (q < line_end && *q != delim) ++q;
            if (q < line_end) ++q;
          }
          ++r;
        }
        p = line_end + 1;
      }
    });
  }
  for (auto& th : ths) th.join();
  return row_at[nt];
}

}  // namespace

// Second pass: parse into the caller-allocated [rows, cols] matrix.
// Sections stream through the PipelineReader (IO overlapped with parsing);
// within a section, parsing is thread-parallel over newline-aligned chunks.
int ParseDelimited(const char* path, char delim, int skip_rows,
                   int64_t rows, int64_t cols, double* out) {
  PipelineReader reader(path, g_section_bytes);
  if (!reader.ok()) return 1;
  int to_skip = skip_rows;
  int64_t row_off = 0;
  std::vector<char> carry;                    // partial tail line
  const char* data;
  size_t n;
  while (reader.acquire(&data, &n)) {
    const char* p = data;
    const char* end = data + n;
    // skip header rows (may span sections)
    while (to_skip > 0 && p < end) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!nl) { p = end; break; }
      p = nl + 1;
      --to_skip;
    }
    if (p >= end) continue;
    if (!carry.empty()) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      size_t take = nl ? static_cast<size_t>(nl - p) + 1
                       : static_cast<size_t>(end - p);
      carry.insert(carry.end(), p, p + take);
      if (!nl) continue;                      // line still incomplete
      row_off += parse_region(carry.data(), carry.size(), delim, rows, cols,
                              row_off, out);
      carry.clear();
      p += take;
    }
    // parse up to the last complete line; keep the tail for the next section
    const char* last_nl = nullptr;
    for (const char* q = end; q > p; --q) {
      if (q[-1] == '\n') { last_nl = q; break; }
    }
    if (!last_nl) {
      carry.assign(p, end);
      continue;
    }
    row_off += parse_region(p, static_cast<size_t>(last_nl - p), delim, rows,
                            cols, row_off, out);
    if (last_nl < end) carry.assign(last_nl, end);
  }
  if (reader.io_error()) return 1;
  if (!carry.empty())
    parse_region(carry.data(), carry.size(), delim, rows, cols, row_off, out);
  return 0;
}

// LibSVM: "label idx:val idx:val ...".  Single pass to find dims, then
// parallel fill.  out must be [rows, max_feature+1] zero-initialised by the
// caller after calling CountLibSVM.
int CountLibSVM(const char* path, int64_t* out_rows, int64_t* out_cols) {
  std::vector<char> buf;
  if (!read_file(path, &buf)) return 1;
  const char* p = buf.data();
  const char* end = p + buf.size() - 1;
  int64_t rows = 0, max_feat = -1;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    if (line_end > p) {
      ++rows;
      for (const char* q = p; q < line_end; ++q) {
        if (*q == ':') {
          const char* d = q;
          while (d > p && std::isdigit(*(d - 1))) --d;
          int64_t idx = std::strtoll(d, nullptr, 10);
          if (idx > max_feat) max_feat = idx;
        }
      }
    }
    p = line_end + 1;
  }
  *out_rows = rows;
  *out_cols = max_feat + 1;
  return 0;
}

int ParseLibSVM(const char* path, int64_t rows, int64_t cols,
                double* out, double* labels) {
  std::vector<char> buf;
  if (!read_file(path, &buf)) return 1;
  const char* base = buf.data();
  size_t len = buf.size() - 1;
  int nt = hardware_threads();
  auto starts = chunk_starts(base, len, nt);
  std::vector<int64_t> row_at(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    int64_t cnt = 0;
    for (size_t p = starts[t]; p < starts[t + 1]; ++p)
      if (base[p] == '\n') ++cnt;
    if (t == nt - 1 && starts[t + 1] > starts[t] &&
        base[starts[t + 1] - 1] != '\n')
      ++cnt;
    row_at[t + 1] = row_at[t] + cnt;
  }
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([&, t]() {
      const char* p = base + starts[t];
      const char* chunk_end = base + starts[t + 1];
      int64_t r = row_at[t];
      while (p < chunk_end && r < rows) {
        const char* line_end = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(chunk_end - p)));
        if (!line_end) line_end = chunk_end;
        if (line_end > p) {
          const char* e;
          labels[r] = fast_atof(p, &e);
          const char* q = e;
          double* dst = out + r * cols;
          while (q < line_end) {
            while (q < line_end && (*q == ' ' || *q == '\t')) ++q;
            if (q >= line_end) break;
            char* colon_end;
            int64_t idx = std::strtoll(q, &colon_end, 10);
            if (*colon_end != ':') break;
            const char* v = colon_end + 1;
            double val = fast_atof(v, &e);
            if (idx >= 0 && idx < cols) dst[idx] = val;
            q = e;
          }
          ++r;
        }
        p = line_end + 1;
      }
    });
  }
  for (auto& th : ths) th.join();
  return 0;
}

// raw values -> bin ids.  Per feature: upper-bound binary search over
// bin_uppers[offsets[f] : offsets[f+1]] (BinMapper::ValueToBin semantics:
// first bin whose upper bound >= value); NaN maps to nan_bin[f] when >= 0,
// else to default_bin[f].  Categorical features (is_cat[f]) map value v to
// cat_bin via a per-feature hash-free table lookup is done Python-side —
// here cat features use the same searchsorted over sorted category values
// encoded in bin_uppers with bin ids in cat_perm.
int BinValues(const double* data, int64_t rows, int64_t cols,
              const double* bin_uppers, const int64_t* offsets,
              const int32_t* nan_bins, const int32_t* default_bins,
              const uint8_t* is_cat, const int32_t* cat_perm,
              uint16_t* out) {
  int nt = hardware_threads();
  std::vector<std::thread> ths;
  int64_t block = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t r0 = t * block;
    int64_t r1 = std::min(rows, r0 + block);
    if (r0 >= r1) break;
    ths.emplace_back([=]() {
      for (int64_t r = r0; r < r1; ++r) {
        const double* row = data + r * cols;
        uint16_t* dst = out + r * cols;
        for (int64_t f = 0; f < cols; ++f) {
          double v = row[f];
          int64_t lo = offsets[f], hi = offsets[f + 1];
          int64_t nb = hi - lo;
          if (std::isnan(v)) {
            dst[f] = static_cast<uint16_t>(
                nan_bins[f] >= 0 ? nan_bins[f] : default_bins[f]);
            continue;
          }
          if (is_cat[f]) {
            // binary search for exact category among sorted values
            int64_t a = 0, b = nb;
            int32_t bin = default_bins[f];
            while (a < b) {
              int64_t m = (a + b) / 2;
              double cv = bin_uppers[lo + m];
              if (cv < v) a = m + 1;
              else if (cv > v) b = m;
              else { bin = cat_perm[lo + m]; break; }
            }
            dst[f] = static_cast<uint16_t>(bin < 0 ? 0 : bin);
            continue;
          }
          // first bin whose upper bound >= v (searchsorted 'left')
          int64_t a = 0, b = nb - 1;
          while (a < b) {
            int64_t m = (a + b) / 2;
            if (bin_uppers[lo + m] < v) a = m + 1;
            else b = m;
          }
          dst[f] = static_cast<uint16_t>(a);
        }
      }
    });
  }
  for (auto& th : ths) th.join();
  return 0;
}

}  // extern "C"
