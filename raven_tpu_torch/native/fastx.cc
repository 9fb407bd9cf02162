// Streaming FASTA/FASTQ(.gz) parser -> packed code arrays.
//
// First-party replacement for the reference's bioparser dependency (use
// site RavenLib/src/io.cc): zlib-backed line streaming, base coding
// A/C/G/T -> 0..3 (IUPAC fallbacks like biosoup's coder), phred qualities.
// The parser allocates result buffers; the caller copies and frees.

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ParseResult {
  std::vector<std::uint8_t> codes;
  std::vector<std::uint8_t> quals;
  std::vector<std::int64_t> lengths;
  std::string names;                   // '\n'-joined
  std::string error;
};

const std::int8_t* coder_table() {
  static std::int8_t table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) table[i] = -1;
    auto set = [&](const char* chars, int v) {
      for (const char* p = chars; *p; ++p) table[(unsigned char)*p] = v;
    };
    set("AaRrMmWwDdHhVvNn", 0);
    set("CcYySsBb", 1);
    set("GgKk", 2);
    set("TtUu", 3);
    init = true;
  }
  return table;
}

class LineReader {
 public:
  explicit LineReader(const char* path) { f_ = gzopen(path, "rb"); }
  ~LineReader() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // reads one line (without terminator) into line; false on EOF
  bool getline(std::string* line) {
    line->clear();
    while (true) {
      if (pos_ >= len_) {
        len_ = gzread(f_, buf_, sizeof(buf_));
        pos_ = 0;
        if (len_ <= 0) return !line->empty();
      }
      char* nl = static_cast<char*>(memchr(buf_ + pos_, '\n', len_ - pos_));
      if (nl) {
        line->append(buf_ + pos_, nl - (buf_ + pos_));
        pos_ = (nl - buf_) + 1;
        if (!line->empty() && line->back() == '\r') line->pop_back();
        return true;
      }
      line->append(buf_ + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gzFile f_ = nullptr;
  char buf_[1 << 16];
  int pos_ = 0;
  int len_ = 0;
};

bool encode_append(const std::string& seq, std::vector<std::uint8_t>* codes,
                   std::string* error) {
  const std::int8_t* tab = coder_table();
  for (char c : seq) {
    const std::int8_t v = tab[(unsigned char)c];
    if (v < 0) {
      *error = std::string("invalid nucleotide character '") + c + "'";
      return false;
    }
    codes->push_back(static_cast<std::uint8_t>(v));
  }
  return true;
}

ParseResult* parse_impl(const char* path, int is_fastq) {
  auto* r = new ParseResult();
  LineReader in(path);
  if (!in.ok()) {
    r->error = "cannot open file";
    return r;
  }
  std::string line;
  if (!is_fastq) {
    std::string name;
    std::int64_t cur_len = 0;
    bool have = false;
    while (in.getline(&line)) {
      if (line.empty()) continue;
      if (line[0] == '>') {
        if (have) {
          if (cur_len == 0) {
            r->error = "empty sequence for " + name;
            return r;
          }
          r->lengths.push_back(cur_len);
        }
        const std::size_t sp = line.find_first_of(" \t");
        name = line.substr(1, sp == std::string::npos ? sp : sp - 1);
        r->names += name;
        r->names += '\n';
        cur_len = 0;
        have = true;
      } else {
        if (!have) {
          r->error = "FASTA data before first header";
          return r;
        }
        if (!encode_append(line, &r->codes, &r->error)) return r;
        cur_len += static_cast<std::int64_t>(line.size());
      }
    }
    if (have) {
      if (cur_len == 0) {
        r->error = "empty sequence for " + name;
        return r;
      }
      r->lengths.push_back(cur_len);
    }
  } else {
    std::string seq, plus, qual;
    while (in.getline(&line)) {
      if (line.empty()) continue;
      if (line[0] != '@') {
        r->error = "malformed FASTQ header";
        return r;
      }
      const std::size_t sp = line.find_first_of(" \t");
      r->names += line.substr(1, sp == std::string::npos ? sp : sp - 1);
      r->names += '\n';
      if (!in.getline(&seq) || !in.getline(&plus) || !in.getline(&qual) ||
          plus.empty() || plus[0] != '+' || qual.size() != seq.size()) {
        r->error = "malformed FASTQ record";
        return r;
      }
      if (!encode_append(seq, &r->codes, &r->error)) return r;
      for (char c : qual)
        r->quals.push_back(static_cast<std::uint8_t>(c - 33));
      r->lengths.push_back(static_cast<std::int64_t>(seq.size()));
    }
  }
  return r;
}

}  // namespace

extern "C" {

void* raven_fastx_parse(const char* path, int is_fastq) {
  return parse_impl(path, is_fastq);
}

long long raven_fastx_num_reads(void* h) {
  return static_cast<ParseResult*>(h)->lengths.size();
}
long long raven_fastx_total_bases(void* h) {
  return static_cast<ParseResult*>(h)->codes.size();
}
long long raven_fastx_names_size(void* h) {
  return static_cast<ParseResult*>(h)->names.size();
}
long long raven_fastx_has_quals(void* h) {
  return static_cast<ParseResult*>(h)->quals.empty() ? 0 : 1;
}
const char* raven_fastx_error(void* h) {
  return static_cast<ParseResult*>(h)->error.c_str();
}
void raven_fastx_copy(void* h, std::uint8_t* codes, std::uint8_t* quals,
                      std::int64_t* lengths, char* names) {
  auto* r = static_cast<ParseResult*>(h);
  if (!r->codes.empty()) memcpy(codes, r->codes.data(), r->codes.size());
  if (quals && !r->quals.empty())
    memcpy(quals, r->quals.data(), r->quals.size());
  if (!r->lengths.empty())
    memcpy(lengths, r->lengths.data(),
           r->lengths.size() * sizeof(std::int64_t));
  if (!r->names.empty()) memcpy(names, r->names.data(), r->names.size());
}
void raven_fastx_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
