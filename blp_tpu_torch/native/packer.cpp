// blp_tpu_torch native data packer (the port's copy of native/packer.cpp;
// same C ABI, same outputs).
//
// Hot host-side paths of the data layer, in C++ (the reference does all of
// this in Python line loops — data.py:117-130, 215-257 — which dominates
// startup at Wikidata5M scale: 21M triple lines, 4.8M descriptions):
//
//   * pack_triples: mmap'd TSV triple parsing with string->id mapping from
//     entities.txt/relations.txt line order, including the FB13/WN11
//     4-column "-1" row skip.
//   * wordpiece_encode_file: greedy longest-match WordPiece tokenization of
//     entity2text.tsv straight into the packed (num_ents, max_len+1) token
//     matrix (ids + length column), matching the Python tokenizer
//     (blp_tpu_torch/data/tokenizers.py) byte-for-byte on ASCII inputs; rows with
//     non-ASCII bytes are left for the Python tokenizer to fill
//     (returned in a needs_python bitmap) so unicode semantics stay exact.
//
// Exposed as a C ABI for ctypes (blp_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <string_view>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

MappedFile map_file(const char* path) {
  MappedFile f;
  f.fd = open(path, O_RDONLY);
  if (f.fd < 0) return f;
  struct stat st;
  if (fstat(f.fd, &st) != 0 || st.st_size == 0) { close(f.fd); return f; }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, f.fd, 0);
  if (p == MAP_FAILED) { close(f.fd); return f; }
  f.data = static_cast<const char*>(p);
  f.size = st.st_size;
  return f;
}

void unmap(MappedFile& f) {
  if (f.data) munmap(const_cast<char*>(f.data), f.size);
  if (f.fd >= 0) close(f.fd);
}

using IdMap = std::unordered_map<std::string_view, int32_t>;

// One id per line, by line order (reference: data.py:19-32).
bool load_id_map(const MappedFile& f, IdMap* out) {
  const char* p = f.data;
  const char* end = f.data + f.size;
  int32_t id = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // strip trailing \r / spaces
    const char* e = line_end;
    while (e > p && (e[-1] == '\r' || e[-1] == ' ' || e[-1] == '\t')) --e;
    const char* s = p;
    while (s < e && (*s == ' ' || *s == '\t')) ++s;
    if (e > s) out->emplace(std::string_view(s, e - s), id++);
    if (!nl) break;
    p = nl + 1;
  }
  return true;
}

inline const char* next_field(const char* p, const char* end,
                              std::string_view* out) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  const char* s = p;
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  *out = std::string_view(s, p - s);
  return p;
}

}  // namespace

extern "C" {

// Parse a triples TSV into out_triples (cap*3 int32, rows [head, tail, rel]).
// Returns the number of triples, or -1 on file error, -2 on unknown
// entity/relation, -3 if cap exceeded.
int64_t pack_triples(const char* triples_path, const char* entities_path,
                     const char* relations_path, int32_t* out_triples,
                     int64_t cap) {
  MappedFile ents = map_file(entities_path);
  MappedFile rels = map_file(relations_path);
  MappedFile trip = map_file(triples_path);
  if (!ents.ok() || !rels.ok() || !trip.ok()) {
    unmap(ents); unmap(rels); unmap(trip);
    return -1;
  }
  IdMap ent_ids, rel_ids;
  ent_ids.reserve(1 << 20);
  load_id_map(ents, &ent_ids);
  load_id_map(rels, &rel_ids);

  const char* p = trip.data;
  const char* end = trip.data + trip.size;
  int64_t n = 0;
  int64_t err = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    std::string_view h, r, t, extra;
    const char* q = next_field(p, line_end, &h);
    q = next_field(q, line_end, &r);
    q = next_field(q, line_end, &t);
    q = next_field(q, line_end, &extra);
    if (!h.empty() && !r.empty() && !t.empty()) {
      // FB13/WN11 duplicate rows labeled -1 are skipped (data.py:121-124).
      if (!(extra.size() == 2 && extra[0] == '-' && extra[1] == '1')) {
        auto hi = ent_ids.find(h);
        auto ti = ent_ids.find(t);
        auto ri = rel_ids.find(r);
        if (hi == ent_ids.end() || ti == ent_ids.end() || ri == rel_ids.end()) {
          err = -2;
          break;
        }
        if (n >= cap) { err = -3; break; }
        out_triples[n * 3 + 0] = hi->second;
        out_triples[n * 3 + 1] = ti->second;
        out_triples[n * 3 + 2] = ri->second;
        ++n;
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  unmap(ents); unmap(rels); unmap(trip);
  return err ? err : n;
}

// Count non-empty lines (for buffer sizing).
int64_t count_lines(const char* path) {
  MappedFile f = map_file(path);
  if (!f.ok()) return -1;
  int64_t n = 0;
  const char* p = f.data;
  const char* end = f.data + f.size;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    if (line_end > p) ++n;
    if (!nl) break;
    p = nl + 1;
  }
  unmap(f);
  return n;
}

// ---------------------------------------------------------------------------
// WordPiece tokenization of an entity2text file into the packed token matrix.
// ---------------------------------------------------------------------------

namespace {

struct Vocab {
  IdMap map;            // token -> id (both "word" and "##piece" forms)
  int32_t unk, cls, sep;
  std::vector<std::string> storage;  // owns vocab strings
};

inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match wordpiece of an ASCII word [s, e).
// Appends ids; returns false if any piece is unknown (emits UNK once).
void wordpiece(const Vocab& v, const char* s, const char* e, bool lower,
               std::vector<int32_t>* out) {
  if (e - s > 100) { out->push_back(v.unk); return; }
  std::string word(s, e - s);
  if (lower) for (auto& c : word) if (c >= 'A' && c <= 'Z') c += 32;
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t len = word.size() - start;
    bool found = false;
    std::string probe;
    while (len > 0) {
      probe.assign(start > 0 ? "##" : "", start > 0 ? 2 : 0);
      probe.append(word, start, len);
      auto it = v.map.find(std::string_view(probe));
      if (it != v.map.end()) {
        pieces.push_back(it->second);
        start += len;
        found = true;
        break;
      }
      --len;
    }
    if (!found) { out->push_back(v.unk); return; }
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

// Tokenize descriptions from a TSV (entity\tdescription...) into the packed
// (num_ents, max_len+1) int32 matrix. Rows are selected via the entity map
// from entities_path. ASCII-only lines are tokenized here; lines containing
// non-ASCII bytes set needs_python[row] = 1 and are skipped (exact unicode
// handling stays in the Python tokenizer).
//
// text_data must be zero-initialized by the caller. Existing rows (length
// column != 0) are not overwritten — mirroring the first-file-wins rule for
// entity2textlong.txt/entity2text.txt (data.py:221-236).
//
// Returns number of rows filled here, or negative on error.
int64_t wordpiece_encode_file(const char* text_path, const char* entities_path,
                              const char* vocab_path, int32_t max_len,
                              int do_lower, int32_t* text_data,
                              uint8_t* needs_python, int64_t num_ents) {
  MappedFile ents = map_file(entities_path);
  MappedFile vocab_f = map_file(vocab_path);
  MappedFile text = map_file(text_path);
  if (!ents.ok() || !vocab_f.ok() || !text.ok()) {
    unmap(ents); unmap(vocab_f); unmap(text);
    return -1;
  }
  IdMap ent_ids;
  ent_ids.reserve(1 << 20);
  load_id_map(ents, &ent_ids);

  Vocab v;
  {
    const char* p = vocab_f.data;
    const char* end = vocab_f.data + vocab_f.size;
    int32_t id = 0;
    while (p < end) {
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      const char* line_end = nl ? nl : end;
      const char* e = line_end;
      while (e > p && (e[-1] == '\r')) --e;
      v.storage.emplace_back(p, e - p);
      if (!nl) { break; }
      p = nl + 1;
    }
    v.unk = v.cls = v.sep = -1;
    for (size_t i = 0; i < v.storage.size(); ++i) {
      v.map.emplace(std::string_view(v.storage[i]), (int32_t)i);
      if (v.storage[i] == "[UNK]") v.unk = i;
      else if (v.storage[i] == "[CLS]") v.cls = i;
      else if (v.storage[i] == "[SEP]") v.sep = i;
    }
    if (v.unk < 0 || v.cls < 0 || v.sep < 0) {
      unmap(ents); unmap(vocab_f); unmap(text);
      return -2;
    }
  }

  const int32_t row_width = max_len + 1;
  int64_t filled = 0;
  const char* p = text.data;
  const char* end = text.data + text.size;
  std::vector<int32_t> ids;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* tab = static_cast<const char*>(memchr(p, '\t', line_end - p));
    if (tab) {
      std::string_view entity(p, tab - p);
      auto it = ent_ids.find(entity);
      if (it != ent_ids.end() && it->second < num_ents) {
        int32_t row = it->second;
        int32_t* out_row = text_data + (int64_t)row * row_width;
        if (out_row[row_width - 1] == 0) {  // first file wins
          // ASCII check.
          bool ascii = true;
          for (const char* c = tab + 1; c < line_end; ++c)
            if ((unsigned char)(*c) >= 0x80) { ascii = false; break; }
          if (!ascii) {
            needs_python[row] = 1;
          } else {
            // Basic-tokenize + wordpiece. Tabs inside the description join
            // with spaces (python: ' '.join(values[1:])) — both are
            // whitespace here.
            ids.clear();
            ids.push_back(v.cls);
            const char* c = tab + 1;
            while (c < line_end) {
              while (c < line_end &&
                     ((unsigned char)*c <= ' ')) ++c;  // ws/control
              if (c >= line_end) break;
              if (is_ascii_punct((unsigned char)*c)) {
                char buf[2] = {*c, 0};
                auto pit = v.map.find(std::string_view(buf, 1));
                ids.push_back(pit != v.map.end() ? pit->second : v.unk);
                ++c;
                continue;
              }
              const char* ws = c;
              while (ws < line_end && (unsigned char)*ws > ' ' &&
                     !is_ascii_punct((unsigned char)*ws)) ++ws;
              wordpiece(v, c, ws, do_lower != 0, &ids);
              c = ws;
            }
            // Truncate to max_len total including [CLS].. [SEP]
            // (HF encode semantics: body truncated to max_len - 2).
            if ((int32_t)ids.size() > max_len - 1)
              ids.resize(max_len - 1);
            ids.push_back(v.sep);
            int32_t n = (int32_t)ids.size();
            for (int32_t i = 0; i < n; ++i) out_row[i] = ids[i];
            out_row[row_width - 1] = n;
            ++filled;
          }
        }
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  unmap(ents); unmap(vocab_f); unmap(text);
  return filled;
}

}  // extern "C"
