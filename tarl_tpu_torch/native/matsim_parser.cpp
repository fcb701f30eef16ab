// Native MATSim scenario ingestion for the PyTorch port of TARL-TPU: the
// port's own copy of native/src/matsim_parser.cpp, unchanged in what it
// computes.
//
// The reference parses network/population XML with lxml plus Python loops
// (transportation_simulator.py:61-228, agents/base.py:38-242) — minutes for
// metropolitan-scale scenarios.  This is the native data-loader tier: a
// memchr-driven streaming scanner over the raw (optionally gzipped) bytes
// that emits flat arrays through a C ABI consumed via ctypes
// (tarl_tpu_torch/io/native.py).  No third-party XML library; MATSim files
// are machine-generated and regular, and the scanner still handles
// comments, prolog/DTD lines and both quote styles.
//
// Build: tarl_tpu_torch/io/native.py compiles it at first use with
// g++ -O3 -fPIC -shared -std=c++17 ... -lz into build/tarl_tpu_torch/.
// Without zlib's header it compiles with -DTARL_NO_ZLIB: a .gz path then
// returns the parser's error (tarl_has_gzip() reads 0).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <unordered_map>
#include <vector>

#ifndef TARL_NO_ZLIB
#include <zlib.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// File loading (plain or gzip)
// ---------------------------------------------------------------------------
bool load_file(const char* path, std::string& out) {
  size_t n = std::strlen(path);
  if (n > 3 && std::strcmp(path + n - 3, ".gz") == 0) {
#ifdef TARL_NO_ZLIB
    return false;  // built without zlib: no .gz input
#else
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    char buf[1 << 16];
    int got;
    while ((got = gzread(f, buf, sizeof(buf))) > 0) out.append(buf, got);
    gzclose(f);
    return got == 0;
#endif
  }
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(sz);
  size_t rd = std::fread(out.data(), 1, sz, f);
  std::fclose(f);
  return rd == static_cast<size_t>(sz);
}

// ---------------------------------------------------------------------------
// Minimal XML tag scanner
// ---------------------------------------------------------------------------
struct Attr {
  const char* key;
  size_t key_len;
  const char* val;
  size_t val_len;
};

struct Tag {
  const char* name;
  size_t name_len;
  bool closing;      // </name>
  bool self_closed;  // <name ... />
  std::vector<Attr> attrs;

  bool is(const char* s) const {
    return std::strlen(s) == name_len && std::memcmp(name, s, name_len) == 0;
  }
  bool get(const char* key, std::string& out) const {
    size_t kl = std::strlen(key);
    for (const Attr& a : attrs) {
      if (a.key_len == kl && std::memcmp(a.key, key, kl) == 0) {
        out.assign(a.val, a.val_len);
        return true;
      }
    }
    return false;
  }
  double get_num(const char* key, double fallback) const {
    size_t kl = std::strlen(key);
    for (const Attr& a : attrs) {
      if (a.key_len == kl && std::memcmp(a.key, key, kl) == 0) {
        return std::strtod(std::string(a.val, a.val_len).c_str(), nullptr);
      }
    }
    return fallback;
  }
};

class Scanner {
 public:
  explicit Scanner(const std::string& data)
      : p_(data.data()), end_(data.data() + data.size()) {}

  // Advance to the next element tag; returns false at EOF.
  bool next(Tag& tag) {
    for (;;) {
      const char* lt =
          static_cast<const char*>(std::memchr(p_, '<', end_ - p_));
      if (!lt) return false;
      p_ = lt + 1;
      if (p_ >= end_) return false;
      if (*p_ == '?') {  // prolog
        skip_until("?>");
        continue;
      }
      if (*p_ == '!') {  // comment / DTD
        if (end_ - p_ >= 3 && p_[1] == '-' && p_[2] == '-') {
          skip_until("-->");
        } else {
          skip_until(">");
        }
        continue;
      }
      return parse_tag(tag);
    }
  }

  // Text content until the next '<' (for <attribute>value</attribute>).
  std::string text() {
    const char* lt = static_cast<const char*>(std::memchr(p_, '<', end_ - p_));
    if (!lt) lt = end_;
    return std::string(p_, lt - p_);
  }

 private:
  void skip_until(const char* marker) {
    size_t ml = std::strlen(marker);
    const char* found = std::search(p_, end_, marker, marker + ml);
    p_ = (found == end_) ? end_ : found + ml;
  }

  bool parse_tag(Tag& tag) {
    tag.attrs.clear();
    tag.closing = false;
    tag.self_closed = false;
    if (*p_ == '/') {
      tag.closing = true;
      ++p_;
    }
    tag.name = p_;
    while (p_ < end_ && !std::strchr(" \t\r\n/>", *p_)) ++p_;
    tag.name_len = p_ - tag.name;
    // attributes
    for (;;) {
      while (p_ < end_ && std::strchr(" \t\r\n", *p_)) ++p_;
      if (p_ >= end_) return false;
      if (*p_ == '/') {
        tag.self_closed = true;
        ++p_;
        continue;
      }
      if (*p_ == '>') {
        ++p_;
        return true;
      }
      Attr a;
      a.key = p_;
      while (p_ < end_ && *p_ != '=' && !std::strchr(" \t\r\n>/", *p_)) ++p_;
      a.key_len = p_ - a.key;
      while (p_ < end_ && *p_ != '=') ++p_;
      if (p_ >= end_) return false;
      ++p_;  // '='
      while (p_ < end_ && std::strchr(" \t\r\n", *p_)) ++p_;
      char quote = *p_;
      if (quote != '"' && quote != '\'') return false;
      ++p_;
      a.val = p_;
      const char* q =
          static_cast<const char*>(std::memchr(p_, quote, end_ - p_));
      if (!q) return false;
      a.val_len = q - p_;
      p_ = q + 1;
      tag.attrs.push_back(a);
    }
  }

  const char* p_;
  const char* end_;
};

// ---------------------------------------------------------------------------
// Network parsing (transportation_simulator.py:96-147 semantics)
// ---------------------------------------------------------------------------
struct NetworkData {
  double effective_cell_size = 7.5;
  std::vector<std::string> link_ids;
  std::vector<double> length, capacity, freespeed, permlanes;
  std::vector<int32_t> from_idx, to_idx;  // sorted-intersection ordinals
  std::vector<std::string> sorted_intersections;
  std::vector<double> node_x, node_y;  // in sorted-intersection order
  std::string error;
};

struct RawLink {
  std::string from, to;
};

NetworkData* parse_network(const char* path) {
  auto* nd = new NetworkData();
  std::string data;
  if (!load_file(path, data)) {
    nd->error = "cannot read file";
    return nd;
  }
  Scanner sc(data);
  Tag tag;
  std::unordered_map<std::string, std::pair<double, double>> node_pos;
  std::vector<RawLink> raw;
  while (sc.next(tag)) {
    if (tag.closing) continue;
    if (tag.is("node")) {
      std::string id;
      tag.get("id", id);
      node_pos[id] = {tag.get_num("x", 0.0), tag.get_num("y", 0.0)};
    } else if (tag.is("links")) {
      nd->effective_cell_size = tag.get_num("effectivecellsize", 7.5);
    } else if (tag.is("link")) {
      std::string id, from, to;
      tag.get("id", id);
      tag.get("from", from);
      tag.get("to", to);
      nd->link_ids.push_back(id.empty()
                                 ? std::to_string(nd->link_ids.size())
                                 : id);
      nd->length.push_back(tag.get_num("length", 0.0));
      nd->capacity.push_back(tag.get_num("capacity", 0.0));
      nd->freespeed.push_back(tag.get_num("freespeed", 1.0));
      nd->permlanes.push_back(tag.get_num("permlanes", 1.0));
      raw.push_back({from, to});
    }
  }
  // Sorted-intersection indexing (ts.py:142): byte-wise string order matches
  // Python's sorted() for the ASCII ids MATSim emits.
  std::vector<std::string> inters;
  {
    std::unordered_map<std::string, int32_t> seen;
    for (const RawLink& l : raw) {
      if (seen.emplace(l.from, 0).second) inters.push_back(l.from);
      if (seen.emplace(l.to, 0).second) inters.push_back(l.to);
    }
    std::sort(inters.begin(), inters.end());
    for (size_t i = 0; i < inters.size(); ++i) seen[inters[i]] = (int32_t)i;
    for (const RawLink& l : raw) {
      nd->from_idx.push_back(seen[l.from]);
      nd->to_idx.push_back(seen[l.to]);
    }
  }
  nd->sorted_intersections = std::move(inters);
  for (const std::string& id : nd->sorted_intersections) {
    auto it = node_pos.find(id);
    nd->node_x.push_back(it == node_pos.end() ? 0.0 : it->second.first);
    nd->node_y.push_back(it == node_pos.end() ? 0.0 : it->second.second);
  }
  return nd;
}

// ---------------------------------------------------------------------------
// Population parsing (agents/base.py:38-242 semantics)
// ---------------------------------------------------------------------------
struct PopulationData {
  // 9 columns per trip row: ORIGIN, DESTINATION, DEPARTURE_TIME,
  // ARRIVAL_TIME, AGE, SEX, EMPLOYMENT_STATUS, ON_WAY, DONE — including the
  // dummy row 0 (base.py:131-133; departure forced to 48 h, base.py:443-444).
  std::vector<float> rows;
  int64_t total_agents = 0, selected_agents = 0;
  int64_t excl_car = 0, excl_no_plan = 0, excl_few_acts = 0, excl_no_trip = 0;
  int64_t invalid_trips = 0;
  bool needs_python_fallback = false;  // coordinate-only legacy plans
  std::string error;
};

int parse_end_time(const std::string& s) {
  // "HH:MM:SS" or "HH:MM" (base.py:47-57); anything else -> 0.
  int h = 0, m = 0, sec = 0;
  if (std::sscanf(s.c_str(), "%d:%d:%d", &h, &m, &sec) >= 2)
    return h * 3600 + m * 60 + sec;
  return 0;
}

std::string lower(std::string s) {
  for (char& c : s) c = (char)std::tolower((unsigned char)c);
  return s;
}

struct Act {
  std::string link;
  std::string end_time;
  bool has_coords = false;
};

PopulationData* parse_population(const char* pop_path, const char* net_path) {
  auto* pd = new PopulationData();
  NetworkData* nd = parse_network(net_path);
  if (!nd->error.empty()) {
    pd->error = "network: " + nd->error;
    delete nd;
    return pd;
  }
  std::unordered_map<std::string, int32_t> inter_ord;
  for (size_t i = 0; i < nd->sorted_intersections.size(); ++i)
    inter_ord[nd->sorted_intersections[i]] = (int32_t)i;
  const int64_t num_links = (int64_t)nd->link_ids.size();

  std::string data;
  if (!load_file(pop_path, data)) {
    pd->error = "cannot read population file";
    delete nd;
    return pd;
  }

  // Dummy agent row 0.
  const float dummy[9] = {0.f, 0.f, 48.f * 3600.f, 0.f, 20.f, 0.f, 0.f, 0.f, 0.f};
  pd->rows.insert(pd->rows.end(), dummy, dummy + 9);

  Scanner sc(data);
  Tag tag;
  bool in_person = false;
  std::unordered_map<std::string, std::string> attrs;
  std::vector<Act> acts;
  std::string pending_attr_name;

  auto flush_person = [&]() {
    if (!in_person) return;
    in_person = false;
    pd->total_agents++;
    std::string car = attrs.count("car_avail") ? attrs["car_avail"]
                      : attrs.count("carAvail") ? attrs["carAvail"]
                                                : "always";
    if (lower(car) != "always") {
      pd->excl_car++;
      return;
    }
    if (acts.empty()) {
      pd->excl_no_plan++;
      return;
    }
    if (acts.size() < 2) {
      pd->excl_few_acts++;
      return;
    }
    float sex = lower(attrs.count("sex") ? attrs["sex"] : "m") == "f" ? 1.f : 0.f;
    float employed =
        lower(attrs.count("employed") ? attrs["employed"] : "no") == "yes" ? 1.f
                                                                           : 0.f;
    // Default age 20 (the reference's attribute default, base.py:71).
    float age =
        attrs.count("age") ? std::strtof(attrs["age"].c_str(), nullptr) : 20.f;
    int valid = 0;
    for (size_t i = 0; i + 1 < acts.size(); ++i) {
      auto o = inter_ord.find(acts[i].link);
      auto d = inter_ord.find(acts[i + 1].link);
      if (o == inter_ord.end() || d == inter_ord.end()) {
        if (acts[i].has_coords || acts[i + 1].has_coords)
          pd->needs_python_fallback = true;  // KDTree path (base.py:165-181)
        pd->invalid_trips++;
        continue;
      }
      float src_idx = (float)(num_links + 2 * o->second);
      float dest_idx = (float)(num_links + 2 * d->second + 1);
      float dep = (float)parse_end_time(acts[i].end_time);
      const float row[9] = {src_idx, dest_idx, dep, 0.f, age,
                            sex,     employed, 0.f, 0.f};
      pd->rows.insert(pd->rows.end(), row, row + 9);
      valid++;
    }
    if (valid > 0)
      pd->selected_agents++;
    else
      pd->excl_no_trip++;
  };

  while (sc.next(tag)) {
    if (tag.is("person")) {
      if (tag.closing) {
        flush_person();
      } else {
        flush_person();  // malformed nesting guard
        in_person = true;
        attrs.clear();
        acts.clear();
        for (const Attr& a : tag.attrs)
          attrs[std::string(a.key, a.key_len)] = std::string(a.val, a.val_len);
        if (tag.self_closed) flush_person();
      }
    } else if (!tag.closing && in_person &&
               (tag.is("act") || tag.is("activity"))) {
      Act act;
      tag.get("link", act.link);
      tag.get("end_time", act.end_time);
      std::string tmp;
      act.has_coords = tag.get("x", tmp);
      acts.push_back(std::move(act));
    } else if (!tag.closing && in_person && tag.is("attribute")) {
      std::string name;
      tag.get("name", name);
      if (!tag.self_closed && !name.empty()) {
        std::string value = sc.text();
        if (!value.empty()) attrs[name] = value;
      }
    }
  }
  flush_person();
  delete nd;
  return pd;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

int32_t tarl_has_gzip() {
#ifdef TARL_NO_ZLIB
  return 0;
#else
  return 1;
#endif
}

void* tarl_parse_network(const char* path) { return parse_network(path); }

const char* tarl_net_error(void* h) {
  return static_cast<NetworkData*>(h)->error.c_str();
}
int64_t tarl_net_num_links(void* h) {
  return (int64_t)static_cast<NetworkData*>(h)->link_ids.size();
}
int64_t tarl_net_num_intersections(void* h) {
  return (int64_t)static_cast<NetworkData*>(h)->sorted_intersections.size();
}
double tarl_net_cell_size(void* h) {
  return static_cast<NetworkData*>(h)->effective_cell_size;
}
void tarl_net_fill(void* h, double* length, double* capacity,
                   double* freespeed, double* permlanes, int32_t* from_idx,
                   int32_t* to_idx) {
  auto* nd = static_cast<NetworkData*>(h);
  size_t n = nd->link_ids.size();
  std::memcpy(length, nd->length.data(), n * sizeof(double));
  std::memcpy(capacity, nd->capacity.data(), n * sizeof(double));
  std::memcpy(freespeed, nd->freespeed.data(), n * sizeof(double));
  std::memcpy(permlanes, nd->permlanes.data(), n * sizeof(double));
  std::memcpy(from_idx, nd->from_idx.data(), n * sizeof(int32_t));
  std::memcpy(to_idx, nd->to_idx.data(), n * sizeof(int32_t));
}
void tarl_net_coords(void* h, double* x, double* y) {
  auto* nd = static_cast<NetworkData*>(h);
  size_t n = nd->sorted_intersections.size();
  std::memcpy(x, nd->node_x.data(), n * sizeof(double));
  std::memcpy(y, nd->node_y.data(), n * sizeof(double));
}
// Intersection ids as one \n-joined buffer (for exact-parity checks).
int64_t tarl_net_ids_size(void* h) {
  auto* nd = static_cast<NetworkData*>(h);
  int64_t total = 0;
  for (const auto& s : nd->sorted_intersections) total += (int64_t)s.size() + 1;
  return total;
}
void tarl_net_ids_fill(void* h, char* buf) {
  auto* nd = static_cast<NetworkData*>(h);
  for (const auto& s : nd->sorted_intersections) {
    std::memcpy(buf, s.data(), s.size());
    buf += s.size();
    *buf++ = '\n';
  }
}
void tarl_net_free(void* h) { delete static_cast<NetworkData*>(h); }

void* tarl_parse_population(const char* pop_path, const char* net_path) {
  return parse_population(pop_path, net_path);
}
const char* tarl_pop_error(void* h) {
  return static_cast<PopulationData*>(h)->error.c_str();
}
int32_t tarl_pop_needs_fallback(void* h) {
  return static_cast<PopulationData*>(h)->needs_python_fallback ? 1 : 0;
}
int64_t tarl_pop_num_rows(void* h) {
  return (int64_t)(static_cast<PopulationData*>(h)->rows.size() / 9);
}
void tarl_pop_fill(void* h, float* out) {
  auto* pd = static_cast<PopulationData*>(h);
  std::memcpy(out, pd->rows.data(), pd->rows.size() * sizeof(float));
}
void tarl_pop_stats(void* h, int64_t* out /* [7] */) {
  auto* pd = static_cast<PopulationData*>(h);
  out[0] = pd->total_agents;
  out[1] = pd->selected_agents;
  out[2] = pd->excl_car;
  out[3] = pd->excl_no_plan;
  out[4] = pd->excl_few_acts;
  out[5] = pd->excl_no_trip;
  out[6] = pd->invalid_trips;
}
void tarl_pop_free(void* h) { delete static_cast<PopulationData*>(h); }

}  // extern "C"
