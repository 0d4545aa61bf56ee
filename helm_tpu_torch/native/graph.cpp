// helm_tpu_torch native graph builder: netlist parser + topological scheduler.
//
// The port's own copy of native/graph.cpp (the JAX package's), unchanged
// but for this header. C++ counterpart of the host-side graph layer
// (reference: Rust src/verilog_parser.rs:138-276 and
// src/circuit.rs:122-239): parsing structural Verilog, Kahn wave
// topological sorting, and levelization — O(gates) with hashed wire tables,
// fast enough for multi-million-gate netlists where the Python parser
// becomes the bottleneck.
//
// ABI: helm_parse_netlist() returns a malloc'd, newline-delimited
// serialization (header lines + one line per gate, already levelized);
// helm_free() releases it. Python binding: helm_tpu_torch/circuit/native.py,
// which builds this file with g++ on first use (helm_tpu_torch/ops/build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>

namespace {

struct Gate {
  std::string name;
  std::string type;
  std::vector<std::string> inputs;
  std::string output;
  unsigned long long lut_const = 0;
  bool has_lut = false;
  int level = -1;
};

bool is_numeric(const std::string& s) {
  if (s.empty()) return false;
  for (char c : s)
    if (!isdigit((unsigned char)c)) return false;
  return true;
}

std::string strip(const std::string& s, const char* chars) {
  size_t b = s.find_first_not_of(chars);
  if (b == std::string::npos) return "";
  size_t e = s.find_last_not_of(chars);
  return s.substr(b, e - b + 1);
}

std::vector<std::string> tokenize(const std::string& line) {
  std::vector<std::string> toks;
  std::string cur;
  for (char c : line) {
    if (c == ' ' || c == ',' || c == '\t') {
      if (!cur.empty()) toks.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(c);
    }
  }
  if (!cur.empty()) toks.push_back(cur);
  return toks;
}

const std::unordered_set<std::string> kGateTypes = {
    "and",  "dff",  "lut", "mux", "nand", "nor", "not",
    "or",   "xnor", "xor", "buf", "czero", "cone", "mult",
    "add",  "sub",  "div", "shl", "shr",  "copy"};

const std::unordered_set<std::string> kArithTypes = {
    "add", "sub", "mult", "div", "shl", "shr", "copy"};

struct ParseResult {
  std::vector<Gate> gates;
  std::vector<std::string> inputs, outputs, dff_outputs;
  std::unordered_set<std::string> wire_set;
  bool has_luts = false, has_arith = false;
  std::string error;
};

bool parse_range(const std::string& tok, long& start, long& end) {
  std::string t = strip(tok, "[]");
  size_t colon = t.find(':');
  char* endp = nullptr;
  if (colon == std::string::npos) {
    long v = strtol(t.c_str(), &endp, 10);
    if (endp == t.c_str() || *endp) return false;
    start = end = v;
    return true;
  }
  std::string a = t.substr(0, colon), b = t.substr(colon + 1);
  long va = strtol(a.c_str(), &endp, 10);
  if (endp == a.c_str() || *endp) return false;
  long vb = strtol(b.c_str(), &endp, 10);
  if (endp == b.c_str() || *endp) return false;
  start = std::min(va, vb);
  end = std::max(va, vb);
  return true;
}

std::string strip_out(const std::string& tok) {
  std::string t = tok;
  while (!t.empty() && (t.back() == ';' || t.back() == ')')) t.pop_back();
  return t;
}

bool parse_gate(const std::vector<std::string>& toks, Gate* g,
                std::string* err) {
  const std::string& type = toks[0];
  g->type = type;
  // split toks[1] on '(' and ','
  std::vector<std::string> ni;
  {
    std::string cur;
    for (char c : toks[1]) {
      if (c == '(' || c == ',') {
        if (!strip(cur, " ").empty()) ni.push_back(strip(cur, " "));
        cur.clear();
      } else
        cur.push_back(c);
    }
    if (!strip(cur, " ").empty()) ni.push_back(strip(cur, " "));
  }
  if (ni.empty()) {
    *err = "malformed gate line";
    return false;
  }
  g->name = ni[0];
  if (type == "not" || type == "dff" || type == "buf" || type == "copy") {
    if (ni.size() < 2 || toks.size() < 3) { *err = "malformed " + type; return false; }
    g->inputs = {ni[1]};
    g->output = strip_out(toks[2]);
  } else if (type == "mux" || type == "lut") {
    if (ni.size() < 2 || toks.size() < 3) { *err = "malformed " + type; return false; }
    std::vector<std::string> ins;
    ins.push_back(ni[1]);
    for (size_t i = 2; i + 1 < toks.size(); i++) ins.push_back(strip_out(toks[i]));
    g->output = strip_out(toks.back());
    if (type == "lut") {
      std::string cs = ins.front();
      ins.erase(ins.begin());
      unsigned long long v = 0;
      if (cs.rfind("0x", 0) == 0)
        v = strtoull(cs.c_str() + 2, nullptr, 16);
      else
        v = strtoull(cs.c_str(), nullptr, 10);
      g->lut_const = v;
      g->has_lut = true;
    }
    g->inputs = ins;
  } else if (type == "czero" || type == "cone") {
    size_t b = toks[1].find('('), e = toks[1].find(')', b + 1);
    if (b == std::string::npos || e == std::string::npos) {
      *err = "malformed const gate";
      return false;
    }
    g->output = toks[1].substr(b + 1, e - b - 1);
  } else {
    if (ni.size() < 2 || toks.size() < 4) { *err = "malformed " + type; return false; }
    g->inputs = {ni[1], strip(toks[2], " ")};
    g->output = strip_out(toks[3]);
  }
  return true;
}

ParseResult parse_netlist(const char* path, bool is_arith) {
  ParseResult r;
  std::ifstream f(path);
  if (!f) {
    r.error = "cannot open file";
    return r;
  }
  std::unordered_set<std::string> seen_names;
  std::string raw;
  while (std::getline(f, raw)) {
    std::string line = strip(raw, " \t\r\n");
    if (line.empty() || line.rfind("module", 0) == 0 ||
        line.rfind("endmodule", 0) == 0 || line.rfind("//", 0) == 0)
      continue;
    auto toks = tokenize(line);
    if (toks.empty()) continue;
    const std::string& kind = toks[0];
    if (kind == "input" || kind == "output") {
      auto& dest = (kind == "input") ? r.inputs : r.outputs;
      long s, e;
      if (toks.size() > 2 && parse_range(toks[1], s, e)) {
        if (is_arith) {
          for (size_t i = 2; i < toks.size(); i++)
            dest.push_back(strip(strip_out(toks[i]), ","));
        } else {
          std::string name = strip(strip_out(toks[2]), ",");
          for (long i = s; i <= e; i++)
            dest.push_back(name + "[" + std::to_string(i) + "]");
        }
      } else {
        for (size_t i = 1; i < toks.size(); i++)
          dest.push_back(strip(strip_out(toks[i]), ","));
      }
    } else if (kind == "wire") {
      continue;
    } else if (kGateTypes.count(kind)) {
      Gate g;
      std::string err;
      if (!parse_gate(toks, &g, &err)) {
        r.error = err;
        return r;
      }
      if (g.type == "dff") {
        r.inputs.push_back(g.output);
        r.dff_outputs.push_back(g.output);
      } else if (g.type == "lut") {
        r.has_luts = true;
      } else if (kArithTypes.count(g.type)) {
        r.has_arith = true;
      }
      r.wire_set.insert(g.output);
      if (seen_names.insert(g.name).second) r.gates.push_back(std::move(g));
    } else {
      r.error = "Invalid gate type \"" + kind + "\"";
      return r;
    }
  }
  if (r.gates.empty()) {
    r.error = r.has_arith ? "Parser error, no arithmetic gates detected."
                          : "Parser error, no gates detected.";
    return r;
  }
  if (r.has_arith && r.has_luts) {
    r.error = "Can't mix LUTs with arithmetic operators!";
    return r;
  }
  return r;
}

// Kahn wave sort + levelization (reference circuit.rs:122-239 semantics,
// const gates kept at level 0).
bool levelize(ParseResult& r, std::string* err) {
  std::unordered_map<std::string, int> wire_level;
  for (const auto& w : r.inputs) wire_level[w] = 0;
  size_t remaining = 0;
  int max_level = 0;
  // multi-pass relaxation over a worklist (gates are near-topological in
  // practice; use indegree counting for O(V+E))
  std::unordered_map<std::string, std::vector<size_t>> consumers;
  std::vector<int> indeg(r.gates.size(), 0);
  std::vector<size_t> ready;
  for (size_t i = 0; i < r.gates.size(); i++) {
    Gate& g = r.gates[i];
    if (g.type == "dff") {
      g.level = INT32_MAX;
      continue;
    }
    if (g.type == "czero" || g.type == "cone") {
      g.level = 0;
      wire_level[g.output] = 0;
      continue;
    }
    for (const auto& in : g.inputs) {
      if (wire_level.count(in) || is_numeric(in)) continue;
      consumers[in].push_back(i);
      indeg[i]++;
    }
    if (indeg[i] == 0)
      ready.push_back(i);
    else
      remaining++;
  }
  // fixpoint: const outputs may feed gates; recheck after seeding
  for (size_t k = 0; k < ready.size(); k++) {
    size_t i = ready[k];
    Gate& g = r.gates[i];
    int depth = 0;
    for (const auto& in : g.inputs) {
      auto it = wire_level.find(in);
      int d = (it != wire_level.end()) ? it->second : 0;
      depth = std::max(depth, d + 1);
    }
    g.level = depth;
    max_level = std::max(max_level, depth);
    if (!wire_level.count(g.output)) {
      wire_level[g.output] = depth;
      auto it = consumers.find(g.output);
      if (it != consumers.end()) {
        for (size_t c : it->second) {
          if (--indeg[c] == 0) {
            ready.push_back(c);
            remaining--;
          }
        }
      }
    }
  }
  if (remaining > 0) {
    *err = "Cyclic or underdriven netlist";
    return false;
  }
  for (auto& g : r.gates)
    if (g.type == "dff") g.level = max_level + 1;
  // deterministic order: (level, name)
  std::stable_sort(r.gates.begin(), r.gates.end(),
                   [](const Gate& a, const Gate& b) {
                     if (a.level != b.level) return a.level < b.level;
                     return a.name < b.name;
                   });
  return true;
}

std::string serialize(const ParseResult& r) {
  std::ostringstream o;
  o << "OK\n";
  o << "FLAGS " << (r.has_luts ? 1 : 0) << " " << (r.has_arith ? 1 : 0) << "\n";
  o << "INPUTS";
  for (const auto& w : r.inputs) o << " " << w;
  o << "\nOUTPUTS";
  for (const auto& w : r.outputs) o << " " << w;
  o << "\nDFF";
  for (const auto& w : r.dff_outputs) o << " " << w;
  o << "\n";
  for (const auto& g : r.gates) {
    o << "G " << g.level << " " << g.type << " " << g.name << " " << g.output
      << " " << g.lut_const << " " << g.inputs.size();
    for (const auto& in : g.inputs) o << " " << in;
    o << "\n";
  }
  return o.str();
}

}  // namespace

extern "C" {

// Returns a malloc'd serialization; first line "OK" or "ERR <message>".
char* helm_parse_netlist(const char* path, int is_arith) {
  ParseResult r = parse_netlist(path, is_arith != 0);
  std::string out;
  if (!r.error.empty()) {
    out = "ERR " + r.error + "\n";
  } else {
    std::string err;
    if (!levelize(r, &err))
      out = "ERR " + err + "\n";
    else
      out = serialize(r);
  }
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

void helm_free(char* p) { free(p); }
}
