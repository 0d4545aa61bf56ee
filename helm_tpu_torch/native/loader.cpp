// helm_tpu_torch native data loader: CSV test-vector parsing + threaded
// batch LWE encryption.
//
// The port's own copy of native/loader.cpp (the JAX package's), unchanged
// but for this header, so that both packages draw the same ciphertexts from
// the same key material. C++ counterpart of the host-side client I/O layer
// (reference: Rust src/verilog_parser.rs:278-349
// read_input_wires/write_output_wires and the encrypt-inputs role of
// src/circuit.rs:450-480): parsing many CSV files and filling the [M, n+1]
// ciphertext slab of a giant batched-serving vector set with all cores,
// straight into a caller-provided buffer (no per-row Python dispatch).
// Python binding: helm_tpu_torch/io/native_loader.py, which builds this file
// with g++ on first use (helm_tpu_torch/ops/build.py).
//
// ABI:
//   helm_read_input_csv(path, is_bool) -> malloc'd "wire=value\n" lines with
//     hex-width rows already expanded to per-bit wires (little-endian index,
//     reference src/lib.rs:181-194); helm_loader_free() releases it.
//   helm_encrypt_lwe(key, n, mu, m, noise_std, key32, nthreads, out) fills
//     out[m][n+1] with LWE encryptions b = <a,s> + mu_i + e (q = 2^32,
//     wrapping). PRNG: ChaCha20 (RFC 8439 block function) keyed by the
//     caller-provided 256-bit key32, one nonce-separated stream per fixed
//     1024-row block (output identical for every nthreads value)
//     — CSPRNG-grade, matching the Python ChaChaGenerator's threat model
//     (helm_tpu_torch/fhe/csprng.py; the reference's client is tfhe-rs,
//     which is CSPRNG-seeded throughout — Cargo.toml:18).

#include <atomic>
#include <cctype>
#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// ChaCha20 keystream (RFC 8439 block function), buffered per instance.
struct ChaCha {
  uint32_t key[8];
  uint32_t nonce[3];
  uint32_t counter = 0;
  uint32_t buf[16];
  int have = 0;

  ChaCha(const uint8_t* key32, uint64_t stream) {
    std::memcpy(key, key32, 32);  // little-endian words (x86/ARM LE)
    nonce[0] = (uint32_t)stream;
    nonce[1] = (uint32_t)(stream >> 32);
    nonce[2] = 0;
  }
  static uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }
#define HELM_QR(a, b, c, d)                      \
  a += b; d = rotl(d ^ a, 16);                   \
  c += d; b = rotl(b ^ c, 12);                   \
  a += b; d = rotl(d ^ a, 8);                    \
  c += d; b = rotl(b ^ c, 7)
  void refill() {
    uint32_t x[16] = {0x61707865u, 0x3320646eu, 0x79622d32u, 0x6b206574u,
                      key[0], key[1], key[2], key[3],
                      key[4], key[5], key[6], key[7],
                      counter, nonce[0], nonce[1], nonce[2]};
    uint32_t w[16];
    std::memcpy(w, x, sizeof(x));
    for (int i = 0; i < 10; i++) {
      HELM_QR(w[0], w[4], w[8], w[12]);
      HELM_QR(w[1], w[5], w[9], w[13]);
      HELM_QR(w[2], w[6], w[10], w[14]);
      HELM_QR(w[3], w[7], w[11], w[15]);
      HELM_QR(w[0], w[5], w[10], w[15]);
      HELM_QR(w[1], w[6], w[11], w[12]);
      HELM_QR(w[2], w[7], w[8], w[13]);
      HELM_QR(w[3], w[4], w[9], w[14]);
    }
    for (int i = 0; i < 16; i++) buf[i] = w[i] + x[i];
    counter++;
    have = 16;
  }
#undef HELM_QR
  uint32_t next32() {
    if (have == 0) refill();
    return buf[16 - have--];
  }
  double uniform01() {  // (0, 1]: 53-bit mantissa from two words
    uint64_t v = (uint64_t)next32() | ((uint64_t)next32() << 32);
    return ((v >> 11) + 1) * 0x1.0p-53;
  }
};

void encrypt_rows(const uint32_t* key, int n, const uint32_t* mu, long lo,
                  long hi, double noise_std, const uint8_t* key32,
                  uint64_t stream, uint32_t* out) {
  ChaCha rng(key32, stream);
  const long stride = n + 1;
  for (long r = lo; r < hi; r++) {
    uint32_t* row = out + r * stride;
    uint64_t dot = 0;
    for (long i = 0; i < n; i++) {
      uint32_t a0 = rng.next32();
      row[i] = a0;
      dot += (uint64_t)a0 * key[i];
    }
    int64_t e = 0;
    if (noise_std > 0.0) {
      // Box-Muller, rounded like the numpy path (rint of normal(0, std))
      double u1 = rng.uniform01(), u2 = rng.uniform01();
      double g = std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
      e = (int64_t)std::llrint(g * noise_std);
    }
    row[n] = (uint32_t)dot + mu[r] + (uint32_t)(int32_t)e;
  }
}

std::string strip(const std::string& sv) {
  size_t b = sv.find_first_not_of(" \t\r\n");
  if (b == std::string::npos) return "";
  size_t e = sv.find_last_not_of(" \t\r\n");
  return sv.substr(b, e - b + 1);
}

}  // namespace

extern "C" {

// Threaded batch LWE encryption. key: u32[n] (any values; binary for TFHE),
// mu: u32[m] torus messages, key32: 256-bit ChaCha20 key (fresh per call),
// out: u32[m*(n+1)]. Wrapping mod 2^32.
void helm_encrypt_lwe(const uint32_t* key, int n, const uint32_t* mu, long m,
                      double noise_std, const uint8_t* key32, int nthreads,
                      uint32_t* out) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  // Nonce-separated streams keyed by FIXED row blocks (not thread index):
  // stream b encrypts rows [b*kRowsPerStream, ...), so the ciphertexts a
  // given (key32, mu) produces are identical for every nthreads value and
  // batch-size threshold. Threads pull blocks from an atomic counter.
  const long kRowsPerStream = 1024;
  long nblocks = (m + kRowsPerStream - 1) / kRowsPerStream;
  std::atomic<long> next(0);
  auto worker = [&]() {
    long b;
    while ((b = next.fetch_add(1)) < nblocks) {
      long lo = b * kRowsPerStream, hi = std::min(m, lo + kRowsPerStream);
      encrypt_rows(key, n, mu, lo, hi, noise_std, key32, (uint64_t)b, out);
    }
  };
  long nt = std::min((long)nthreads, nblocks);
  if (nt <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> ts;
  for (long t = 0; t < nt; t++) ts.emplace_back(worker);
  for (auto& th : ts) th.join();
}

// Parse an input-wire CSV (reference formats: `wire,value` or bool
// `wire,hex,width` with little-endian bit expansion). Returns malloc'd
// "name=value\n" text (value: 0/1 for bool, decimal otherwise), or NULL on
// unreadable file. An optional first header row (wire/name/...) is skipped.
char* helm_read_input_csv(const char* path, int is_bool) {
  std::ifstream f(path);
  if (!f.good()) return nullptr;
  std::ostringstream outbuf;
  std::string line;
  bool first = true;
  while (std::getline(f, line)) {
    std::vector<std::string> cols;
    std::stringstream ss(line);
    std::string c;
    while (std::getline(ss, c, ',')) cols.push_back(strip(c));
    if (cols.empty() || (cols.size() == 1 && cols[0].empty())) continue;
    if (first) {
      first = false;
      std::string h = cols[0];
      for (auto& ch : h) ch = (char)tolower((unsigned char)ch);
      if (h == "wire" || h == "wire_name" || h == "name") continue;
    }
    if (cols.size() == 2) {
      if (is_bool) {
        std::string v = cols[1];
        for (auto& ch : v) ch = (char)tolower((unsigned char)ch);
        outbuf << cols[0] << "=" << ((v == "1" || v == "true") ? 1 : 0) << "\n";
      } else {
        outbuf << cols[0] << "=" << cols[1] << "\n";
      }
    } else if (cols.size() == 3 && is_bool) {
      long width = strtol(cols[2].c_str(), nullptr, 10);
      if (width <= 1) {
        std::string v = cols[1];
        for (auto& ch : v) ch = (char)tolower((unsigned char)ch);
        outbuf << cols[0] << "=" << ((v == "1" || v == "true") ? 1 : 0) << "\n";
        continue;
      }
      // hex -> bitstring (4 bits per digit, MSB first), then reverse-index
      const std::string& hex = cols[1];
      std::string bits;
      bits.reserve(hex.size() * 4);
      for (char hc : hex) {
        if (!isxdigit((unsigned char)hc)) return nullptr;  // ValueError parity
        int v = isdigit((unsigned char)hc)
                    ? hc - '0'
                    : 10 + (tolower((unsigned char)hc) - 'a');
        for (int b = 3; b >= 0; b--) bits.push_back((char)('0' + ((v >> b) & 1)));
      }
      std::string rev(bits.rbegin(), bits.rend());
      for (long idx = 0; idx < width; idx++) {
        int bit = idx < (long)rev.size() && rev[(size_t)idx] == '1';
        outbuf << cols[0] << "[" << idx << "]=" << bit << "\n";
      }
    } else {
      return nullptr;  // malformed row: mirror the Python ValueError
    }
  }
  std::string s = outbuf.str();
  char* ret = (char*)malloc(s.size() + 1);
  std::memcpy(ret, s.c_str(), s.size() + 1);
  return ret;
}

void helm_loader_free(char* p) { free(p); }

}  // extern "C"
