/* Native WebSocket transcription client (see moonshine_client.h).
 *
 * Dependency-free: RFC 6455 client framing, the SHA-1 + base64 needed for
 * the handshake, and a minimal JSON reader for the server's flat event
 * objects are all implemented here (~no third-party code, matching the
 * repo rule that the native runtime vendors nothing).
 */
#include "moonshine_client.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <vector>

static_assert(sizeof(float) == 4, "float32 wire format");

namespace mtclient {

// ---------------------------------------------------------------------------
// SHA-1 (FIPS 180-1) — needed only to verify Sec-WebSocket-Accept.
// ---------------------------------------------------------------------------

struct Sha1 {
  uint32_t h[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u,
                   0xC3D2E1F0u};
  uint64_t total = 0;
  uint8_t block[64];
  size_t fill = 0;

  static uint32_t rol(uint32_t v, int n) { return (v << n) | (v >> (32 - n)); }

  void process(const uint8_t* p) {
    uint32_t w[80];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 80; ++i)
      w[i] = rol(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
    for (int i = 0; i < 80; ++i) {
      uint32_t f, k;
      if (i < 20) {
        f = (b & c) | (~b & d);
        k = 0x5A827999u;
      } else if (i < 40) {
        f = b ^ c ^ d;
        k = 0x6ED9EBA1u;
      } else if (i < 60) {
        f = (b & c) | (b & d) | (c & d);
        k = 0x8F1BBCDCu;
      } else {
        f = b ^ c ^ d;
        k = 0xCA62C1D6u;
      }
      uint32_t t = rol(a, 5) + f + e + k + w[i];
      e = d;
      d = c;
      c = rol(b, 30);
      b = a;
      a = t;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
    h[4] += e;
  }

  void update(const void* data, size_t n) {
    const uint8_t* p = static_cast<const uint8_t*>(data);
    total += n;
    while (n > 0) {
      size_t take = std::min(n, sizeof(block) - fill);
      memcpy(block + fill, p, take);
      fill += take;
      p += take;
      n -= take;
      if (fill == 64) {
        process(block);
        fill = 0;
      }
    }
  }

  void finish(uint8_t out[20]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (fill != 56) update(&zero, 1);
    uint8_t len[8];
    for (int i = 0; i < 8; ++i) len[i] = uint8_t(bits >> (56 - 8 * i));
    update(len, 8);
    for (int i = 0; i < 5; ++i) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

inline std::string sha1_hex(const std::string& s) {
  Sha1 sha;
  sha.update(s.data(), s.size());
  uint8_t d[20];
  sha.finish(d);
  char buf[41];
  for (int i = 0; i < 20; ++i) snprintf(buf + 2 * i, 3, "%02x", d[i]);
  return std::string(buf, 40);
}

inline std::string base64(const uint8_t* data, size_t n) {
  static const char tbl[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
  std::string out;
  out.reserve((n + 2) / 3 * 4);
  for (size_t i = 0; i < n; i += 3) {
    uint32_t v = uint32_t(data[i]) << 16;
    if (i + 1 < n) v |= uint32_t(data[i + 1]) << 8;
    if (i + 2 < n) v |= uint32_t(data[i + 2]);
    out.push_back(tbl[(v >> 18) & 63]);
    out.push_back(tbl[(v >> 12) & 63]);
    out.push_back(i + 1 < n ? tbl[(v >> 6) & 63] : '=');
    out.push_back(i + 2 < n ? tbl[v & 63] : '=');
  }
  return out;
}

// ---------------------------------------------------------------------------
// Minimal JSON reader for the server's flat event objects.
// Handles: {"k": "string", "k": number, "k": true/false/null}.  Strings
// decode \" \\ \/ \b \f \n \r \t and \uXXXX incl. surrogate pairs → UTF-8.
// ---------------------------------------------------------------------------

struct JsonValue {
  bool is_string = false;
  bool is_number = false;
  bool is_array = false;
  std::string str;
  double num = 0.0;
  std::vector<double> nums;  // flat number arrays (e.g. "speakers")
};

inline void utf8_append(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(char(cp));
  } else if (cp < 0x800) {
    out.push_back(char(0xC0 | (cp >> 6)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(char(0xE0 | (cp >> 12)));
    out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(char(0xF0 | (cp >> 18)));
    out.push_back(char(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(char(0x80 | (cp & 0x3F)));
  }
}

// Parses the string literal starting at s[i] == '"'.  Returns false on
// malformed input; advances i past the closing quote.
inline bool parse_json_string(const std::string& s, size_t& i,
                              std::string& out) {
  if (i >= s.size() || s[i] != '"') return false;
  ++i;
  out.clear();
  while (i < s.size()) {
    char c = s[i];
    if (c == '"') {
      ++i;
      return true;
    }
    if (c == '\\') {
      if (i + 1 >= s.size()) return false;
      char e = s[i + 1];
      i += 2;
      switch (e) {
        case '"': out.push_back('"'); break;
        case '\\': out.push_back('\\'); break;
        case '/': out.push_back('/'); break;
        case 'b': out.push_back('\b'); break;
        case 'f': out.push_back('\f'); break;
        case 'n': out.push_back('\n'); break;
        case 'r': out.push_back('\r'); break;
        case 't': out.push_back('\t'); break;
        case 'u': {
          if (i + 4 > s.size()) return false;
          uint32_t cp = uint32_t(strtoul(s.substr(i, 4).c_str(), nullptr, 16));
          i += 4;
          if (cp >= 0xD800 && cp <= 0xDBFF && i + 6 <= s.size() &&
              s[i] == '\\' && s[i + 1] == 'u') {
            uint32_t lo =
                uint32_t(strtoul(s.substr(i + 2, 4).c_str(), nullptr, 16));
            if (lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              i += 6;
            }
          }
          utf8_append(out, cp);
          break;
        }
        default: return false;
      }
    } else {
      out.push_back(c);
      ++i;
    }
  }
  return false;  // unterminated
}

// Flat-object parse: fills kv with every top-level key.  Nested containers
// are not needed by the protocol and are rejected.
inline bool parse_json_object(const std::string& s,
                              std::map<std::string, JsonValue>& kv) {
  size_t i = 0;
  auto skip_ws = [&]() {
    while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' ||
                            s[i] == '\r'))
      ++i;
  };
  skip_ws();
  if (i >= s.size() || s[i] != '{') return false;
  ++i;
  skip_ws();
  if (i < s.size() && s[i] == '}') return true;
  while (i < s.size()) {
    skip_ws();
    std::string key;
    if (!parse_json_string(s, i, key)) return false;
    skip_ws();
    if (i >= s.size() || s[i] != ':') return false;
    ++i;
    skip_ws();
    JsonValue v;
    if (i >= s.size()) return false;
    char c = s[i];
    if (c == '"') {
      if (!parse_json_string(s, i, v.str)) return false;
      v.is_string = true;
    } else if (c == 't' && s.compare(i, 4, "true") == 0) {
      v.is_number = true;
      v.num = 1.0;
      i += 4;
    } else if (c == 'f' && s.compare(i, 5, "false") == 0) {
      v.is_number = true;
      v.num = 0.0;
      i += 5;
    } else if (c == 'n' && s.compare(i, 4, "null") == 0) {
      i += 4;
    } else if (c == '-' || (c >= '0' && c <= '9')) {
      char* end = nullptr;
      v.num = strtod(s.c_str() + i, &end);
      if (end == s.c_str() + i) return false;
      v.is_number = true;
      i = size_t(end - s.c_str());
    } else if (c == '[') {
      /* flat number arrays only (the "speakers" field) */
      ++i;
      v.is_array = true;
      skip_ws();
      if (i < s.size() && s[i] == ']') {
        ++i;
      } else {
        for (;;) {
          skip_ws();
          char* end = nullptr;
          double x = strtod(s.c_str() + i, &end);
          if (end == s.c_str() + i) return false;
          v.nums.push_back(x);
          i = size_t(end - s.c_str());
          skip_ws();
          if (i >= s.size()) return false;
          if (s[i] == ',') { ++i; continue; }
          if (s[i] == ']') { ++i; break; }
          return false;
        }
      }
    } else {
      return false;  // nested objects: not part of the protocol
    }
    kv[key] = std::move(v);
    skip_ws();
    if (i >= s.size()) return false;
    if (s[i] == ',') {
      ++i;
      continue;
    }
    if (s[i] == '}') return true;
    return false;
  }
  return false;
}

// ---------------------------------------------------------------------------
// RFC 6455 framing.
// ---------------------------------------------------------------------------

enum Opcode : uint8_t {
  OP_CONT = 0x0,
  OP_TEXT = 0x1,
  OP_BINARY = 0x2,
  OP_CLOSE = 0x8,
  OP_PING = 0x9,
  OP_PONG = 0xA,
};

// Builds one masked client→server frame (clients MUST mask, RFC 6455 §5.3).
inline std::vector<uint8_t> encode_frame(uint8_t opcode, const uint8_t* data,
                                         size_t n, uint32_t mask_key) {
  std::vector<uint8_t> f;
  f.reserve(n + 14);
  f.push_back(uint8_t(0x80 | opcode));  // FIN | opcode
  if (n < 126) {
    f.push_back(uint8_t(0x80 | n));
  } else if (n < 65536) {
    f.push_back(0x80 | 126);
    f.push_back(uint8_t(n >> 8));
    f.push_back(uint8_t(n));
  } else {
    f.push_back(0x80 | 127);
    for (int i = 7; i >= 0; --i) f.push_back(uint8_t(uint64_t(n) >> (8 * i)));
  }
  uint8_t mk[4] = {uint8_t(mask_key >> 24), uint8_t(mask_key >> 16),
                   uint8_t(mask_key >> 8), uint8_t(mask_key)};
  f.insert(f.end(), mk, mk + 4);
  size_t base = f.size();
  f.resize(base + n);
  for (size_t i = 0; i < n; ++i) f[base + i] = data[i] ^ mk[i & 3];
  return f;
}

// Incremental frame decoder over a byte buffer.  Returns true when a full
// frame was consumed from buf (erasing it), filling opcode/payload/fin.
inline bool decode_frame(std::vector<uint8_t>& buf, uint8_t& opcode,
                         std::vector<uint8_t>& payload, bool& fin,
                         bool& malformed) {
  malformed = false;
  if (buf.size() < 2) return false;
  fin = (buf[0] & 0x80) != 0;
  opcode = buf[0] & 0x0F;
  bool masked = (buf[1] & 0x80) != 0;
  uint64_t len = buf[1] & 0x7F;
  size_t pos = 2;
  if (len == 126) {
    if (buf.size() < 4) return false;
    len = (uint64_t(buf[2]) << 8) | buf[3];
    pos = 4;
  } else if (len == 127) {
    if (buf.size() < 10) return false;
    len = 0;
    for (int i = 0; i < 8; ++i) len = (len << 8) | buf[2 + i];
    pos = 10;
  }
  if (len > (1ull << 31)) {  // refuse absurd frames
    malformed = true;
    return false;
  }
  uint8_t mk[4] = {0, 0, 0, 0};
  if (masked) {
    if (buf.size() < pos + 4) return false;
    memcpy(mk, buf.data() + pos, 4);
    pos += 4;
  }
  if (buf.size() < pos + len) return false;
  payload.assign(buf.begin() + pos, buf.begin() + pos + len);
  if (masked)
    for (size_t i = 0; i < payload.size(); ++i) payload[i] ^= mk[i & 3];
  buf.erase(buf.begin(), buf.begin() + pos + len);
  return true;
}

// ---------------------------------------------------------------------------
// Connection.
// ---------------------------------------------------------------------------

struct LineState {
  bool started = false;
  bool completed = false;
  std::string text;
  std::vector<int32_t> speakers;
};

struct Conn {
  int fd = -1;
  /* Regularized line-event translation (mt_client_set_line_events):
   * per-line state + a queue of expanded events awaiting delivery. */
  bool line_events = false;
  std::map<int32_t, LineState> lines;
  std::vector<mt_client_event_t> pending;  // FIFO, drained from front
  std::mutex line_mu;
  std::vector<uint8_t> rxbuf;
  std::vector<uint8_t> msg;  // continuation-frame accumulator
  uint8_t msg_opcode = 0;
  bool closed = false;
  std::mt19937 rng{std::random_device{}()};
  std::mutex send_mu;  // serializes writers
  std::mutex recv_mu;  // serializes pollers

  ~Conn() {
    if (fd >= 0) ::close(fd);
  }

  int send_all(const uint8_t* p, size_t n) {
    while (n > 0) {
      ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
      if (w <= 0) return MT_CLIENT_ERR_IO;
      p += w;
      n -= size_t(w);
    }
    return MT_CLIENT_OK;
  }

  int send_frame(uint8_t opcode, const uint8_t* data, size_t n) {
    std::lock_guard<std::mutex> lk(send_mu);
    if (closed || fd < 0) return MT_CLIENT_ERR_CLOSED;
    auto f = encode_frame(opcode, data, n, uint32_t(rng()));
    return send_all(f.data(), f.size());
  }

  // Waits for one complete application message (TEXT/BINARY), transparently
  // answering pings and close frames.  Returns 1/0/negative like poll_event.
  // TEXT-only by default (the stream protocol); RPC callers pass kind_out
  // to also receive BINARY payload frames.
  int recv_message(std::string& out, int timeout_ms,
                   uint8_t* kind_out = nullptr) {
    std::lock_guard<std::mutex> lk(recv_mu);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    for (;;) {
      uint8_t opcode;
      std::vector<uint8_t> payload;
      bool fin, malformed;
      while (decode_frame(rxbuf, opcode, payload, fin, malformed)) {
        if (opcode == OP_PING) {
          send_frame(OP_PONG, payload.data(), payload.size());
          continue;
        }
        if (opcode == OP_PONG) continue;
        if (opcode == OP_CLOSE) {
          send_frame(OP_CLOSE, payload.data(),
                     std::min<size_t>(payload.size(), 2));
          closed = true;
          return MT_CLIENT_ERR_CLOSED;
        }
        if (opcode == OP_CONT) {
          msg.insert(msg.end(), payload.begin(), payload.end());
        } else {
          msg.assign(payload.begin(), payload.end());
          msg_opcode = opcode;
        }
        if (fin) {
          out.assign(msg.begin(), msg.end());
          uint8_t kind = msg_opcode;
          msg.clear();
          if (kind == OP_TEXT || (kind_out != nullptr && kind == OP_BINARY)) {
            if (kind_out != nullptr) *kind_out = kind;
            return 1;
          }
          // Stream protocol: the server never sends binary; skip.
        }
      }
      if (malformed) {
        closed = true;
        return MT_CLIENT_ERR_PROTOCOL;
      }
      if (closed) return MT_CLIENT_ERR_CLOSED;
      auto now = std::chrono::steady_clock::now();
      int remain = int(std::chrono::duration_cast<std::chrono::milliseconds>(
                           deadline - now)
                           .count());
      if (remain < 0) return 0;
      struct pollfd pfd = {fd, POLLIN, 0};
      int pr = ::poll(&pfd, 1, remain);
      if (pr == 0) return 0;
      if (pr < 0) return MT_CLIENT_ERR_IO;
      uint8_t tmp[16384];
      ssize_t r = ::recv(fd, tmp, sizeof(tmp), 0);
      if (r == 0) {
        closed = true;
        return MT_CLIENT_ERR_CLOSED;
      }
      if (r < 0) return MT_CLIENT_ERR_IO;
      rxbuf.insert(rxbuf.end(), tmp, tmp + r);
    }
  }
};

// Performs TCP connect + HTTP Upgrade.  Returns the connected Conn or null.
inline std::unique_ptr<Conn> ws_connect(const char* host, int port) {
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  struct addrinfo hints = {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || res == nullptr)
    return nullptr;
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));

  auto conn = std::make_unique<Conn>();
  conn->fd = fd;

  uint8_t key_bytes[16];
  for (int i = 0; i < 16; ++i) key_bytes[i] = uint8_t(conn->rng());
  std::string key = base64(key_bytes, 16);

  char req[512];
  snprintf(req, sizeof(req),
           "GET / HTTP/1.1\r\n"
           "Host: %s:%d\r\n"
           "Upgrade: websocket\r\n"
           "Connection: Upgrade\r\n"
           "Sec-WebSocket-Key: %s\r\n"
           "Sec-WebSocket-Version: 13\r\n\r\n",
           host, port, key.c_str());
  if (conn->send_all(reinterpret_cast<const uint8_t*>(req), strlen(req)) != 0)
    return nullptr;

  // Read headers until CRLFCRLF; anything after it is frame data.
  std::string hdr;
  uint8_t tmp[4096];
  for (;;) {
    struct pollfd pfd = {fd, POLLIN, 0};
    if (::poll(&pfd, 1, 10000) <= 0) return nullptr;
    ssize_t r = ::recv(fd, tmp, sizeof(tmp), 0);
    if (r <= 0) return nullptr;
    hdr.append(reinterpret_cast<char*>(tmp), size_t(r));
    size_t end = hdr.find("\r\n\r\n");
    if (end != std::string::npos) {
      conn->rxbuf.assign(hdr.begin() + end + 4, hdr.end());
      hdr.resize(end + 4);
      break;
    }
    if (hdr.size() > 65536) return nullptr;
  }
  if (hdr.compare(0, 12, "HTTP/1.1 101") != 0) return nullptr;

  // Verify Sec-WebSocket-Accept = b64(sha1(key + GUID)).
  Sha1 sha;
  std::string magic = key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11";
  sha.update(magic.data(), magic.size());
  uint8_t digest[20];
  sha.finish(digest);
  std::string expect = base64(digest, 20);
  // Case-insensitive header scan.
  std::string lower;
  lower.reserve(hdr.size());
  for (char c : hdr) lower.push_back(char(tolower(uint8_t(c))));
  size_t at = lower.find("sec-websocket-accept:");
  if (at == std::string::npos) return nullptr;
  size_t vs = at + strlen("sec-websocket-accept:");
  while (vs < hdr.size() && hdr[vs] == ' ') ++vs;
  size_t ve = hdr.find("\r\n", vs);
  if (ve == std::string::npos || hdr.substr(vs, ve - vs) != expect)
    return nullptr;
  return conn;
}

// ---------------------------------------------------------------------------
// Handle table (reference pattern: moonshine-c-api.cpp:176-190).
// ---------------------------------------------------------------------------

struct HandleTable {
  std::mutex mu;
  std::map<int32_t, std::shared_ptr<Conn>> conns;
  int32_t next = 1;

  int32_t put(std::unique_ptr<Conn> c) {
    std::lock_guard<std::mutex> lk(mu);
    int32_t h = next++;
    conns[h] = std::move(c);
    return h;
  }
  std::shared_ptr<Conn> get(int32_t h) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = conns.find(h);
    return it == conns.end() ? nullptr : it->second;
  }
  bool erase(int32_t h) {
    std::lock_guard<std::mutex> lk(mu);
    return conns.erase(h) > 0;
  }
};

inline HandleTable& handles() {
  static HandleTable t;
  return t;
}

// Copies text into the fixed event buffer, truncating at a UTF-8 boundary.
inline void copy_text(char* dst, size_t cap, const std::string& s) {
  size_t n = std::min(s.size(), cap - 1);
  // Do not end mid-codepoint: back up over continuation bytes.
  while (n > 0 && (uint8_t(s[n]) & 0xC0) == 0x80 && n < s.size()) --n;
  memcpy(dst, s.data(), n);
  dst[n] = '\0';
}

}  // namespace mtclient

// ---------------------------------------------------------------------------
// C ABI.
// ---------------------------------------------------------------------------

using namespace mtclient;

extern "C" {

const char* mt_client_version(void) { return "0.2.0"; }

int32_t mt_client_connect(const char* host, int32_t port) {
  auto conn = ws_connect(host, int(port));
  if (!conn) return MT_CLIENT_ERR_CONNECT;
  return handles().put(std::move(conn));
}

int32_t mt_client_start(int32_t handle, int32_t sample_rate) {
  auto c = handles().get(handle);
  if (!c) return MT_CLIENT_ERR_HANDLE;
  char msg[96];
  snprintf(msg, sizeof(msg), "{\"type\": \"start\", \"sample_rate\": %d}",
           int(sample_rate));
  return c->send_frame(OP_TEXT, reinterpret_cast<uint8_t*>(msg), strlen(msg));
}

int32_t mt_client_add_audio(int32_t handle, const float* pcm, int32_t n) {
  auto c = handles().get(handle);
  if (!c) return MT_CLIENT_ERR_HANDLE;
  if (n < 0) return MT_CLIENT_ERR_PROTOCOL;
  return c->send_frame(OP_BINARY, reinterpret_cast<const uint8_t*>(pcm),
                       size_t(n) * 4);
}

int32_t mt_client_stop(int32_t handle) {
  auto c = handles().get(handle);
  if (!c) return MT_CLIENT_ERR_HANDLE;
  const char* msg = "{\"type\": \"stop\"}";
  return c->send_frame(OP_TEXT, reinterpret_cast<const uint8_t*>(msg),
                       strlen(msg));
}

static int parse_raw_event(const std::string& raw, mt_client_event_t* out) {
  using namespace mtclient;
  std::map<std::string, JsonValue> kv;
  if (!parse_json_object(raw, kv)) return MT_CLIENT_ERR_PROTOCOL;
  memset(out, 0, sizeof(*out));
  out->segment = -1;
  out->line_id = -1;
  const std::string& type = kv["type"].str;
  if (type == "partial")
    out->type = MT_EVENT_PARTIAL;
  else if (type == "final")
    out->type = MT_EVENT_FINAL;
  else if (type == "stopped")
    out->type = MT_EVENT_STOPPED;
  else if (type == "error")
    out->type = MT_EVENT_ERROR;
  else
    return MT_CLIENT_ERR_PROTOCOL;
  if (kv.count("text")) copy_text(out->text, sizeof(out->text), kv["text"].str);
  if (kv.count("error")) copy_text(out->text, sizeof(out->text), kv["error"].str);
  if (kv.count("segment")) out->segment = int32_t(kv["segment"].num);
  if (kv.count("start")) out->start_s = kv["start"].num;
  if (kv.count("end")) out->end_s = kv["end"].num;
  if (kv.count("latency_ms")) out->latency_ms = kv["latency_ms"].num;
  out->line_id = out->segment;
  if (kv.count("speakers") && kv["speakers"].is_array) {
    const auto& nums = kv["speakers"].nums;
    out->n_speakers = int32_t(
        nums.size() > MT_CLIENT_MAX_SPEAKERS ? MT_CLIENT_MAX_SPEAKERS
                                             : nums.size());
    for (int32_t i = 0; i < out->n_speakers; ++i)
      out->speakers[i] = int32_t(nums[size_t(i)]);
  }
  return 1;
}

namespace mtclient {

/* Expand one raw server event into the regularized line-event sequence
 * (reference: moonshine-c-api.h:165-196 delivery guarantees).  Appends
 * to c->pending; caller holds line_mu. */
static void expand_line_events(Conn* c, const mt_client_event_t& raw) {
  auto emit = [&](int32_t type, const mt_client_event_t& base,
                  const LineState* st) {
    mt_client_event_t ev = base;
    ev.type = type;
    if (st != nullptr) {
      copy_text(ev.text, sizeof(ev.text), st->text);
      ev.n_speakers = int32_t(st->speakers.size());
      for (size_t i = 0; i < st->speakers.size() &&
                         i < MT_CLIENT_MAX_SPEAKERS; ++i)
        ev.speakers[i] = st->speakers[i];
    }
    c->pending.push_back(ev);
  };

  auto complete_line = [&](int32_t id) {
    LineState& st = c->lines[id];
    if (st.completed) return;
    mt_client_event_t base;
    memset(&base, 0, sizeof(base));
    base.segment = id;
    base.line_id = id;
    if (!st.started) {
      st.started = true;
      emit(MT_EVENT_LINE_STARTED, base, &st);
    }
    st.completed = true;
    emit(MT_EVENT_LINE_COMPLETED, base, &st);
  };

  if (raw.type == MT_EVENT_STOPPED) {
    /* Drain guarantee: no line stays incomplete past the stream end. */
    for (auto& [id, st] : c->lines)
      if (st.started && !st.completed) complete_line(id);
    c->pending.push_back(raw);
    return;
  }
  if (raw.type == MT_EVENT_ERROR) {
    c->pending.push_back(raw);
    return;
  }

  const int32_t id = raw.segment;
  LineState& st = c->lines[id];
  if (st.completed) return;  /* frozen-completed-lines: drop stragglers */

  /* Only-last-line-incomplete: starting/updating line N completes every
   * earlier incomplete line first. */
  for (auto& [oid, ost] : c->lines)
    if (oid < id && ost.started && !ost.completed) complete_line(oid);

  std::vector<int32_t> new_speakers(raw.speakers,
                                    raw.speakers + raw.n_speakers);
  const bool text_changed = std::string(raw.text) != st.text;
  const bool speakers_changed =
      raw.n_speakers > 0 && new_speakers != st.speakers;
  st.text = raw.text;
  if (raw.n_speakers > 0) st.speakers = new_speakers;

  if (!st.started) {
    st.started = true;
    emit(MT_EVENT_LINE_STARTED, raw, nullptr);
  }
  emit(MT_EVENT_LINE_UPDATED, raw, nullptr);
  if (text_changed) emit(MT_EVENT_LINE_TEXT_CHANGED, raw, nullptr);
  if (speakers_changed) emit(MT_EVENT_LINE_SPEAKERS_CHANGED, raw, nullptr);
  if (raw.type == MT_EVENT_FINAL) {
    st.completed = true;
    emit(MT_EVENT_LINE_COMPLETED, raw, nullptr);
  }
}

}  // namespace mtclient

int32_t mt_client_set_line_events(int32_t handle, int32_t enabled) {
  auto c = handles().get(handle);
  if (!c) return MT_CLIENT_ERR_HANDLE;
  std::lock_guard<std::mutex> lk(c->line_mu);
  c->line_events = enabled != 0;
  if (!c->line_events) {
    c->lines.clear();
    c->pending.clear();
  }
  return MT_CLIENT_OK;
}

int32_t mt_client_poll_event(int32_t handle, mt_client_event_t* out,
                             int32_t timeout_ms) {
  auto c = handles().get(handle);
  if (!c) return MT_CLIENT_ERR_HANDLE;
  if (!out) return MT_CLIENT_ERR_PROTOCOL;
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(timeout_ms);
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(c->line_mu);
      if (c->line_events && !c->pending.empty()) {
        *out = c->pending.front();
        c->pending.erase(c->pending.begin());
        return 1;
      }
    }
    const auto now = std::chrono::steady_clock::now();
    int remain = int(std::chrono::duration_cast<std::chrono::milliseconds>(
                         deadline - now)
                         .count());
    if (remain < 0) remain = 0;
    std::string raw;
    int rc = c->recv_message(raw, remain);
    if (rc <= 0) return rc;
    mt_client_event_t ev;
    rc = parse_raw_event(raw, &ev);
    if (rc <= 0) return rc;
    std::lock_guard<std::mutex> lk(c->line_mu);
    if (!c->line_events) {
      *out = ev;
      return 1;
    }
    mtclient::expand_line_events(c.get(), ev);
    /* loop: deliver from pending (a frozen-line drop yields nothing —
     * keep polling until the deadline) */
    if (remain == 0 && c->pending.empty()) return 0;
  }
}

int32_t mt_client_free(int32_t handle) {
  return handles().erase(handle) ? MT_CLIENT_OK : MT_CLIENT_ERR_HANDLE;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-shot RPC surface.
// ---------------------------------------------------------------------------

namespace mtclient {

inline std::string json_escape(const char* s) {
  std::string out;
  for (const char* p = s; p && *p; ++p) {
    unsigned char c = (unsigned char)*p;
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out.push_back(char(c));
        }
    }
  }
  return out;
}

// Connect, send one TEXT request, read the TEXT header reply (and report
// protocol errors from the server's error messages).
inline int rpc_send(std::unique_ptr<Conn>& conn, const char* host, int port,
                    const std::string& request) {
  conn = ws_connect(host, port);
  if (!conn) return MT_CLIENT_ERR_CONNECT;
  return conn->send_frame(OP_TEXT,
                          reinterpret_cast<const uint8_t*>(request.data()),
                          request.size());
}

constexpr int kRpcTimeoutMs = 120000;  // first call may compile on-device

inline int rpc_recv_header(Conn& c, std::map<std::string, JsonValue>& kv) {
  std::string raw;
  int rc = c.recv_message(raw, kRpcTimeoutMs);
  if (rc == 0) return MT_CLIENT_ERR_IO;
  if (rc < 0) return rc;
  if (!parse_json_object(raw, kv)) return MT_CLIENT_ERR_PROTOCOL;
  if (kv.count("type") && kv["type"].str == "error") return MT_CLIENT_ERR_PROTOCOL;
  return MT_CLIENT_OK;
}

inline int rpc_recv_binary(Conn& c, std::string& payload) {
  uint8_t kind = 0;
  int rc = c.recv_message(payload, kRpcTimeoutMs, &kind);
  if (rc == 0) return MT_CLIENT_ERR_IO;
  if (rc < 0) return rc;
  if (kind != OP_BINARY) return MT_CLIENT_ERR_PROTOCOL;
  return MT_CLIENT_OK;
}

}  // namespace mtclient

extern "C" {

int32_t mt_client_tts(const char* host, int32_t port, const char* text,
                      const char* ipa, const char* voice, float* out_pcm,
                      int32_t cap, int32_t* sample_rate) {
  std::string req = "{\"type\": \"tts\"";
  if (ipa != nullptr)
    req += ", \"ipa\": \"" + json_escape(ipa) + "\"";
  else
    req += ", \"text\": \"" + json_escape(text ? text : "") + "\"";
  if (voice != nullptr) req += ", \"voice\": \"" + json_escape(voice) + "\"";
  req += "}";
  std::unique_ptr<Conn> conn;
  int rc = rpc_send(conn, host, int(port), req);
  if (rc != MT_CLIENT_OK) return rc;
  std::map<std::string, JsonValue> kv;
  rc = rpc_recv_header(*conn, kv);
  if (rc != MT_CLIENT_OK) return rc;
  if (!kv.count("n")) return MT_CLIENT_ERR_PROTOCOL;
  std::string payload;
  rc = rpc_recv_binary(*conn, payload);
  if (rc != MT_CLIENT_OK) return rc;
  int32_t n = int32_t(kv["n"].num);
  if (size_t(n) * 4 != payload.size()) return MT_CLIENT_ERR_PROTOCOL;
  if (sample_rate != nullptr && kv.count("sample_rate"))
    *sample_rate = int32_t(kv["sample_rate"].num);
  int32_t copy = n < cap ? n : cap;
  if (out_pcm != nullptr && copy > 0)
    memcpy(out_pcm, payload.data(), size_t(copy) * 4);
  return n;
}

int32_t mt_client_g2p(const char* host, int32_t port, const char* text,
                      const char* language, char* out_ipa, int32_t cap) {
  std::string req = "{\"type\": \"g2p\", \"text\": \"" +
                    json_escape(text ? text : "") + "\"";
  if (language != nullptr)
    req += ", \"language\": \"" + json_escape(language) + "\"";
  req += "}";
  std::unique_ptr<Conn> conn;
  int rc = rpc_send(conn, host, int(port), req);
  if (rc != MT_CLIENT_OK) return rc;
  std::map<std::string, JsonValue> kv;
  rc = rpc_recv_header(*conn, kv);
  if (rc != MT_CLIENT_OK) return rc;
  if (!kv.count("ipa")) return MT_CLIENT_ERR_PROTOCOL;
  if (out_ipa != nullptr && cap > 0)
    copy_text(out_ipa, size_t(cap), kv["ipa"].str);
  return int32_t(kv["ipa"].str.size());
}

int32_t mt_client_embed(const char* host, int32_t port,
                        const char* const* texts, int32_t n_texts, float* out,
                        int32_t cap, int32_t* dim) {
  std::string req = "{\"type\": \"embed\", \"texts\": [";
  for (int32_t i = 0; i < n_texts; ++i) {
    if (i) req += ", ";
    req += "\"" + json_escape(texts[i]) + "\"";
  }
  req += "]}";
  std::unique_ptr<Conn> conn;
  int rc = rpc_send(conn, host, int(port), req);
  if (rc != MT_CLIENT_OK) return rc;
  std::map<std::string, JsonValue> kv;
  rc = rpc_recv_header(*conn, kv);
  if (rc != MT_CLIENT_OK) return rc;
  if (!kv.count("n") || !kv.count("dim")) return MT_CLIENT_ERR_PROTOCOL;
  std::string payload;
  rc = rpc_recv_binary(*conn, payload);
  if (rc != MT_CLIENT_OK) return rc;
  int32_t total = int32_t(kv["n"].num) * int32_t(kv["dim"].num);
  if (size_t(total) * 4 != payload.size()) return MT_CLIENT_ERR_PROTOCOL;
  if (dim != nullptr) *dim = int32_t(kv["dim"].num);
  int32_t copy = total < cap ? total : cap;
  if (out != nullptr && copy > 0) memcpy(out, payload.data(), size_t(copy) * 4);
  return total;
}

int32_t mt_client_speech_clip(const char* host, int32_t port, const float* pcm,
                              int32_t n, int32_t sample_rate,
                              mt_clip_result_t* out) {
  if (out == nullptr || n < 0) return MT_CLIENT_ERR_PROTOCOL;
  char head[96];
  snprintf(head, sizeof(head),
           "{\"type\": \"speech_clip\", \"sample_rate\": %d}",
           int(sample_rate));
  std::unique_ptr<Conn> conn;
  int rc = rpc_send(conn, host, int(port), head);
  if (rc != MT_CLIENT_OK) return rc;
  // Stream the audio in bounded frames, then the end marker.
  const size_t kChunk = 65536;
  for (size_t off = 0; off < size_t(n); off += kChunk) {
    size_t take = std::min(kChunk, size_t(n) - off);
    rc = conn->send_frame(OP_BINARY,
                          reinterpret_cast<const uint8_t*>(pcm + off),
                          take * 4);
    if (rc != MT_CLIENT_OK) return rc;
  }
  const char* endmsg = "{\"type\": \"end\"}";
  rc = conn->send_frame(OP_TEXT, reinterpret_cast<const uint8_t*>(endmsg),
                        strlen(endmsg));
  if (rc != MT_CLIENT_OK) return rc;
  std::map<std::string, JsonValue> kv;
  rc = rpc_recv_header(*conn, kv);
  if (rc != MT_CLIENT_OK) return rc;
  memset(out, 0, sizeof(*out));
  if (kv.count("found")) out->found = int32_t(kv["found"].num);
  if (kv.count("start_s")) out->start_s = kv["start_s"].num;
  if (kv.count("end_s")) out->end_s = kv["end_s"].num;
  if (kv.count("speech_s")) out->speech_s = kv["speech_s"].num;
  return MT_CLIENT_OK;
}

int32_t mt_client_catalog_json(const char* host, int32_t port,
                               const char* kind, const char* arg,
                               const char* options_json, char* out_json,
                               int32_t cap) {
  /* Reference analog: the moonshine_get_* catalog/dependency family
   * (moonshine-c-api.h:910-1074), carried over the service boundary.
   * The JSON document rides a binary frame so this client never parses
   * nested escapes; header carries the byte count. */
  if (kind == nullptr) return MT_CLIENT_ERR_PROTOCOL;
  std::string req =
      "{\"type\": \"catalog\", \"kind\": \"" + json_escape(kind) + "\"";
  if (arg != nullptr)
    req += ", \"arg\": \"" + json_escape(arg) + "\"";
  if (options_json != nullptr && options_json[0] != '\0')
    req += std::string(", \"options\": ") + options_json;
  req += "}";
  std::unique_ptr<Conn> conn;
  int rc = rpc_send(conn, host, int(port), req);
  if (rc != MT_CLIENT_OK) return rc;
  std::map<std::string, JsonValue> kv;
  rc = rpc_recv_header(*conn, kv);
  if (rc != MT_CLIENT_OK) return rc;
  if (!kv.count("n")) return MT_CLIENT_ERR_PROTOCOL;
  std::string payload;
  rc = rpc_recv_binary(*conn, payload);
  if (rc != MT_CLIENT_OK) return rc;
  if (payload.size() != size_t(kv["n"].num)) return MT_CLIENT_ERR_PROTOCOL;
  if (out_json != nullptr && cap > 0) copy_text(out_json, size_t(cap), payload);
  return int32_t(payload.size());
}

}  // extern "C"
