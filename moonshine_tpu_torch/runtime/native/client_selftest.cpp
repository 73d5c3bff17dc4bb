/* Deterministic self-test for the native client's pure components —
 * SHA-1, base64, JSON reader, and RFC 6455 frame codec — plus a randomized
 * fuzz sweep over the frame decoder.  Built by scripts/reliability.sh
 * under ASan/UBSan and TSan alongside host_selftest (reference analog:
 * core/reliability/fuzz-*.cpp harnesses).
 *
 * Includes the implementation directly so internals are testable without
 * widening the C ABI.
 */
#include "moonshine_client.cpp"

#include <cassert>
#include <cstdio>
#include <random>

using namespace mtclient;

static int failures = 0;
#define CHECK(cond)                                                      \
  do {                                                                   \
    if (!(cond)) {                                                       \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);    \
      ++failures;                                                        \
    }                                                                    \
  } while (0)

static void test_sha1() {
  // FIPS 180-1 appendix vectors.
  CHECK(sha1_hex("abc") == "a9993e364706816aba3e25717850c26c9cd0d89d");
  CHECK(sha1_hex("") == "da39a3ee5e6b4b0d3255bfef95601890afd80709");
  CHECK(sha1_hex("abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq") ==
        "84983e441c3bd26ebaae4aa1f95129e5e54670f1");
  // RFC 6455 §1.3 handshake example.
  Sha1 sha;
  std::string magic = "dGhlIHNhbXBsZSBub25jZQ==258EAFA5-E914-47DA-95CA-C5AB0DC85B11";
  sha.update(magic.data(), magic.size());
  uint8_t d[20];
  sha.finish(d);
  CHECK(base64(d, 20) == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=");
}

static void test_base64() {
  const uint8_t a[] = {'f', 'o', 'o', 'b', 'a', 'r'};
  CHECK(base64(a, 6) == "Zm9vYmFy");
  CHECK(base64(a, 5) == "Zm9vYmE=");
  CHECK(base64(a, 4) == "Zm9vYg==");
  CHECK(base64(a, 0) == "");
}

static void test_json() {
  std::map<std::string, JsonValue> kv;
  CHECK(parse_json_object(
      "{\"type\": \"final\", \"text\": \"a b\", \"segment\": 3, "
      "\"start\": 0.5, \"end\": -1.25, \"latency_ms\": 74.3}", kv));
  CHECK(kv["type"].str == "final");
  CHECK(kv["text"].str == "a b");
  CHECK(kv["segment"].num == 3.0);
  CHECK(kv["start"].num == 0.5);
  CHECK(kv["end"].num == -1.25);

  kv.clear();  // escapes incl. surrogate pair (U+1F600) and BMP (U+00E9)
  CHECK(parse_json_object(
      "{\"text\": \"q\\\"\\\\\\n\\u00e9\\ud83d\\ude00\"}", kv));
  CHECK(kv["text"].str == std::string("q\"\\\n\xc3\xa9\xf0\x9f\x98\x80"));

  kv.clear();
  CHECK(parse_json_object("{}", kv) && kv.empty());
  kv.clear();
  CHECK(parse_json_object("{\"a\": true, \"b\": false, \"c\": null}", kv));
  CHECK(kv["a"].num == 1.0 && kv["b"].num == 0.0);
  CHECK(!kv["c"].is_number && !kv["c"].is_string);

  // Flat number arrays (the "speakers" field of line events).
  kv.clear();
  CHECK(parse_json_object("{\"speakers\": [1, 2, 7]}", kv));
  CHECK(kv["speakers"].is_array && kv["speakers"].nums.size() == 3);
  CHECK(kv["speakers"].nums[2] == 7.0);
  kv.clear();
  CHECK(parse_json_object("{\"speakers\": []}", kv));
  CHECK(kv["speakers"].is_array && kv["speakers"].nums.empty());

  // Malformed inputs must be rejected, never crash.
  const char* bad[] = {"", "{", "{\"a\"", "{\"a\":}", "{\"a\":\"x}", "[1]",
                       "{\"a\": {\"n\": 1}}", "{\"a\": [1,}", "{\"a\": [x]}",
                       "{\"a\": [\"s\"]}", "{\"a\":1,}"};
  for (const char* s : bad) {
    kv.clear();
    CHECK(!parse_json_object(s, kv));
  }
}

static void roundtrip(uint8_t opcode, const std::vector<uint8_t>& payload,
                      std::mt19937& rng) {
  auto frame = encode_frame(opcode, payload.data(), payload.size(),
                            uint32_t(rng()));
  // Feed byte-by-byte to exercise incremental decoding.
  std::vector<uint8_t> buf;
  uint8_t op;
  std::vector<uint8_t> out;
  bool fin, malformed;
  bool done = false;
  for (uint8_t b : frame) {
    buf.push_back(b);
    if (decode_frame(buf, op, out, fin, malformed)) {
      done = true;
      break;
    }
    CHECK(!malformed);
  }
  CHECK(done && fin && op == opcode && out == payload && buf.empty());
}

static void test_frames(int iters) {
  std::mt19937 rng(1234);
  // Length-class boundaries: 0, 125/126, 65535/65536.
  for (size_t n : {size_t(0), size_t(1), size_t(125), size_t(126),
                   size_t(127), size_t(65535), size_t(65536), size_t(70000)}) {
    std::vector<uint8_t> p(n);
    for (auto& b : p) b = uint8_t(rng());
    roundtrip(OP_BINARY, p, rng);
  }
  roundtrip(OP_TEXT, {'h', 'i'}, rng);

  // Fuzz: random bytes through the decoder must never read OOB or loop.
  for (int i = 0; i < iters; ++i) {
    size_t n = rng() % 64;
    std::vector<uint8_t> buf(n);
    for (auto& b : buf) b = uint8_t(rng());
    uint8_t op;
    std::vector<uint8_t> out;
    bool fin, malformed;
    for (int guard = 0; guard < 64; ++guard)
      if (!decode_frame(buf, op, out, fin, malformed)) break;
  }
}

static void test_copy_text() {
  char buf[8];
  copy_text(buf, sizeof(buf), "hello");
  CHECK(std::string(buf) == "hello");
  // 2-byte codepoints: truncation must not split one.
  copy_text(buf, sizeof(buf), "\xc3\xa9\xc3\xa9\xc3\xa9\xc3\xa9");  // 4 é
  CHECK(std::string(buf) == "\xc3\xa9\xc3\xa9\xc3\xa9");            // 3 fit
  copy_text(buf, 2, "\xc3\xa9");
  CHECK(std::string(buf).empty());
}

int main(int argc, char** argv) {
  int iters = argc > 1 ? atoi(argv[1]) : 2000;
  test_sha1();
  test_base64();
  test_json();
  test_frames(iters);
  test_copy_text();
  if (failures) {
    fprintf(stderr, "client_selftest: %d failures\n", failures);
    return 1;
  }
  printf("client_selftest OK (%d fuzz iters)\n", iters);
  return 0;
}
