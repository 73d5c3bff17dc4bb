/* WASM/Embind shim over the native transcription client.
 *
 * Proof of the "device bindings are thin shims over moonshine_client.h"
 * claim for the browser target (the reference ships an Embind bridge
 * over its C ABI, reference: language-bindings/wasm/moonshine-embind.cpp;
 * here the ABI is the service-boundary client — in a browser the
 * WebSocket transport maps 1:1 onto the same wire protocol).  Compiles
 * against the real <emscripten/bind.h> when the SDK is present
 * (-DMOONSHINE_EMBIND_REAL_HEADER) or the declared-subset
 * embind_compat.h otherwise; either way it links only
 * moonshine_client.h symbols — no engine code.
 *
 * JS surface (mirrors the Java MoonshineClient API):
 *   new Module.MoonshineStream(host, port)   // connect
 *     .start(sampleRate) .addAudio(float32Array) .stop()
 *     .pollEventText(timeoutMs) -> "type|segment|start|end|latency|text"
 *     .close()
 *   Module.tts(host, port, text)  -> Float32Array-backed vector
 *   Module.g2p(host, port, text, language) -> IPA string
 *   Module.catalogJson(host, port, kind, arg) -> JSON document
 */
#include "embind_compat.h"

#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "../../native/moonshine_client.h"

using emscripten::val;

namespace {

class MoonshineStream {
 public:
  MoonshineStream(const std::string& host, int port)
      : handle_(mt_client_connect(host.c_str(), port)) {
    if (handle_ < 0) {
      throw std::runtime_error("moonshine:connect:" +
                               std::to_string(handle_));
    }
  }
  ~MoonshineStream() { close(); }

  int start(int sample_rate) { return mt_client_start(handle_, sample_rate); }

  int addAudio(const val& pcm) {
    std::vector<float> v = emscripten::convertJSArrayToNumberVector<float>(pcm);
    return mt_client_add_audio(handle_, v.data(),
                               static_cast<int32_t>(v.size()));
  }

  int stop() { return mt_client_stop(handle_); }

  /* Regularized line lifecycle (mt_client_set_line_events): pollEventText
   * then yields types 4..8 (started/updated/text-changed/speakers-changed/
   * completed; reference: moonshine-c-api.h:165-196). */
  int setLineEvents(int enabled) {
    return mt_client_set_line_events(handle_, enabled);
  }

  /* "type|segment|start|end|latency|text", or "" on timeout. */
  std::string pollEventText(int timeout_ms) {
    mt_client_event_t ev;
    int rc = mt_client_poll_event(handle_, &ev, timeout_ms);
    if (rc <= 0) {
      return "";
    }
    char head[128];
    snprintf(head, sizeof(head), "%d|%d|%.3f|%.3f|%.1f|", ev.type, ev.segment,
             ev.start_s, ev.end_s, ev.latency_ms);
    return std::string(head) + ev.text;
  }

  int close() {
    if (handle_ >= 0) {
      int rc = mt_client_free(handle_);
      handle_ = -1;
      return rc;
    }
    return MT_CLIENT_OK;
  }

 private:
  int32_t handle_;
};

std::vector<float> wasm_tts(const std::string& host, int port,
                            const std::string& text) {
  std::vector<float> pcm(16000 * 30);
  int32_t sr = 0;
  int32_t n = mt_client_tts(host.c_str(), port, text.c_str(), nullptr,
                            nullptr, pcm.data(),
                            static_cast<int32_t>(pcm.size()), &sr);
  if (n < 0) {
    throw std::runtime_error("moonshine:tts:" + std::to_string(n));
  }
  pcm.resize(static_cast<size_t>(n) < pcm.size() ? static_cast<size_t>(n)
                                                 : pcm.size());
  return pcm;
}

std::string wasm_g2p(const std::string& host, int port,
                     const std::string& text, const std::string& language) {
  std::string out(1 << 16, '\0');
  int32_t n = mt_client_g2p(host.c_str(), port, text.c_str(),
                            language.empty() ? nullptr : language.c_str(),
                            out.data(), static_cast<int32_t>(out.size()));
  if (n < 0) {
    throw std::runtime_error("moonshine:g2p:" + std::to_string(n));
  }
  out.resize(strnlen(out.c_str(), out.size()));
  return out;
}

std::string wasm_catalog_json(const std::string& host, int port,
                              const std::string& kind,
                              const std::string& arg) {
  std::string out(1 << 20, '\0');
  int32_t n = mt_client_catalog_json(host.c_str(), port, kind.c_str(),
                                     arg.empty() ? nullptr : arg.c_str(),
                                     nullptr, out.data(),
                                     static_cast<int32_t>(out.size()));
  if (n < 0) {
    throw std::runtime_error("moonshine:catalog:" + std::to_string(n));
  }
  out.resize(strnlen(out.c_str(), out.size()));
  return out;
}

}  // namespace

EMSCRIPTEN_BINDINGS(moonshine_tpu) {
  emscripten::register_vector<float>("FloatVector");
  emscripten::class_<MoonshineStream>("MoonshineStream")
      .constructor<std::string, int>()
      .function("start", &MoonshineStream::start)
      .function("addAudio", &MoonshineStream::addAudio)
      .function("stop", &MoonshineStream::stop)
      .function("setLineEvents", &MoonshineStream::setLineEvents)
      .function("pollEventText", &MoonshineStream::pollEventText)
      .function("close", &MoonshineStream::close);
  emscripten::function("tts", &wasm_tts);
  emscripten::function("g2p", &wasm_g2p);
  emscripten::function("catalogJson", &wasm_catalog_json);
}
