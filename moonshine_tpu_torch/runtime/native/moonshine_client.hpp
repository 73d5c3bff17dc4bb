/* moonshine_client.hpp — header-only C++ wrapper over the C client ABI.
 *
 * The analog of the reference's moonshine-cpp.h (reference:
 * core/moonshine-cpp.h:56-430 — RAII classes + typed events over the C
 * ABI): typed Event, RAII Stream, exceptions on failure, and a small
 * blocking transcribe helper.  Link against libmoonshine_client.
 */
#ifndef MOONSHINE_CLIENT_HPP
#define MOONSHINE_CLIENT_HPP

#include <functional>
#include <stdexcept>
#include <string>
#include <vector>

#include "moonshine_client.h"

namespace moonshine {

struct Event {
  enum class Type {
    Partial, Final, Stopped, Error,
    /* regularized line lifecycle (Stream::set_line_events; reference:
     * moonshine-c-api.h:165-196) */
    LineStarted, LineUpdated, LineTextChanged, LineSpeakersChanged,
    LineCompleted,
  };
  Type type;
  std::string text;
  int segment;
  double start_s;
  double end_s;
  double latency_ms;
  int line_id = -1;
  std::vector<int> speakers;
};

class ClientError : public std::runtime_error {
 public:
  ClientError(const std::string& what, int code)
      : std::runtime_error(what + " (code " + std::to_string(code) + ")"),
        code_(code) {}
  int code() const { return code_; }

 private:
  int code_;
};

/* One live stream to a transcription server.  Movable, not copyable;
 * closes the connection on destruction. */
class Stream {
 public:
  Stream(const std::string& host, int port, int sample_rate = 16000) {
    handle_ = mt_client_connect(host.c_str(), port);
    if (handle_ < 0) throw ClientError("connect failed", handle_);
    int rc = mt_client_start(handle_, sample_rate);
    if (rc < 0) throw ClientError("start failed", rc);
  }
  ~Stream() {
    if (handle_ >= 0) mt_client_free(handle_);
  }
  Stream(const Stream&) = delete;
  Stream& operator=(const Stream&) = delete;
  Stream(Stream&& o) noexcept : handle_(o.handle_) { o.handle_ = -1; }
  Stream& operator=(Stream&& o) noexcept {
    if (this != &o) {
      if (handle_ >= 0) mt_client_free(handle_);
      handle_ = o.handle_;
      o.handle_ = -1;
    }
    return *this;
  }

  void add_audio(const float* pcm, size_t n) {
    int rc = mt_client_add_audio(handle_, pcm, int32_t(n));
    if (rc < 0) throw ClientError("add_audio failed", rc);
  }
  void add_audio(const std::vector<float>& pcm) {
    add_audio(pcm.data(), pcm.size());
  }

  void stop() {
    int rc = mt_client_stop(handle_);
    if (rc < 0) throw ClientError("stop failed", rc);
  }

  /* Switch poll() to the regularized LineStarted/LineUpdated/
   * LineTextChanged/LineSpeakersChanged/LineCompleted stream. */
  void set_line_events(bool enabled = true) {
    int rc = mt_client_set_line_events(handle_, enabled ? 1 : 0);
    if (rc < 0) throw ClientError("set_line_events failed", rc);
  }

  /* Waits up to timeout_ms; returns false on timeout, throws on closed/
   * protocol errors, fills ev otherwise. */
  bool poll(Event& ev, int timeout_ms) {
    mt_client_event_t raw;
    int rc = mt_client_poll_event(handle_, &raw, timeout_ms);
    if (rc == 0) return false;
    if (rc < 0) throw ClientError("poll failed", rc);
    switch (raw.type) {
      case MT_EVENT_PARTIAL: ev.type = Event::Type::Partial; break;
      case MT_EVENT_FINAL: ev.type = Event::Type::Final; break;
      case MT_EVENT_STOPPED: ev.type = Event::Type::Stopped; break;
      case MT_EVENT_LINE_STARTED: ev.type = Event::Type::LineStarted; break;
      case MT_EVENT_LINE_UPDATED: ev.type = Event::Type::LineUpdated; break;
      case MT_EVENT_LINE_TEXT_CHANGED:
        ev.type = Event::Type::LineTextChanged; break;
      case MT_EVENT_LINE_SPEAKERS_CHANGED:
        ev.type = Event::Type::LineSpeakersChanged; break;
      case MT_EVENT_LINE_COMPLETED: ev.type = Event::Type::LineCompleted; break;
      default: ev.type = Event::Type::Error; break;
    }
    ev.text = raw.text;
    ev.segment = raw.segment;
    ev.start_s = raw.start_s;
    ev.end_s = raw.end_s;
    ev.latency_ms = raw.latency_ms;
    ev.line_id = raw.line_id;
    ev.speakers.assign(raw.speakers, raw.speakers + raw.n_speakers);
    return true;
  }

  /* Streams the whole buffer, stops, and collects final-line texts until
   * the server acknowledges the stop (or overall_timeout_ms elapses). */
  std::vector<std::string> transcribe(const std::vector<float>& pcm,
                                      int chunk = 6400,
                                      int overall_timeout_ms = 120000,
                                      const std::function<void(const Event&)>&
                                          on_event = nullptr) {
    for (size_t i = 0; i < pcm.size(); i += size_t(chunk))
      add_audio(pcm.data() + i, std::min(size_t(chunk), pcm.size() - i));
    stop();
    std::vector<std::string> finals;
    int waited = 0;
    const int step = 250;
    Event ev;
    while (waited < overall_timeout_ms) {
      if (!poll(ev, step)) {
        waited += step;
        continue;
      }
      if (on_event) on_event(ev);
      if (ev.type == Event::Type::Final) finals.push_back(ev.text);
      if (ev.type == Event::Type::Stopped) break;
      if (ev.type == Event::Type::Error)
        throw ClientError("server error: " + ev.text, MT_CLIENT_ERR_PROTOCOL);
    }
    return finals;
  }

  int32_t handle() const { return handle_; }

 private:
  int32_t handle_ = -1;
};

}  // namespace moonshine

#endif  // MOONSHINE_CLIENT_HPP
