/* moonshine_tpu native host runtime — implementation.
 * See moonshine_host.h for the contract. C++17, no dependencies. */

#include "moonshine_host.h"

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstring>
#include <numeric>
#include <vector>

/* ---- resampler -------------------------------------------------------- */

extern "C" size_t mt_resample_output_size(size_t input_size, float in_rate,
                                          float out_rate) {
  if (in_rate == out_rate) return input_size;
  return static_cast<size_t>(input_size * out_rate / in_rate);
}

extern "C" size_t mt_resample(const float *in, size_t in_size, float in_rate,
                              float out_rate, float *out) {
  if (in_size == 0) return 0;
  if (in_rate == out_rate) {
    std::memcpy(out, in, in_size * sizeof(float));
    return in_size;
  }
  const size_t out_size = mt_resample_output_size(in_size, in_rate, out_rate);
  if (in_rate > out_rate) {
    /* Box average over [start, end] inclusive (reference: resampler.cpp).
     * Position math in double so boundaries match the Python oracle. */
    const double ratio = static_cast<double>(in_rate) / out_rate;
    for (size_t i = 0; i < out_size; i++) {
      size_t start = static_cast<size_t>(i * ratio);
      size_t end = static_cast<size_t>((i + 1) * ratio);
      if (end >= in_size) end = in_size - 1;
      double sum = 0.0;
      size_t count = 0;
      for (size_t j = start; j <= end; j++) {
        sum += in[j];
        count++;
      }
      out[i] = count ? static_cast<float>(sum / count) : 0.0f;
    }
  } else {
    const double ratio = static_cast<double>(in_rate) / out_rate;
    for (size_t i = 0; i < out_size; i++) {
      const double pos = i * ratio;
      const size_t idx = static_cast<size_t>(pos);
      const float frac = static_cast<float>(pos - idx);
      if (idx >= in_size - 1) {
        out[i] = in[in_size - 1];
      } else {
        out[i] = in[idx] + frac * (in[idx + 1] - in[idx]);
      }
    }
  }
  return out_size;
}

/* ---- SPSC ring buffer -------------------------------------------------- */

struct mt_ring {
  std::vector<float> data;
  std::atomic<size_t> head{0};  /* write index */
  std::atomic<size_t> tail{0};  /* read index */
};

extern "C" mt_ring *mt_ring_create(size_t capacity_samples) {
  auto *r = new mt_ring();
  r->data.resize(capacity_samples + 1); /* one slot spare */
  return r;
}

extern "C" void mt_ring_free(mt_ring *r) { delete r; }

extern "C" size_t mt_ring_capacity(const mt_ring *r) {
  return r->data.size() - 1;
}

extern "C" size_t mt_ring_available(const mt_ring *r) {
  const size_t h = r->head.load(std::memory_order_acquire);
  const size_t t = r->tail.load(std::memory_order_acquire);
  const size_t n = r->data.size();
  return (h + n - t) % n;
}

extern "C" size_t mt_ring_write(mt_ring *r, const float *data, size_t n) {
  const size_t cap = r->data.size();
  size_t h = r->head.load(std::memory_order_relaxed);
  const size_t t = r->tail.load(std::memory_order_acquire);
  const size_t free_slots = (t + cap - h - 1) % cap;
  const size_t to_write = std::min(n, free_slots);
  for (size_t i = 0; i < to_write; i++) {
    r->data[(h + i) % cap] = data[i];
  }
  r->head.store((h + to_write) % cap, std::memory_order_release);
  return to_write;
}

extern "C" size_t mt_ring_read(mt_ring *r, float *out, size_t n) {
  const size_t cap = r->data.size();
  const size_t h = r->head.load(std::memory_order_acquire);
  size_t t = r->tail.load(std::memory_order_relaxed);
  const size_t avail = (h + cap - t) % cap;
  const size_t to_read = std::min(n, avail);
  for (size_t i = 0; i < to_read; i++) {
    out[i] = r->data[(t + i) % cap];
  }
  r->tail.store((t + to_read) % cap, std::memory_order_release);
  return to_read;
}

/* ---- VAD segmenter ------------------------------------------------------ */

namespace {
constexpr int32_t kSampleRate = 16000;

struct Segment {
  std::vector<float> audio;
  double start_time = 0.0;
  double end_time = 0.0;
  bool is_complete = false;
  bool just_updated = false;
};
}  // namespace

struct mt_segmenter {
  float threshold;
  int32_t window_size;
  int32_t hop_size;
  size_t look_behind_count;
  size_t max_segment_count;

  bool active = false;
  std::vector<float> prob_window;
  int32_t prob_index = 0;
  size_t samples_processed = 0;
  std::vector<float> current_segment;
  std::vector<float> look_behind;
  bool previous_is_voice = false;
  std::vector<Segment> segments;

  void reset_state() {
    prob_window.assign(window_size, 0.0f);
    prob_index = 0;
    samples_processed = 0;
    current_segment.clear();
    look_behind.assign(look_behind_count, 0.0f);
    previous_is_voice = false;
  }
};

extern "C" mt_segmenter *mt_segmenter_create(float threshold,
                                             int32_t window_size,
                                             int32_t hop_size,
                                             size_t look_behind_sample_count,
                                             size_t max_segment_sample_count) {
  auto *s = new mt_segmenter();
  s->threshold = threshold;
  s->window_size = std::max(window_size, 1);
  s->hop_size = hop_size;
  s->look_behind_count = look_behind_sample_count;
  s->max_segment_count = max_segment_sample_count;
  s->reset_state();
  return s;
}

extern "C" void mt_segmenter_free(mt_segmenter *s) { delete s; }

extern "C" void mt_segmenter_start(mt_segmenter *s) {
  s->active = true;
  s->segments.clear();
  s->reset_state();
}

static void on_voice_end(mt_segmenter *s) {
  Segment &seg = s->segments.back();
  seg.audio = s->current_segment;
  seg.end_time = static_cast<double>(s->samples_processed) / kSampleRate;
  seg.is_complete = true;
  seg.just_updated = true;
}

extern "C" void mt_segmenter_stop(mt_segmenter *s) {
  s->active = false;
  if (s->previous_is_voice) {
    on_voice_end(s);
    s->previous_is_voice = false;
  }
}

extern "C" int32_t mt_segmenter_is_active(const mt_segmenter *s) {
  return s->active ? 1 : 0;
}

extern "C" void mt_segmenter_begin_update(mt_segmenter *s) {
  for (Segment &seg : s->segments) seg.just_updated = false;
}

extern "C" void mt_segmenter_process_hop(mt_segmenter *s, const float *hop,
                                         float probability) {
  if (!s->active) return;
  const size_t n = static_cast<size_t>(s->hop_size);
  s->samples_processed += n;

  /* Slide look-behind. */
  if (s->look_behind_count > 0) {
    if (n >= s->look_behind_count) {
      std::copy(hop + (n - s->look_behind_count), hop + n,
                s->look_behind.begin());
    } else {
      std::move(s->look_behind.begin() + n, s->look_behind.end(),
                s->look_behind.begin());
      std::copy(hop, hop + n, s->look_behind.end() - n);
    }
  }

  float smoothed;
  if (s->threshold > 0.0f) {
    s->prob_window[s->prob_index] = probability;
    s->prob_index = (s->prob_index + 1) % s->window_size;
    smoothed = std::accumulate(s->prob_window.begin(), s->prob_window.end(),
                               0.0f) /
               s->window_size;
  } else {
    smoothed = 1.0f;
  }

  const size_t fade_count = (s->max_segment_count * 2) / 3;
  if (s->max_segment_count && s->current_segment.size() > fade_count) {
    const float fade =
        static_cast<float>(s->current_segment.size() - fade_count) /
        static_cast<float>(fade_count);
    smoothed *= fade;
  }

  bool is_voice = smoothed > s->threshold;
  // Always-voice (threshold <= 0): hard-split at the max segment length —
  // the faded probability never reaches 0 exactly, so the comparison
  // alone would keep one unbounded segment (see the Python twin's note in
  // pipeline/vad_segmenter.py).
  if (s->threshold <= 0.0f && s->max_segment_count &&
      s->current_segment.size() >= s->max_segment_count) {
    is_voice = false;
  }
  if (is_voice && !s->previous_is_voice) {
    const size_t look =
        std::min(s->look_behind_count, s->samples_processed);
    s->current_segment.assign(s->look_behind.end() - look,
                              s->look_behind.end());
    Segment seg;
    const double now = static_cast<double>(s->samples_processed) / kSampleRate;
    seg.audio = s->current_segment;
    seg.start_time =
        now - static_cast<double>(s->current_segment.size()) / kSampleRate;
    seg.end_time = now;
    seg.just_updated = true;
    s->segments.push_back(std::move(seg));
  } else if (!is_voice && s->previous_is_voice) {
    s->current_segment.insert(s->current_segment.end(), hop, hop + n);
    on_voice_end(s);
    s->current_segment.clear();
    // look_behind retained across voice end (the reference's resize at
    // voice-activity-detector.cpp:186 is a same-size no-op).
  } else if (is_voice && s->previous_is_voice) {
    s->current_segment.insert(s->current_segment.end(), hop, hop + n);
    Segment &seg = s->segments.back();
    seg.audio = s->current_segment;
    seg.end_time = static_cast<double>(s->samples_processed) / kSampleRate;
    seg.just_updated = true;
  }
  s->previous_is_voice = is_voice;
}

extern "C" size_t mt_segmenter_segment_count(const mt_segmenter *s) {
  return s->segments.size();
}

extern "C" void mt_segmenter_segment_info(const mt_segmenter *s, size_t index,
                                          mt_segment_info *out) {
  if (index >= s->segments.size()) {
    std::memset(out, 0, sizeof(*out));
    return;
  }
  const Segment &seg = s->segments[index];
  out->start_time = seg.start_time;
  out->end_time = seg.end_time;
  out->is_complete = seg.is_complete ? 1 : 0;
  out->just_updated = seg.just_updated ? 1 : 0;
  out->audio_sample_count = seg.audio.size();
}

extern "C" size_t mt_segmenter_copy_audio(const mt_segmenter *s, size_t index,
                                          float *out, size_t max_samples) {
  if (index >= s->segments.size()) return 0;
  const Segment &seg = s->segments[index];
  const size_t n = std::min(max_samples, seg.audio.size());
  // n == 0 guard: memcpy from a null .data() (empty vector) is UB.
  if (n > 0) std::memcpy(out, seg.audio.data(), n * sizeof(float));
  return n;
}

extern "C" size_t mt_segmenter_retained_bytes(const mt_segmenter *s) {
  size_t total = 0;
  for (const Segment &seg : s->segments) total += seg.audio.size();
  return total * sizeof(float);
}

extern "C" size_t mt_segmenter_completed_bytes(const mt_segmenter *s) {
  size_t total = 0;
  for (const Segment &seg : s->segments)
    if (seg.is_complete) total += seg.audio.size();
  return total * sizeof(float);
}

extern "C" void mt_segmenter_clear_completed_audio(mt_segmenter *s) {
  for (Segment &seg : s->segments)
    if (seg.is_complete) {
      std::vector<float>().swap(seg.audio);
    }
}

extern "C" const char *mt_host_version(void) { return "0.1.0"; }
