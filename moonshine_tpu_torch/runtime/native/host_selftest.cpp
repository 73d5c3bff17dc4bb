// Sanitizer-instrumented selftest / fuzz driver for the native host runtime.
//
// Analog of the reference's MOONSHINE_RELIABILITY suite (reference:
// core/reliability/fuzz-*.cpp + scripts/reliability.sh): deterministic
// randomized sweeps over every C-ABI entry point, built with
// -fsanitize=address,undefined (memory/UB) and separately with
// -fsanitize=thread (the SPSC ring's producer/consumer contract), driven
// by scripts/reliability.sh.
//
// Exit code 0 = all invariants held and the sanitizers stayed silent.

#include "moonshine_host.h"

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

#define CHECK(cond)                                                         \
  do {                                                                      \
    if (!(cond)) {                                                          \
      std::fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,          \
                   __LINE__, #cond);                                        \
      std::abort();                                                         \
    }                                                                       \
  } while (0)

void fuzz_resampler(std::mt19937 &rng, int iters) {
  const float rates[] = {7919.f, 8000.f, 16000.f, 22050.f, 24000.f,
                         44100.f, 48000.f, 96000.f, 12345.f};
  std::uniform_int_distribution<size_t> size_dist(0, 5000);
  std::uniform_int_distribution<int> rate_dist(0, 8);
  std::normal_distribution<float> val;
  for (int i = 0; i < iters; ++i) {
    size_t n = size_dist(rng);
    float in_rate = rates[rate_dist(rng)];
    float out_rate = rates[rate_dist(rng)];
    std::vector<float> in(n);
    for (auto &x : in) x = val(rng);
    size_t expect = mt_resample_output_size(n, in_rate, out_rate);
    std::vector<float> out(expect + 1, 1234.5f);  // +1 canary slot
    size_t got = mt_resample(in.data(), n, in_rate, out_rate, out.data());
    CHECK(got == expect);
    CHECK(out[expect] == 1234.5f);  // never writes past the stated size
    for (size_t j = 0; j < got; ++j) CHECK(std::isfinite(out[j]));
  }
  // Degenerate rates/sizes.
  float one = 0.5f;
  CHECK(mt_resample_output_size(0, 16000.f, 16000.f) == 0);
  CHECK(mt_resample(&one, 1, 16000.f, 16000.f, &one) == 1);
}

// SPSC ring: a producer thread writes an increasing ramp; a consumer reads
// random-sized chunks and checks the values arrive in order without gaps
// (modulo full-buffer drops, which mt_ring_write reports).
void ring_threaded(std::mt19937 &rng, int iters) {
  std::uniform_int_distribution<size_t> cap_dist(64, 4096);
  for (int round = 0; round < 4; ++round) {
    size_t cap = cap_dist(rng);
    mt_ring *r = mt_ring_create(cap);
    CHECK(mt_ring_capacity(r) >= cap);
    std::atomic<bool> done{false};
    std::atomic<uint64_t> written{0};
    const uint64_t total = static_cast<uint64_t>(iters) * 97;

    std::thread producer([&] {
      std::mt19937 prng(round * 7919 + 13);
      std::uniform_int_distribution<size_t> chunk(1, 257);
      uint64_t seq = 0;
      while (seq < total) {
        size_t n = std::min<uint64_t>(chunk(prng), total - seq);
        std::vector<float> buf(n);
        for (size_t j = 0; j < n; ++j) buf[j] = static_cast<float>(seq + j);
        size_t w = mt_ring_write(r, buf.data(), n);
        seq += w;  // unwritten (dropped) tail is retried with fresh values
        written.store(seq, std::memory_order_relaxed);
        if (w == 0) std::this_thread::yield();
      }
      done.store(true, std::memory_order_release);
    });

    std::mt19937 crng(round * 104729 + 7);
    std::uniform_int_distribution<size_t> chunk(1, 311);
    uint64_t next_expect = 0;
    std::vector<float> buf(512);
    while (true) {
      size_t n = std::min<size_t>(chunk(crng), buf.size());
      size_t got = mt_ring_read(r, buf.data(), n);
      for (size_t j = 0; j < got; ++j) {
        CHECK(buf[j] == static_cast<float>(next_expect));
        ++next_expect;
      }
      if (got == 0) {
        if (done.load(std::memory_order_acquire) && mt_ring_available(r) == 0)
          break;
        std::this_thread::yield();
      }
    }
    producer.join();
    CHECK(next_expect == total);
    mt_ring_free(r);
  }
}

void fuzz_segmenter(std::mt19937 &rng, int iters) {
  std::uniform_int_distribution<int> hop_dist(0, 2);
  const int hop_sizes[] = {256, 512, 1024};
  std::uniform_real_distribution<float> prob(0.f, 1.f);
  std::normal_distribution<float> val;
  for (int round = 0; round < 6; ++round) {
    int hop = hop_sizes[hop_dist(rng)];
    size_t max_seg = 4096 + (rng() % 8) * 1024;
    mt_segmenter *s = mt_segmenter_create(0.5f, 8, hop, 1024, max_seg);
    mt_segmenter_start(s);
    CHECK(mt_segmenter_is_active(s));
    std::vector<float> audio(hop);
    double last_end = -1.0;
    for (int i = 0; i < iters; ++i) {
      mt_segmenter_begin_update(s);
      int hops = 1 + static_cast<int>(rng() % 5);
      for (int h = 0; h < hops; ++h) {
        for (auto &x : audio) x = val(rng) * 0.1f;
        // Bias toward long voiced runs so segments actually form and split.
        float p = (i / 50) % 2 == 0 ? 0.2f + 0.8f * prob(rng) : prob(rng) * 0.6f;
        mt_segmenter_process_hop(s, audio.data(), p);
      }
      size_t count = mt_segmenter_segment_count(s);
      for (size_t k = 0; k < count; ++k) {
        mt_segment_info info;
        mt_segmenter_segment_info(s, k, &info);
        CHECK(info.end_time >= info.start_time);
        if (k > 0) CHECK(info.start_time >= last_end - 0.3);  // look-behind overlap cap
        if (info.is_complete) last_end = info.end_time;
        std::vector<float> out(info.audio_sample_count + 1, 777.f);
        size_t got = mt_segmenter_copy_audio(s, k, out.data(), out.size());
        CHECK(got <= info.audio_sample_count);
        CHECK(out[info.audio_sample_count] == 777.f);
      }
      if (i % 97 == 96) mt_segmenter_clear_completed_audio(s);
    }
    mt_segmenter_stop(s);
    CHECK(!mt_segmenter_is_active(s));
    size_t count = mt_segmenter_segment_count(s);
    for (size_t k = 0; k < count; ++k) {
      mt_segment_info info;
      mt_segmenter_segment_info(s, k, &info);
      CHECK(info.is_complete);  // stop() finalizes everything
    }
    // Retained audio is bounded (leak regression, reference:
    // voice-activity-detector.h:59-61 retained-byte counters).
    CHECK(mt_segmenter_retained_bytes(s) <=
          (max_seg + 1024 + 16 * static_cast<size_t>(hop)) * sizeof(float) +
              mt_segmenter_completed_bytes(s));
    mt_segmenter_free(s);
  }
}

}  // namespace

int main(int argc, char **argv) {
  int iters = argc > 1 ? std::atoi(argv[1]) : 2000;
  std::mt19937 rng(20260818);
  std::printf("host_selftest: %s, iters=%d\n", mt_host_version(), iters);
  fuzz_resampler(rng, iters);
  std::printf("resampler fuzz ok\n");
  ring_threaded(rng, iters);
  std::printf("ring SPSC threaded ok\n");
  fuzz_segmenter(rng, iters / 4 + 1);
  std::printf("segmenter fuzz ok\n");
  std::printf("host_selftest PASSED\n");
  return 0;
}
