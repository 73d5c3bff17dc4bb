/* moonshine_tpu native host runtime — C ABI.
 *
 * The TPU compute path is JAX/XLA; this library is the native runtime
 * around it (the analog of the reference's C++ core for host-side work,
 * reference: core/moonshine-c-api.h / core/voice-activity-detector.cpp /
 * core/resampler.cpp): audio ring buffers for ingest threads, the
 * resampler, and the VAD hysteresis segmenter state machine, all hot
 * per-stream host loops that should not run in Python when a server hosts
 * hundreds of streams.
 *
 * Semantics are bit-identical to the Python implementations in
 * moonshine_tpu.audio.resample / moonshine_tpu.pipeline.vad_segmenter
 * (tested against each other); the Python layer falls back to its own
 * implementation when the shared library is absent.
 */

#ifndef MOONSHINE_HOST_H
#define MOONSHINE_HOST_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define MT_API __attribute__((visibility("default")))

/* ---- resampler (reference: core/resampler.cpp semantics) -------------- */

/* Returns the number of output samples for the given conversion. */
MT_API size_t mt_resample_output_size(size_t input_size, float in_rate, float out_rate);

/* Box-filter downsample / linear upsample. `out` must hold
 * mt_resample_output_size() floats. Returns samples written. */
MT_API size_t mt_resample(const float *in, size_t in_size, float in_rate,
                          float out_rate, float *out);

/* ---- SPSC audio ring buffer ------------------------------------------ */

typedef struct mt_ring mt_ring;

MT_API mt_ring *mt_ring_create(size_t capacity_samples);
MT_API void mt_ring_free(mt_ring *r);
/* Returns samples actually written (drops the excess when full). */
MT_API size_t mt_ring_write(mt_ring *r, const float *data, size_t n);
/* Returns samples read into `out` (up to n). */
MT_API size_t mt_ring_read(mt_ring *r, float *out, size_t n);
MT_API size_t mt_ring_available(const mt_ring *r);
MT_API size_t mt_ring_capacity(const mt_ring *r);

/* ---- VAD segmenter state machine -------------------------------------- */
/* Mirrors moonshine_tpu.pipeline.vad_segmenter exactly: the caller runs
 * the neural VAD on device and feeds per-hop probabilities + the hop audio
 * here; the machine handles smoothing, hysteresis, look-behind and the
 * force-split threshold decay (reference: voice-activity-detector.cpp). */

typedef struct mt_segmenter mt_segmenter;

typedef struct {
  double start_time;
  double end_time;
  int32_t is_complete;
  int32_t just_updated;
  /* Offset/length of the segment audio in the segmenter's retained pool;
   * fetch with mt_segmenter_copy_audio. */
  size_t audio_sample_count;
} mt_segment_info;

MT_API mt_segmenter *mt_segmenter_create(float threshold, int32_t window_size,
                                         int32_t hop_size,
                                         size_t look_behind_sample_count,
                                         size_t max_segment_sample_count);
MT_API void mt_segmenter_free(mt_segmenter *s);
MT_API void mt_segmenter_start(mt_segmenter *s);
MT_API void mt_segmenter_stop(mt_segmenter *s);
MT_API int32_t mt_segmenter_is_active(const mt_segmenter *s);

/* Clears just_updated flags; call once per update before feeding hops. */
MT_API void mt_segmenter_begin_update(mt_segmenter *s);

/* Feed one hop of audio with its (raw, unsmoothed) speech probability.
 * `hop` must be exactly hop_size samples. */
MT_API void mt_segmenter_process_hop(mt_segmenter *s, const float *hop,
                                     float probability);

MT_API size_t mt_segmenter_segment_count(const mt_segmenter *s);
MT_API void mt_segmenter_segment_info(const mt_segmenter *s, size_t index,
                                      mt_segment_info *out);
/* Copies segment audio into `out` (caller sizes it from segment_info).
 * Returns samples copied. */
MT_API size_t mt_segmenter_copy_audio(const mt_segmenter *s, size_t index,
                                      float *out, size_t max_samples);
MT_API size_t mt_segmenter_retained_bytes(const mt_segmenter *s);
MT_API size_t mt_segmenter_completed_bytes(const mt_segmenter *s);
MT_API void mt_segmenter_clear_completed_audio(mt_segmenter *s);

/* ---- version ----------------------------------------------------------- */
MT_API const char *mt_host_version(void);

#ifdef __cplusplus
}
#endif

#endif /* MOONSHINE_HOST_H */
