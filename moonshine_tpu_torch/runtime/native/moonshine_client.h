/* moonshine_client.h — C ABI for the native transcription client.
 *
 * The TPU build's service boundary is the WebSocket transcription server
 * (moonshine_tpu/server.py); this library is the native-caller analog of
 * the reference's C ABI (reference: core/moonshine-c-api.h:387-679 —
 * handle-based transcriber/stream surface) for that boundary: a
 * dependency-free C client that connects to the server, streams PCM, and
 * polls transcript events.  Handles are int32 indices into a global map,
 * the same ownership convention as the reference
 * (moonshine-c-api.cpp:176-190); all calls are thread-safe, with send and
 * receive independently serialized per connection so one thread can feed
 * audio while another polls events (reference: moonshine-c-api.h:64-67,
 * per-transcriber serialization).
 *
 * Wire protocol (see server.py docstring): one WebSocket per stream;
 * client sends {"type":"start"...} / binary float32 LE PCM /
 * {"type":"stop"}; server sends partial/final/stopped/error JSON events.
 */
#ifndef MOONSHINE_CLIENT_H
#define MOONSHINE_CLIENT_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#if defined(_WIN32)
#define MT_CLIENT_EXPORT __declspec(dllexport)
#else
#define MT_CLIENT_EXPORT __attribute__((visibility("default")))
#endif

/* Event types mirror the server's message types; the MT_EVENT_LINE_*
 * family is the reference's regularized line lifecycle
 * (reference: moonshine-c-api.h:165-196, README.md:379-397), derived
 * client-side from the partial/final stream when line events are
 * enabled (mt_client_set_line_events).  Delivery guarantees match the
 * reference: exactly one STARTED and one COMPLETED per line, COMPLETED
 * lines are frozen (stray later updates are dropped), and at most the
 * LAST started line is incomplete (a new line's STARTED is preceded by
 * the previous line's COMPLETED). */
enum mt_client_event_type {
  MT_EVENT_PARTIAL = 0, /* in-progress line text update */
  MT_EVENT_FINAL = 1,   /* line completed (frozen) */
  MT_EVENT_STOPPED = 2, /* server acknowledged stop; stream is drained */
  MT_EVENT_ERROR = 3,   /* server-reported error (text holds the message) */
  MT_EVENT_LINE_STARTED = 4,          /* first update for a new line */
  MT_EVENT_LINE_UPDATED = 5,          /* any update touching the line */
  MT_EVENT_LINE_TEXT_CHANGED = 6,     /* the line's text differs */
  MT_EVENT_LINE_SPEAKERS_CHANGED = 7, /* the line's speaker set differs */
  MT_EVENT_LINE_COMPLETED = 8,        /* line frozen; no further events */
};

/* Return codes (negative = failure), reference-style int error model
 * (reference: moonshine-c-api.h:114-118). */
enum mt_client_status {
  MT_CLIENT_OK = 0,
  MT_CLIENT_ERR_CONNECT = -1,   /* TCP/handshake failure */
  MT_CLIENT_ERR_HANDLE = -2,    /* bad or freed handle */
  MT_CLIENT_ERR_CLOSED = -3,    /* connection closed by peer */
  MT_CLIENT_ERR_PROTOCOL = -4,  /* malformed frame / unexpected data */
  MT_CLIENT_ERR_IO = -5,        /* socket error */
};

#define MT_CLIENT_MAX_TEXT 4096
#define MT_CLIENT_MAX_SPEAKERS 8

typedef struct mt_client_event_t {
  int32_t type;       /* mt_client_event_type */
  int32_t segment;    /* segment id (monotonic per stream; -1 if absent) */
  double start_s;     /* segment start time in stream seconds */
  double end_s;       /* segment end time in stream seconds */
  double latency_ms;  /* server-measured update latency */
  /* UTF-8, NUL-terminated, truncated at a codepoint boundary if longer
   * than the buffer.  Owned by the caller's struct (no library-owned
   * memory, unlike the reference's next-call invalidation rule). */
  char text[MT_CLIENT_MAX_TEXT];
  /* Line lifecycle fields (MT_EVENT_LINE_*; appended for ABI growth —
   * older callers that allocated the pre-line-events struct must not
   * enable line events).  line_id == segment id of the line.  speakers
   * is the line's current speaker-id set (reference:
   * moonshine-c-api.h speaker change reporting). */
  int32_t line_id;
  int32_t n_speakers;
  int32_t speakers[MT_CLIENT_MAX_SPEAKERS];
} mt_client_event_t;

/* Library version string, static storage. */
MT_CLIENT_EXPORT const char* mt_client_version(void);

/* Connect to ws://host:port/ and perform the WebSocket handshake.
 * Returns a handle >= 0, or MT_CLIENT_ERR_CONNECT. */
MT_CLIENT_EXPORT int32_t mt_client_connect(const char* host, int32_t port);

/* Send the start message.  sample_rate is the rate of subsequent PCM. */
MT_CLIENT_EXPORT int32_t mt_client_start(int32_t handle, int32_t sample_rate);

/* Stream n float32 samples (host byte order; the wire is little-endian,
 * which is asserted at build time). */
MT_CLIENT_EXPORT int32_t mt_client_add_audio(int32_t handle,
                                             const float* pcm, int32_t n);

/* Send the stop message.  Events keep arriving until MT_EVENT_STOPPED. */
MT_CLIENT_EXPORT int32_t mt_client_stop(int32_t handle);

/* Enable (1) / disable (0) the regularized line-event stream for this
 * connection: poll_event then yields MT_EVENT_LINE_* events derived from
 * the server's partial/final messages (STOPPED/ERROR pass through; raw
 * PARTIAL/FINAL are consumed by the translation).  Safe to call before
 * or after mt_client_start; state resets per connection. */
MT_CLIENT_EXPORT int32_t mt_client_set_line_events(int32_t handle,
                                                   int32_t enabled);

/* Wait up to timeout_ms for one event.  Returns 1 with *out filled,
 * 0 on timeout, or a negative mt_client_status. */
MT_CLIENT_EXPORT int32_t mt_client_poll_event(int32_t handle,
                                              mt_client_event_t* out,
                                              int32_t timeout_ms);

/* Close the socket and free the handle.  Idempotent. */
MT_CLIENT_EXPORT int32_t mt_client_free(int32_t handle);

/* ---- One-shot RPC surface --------------------------------------------
 * Native-caller analogs of the reference's non-transcription C ABI entry
 * points (reference: moonshine-c-api.h:849-890/:1087-1111 TTS,
 * :1140-1184 G2P, :703-758 embeddings, :812 speech-clip), carried over
 * the service boundary: each call opens a WebSocket, performs one
 * request, and closes.  Output buffers are caller-owned (no library-
 * owned memory, no next-call invalidation). */

/* Synthesize `text` (or IPA when `ipa` is non-NULL; `voice` may be NULL
 * for the default voice).  Writes up to `cap` float32 samples into
 * out_pcm and the rate into *sample_rate.  Returns the sample count
 * (which may exceed `cap`; the copy is truncated — call again with a
 * bigger buffer), or a negative mt_client_status. */
MT_CLIENT_EXPORT int32_t mt_client_tts(const char* host, int32_t port,
                                       const char* text, const char* ipa,
                                       const char* voice, float* out_pcm,
                                       int32_t cap, int32_t* sample_rate);

/* Grapheme-to-phoneme: UTF-8 IPA into out_ipa (NUL-terminated,
 * truncated at a codepoint boundary).  language may be NULL ("en_us"). */
MT_CLIENT_EXPORT int32_t mt_client_g2p(const char* host, int32_t port,
                                       const char* text, const char* language,
                                       char* out_ipa, int32_t cap);

/* Embed n_texts strings; writes n_texts * (*dim) float32 values into
 * out (row-major) when they fit in `cap` floats.  Returns the total
 * float count, or negative status. */
MT_CLIENT_EXPORT int32_t mt_client_embed(const char* host, int32_t port,
                                         const char* const* texts,
                                         int32_t n_texts, float* out,
                                         int32_t cap, int32_t* dim);

typedef struct mt_clip_result_t {
  int32_t found;     /* 1 when a qualifying clip exists */
  double start_s;    /* clip start in input seconds */
  double end_s;      /* clip end in input seconds */
  double speech_s;   /* voiced seconds inside the clip */
} mt_clip_result_t;

/* Best ~4 s mostly-speech window of the supplied audio (the voice-clone
 * clip extractor; reference: speech-clip.h).  pcm is n float32 samples
 * at sample_rate. */
MT_CLIENT_EXPORT int32_t mt_client_speech_clip(const char* host, int32_t port,
                                               const float* pcm, int32_t n,
                                               int32_t sample_rate,
                                               mt_clip_result_t* out);

/* Catalog / dependency JSON surface — the service-boundary analog of the
 * reference's moonshine_get_* family (reference:
 * moonshine-c-api.h:910-1074).  `kind` selects the document:
 *   "stt_catalog"              full STT model catalog
 *   "embedding_catalog"        embedding model catalog
 *   "stt_dependencies"         download manifest; `arg` = language,
 *                              options_json may carry {"model_arch":...,
 *                              "include_spelling":true}
 *   "tts_dependencies"         merged TTS voice deps; `arg` = languages
 *   "g2p_dependencies"         G2P data deps; `arg` = languages
 *   "embedding_dependencies"   `arg` = model name (NULL = default)
 *   "diarization_dependencies" no arguments
 *   "tts_voices"               voices w/ availability; `arg` = languages
 * `options_json` is a JSON object forwarded verbatim (may be NULL).
 * Writes the NUL-terminated JSON document into out_json (truncated when
 * longer than cap) and returns the full byte length, or a negative
 * mt_client_status.  Caller-owned buffer — no library-owned memory. */
MT_CLIENT_EXPORT int32_t mt_client_catalog_json(const char* host, int32_t port,
                                                const char* kind,
                                                const char* arg,
                                                const char* options_json,
                                                char* out_json, int32_t cap);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* MOONSHINE_CLIENT_H */
