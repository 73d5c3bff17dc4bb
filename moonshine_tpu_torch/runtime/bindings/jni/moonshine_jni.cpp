/* Android/Java JNI shim over the native transcription client.
 *
 * Proof of the "device bindings are thin shims over moonshine_client.h"
 * claim (the reference ships a 1,467-line JNI shim over its C ABI,
 * reference: language-bindings/android/moonshine-jni/moonshine-jni.cpp;
 * here the ABI is the service-boundary client, so the whole binding is
 * the marshalling below).  Compiles against the real <jni.h> when a JDK
 * is present (-DMOONSHINE_JNI_REAL_HEADER) or the declared-subset
 * jni_compat.h otherwise; either way it links only moonshine_client.h
 * symbols — no engine code.
 *
 * Java surface (class ai.moonshine.tpu.MoonshineClient):
 *   static native int    connect(String host, int port);
 *   static native int    start(int handle, int sampleRate);
 *   static native int    addAudio(int handle, float[] pcm);
 *   static native int    stop(int handle);
 *   static native int    setLineEvents(int handle, int enabled);
 *   static native String pollEventText(int handle, int timeoutMs);
 *   static native int    free(int handle);
 *   static native float[] tts(String host, int port, String text);
 *   static native String  g2p(String host, int port, String text,
 *                             String language);
 */
#include "jni_compat.h"

#include <string.h>

#include <string>
#include <vector>

#include "../../native/moonshine_client.h"

extern "C" {

JNIEXPORT jint JNICALL Java_ai_moonshine_tpu_MoonshineClient_connect(
    JNIEnv* env, jclass, jstring host, jint port) {
  const char* h = JNI_CALL(env, GetStringUTFChars, host, nullptr);
  jint rc = mt_client_connect(h, port);
  JNI_CALL(env, ReleaseStringUTFChars, host, h);
  return rc;
}

JNIEXPORT jint JNICALL Java_ai_moonshine_tpu_MoonshineClient_start(
    JNIEnv*, jclass, jint handle, jint sample_rate) {
  return mt_client_start(handle, sample_rate);
}

JNIEXPORT jint JNICALL Java_ai_moonshine_tpu_MoonshineClient_addAudio(
    JNIEnv* env, jclass, jint handle, jfloatArray pcm) {
  const jsize n = JNI_CALL(env, GetArrayLength, pcm);
  std::vector<jfloat> buf(static_cast<size_t>(n));
  JNI_CALL(env, GetFloatArrayRegion, pcm, 0, n, buf.data());
  return mt_client_add_audio(handle, buf.data(), n);
}

JNIEXPORT jint JNICALL Java_ai_moonshine_tpu_MoonshineClient_stop(
    JNIEnv*, jclass, jint handle) {
  return mt_client_stop(handle);
}

JNIEXPORT jint JNICALL Java_ai_moonshine_tpu_MoonshineClient_setLineEvents(
    JNIEnv*, jclass, jint handle, jint enabled) {
  return mt_client_set_line_events(handle, enabled);
}

/* Events marshal as "type|segment|start|end|latency|text" (the Java layer
 * splits; a struct-per-field JNI surface needs jclass lookups that add
 * nothing over the reference's own string-marshalled JSON events). */
JNIEXPORT jstring JNICALL Java_ai_moonshine_tpu_MoonshineClient_pollEventText(
    JNIEnv* env, jclass, jint handle, jint timeout_ms) {
  mt_client_event_t ev;
  int rc = mt_client_poll_event(handle, &ev, timeout_ms);
  if (rc <= 0) return nullptr;
  char head[128];
  snprintf(head, sizeof(head), "%d|%d|%.3f|%.3f|%.1f|", ev.type, ev.segment,
           ev.start_s, ev.end_s, ev.latency_ms);
  std::string s = std::string(head) + ev.text;
  return JNI_CALL(env, NewStringUTF, s.c_str());
}

JNIEXPORT jint JNICALL Java_ai_moonshine_tpu_MoonshineClient_free(
    JNIEnv*, jclass, jint handle) {
  return mt_client_free(handle);
}

JNIEXPORT jfloatArray JNICALL Java_ai_moonshine_tpu_MoonshineClient_tts(
    JNIEnv* env, jclass, jstring host, jint port, jstring text) {
  const char* h = JNI_CALL(env, GetStringUTFChars, host, nullptr);
  const char* t = JNI_CALL(env, GetStringUTFChars, text, nullptr);
  std::vector<float> pcm(16000 * 60);
  int32_t sr = 0;
  int32_t n = mt_client_tts(h, port, t, nullptr, nullptr, pcm.data(),
                            static_cast<int32_t>(pcm.size()), &sr);
  JNI_CALL(env, ReleaseStringUTFChars, host, h);
  JNI_CALL(env, ReleaseStringUTFChars, text, t);
  if (n < 0) return nullptr;
  if (n > static_cast<int32_t>(pcm.size())) n = static_cast<int32_t>(pcm.size());
  jfloatArray out = JNI_CALL(env, NewFloatArray, n);
  if (out != nullptr) JNI_CALL(env, SetFloatArrayRegion, out, 0, n, pcm.data());
  return out;
}

JNIEXPORT jstring JNICALL Java_ai_moonshine_tpu_MoonshineClient_g2p(
    JNIEnv* env, jclass, jstring host, jint port, jstring text,
    jstring language) {
  const char* h = JNI_CALL(env, GetStringUTFChars, host, nullptr);
  const char* t = JNI_CALL(env, GetStringUTFChars, text, nullptr);
  const char* lang =
      language ? JNI_CALL(env, GetStringUTFChars, language, nullptr) : nullptr;
  char ipa[1 << 16];
  int32_t rc = mt_client_g2p(h, port, t, lang, ipa, sizeof(ipa));
  JNI_CALL(env, ReleaseStringUTFChars, host, h);
  JNI_CALL(env, ReleaseStringUTFChars, text, t);
  if (lang != nullptr) JNI_CALL(env, ReleaseStringUTFChars, language, lang);
  if (rc < 0) return nullptr;
  return JNI_CALL(env, NewStringUTF, ipa);
}

}  // extern "C"
