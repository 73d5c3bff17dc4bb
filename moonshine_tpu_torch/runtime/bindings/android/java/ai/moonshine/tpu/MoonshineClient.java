package ai.moonshine.tpu;

/**
 * JNI surface over the native transcription client
 * (runtime/bindings/jni/moonshine_jni.cpp, itself a thin shim over
 * moonshine_client.h — the service-boundary analog of the reference's
 * Android binding, reference:
 * language-bindings/android/moonshine-jni/moonshine-jni.cpp + the
 * MoonshineVoice Java API classes).
 *
 * Every method here maps 1:1 onto a Java_ai_moonshine_tpu_MoonshineClient_*
 * symbol exported by libmoonshine_jni.so; the consistency is asserted by
 * tests/test_native_client.py::test_java_api_matches_jni_symbols.
 */
public final class MoonshineClient {
    static {
        System.loadLibrary("moonshine_jni");
    }

    private MoonshineClient() {}

    /** Connect to the transcription server; returns a handle >= 0 or a
     *  negative mt_client_status. */
    public static native int connect(String host, int port);

    /** Send the start message for a stream of {@code sampleRate} PCM. */
    public static native int start(int handle, int sampleRate);

    /** Stream float32 PCM samples. */
    public static native int addAudio(int handle, float[] pcm);

    /** Request the final flush; events drain until STOPPED. */
    public static native int stop(int handle);

    /** Enable the regularized TranscriptEvent.LINE_* stream. */
    public static native int setLineEvents(int handle, int enabled);

    /** One event as "type|segment|start|end|latency|text", or null on
     *  timeout/error.  Parse with {@link TranscriptEvent#parse}. */
    public static native String pollEventText(int handle, int timeoutMs);

    /** Close the socket and release the handle (idempotent). */
    public static native int free(int handle);

    /** One-shot TTS; returns PCM at the server's voice rate. */
    public static native float[] tts(String host, int port, String text);

    /** One-shot grapheme-to-phoneme; returns IPA. */
    public static native String g2p(String host, int port, String text,
                                    String language);
}
