package ai.moonshine.tpu;

import java.util.ArrayDeque;
import java.util.Deque;

/**
 * TextToSpeech — say-queue over the service-boundary TTS RPC
 * (reference analog: the Android binding's TextToSpeech; the engine
 * runs server-side through the JNI shim's tts()).  Utterances are
 * synthesized and delivered in FIFO order on a worker thread to a
 * pluggable playback sink (device builds wrap AudioTrack).
 */
public final class TextToSpeech {
    /** Playback sink: mono float32 at the given sample rate. */
    public interface Playback {
        void play(float[] pcm, int sampleRate);
    }

    private final String host;
    private final int port;
    private final Deque<String> queued = new ArrayDeque<>();
    private Playback playback;
    private Thread worker;
    private volatile boolean running;

    public TextToSpeech(String host, int port) {
        this.host = host;
        this.port = port;
    }

    public TextToSpeech playWith(Playback sink) {
        playback = sink;
        return this;
    }

    /** Synchronous synthesis (sample rate rides in the JNI float[]
     *  convention: MoonshineClient.tts returns PCM; rate is 24000 for
     *  the acoustic model voices, 22050 for klatt, 16000 for
     *  neural-pack — the server's header frame carries it and the shim
     *  resamples nothing). */
    public float[] synthesize(String text) {
        float[] pcm = MoonshineClient.tts(host, port, text);
        if (pcm == null) {
            throw new IllegalStateException("tts failed");
        }
        return pcm;
    }

    /** Queue an utterance for sequential synthesis + playback. */
    public synchronized void say(String text) {
        queued.addLast(text);
        if (worker == null || !worker.isAlive()) {
            running = true;
            worker = new Thread(this::drain, "moonshine-tpu-tts");
            worker.setDaemon(true);
            worker.start();
        }
    }

    /** Drop utterances that have not started synthesizing. */
    public synchronized void stopSpeaking() {
        queued.clear();
        running = false;
    }

    private void drain() {
        for (;;) {
            String text;
            synchronized (this) {
                text = queued.pollFirst();
            }
            if (text == null || !running) {
                return;
            }
            float[] pcm = synthesize(text);
            Playback sink = playback;
            if (sink != null) {
                sink.play(pcm, 24000);
            }
        }
    }
}
