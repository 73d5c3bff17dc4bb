package ai.moonshine.tpu;

import java.util.List;
import java.util.concurrent.CopyOnWriteArrayList;

/**
 * MicTranscriber — the idiomatic Android capture-to-transcript surface
 * over the service-boundary stream (reference analog: the Android
 * binding's MicTranscriber over AudioRecord).
 *
 * Architectural difference, by design: the engine runs server-side;
 * this class streams PCM through the JNI shim (MoonshineClient) and
 * dispatches the regularized 5-event line lifecycle.  Capture is
 * injected via {@link AudioSource} so the class is drivable without
 * android.media on the build image (a device build wraps AudioRecord
 * in an AudioSource; tests feed file PCM).
 *
 * Verification level: the JNI symbols this class calls are
 * compile-checked against the shim
 * (tests/test_native_client.py::test_java_api_matches_jni_symbols);
 * no javac ships on the build image.
 */
public final class MicTranscriber {
    /** Pluggable PCM source (device builds wrap AudioRecord). */
    public interface AudioSource {
        /** Begin capture; deliver mono float32 chunks to the sink. */
        void start(Sink sink);

        void stop();

        interface Sink {
            void onAudio(float[] pcm);
        }
    }

    private final String host;
    private final int port;
    private final List<TranscriptEventListener> listeners =
        new CopyOnWriteArrayList<>();
    private AudioSource source;
    private int handle = -1;
    private Thread pollThread;
    private volatile boolean running;

    public MicTranscriber(String host, int port) {
        this.host = host;
        this.port = port;
    }

    public MicTranscriber addListener(TranscriptEventListener l) {
        listeners.add(l);
        return this;
    }

    public MicTranscriber withAudioSource(AudioSource s) {
        source = s;
        return this;
    }

    /** Connect, enable line events, start capture + the poll loop. */
    public synchronized void start(int sampleRate) {
        if (running) {
            return;
        }
        handle = MoonshineClient.connect(host, port);
        if (handle < 0) {
            throw new IllegalStateException("connect failed: " + handle);
        }
        check(MoonshineClient.start(handle, sampleRate), "start");
        check(MoonshineClient.setLineEvents(handle, 1), "setLineEvents");
        running = true;
        if (source != null) {
            source.start(pcm -> {
                if (running) {
                    MoonshineClient.addAudio(handle, pcm);
                }
            });
        }
        pollThread = new Thread(this::pollLoop, "moonshine-tpu-mic-poll");
        pollThread.setDaemon(true);
        pollThread.start();
    }

    /** Feed PCM directly (file playback, tests). */
    public void feed(float[] pcm) {
        check(MoonshineClient.addAudio(handle, pcm), "addAudio");
    }

    /** Stop capture, flush, and wait for the event drain. */
    public synchronized void stop() {
        if (!running) {
            return;
        }
        if (source != null) {
            source.stop();
        }
        MoonshineClient.stop(handle);
        try {
            pollThread.join(30_000);
        } catch (InterruptedException e) {
            Thread.currentThread().interrupt();
        }
        running = false;
        MoonshineClient.free(handle);
        handle = -1;
    }

    private void pollLoop() {
        while (running) {
            String wire = MoonshineClient.pollEventText(handle, 250);
            TranscriptEvent ev = TranscriptEvent.parse(wire);
            if (ev == null) {
                continue;
            }
            dispatch(ev);
            if (ev.type == TranscriptEvent.STOPPED) {
                break;
            }
        }
    }

    private void dispatch(TranscriptEvent ev) {
        for (TranscriptEventListener l : listeners) {
            switch (ev.type) {
                case TranscriptEvent.LINE_STARTED: l.onLineStarted(ev); break;
                case TranscriptEvent.LINE_UPDATED: l.onLineUpdated(ev); break;
                case TranscriptEvent.LINE_TEXT_CHANGED:
                    l.onLineTextChanged(ev); break;
                case TranscriptEvent.LINE_SPEAKERS_CHANGED:
                    l.onLineSpeakersChanged(ev); break;
                case TranscriptEvent.LINE_COMPLETED:
                    l.onLineCompleted(ev); break;
                case TranscriptEvent.ERROR: l.onError(ev); break;
                default: break;
            }
        }
    }

    private static void check(int rc, String what) {
        if (rc < 0) {
            throw new IllegalStateException(what + " failed: " + rc);
        }
    }
}
