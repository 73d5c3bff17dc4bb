package ai.moonshine.tpu;

/**
 * Listener for the regularized transcript line lifecycle (reference
 * analog: the Android binding's TranscriptEventListener over
 * moonshine-c-api.h:165-196).  Delivery guarantees match the native
 * wire (MoonshineClient.setLineEvents): exactly one started/completed
 * per line, completed lines frozen, only the last line incomplete.
 *
 * All methods default to no-ops so callers implement only what they
 * need.
 */
public interface TranscriptEventListener {
    default void onLineStarted(TranscriptEvent event) {}

    default void onLineUpdated(TranscriptEvent event) {}

    default void onLineTextChanged(TranscriptEvent event) {}

    default void onLineSpeakersChanged(TranscriptEvent event) {}

    default void onLineCompleted(TranscriptEvent event) {}

    default void onError(TranscriptEvent event) {}
}
