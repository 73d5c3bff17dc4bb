package ai.moonshine.tpu;

/** Parsed transcript event (the Java analog of mt_client_event_t). */
public final class TranscriptEvent {
    public static final int PARTIAL = 0;
    public static final int FINAL = 1;
    public static final int STOPPED = 2;
    public static final int ERROR = 3;
    // Regularized line lifecycle (MoonshineClient.setLineEvents;
    // reference: moonshine-c-api.h:165-196).  For line events the
    // segment field is the line id.
    public static final int LINE_STARTED = 4;
    public static final int LINE_UPDATED = 5;
    public static final int LINE_TEXT_CHANGED = 6;
    public static final int LINE_SPEAKERS_CHANGED = 7;
    public static final int LINE_COMPLETED = 8;

    public final int type;
    public final int segment;
    public final double startSeconds;
    public final double endSeconds;
    public final double latencyMillis;
    public final String text;

    private TranscriptEvent(int type, int segment, double start, double end,
                            double latency, String text) {
        this.type = type;
        this.segment = segment;
        this.startSeconds = start;
        this.endSeconds = end;
        this.latencyMillis = latency;
        this.text = text;
    }

    /** Parses {@link MoonshineClient#pollEventText}'s
     *  "type|segment|start|end|latency|text" encoding ('|' cannot occur
     *  in the numeric head; the text field keeps any embedded '|'). */
    public static TranscriptEvent parse(String wire) {
        if (wire == null) {
            return null;
        }
        String[] head = wire.split("\\|", 6);
        if (head.length < 6) {
            return null;
        }
        return new TranscriptEvent(
            Integer.parseInt(head[0]), Integer.parseInt(head[1]),
            Double.parseDouble(head[2]), Double.parseDouble(head[3]),
            Double.parseDouble(head[4]), head[5]);
    }

    public boolean isFinal() {
        return type == FINAL;
    }

    public boolean isLineEvent() {
        return type >= LINE_STARTED && type <= LINE_COMPLETED;
    }
}
