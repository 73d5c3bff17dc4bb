// Transcript event model for the WASM binding (reference analog:
// language-bindings/wasm/src/events.ts).  Values mirror
// moonshine_client.h mt_client_event_type; the LINE_* family is the
// regularized lifecycle MoonshineStream.setLineEvents enables.

export enum TranscriptEventKind {
  Partial = 0,
  Final = 1,
  Stopped = 2,
  Error = 3,
  LineStarted = 4,
  LineUpdated = 5,
  LineTextChanged = 6,
  LineSpeakersChanged = 7,
  LineCompleted = 8,
}

export interface TranscriptEvent {
  kind: TranscriptEventKind;
  /** Line id == segment id (monotonic per stream). */
  segment: number;
  startSeconds: number;
  endSeconds: number;
  latencyMillis: number;
  text: string;
}

/** Parses the embind shim's "type|segment|start|end|latency|text"
 *  encoding (pollEventText); returns null on timeout (""). */
export function parseEvent(wire: string): TranscriptEvent | null {
  if (!wire) return null;
  const head = wire.split("|");
  if (head.length < 6) return null;
  return {
    kind: Number(head[0]) as TranscriptEventKind,
    segment: Number(head[1]),
    startSeconds: Number(head[2]),
    endSeconds: Number(head[3]),
    latencyMillis: Number(head[4]),
    text: head.slice(5).join("|"),
  };
}

export interface TranscriptEventListener {
  onLineStarted?(event: TranscriptEvent): void;
  onLineUpdated?(event: TranscriptEvent): void;
  onLineTextChanged?(event: TranscriptEvent): void;
  onLineSpeakersChanged?(event: TranscriptEvent): void;
  onLineCompleted?(event: TranscriptEvent): void;
  onError?(event: TranscriptEvent): void;
}

export function dispatch(
  listener: TranscriptEventListener,
  event: TranscriptEvent,
): void {
  switch (event.kind) {
    case TranscriptEventKind.LineStarted:
      listener.onLineStarted?.(event);
      break;
    case TranscriptEventKind.LineUpdated:
      listener.onLineUpdated?.(event);
      break;
    case TranscriptEventKind.LineTextChanged:
      listener.onLineTextChanged?.(event);
      break;
    case TranscriptEventKind.LineSpeakersChanged:
      listener.onLineSpeakersChanged?.(event);
      break;
    case TranscriptEventKind.LineCompleted:
      listener.onLineCompleted?.(event);
      break;
    case TranscriptEventKind.Error:
      listener.onError?.(event);
      break;
  }
}
