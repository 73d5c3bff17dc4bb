// MicTranscriber — the idiomatic browser capture-to-transcript surface
// (reference analog: language-bindings/wasm/src/mic-transcriber.ts —
// getUserMedia + AudioWorklet capture, listener dispatch).
//
// Architectural difference, by design: the engine runs server-side;
// this class streams PCM through the Embind shim (moonshine_embind.cpp
// MoonshineStream) and consumes the regularized 5-event line lifecycle
// (setLineEvents).  The capture path is the standard AudioWorklet
// pattern; `feed()` is public so tests drive the pipeline with file
// audio and no microphone.
//
// Verification level: the shim methods referenced here are
// compile-checked in tests/test_native_client.py (embind shim g++
// compile + symbol consistency); no Emscripten/tsc on the build image.

import {
  dispatch,
  parseEvent,
  TranscriptEvent,
  TranscriptEventKind,
  TranscriptEventListener,
} from "./events";

/** The embind shim's stream surface (moonshine_embind.cpp). */
interface ShimStream {
  start(sampleRate: number): number;
  addAudio(pcm: Float32Array | number[]): number;
  setLineEvents(enabled: number): number;
  pollEventText(timeoutMs: number): string;
  stop(): number;
  close(): number;
}

interface ShimModule {
  MoonshineStream: new (host: string, port: number) => ShimStream;
}

export class MicTranscriber {
  private stream: ShimStream | null = null;
  private listeners: TranscriptEventListener[] = [];
  private textHandlers: ((text: string) => void)[] = [];
  private polling = false;
  private audioContext: AudioContext | null = null;
  private workletNode: AudioWorkletNode | null = null;

  constructor(
    private readonly module: ShimModule,
    private readonly host = "127.0.0.1",
    private readonly port = 8765,
    private readonly sampleRate = 16000,
  ) {}

  onText(handler: (text: string) => void): this {
    this.textHandlers.push(handler);
    return this;
  }

  addListener(listener: TranscriptEventListener): this {
    this.listeners.push(listener);
    return this;
  }

  /** Connect, enable line events, and begin polling. */
  load(): this {
    const s = new this.module.MoonshineStream(this.host, this.port);
    if (s.start(this.sampleRate) < 0) throw new Error("start failed");
    if (s.setLineEvents(1) < 0) throw new Error("setLineEvents failed");
    this.stream = s;
    this.polling = true;
    void this.pollLoop();
    return this;
  }

  /** Feed captured mono float32 PCM (the worklet calls this; tests
   *  call it directly). */
  feed(pcm: Float32Array): void {
    this.stream?.addAudio(pcm);
  }

  /** Start microphone capture via AudioWorklet (browser only). */
  async start(): Promise<void> {
    const media = await navigator.mediaDevices.getUserMedia({ audio: true });
    const ctx = new AudioContext({ sampleRate: this.sampleRate });
    await ctx.audioWorklet.addModule("moonshine-capture-worklet.js");
    const source = ctx.createMediaStreamSource(media);
    const node = new AudioWorkletNode(ctx, "moonshine-capture");
    node.port.onmessage = (ev: MessageEvent<Float32Array>) =>
      this.feed(ev.data);
    source.connect(node);
    this.audioContext = ctx;
    this.workletNode = node;
  }

  /** Stop capture and flush; events keep arriving until Stopped. */
  stop(): void {
    this.workletNode?.disconnect();
    void this.audioContext?.close();
    this.stream?.stop();
  }

  private async pollLoop(): Promise<void> {
    while (this.polling && this.stream) {
      const wire = this.stream.pollEventText(100);
      const ev = parseEvent(wire);
      if (!ev) {
        // Yield to the event loop between polls.
        await new Promise((r) => setTimeout(r, 10));
        continue;
      }
      this.handle(ev);
      if (ev.kind === TranscriptEventKind.Stopped) break;
    }
    this.polling = false;
    this.stream?.close();
    this.stream = null;
  }

  private handle(ev: TranscriptEvent): void {
    if (ev.kind === TranscriptEventKind.LineTextChanged) {
      for (const h of this.textHandlers) h(ev.text);
    }
    for (const l of this.listeners) dispatch(l, ev);
  }
}
