// MicTranscriber — the idiomatic Swift capture-to-transcript surface
// over the service-boundary stream (reference analog:
// language-bindings/swift/Sources/MoonshineVoice/MicTranscriber.swift —
// AVAudioEngine capture, chainable config, closure/object listeners).
//
// Architectural difference, by design: the reference runs the engine
// in-process; this binding streams PCM to a moonshine_tpu
// TranscriptionServer and consumes the regularized 5-event line
// lifecycle the native client derives (MoonshineStream.setLineEvents —
// the same delivery guarantees as the reference's TranscriptEvent
// stream: exactly-once started/completed, frozen completed lines, only
// the last line incomplete).
//
// Verification level: textual symbol/ABI consistency only (no swiftc on
// the build image — tests/test_native_client.py::test_swift_package).
// AVAudioEngine capture requires device hardware; the capture tap is
// isolated behind `feed(_:)` so the pipeline is drivable from any PCM
// source (file playback, test vectors) without AVFoundation.

#if canImport(AVFoundation)
@preconcurrency import AVFoundation
#endif
import Foundation

/// Closure/object listener contract for the regularized line lifecycle
/// (reference: TranscriptEventListener.swift; wire:
/// moonshine_client.h MT_EVENT_LINE_*).
public protocol TranscriptEventListener: AnyObject {
    func onLineStarted(_ event: TranscriptEvent)
    func onLineUpdated(_ event: TranscriptEvent)
    func onLineTextChanged(_ event: TranscriptEvent)
    func onLineSpeakersChanged(_ event: TranscriptEvent)
    func onLineCompleted(_ event: TranscriptEvent)
    func onError(_ event: TranscriptEvent)
}

public extension TranscriptEventListener {
    // All optional: implement only the events you care about.
    func onLineStarted(_ event: TranscriptEvent) {}
    func onLineUpdated(_ event: TranscriptEvent) {}
    func onLineTextChanged(_ event: TranscriptEvent) {}
    func onLineSpeakersChanged(_ event: TranscriptEvent) {}
    func onLineCompleted(_ event: TranscriptEvent) {}
    func onError(_ event: TranscriptEvent) {}
}

public final class MicTranscriber: @unchecked Sendable {
    private let host: String
    private let port: Int32
    private var stream: MoonshineStream?
    private var pollThread: Thread?
    private var running = false
    private let lock = NSLock()

    private var textHandlers: [(String) -> Void] = []
    private var lineHandlers: [(TranscriptEvent) -> Void] = []
    private var listeners: [TranscriptEventListener] = []
    private var sampleRate: Int32 = 16000

#if canImport(AVFoundation)
    private var audioEngine: AVAudioEngine?
#endif

    public init(host: String = "127.0.0.1", port: Int32 = 8765) {
        self.host = host
        self.port = port
    }

    // Chainable configuration (reference MicTranscriber style).
    @discardableResult
    public func onText(_ handler: @escaping (String) -> Void) -> MicTranscriber {
        textHandlers.append(handler)
        return self
    }

    @discardableResult
    public func onLine(_ handler: @escaping (TranscriptEvent) -> Void) -> MicTranscriber {
        lineHandlers.append(handler)
        return self
    }

    @discardableResult
    public func addListener(_ l: TranscriptEventListener) -> MicTranscriber {
        listeners.append(l)
        return self
    }

    @discardableResult
    public func withSampleRate(_ rate: Int32) -> MicTranscriber {
        sampleRate = rate
        return self
    }

    /// Connects, enables line events, and starts the poll loop.
    public func load() throws {
        let s = try MoonshineStream(host: host, port: port)
        try s.start(sampleRate: sampleRate)
        try s.setLineEvents(true)
        stream = s
        running = true
        let t = Thread { [weak self] in self?.pollLoop() }
        t.name = "ai.moonshine.tpu.MicTranscriber.poll"
        t.start()
        pollThread = t
    }

    /// Feed captured PCM (mono float32).  The capture tap calls this;
    /// tests call it directly with file audio.
    public func feed(_ pcm: [Float]) throws {
        try stream?.addAudio(pcm)
    }

#if canImport(AVFoundation)
    /// Start the AVAudioEngine microphone tap (device builds only).
    public func start() throws {
        let engine = AVAudioEngine()
        let input = engine.inputNode
        let format = input.outputFormat(forBus: 0)
        input.installTap(onBus: 0, bufferSize: 1024, format: format) {
            [weak self] buffer, _ in
            guard let self, let data = buffer.floatChannelData else { return }
            let n = Int(buffer.frameLength)
            let pcm = Array(UnsafeBufferPointer(start: data[0], count: n))
            try? self.feed(pcm)
        }
        try engine.start()
        audioEngine = engine
    }
#endif

    /// Stop capture, flush the stream, and drain remaining events.
    public func stop() throws {
#if canImport(AVFoundation)
        audioEngine?.stop()
        audioEngine = nil
#endif
        try stream?.stop()
    }

    private func pollLoop() {
        while running, let s = stream {
            guard let ev = try? s.pollEvent(timeoutMs: 250) else { continue }
            dispatch(ev)
            if ev.kind == .stopped { break }
        }
        running = false
    }

    private func dispatch(_ ev: TranscriptEvent) {
        lock.lock()
        let lines = lineHandlers
        let texts = textHandlers
        let objs = listeners
        lock.unlock()
        for h in lines { h(ev) }
        switch ev.kind {
        case .lineTextChanged:
            for h in texts { h(ev.text) }
            for l in objs { l.onLineTextChanged(ev) }
        case .lineStarted: for l in objs { l.onLineStarted(ev) }
        case .lineUpdated: for l in objs { l.onLineUpdated(ev) }
        case .lineSpeakersChanged: for l in objs { l.onLineSpeakersChanged(ev) }
        case .lineCompleted: for l in objs { l.onLineCompleted(ev) }
        case .error: for l in objs { l.onError(ev) }
        default: break
        }
    }

    deinit {
        running = false
    }
}
