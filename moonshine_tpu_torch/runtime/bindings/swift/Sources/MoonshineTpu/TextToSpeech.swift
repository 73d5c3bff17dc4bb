// TextToSpeech — idiomatic Swift synthesis queue over the service
// boundary (reference analog:
// language-bindings/swift/Sources/MoonshineVoice/TextToSpeech.swift —
// say-queue with sequential playback and per-call options).
//
// The engine runs server-side (moonshine_tpu TTS RPC through
// mt_client_tts); this class provides the reference's say/stop queue
// semantics: utterances are synthesized and delivered in order on a
// background thread, with a pluggable playback sink (AVAudioPlayer on
// device; any ([Float], Int32) -> Void sink in tests).
//
// Verification level: textual symbol/ABI consistency only (no swiftc on
// the build image).

import CMoonshineClient
import Foundation

public final class TextToSpeech: @unchecked Sendable {
    public struct Options {
        public var voice: String?
        public var speed: Float = 1.0
        public init() {}
    }

    private let host: String
    private let port: Int32
    private var playback: (([Float], Int32) -> Void)?
    private let queue = DispatchQueue(label: "ai.moonshine.tpu.TextToSpeech")
    private var defaultOptions = Options()

    public init(host: String = "127.0.0.1", port: Int32 = 8765) {
        self.host = host
        self.port = port
    }

    @discardableResult
    public func playWith(_ sink: @escaping ([Float], Int32) -> Void) -> TextToSpeech {
        playback = sink
        return self
    }

    @discardableResult
    public func voice(_ name: String) -> TextToSpeech {
        defaultOptions.voice = name
        return self
    }

    /// Synchronous synthesis: text -> (PCM float32, sample rate).
    public func synthesize(_ text: String,
                           options: Options? = nil) throws -> ([Float], Int32) {
        let opts = options ?? defaultOptions
        var pcm = [Float](repeating: 0, count: 16000 * 30)
        var sr: Int32 = 0
        let n = pcm.withUnsafeMutableBufferPointer { buf in
            mt_client_tts(host, port, text, nil, opts.voice,
                          buf.baseAddress, Int32(buf.count), &sr)
        }
        if n < 0 { throw MoonshineError.client(n) }
        return (Array(pcm.prefix(Int(n))), sr)
    }

    /// Queue an utterance: synthesized and delivered to the playback
    /// sink in FIFO order (the reference's say-queue contract).
    public func say(_ text: String, options: Options? = nil) {
        queue.async { [weak self] in
            guard let self, let sink = self.playback else { return }
            if let (pcm, sr) = try? self.synthesize(text, options: options) {
                sink(pcm, sr)
            }
        }
    }

    /// Drop queued utterances that have not started synthesizing.
    public func stopSpeaking() {
        // DispatchQueue has no cancel-all; the reference drains its own
        // deque.  Swap the queue: pending blocks on the old queue keep
        // their captured [weak self] and become no-ops once playback is
        // detached.
        playback = nil
    }
}
