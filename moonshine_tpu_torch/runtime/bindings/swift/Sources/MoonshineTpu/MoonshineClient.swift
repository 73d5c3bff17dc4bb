import CMoonshineClient
import Foundation

/// Transcript event parsed from the native client's event struct
/// (the Swift analog of `mt_client_event_t`).
public struct TranscriptEvent {
    public enum Kind: Int32 {
        case partial = 0, final = 1, stopped = 2, error = 3
        // Regularized line lifecycle (MoonshineStream.setLineEvents;
        // reference: moonshine-c-api.h:165-196)
        case lineStarted = 4, lineUpdated = 5, lineTextChanged = 6
        case lineSpeakersChanged = 7, lineCompleted = 8
    }

    public let kind: Kind
    public let segment: Int32
    public let startSeconds: Double
    public let endSeconds: Double
    public let latencyMillis: Double
    public let text: String
}

public enum MoonshineError: Error {
    case connect(Int32)
    case client(Int32)
}

/// One live transcription stream over the service boundary — a thin
/// shim over moonshine_client.h, mirroring the reference Swift
/// binding's Transcriber/stream surface (reference:
/// language-bindings/swift/Sources/MoonshineVoice/Transcriber.swift)
/// with the WebSocket service as the engine.
public final class MoonshineStream {
    private var handle: Int32

    public init(host: String, port: Int32) throws {
        handle = mt_client_connect(host, port)
        if handle < 0 { throw MoonshineError.connect(handle) }
    }

    deinit { _ = mt_client_free(handle) }

    public func start(sampleRate: Int32 = 16000) throws {
        let rc = mt_client_start(handle, sampleRate)
        if rc != 0 { throw MoonshineError.client(rc) }
    }

    public func addAudio(_ pcm: [Float]) throws {
        let rc = pcm.withUnsafeBufferPointer {
            mt_client_add_audio(handle, $0.baseAddress, Int32(pcm.count))
        }
        if rc != 0 { throw MoonshineError.client(rc) }
    }

    public func stop() throws {
        let rc = mt_client_stop(handle)
        if rc != 0 { throw MoonshineError.client(rc) }
    }

    /// Switch pollEvent to the regularized line-lifecycle stream.
    public func setLineEvents(_ enabled: Bool = true) throws {
        let rc = mt_client_set_line_events(handle, enabled ? 1 : 0)
        if rc != 0 { throw MoonshineError.client(rc) }
    }

    /// Wait up to `timeoutMs` for one event; nil on timeout.
    public func pollEvent(timeoutMs: Int32) throws -> TranscriptEvent? {
        var ev = mt_client_event_t()
        let rc = mt_client_poll_event(handle, &ev, timeoutMs)
        if rc == 0 { return nil }
        if rc < 0 { throw MoonshineError.client(rc) }
        let text = withUnsafeBytes(of: &ev.text) { raw -> String in
            let p = raw.baseAddress!.assumingMemoryBound(to: CChar.self)
            return String(cString: p)
        }
        return TranscriptEvent(
            kind: TranscriptEvent.Kind(rawValue: ev.type) ?? .error,
            segment: ev.segment, startSeconds: ev.start_s,
            endSeconds: ev.end_s, latencyMillis: ev.latency_ms, text: text)
    }

    public func close() {
        _ = mt_client_free(handle)
        handle = -1
    }
}

/// One-shot RPC surface (TTS / G2P / catalog JSON), mirroring the
/// reference binding's synthesis and catalog helpers.
public enum Moonshine {
    public static func tts(host: String, port: Int32, text: String,
                           capSamples: Int32 = 16000 * 30)
        throws -> ([Float], Int32)
    {
        var pcm = [Float](repeating: 0, count: Int(capSamples))
        var rate: Int32 = 0
        let n = pcm.withUnsafeMutableBufferPointer {
            mt_client_tts(host, port, text, nil, nil, $0.baseAddress,
                          capSamples, &rate)
        }
        if n < 0 { throw MoonshineError.client(n) }
        return (Array(pcm.prefix(Int(min(n, capSamples)))), rate)
    }

    public static func g2p(host: String, port: Int32, text: String,
                           language: String = "en_us") throws -> String {
        var buf = [CChar](repeating: 0, count: 1 << 16)
        let n = buf.withUnsafeMutableBufferPointer {
            mt_client_g2p(host, port, text, language, $0.baseAddress,
                          Int32($0.count))
        }
        if n < 0 { throw MoonshineError.client(n) }
        return String(cString: buf)
    }

    /// Catalog/dependency JSON (the reference's moonshine_get_* family,
    /// moonshine-c-api.h:910-1074, over the service boundary).
    public static func catalogJson(host: String, port: Int32, kind: String,
                                   arg: String? = nil) throws -> String {
        var buf = [CChar](repeating: 0, count: 1 << 20)
        let n = buf.withUnsafeMutableBufferPointer {
            mt_client_catalog_json(host, port, kind, arg, nil,
                                   $0.baseAddress, Int32($0.count))
        }
        if n < 0 { throw MoonshineError.client(n) }
        return String(cString: buf)
    }
}
