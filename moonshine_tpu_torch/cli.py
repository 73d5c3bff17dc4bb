"""``moonshine-tpu-torch`` command line interface.

Counterpart of the JAX package's ``cli.py``: every subcommand runs over
the port, on CUDA unless ``--device`` names another device.  Mirrors the
reference CLI surface (reference: language-bindings/python/src/
moonshine_voice/cli.py with mic/transcribe/tts/agent/download/g2p
subcommands).  ``bench`` runs the JAX package's ``bench.py`` there; the
port has no bench entry yet (ROADMAP.md item 13.5), so its ``bench``
refuses with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_transcribe(args) -> int:
    from .api import Transcriber
    from .core.config import TranscriberOptions, VadOptions

    options = TranscriberOptions(
        model=args.model,
        word_timestamps=args.word_timestamps,
        vad=VadOptions(threshold=args.vad_threshold),
    )
    t = Transcriber(
        model=args.model,
        language=args.language,
        weights=args.weights,
        tokenizer_path=args.tokenizer,
        options=options,
        device=args.device,
    ).load()
    t0 = time.monotonic()
    transcript = t.transcribe_wav(args.wav)
    elapsed = time.monotonic() - t0
    for line in transcript.lines:
        stamp = f"[{line.start_time:7.2f}s +{line.duration:5.2f}s] "
        print(stamp + (line.text or ""))
        if args.word_timestamps:
            for w in line.words:
                print(f"    {w.start:7.2f}-{w.end:7.2f}  {w.text}")
    print(f"# transcribed in {elapsed:.2f}s", file=sys.stderr)
    return 0


def cmd_mic(args) -> int:  # pragma: no cover - needs audio hardware
    from .api import MicTranscriber, Transcriber
    from .pipeline.transcriber import LineCompleted, LineTextChanged

    t = Transcriber(model=args.model, weights=args.weights, tokenizer_path=args.tokenizer,
                    device=args.device).load()
    mic = MicTranscriber(t, update_interval=args.update_interval)

    def on_event(event):
        if isinstance(event, LineTextChanged):
            print("\r" + (event.line.text or ""), end="", flush=True)
        elif isinstance(event, LineCompleted):
            print("\r" + (event.line.text or ""))

    mic.add_listener(on_event)
    mic.start()
    print("Listening — Ctrl-C to stop.", file=sys.stderr)
    try:
        while True:
            time.sleep(0.1)
    except KeyboardInterrupt:
        mic.stop()
    return 0


def cmd_tts(args) -> int:
    from .audio.wav import save_wav
    from .tts.facade import TTSOptions, TextToSpeech

    tts = TextToSpeech(language=args.language, device=args.device).voice(args.voice).load()
    wav, sr = tts.synthesize(args.text, TTSOptions(speed=args.speed))
    if args.output:
        # TTS runs at 24 kHz; save as-is.
        save_wav(args.output, wav, sr)
        print(f"wrote {args.output} ({len(wav)/sr:.2f}s at {sr} Hz)")
    else:
        print(f"synthesized {len(wav)/sr:.2f}s at {sr} Hz (pass -o to save)")
    return 0


def cmd_g2p(args) -> int:
    from .tts.g2p import GraphemeToPhonemizer

    g = GraphemeToPhonemizer(args.language, lexicon_path=args.lexicon)
    print(g.text_to_ipa(args.text))
    return 0


def cmd_models(args) -> int:
    from . import catalog

    if args.json:
        print(catalog.catalog_json())
    else:
        for name in catalog.list_models():
            print(name)
    return 0


def cmd_bench(args) -> int:
    print("bench: the port has no benchmark entry yet (ROADMAP.md queue 1, item 13.5); "
          "the JAX package's bench.py runs JAX and is not run from here", file=sys.stderr)
    return 2


def cmd_agent(args) -> int:
    """Text-driven agent REPL (reference: cli.py `agent`; utterances come
    from stdin — use `mic` + AgentFlow in code for live audio)."""
    from .agent.flow import AgentFlow

    def echo_flow(d):
        answer = yield d.ask("Say something and I'll repeat it.")
        yield d.say(f"You said: {answer}")

    agent = (
        AgentFlow()
        .use_embeddings(args.embeddings)
        .speak_with(lambda text: print(f"[agent] {text}"))
        .listen_for(args.trigger, echo_flow)
        .otherwise(lambda text: print(f"[agent] (heard: {text!r})"))
        .load()
    )
    print(f"agent ready; trigger phrase: {args.trigger!r} (ctrl-d to exit)")
    try:
        for line in sys.stdin:
            line = line.strip()
            if line:
                agent.handle_utterance(line)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_download(args) -> int:
    from .download import DownloadError, download_model

    def progress(fraction: float, name: str) -> None:
        # download_file reports (fraction, file name); the JAX package's
        # callback reads them as (bytes done, bytes total).
        print(f"\r{name} {100.0 * fraction:5.1f}%", end="", file=sys.stderr)

    try:
        path = download_model(
            args.model, args.language, base_url=args.base_url, progress=progress
        )
    except DownloadError as e:
        print(f"\ndownload failed: {e}", file=sys.stderr)
        return 1
    print(f"\n{path}")
    return 0


def cmd_serve(args) -> int:  # pragma: no cover - long-running
    from . import server

    argv = [
        "--model", args.model, "--streams", str(args.streams),
        "--host", args.host, "--port", str(args.port),
    ]
    if args.device:
        argv += ["--device", args.device]
    if args.weights:
        argv += ["--weights", args.weights]
    if args.tokenizer:
        argv += ["--tokenizer", args.tokenizer]
    server.main(argv)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="moonshine-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    tp = sub.add_parser("transcribe", help="Transcribe a WAV file")
    tp.add_argument("wav")
    tp.add_argument("--model", default="tiny")
    tp.add_argument("--language", default="en")
    tp.add_argument("--weights", default=None)
    tp.add_argument("--tokenizer", default=None)
    tp.add_argument("--word-timestamps", action="store_true")
    tp.add_argument("--vad-threshold", type=float, default=0.5)
    tp.add_argument("--device", default=None, help="torch device (default: cuda)")
    tp.set_defaults(fn=cmd_transcribe)

    mp = sub.add_parser("mic", help="Live transcription from the microphone")
    mp.add_argument("--model", default="tiny_streaming")
    mp.add_argument("--weights", default=None)
    mp.add_argument("--tokenizer", default=None)
    mp.add_argument("--update-interval", type=float, default=0.5)
    mp.add_argument("--device", default=None, help="torch device (default: cuda)")
    mp.set_defaults(fn=cmd_mic)

    sp = sub.add_parser("tts", help="Synthesize speech from text")
    sp.add_argument("text")
    sp.add_argument("-o", "--output", default=None, help="Output WAV path")
    sp.add_argument("--voice", default="af_default")
    sp.add_argument("--language", default="en")
    sp.add_argument("--speed", type=float, default=1.0)
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_tts)

    gp = sub.add_parser("g2p", help="Convert text to IPA phonemes")
    gp.add_argument("text")
    gp.add_argument("--language", default="en")
    gp.add_argument("--lexicon", default=None)
    gp.set_defaults(fn=cmd_g2p)

    cp = sub.add_parser("models", help="List the model catalog")
    cp.add_argument("--json", action="store_true")
    cp.set_defaults(fn=cmd_models)

    bp = sub.add_parser("bench", help="Refused: the port has no benchmark entry yet")
    bp.set_defaults(fn=cmd_bench)

    ap = sub.add_parser("agent", help="Text-driven agent REPL (stdin)")
    ap.add_argument("--trigger", default="hello agent")
    ap.add_argument("--embeddings", action="store_true",
                    help="semantic phrase matching (needs the Gemma embedder)")
    ap.set_defaults(fn=cmd_agent)

    dp = sub.add_parser("download", help="Fetch a model from the catalog")
    dp.add_argument("model")
    dp.add_argument("--language", default="en")
    dp.add_argument("--base-url", default=None)
    dp.set_defaults(fn=cmd_download)

    vp = sub.add_parser("serve", help="WebSocket transcription server")
    vp.add_argument("--model", default="tiny_streaming")
    vp.add_argument("--weights", default=None)
    vp.add_argument("--tokenizer", default=None)
    vp.add_argument("--streams", type=int, default=16)
    vp.add_argument("--host", default="127.0.0.1")
    vp.add_argument("--port", type=int, default=8765)
    vp.add_argument("--device", default=None, help="torch device (default: cuda)")
    vp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
