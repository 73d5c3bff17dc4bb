"""Generator-driven conversational agent flows.

Capability mirror of the reference Python binding's AgentFlow
(reference: language-bindings/python/src/moonshine_voice/agent_flow.py):
flows are plain generator functions that yield Prompt objects
(Say / Ask / Confirm / Choose); the runner carries each prompt out and
sends the result back into the generator.  Trigger phrases and in-flow
matching use embedding cosine similarity (PhraseMatcher) with a
model-free SubstringMatcher fallback (reference: agent_flow.py:253-385).

The runner here is transport-agnostic: speech synthesis, microphone
muting and timers are injected callables, so the same runner drives a
real MicTranscriber+TTS stack or a text harness (``handle_utterance``)
unchanged — the reference reaches the same testability through
``microphone(False)`` + ``use_embeddings(False)``.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generator, List, Mapping, NoReturn, Optional, Sequence, Set, Tuple

# Input modes (reference: agent_flow.py:108-113)
FREE = "free"
SPELLED = "spelled"
DIGITS = "digits"
PHRASE = "phrase"


# -- prompts ---------------------------------------------------------------

@dataclass
class Prompt:
    """Base class for values a flow yields to the runner."""


@dataclass
class Say(Prompt):
    text: str
    barge_in: bool = False


@dataclass
class Ask(Prompt):
    prompt: str
    mode: str = FREE
    bias_terms: Optional[List[str]] = None
    timeout: Optional[float] = 8.0
    no_input_reprompt: Optional[str] = "Sorry, I didn't catch that. {prompt}"
    max_retries: int = 2


_DEFAULT_YES = (
    "yes", "yeah", "yep", "correct", "that's right", "sure",
    "affirmative", "okay", "please do", "do it",
)
_DEFAULT_NO = (
    "no", "nope", "incorrect", "that's wrong", "negative", "cancel",
    "don't do it", "stop",
)


@dataclass
class Confirm(Prompt):
    prompt: str
    timeout: Optional[float] = 6.0
    max_retries: int = 1
    threshold: float = 0.55
    no_input_reprompt: Optional[str] = (
        "Sorry, I didn't catch that. Was that a yes or a no? {prompt}"
    )
    yes_phrases: Sequence[str] = field(default_factory=lambda: _DEFAULT_YES)
    no_phrases: Sequence[str] = field(default_factory=lambda: _DEFAULT_NO)


@dataclass
class Choose(Prompt):
    prompt: str
    options: Mapping[str, Sequence[str]] = field(default_factory=dict)
    timeout: Optional[float] = 8.0
    max_retries: int = 2
    threshold: float = 0.55
    no_input_reprompt: Optional[str] = "Sorry, I didn't catch that. {prompt}"


class DialogError(Exception):
    pass


class DialogCancelled(DialogError):
    pass


class DialogRestart(DialogError):
    pass


# -- matchers (reference: agent_flow.py:253-385) ---------------------------

class PhraseMatcher:
    """Key -> phrases matching via embedding cosine similarity."""

    def __init__(self, backend, phrases_by_key: Mapping[str, Sequence[str]], *, threshold: float = 0.55):
        if backend is None:
            raise ValueError("PhraseMatcher requires an embedding backend")
        self._backend = backend
        self._threshold = float(threshold)
        self._phrase_embeddings: Dict[str, list] = {}
        for key, phrases in phrases_by_key.items():
            embs = []
            for phrase in phrases:
                if not phrase:
                    continue
                try:
                    embs.append(backend.calculate_embedding(phrase))
                except Exception as e:  # noqa: BLE001
                    print(f"PhraseMatcher: failed to embed {phrase!r}: {e}", file=sys.stderr)
            self._phrase_embeddings[key] = embs

    @property
    def threshold(self) -> float:
        return self._threshold

    def match(self, utterance: str) -> Optional[str]:
        return self.match_with_score(utterance)[0]

    def match_with_score(self, utterance: str) -> Tuple[Optional[str], float]:
        if not utterance:
            return None, 0.0
        try:
            u = self._backend.calculate_embedding(utterance)
        except Exception as e:  # noqa: BLE001
            print(f"PhraseMatcher: failed to embed utterance: {e}", file=sys.stderr)
            return None, 0.0
        best_key, best_sim = None, -1.0
        for key, embs in self._phrase_embeddings.items():
            for e in embs:
                sim = self._backend.distance(u, e)
                if sim > best_sim:
                    best_sim, best_key = sim, key
        if best_key is not None and best_sim >= self._threshold:
            return best_key, best_sim
        return None, max(best_sim, 0.0)


class SubstringMatcher:
    """Model-free fallback: case-insensitive substring, longest phrase wins
    (reference: agent_flow.py:352-385)."""

    def __init__(self, phrases_by_key: Mapping[str, Sequence[str]], *, threshold: float = 0.55):
        self._threshold = float(threshold)
        self._phrases_by_key = {
            key: [p.strip().lower() for p in phrases if p and p.strip()]
            for key, phrases in phrases_by_key.items()
        }

    @property
    def threshold(self) -> float:
        return self._threshold

    def match(self, utterance: str) -> Optional[str]:
        return self.match_with_score(utterance)[0]

    def match_with_score(self, utterance: str) -> Tuple[Optional[str], float]:
        text = (utterance or "").strip().lower()
        if not text:
            return None, 0.0
        best_key, best_len = None, 0
        for key, phrases in self._phrases_by_key.items():
            for phrase in phrases:
                if phrase in text or text in phrase:
                    if len(phrase) > best_len:
                        best_len, best_key = len(phrase), key
        if best_key is None:
            return None, 0.0
        return best_key, min(1.0, best_len / max(len(text), 1))


class EmbeddingBackend:
    """Adapter: a GemmaEmbedder (or cache) -> matcher backend protocol."""

    def __init__(self, embedder, cache: Optional[dict] = None):
        self._embedder = embedder
        self._cache = cache if cache is not None else {}

    def calculate_embedding(self, text: str):
        if text in self._cache:
            return self._cache[text]
        e = self._embedder.get_embeddings(text)
        self._cache[text] = e
        return e

    def distance(self, a, b) -> float:
        from ..models.gemma import cosine_similarity

        return cosine_similarity(a, b)


# -- dialog ----------------------------------------------------------------

class Dialog:
    """Context object handed to a flow; performs no I/O itself
    (reference: agent_flow.py:413-486)."""

    def __init__(self, trigger_phrase: str = "", *, state: Optional[Dict[str, Any]] = None):
        self.trigger_phrase = trigger_phrase
        self.state: Dict[str, Any] = dict(state) if state else {}
        self._last_spoken_prompt: Optional[str] = None

    def say(self, text: str, *, barge_in: bool = False) -> Say:
        self._last_spoken_prompt = text
        return Say(text=text, barge_in=barge_in)

    def ask(self, prompt: str, **kw) -> Ask:
        self._last_spoken_prompt = prompt
        return Ask(prompt=prompt, **kw)

    def confirm(self, prompt: str, **kw) -> Confirm:
        self._last_spoken_prompt = prompt
        return Confirm(prompt=prompt, **kw)

    def choose(self, prompt: str, options: Mapping[str, Sequence[str]], **kw) -> Choose:
        self._last_spoken_prompt = prompt
        return Choose(prompt=prompt, options={k: list(v) for k, v in options.items()}, **kw)

    def cancel(self) -> NoReturn:
        raise DialogCancelled()

    def restart(self) -> NoReturn:
        raise DialogRestart()

    def replay_last_prompt(self) -> Optional[Say]:
        if self._last_spoken_prompt is None:
            return None
        return Say(text=self._last_spoken_prompt)


FlowFn = Callable[[Dialog], Generator]


class _ActiveFlow:
    def __init__(self, fn: FlowFn, dialog: Dialog, gen: Generator):
        self.fn = fn
        self.dialog = dialog
        self.gen = gen
        self.pending: Optional[Prompt] = None  # input-expecting prompt
        self.retries_left = 0
        self.timer: Optional[Any] = None
        self.alpha_session = None  # AlphanumericSession for SPELLED/DIGITS


# -- runner ----------------------------------------------------------------

class AgentFlow:
    """Synchronous flow runner with injectable transport.

    Chainable setters -> ``load()`` -> feed utterances (from a transcriber
    or ``handle_utterance``).  Built-in flow-scoped globals "cancel" and
    "start over" (reference: agent_flow.py:676-686).
    """

    def __init__(self) -> None:
        self._language = "en"
        self._use_embeddings = True
        self._trigger_threshold = 0.7
        self._flows: Dict[str, FlowFn] = {}
        self._globals: Dict[str, Callable[[Dialog], Any]] = {}
        self._flow_scoped_globals: Set[str] = set()
        self._active: Optional[_ActiveFlow] = None
        self._lock = threading.RLock()
        self._embedder = None
        self._backend = None
        self._embedding_cache: Dict[str, Any] = {}
        self._speak_fn: Optional[Callable[[str], None]] = None
        self._mute_fn: Optional[Callable[[bool], None]] = None
        self._timer_factory: Callable = threading.Timer
        self._heard_fn: Optional[Callable[[str], None]] = None
        self._said_fn: Optional[Callable[[str], None]] = None
        self._error_fn: Optional[Callable[[BaseException], None]] = None
        self._otherwise_fn: Optional[Callable[[str], None]] = None
        self._trigger_matcher = None
        self._loaded = False

        self._add_flow_scoped_global("cancel", lambda d: d.cancel())
        self._add_flow_scoped_global("start over", lambda d: d.restart())

    # -- chainable configuration -------------------------------------------

    def language(self, code: str) -> "AgentFlow":
        self._language = code
        return self

    def use_embeddings(self, enabled: bool = True) -> "AgentFlow":
        self._use_embeddings = bool(enabled)
        self._trigger_matcher = None
        return self

    def with_cached_embeddings(self, path) -> "AgentFlow":
        """Preload phrase embeddings from a TSV (reference:
        cached_embeddings.py) — constant phrases (triggers, yes/no sets)
        skip the embedder forward pass; live utterances fall through."""
        from .cached_embeddings import load_cached_embeddings

        vectors, _meta = load_cached_embeddings(path)
        self._embedding_cache.update(vectors)
        if self._backend is not None:
            self._backend._cache.update(vectors)
        return self

    def use_embedder(self, embedder) -> "AgentFlow":
        """Attach a GemmaEmbedder (or compatible) for phrase matching."""
        self._embedder = embedder
        self._backend = None
        self._trigger_matcher = None
        return self

    def trigger_threshold(self, threshold: float) -> "AgentFlow":
        self._trigger_threshold = float(threshold)
        self._trigger_matcher = None
        return self

    def speak_with(self, fn: Callable[[str], None]) -> "AgentFlow":
        self._speak_fn = fn
        return self

    def mute_with(self, fn: Callable[[bool], None]) -> "AgentFlow":
        self._mute_fn = fn
        return self

    def timers_with(self, factory) -> "AgentFlow":
        self._timer_factory = factory
        return self

    def on_heard(self, cb) -> "AgentFlow":
        self._heard_fn = cb
        return self

    def on_said(self, cb) -> "AgentFlow":
        self._said_fn = cb
        return self

    def on_error(self, cb) -> "AgentFlow":
        self._error_fn = cb
        return self

    def otherwise(self, cb) -> "AgentFlow":
        """Handler for utterances no trigger matched (dictation fallthrough)."""
        self._otherwise_fn = cb
        return self

    def listen_for(self, trigger_phrase: str, flow: FlowFn) -> "AgentFlow":
        self._flows[trigger_phrase.strip().lower()] = flow
        self._trigger_matcher = None
        return self

    def always(self, phrase: str, handler: Callable[[Dialog], Any]) -> "AgentFlow":
        key = phrase.strip().lower()
        self._globals[key] = handler
        self._flow_scoped_globals.discard(key)
        self._trigger_matcher = None
        return self

    def _add_flow_scoped_global(self, phrase: str, handler) -> None:
        key = phrase.strip().lower()
        self._globals[key] = handler
        self._flow_scoped_globals.add(key)

    # -- loading ------------------------------------------------------------

    def load(self) -> "AgentFlow":
        self._loaded = True
        return self

    def _make_matcher(self, phrases_by_key: Mapping[str, Sequence[str]], threshold: float):
        if self._use_embeddings and self._embedder is not None:
            if self._backend is None:
                self._backend = EmbeddingBackend(
                    self._embedder, cache=self._embedding_cache
                )
            return PhraseMatcher(self._backend, phrases_by_key, threshold=threshold)
        return SubstringMatcher(phrases_by_key, threshold=threshold)

    # -- speaking -----------------------------------------------------------

    def _speak(self, text: str) -> None:
        if self._said_fn:
            self._said_fn(text)
        if self._mute_fn:
            self._mute_fn(True)
        try:
            if self._speak_fn:
                self._speak_fn(text)
        finally:
            if self._mute_fn:
                self._mute_fn(False)

    # -- flow driving -------------------------------------------------------

    def handle_utterance(self, text: str) -> None:
        """Route one completed utterance (the text-driven entry point;
        the mic path calls this from LineCompleted)."""
        with self._lock:
            if self._heard_fn:
                self._heard_fn(text)
            text_norm = (text or "").strip()
            if not text_norm:
                return
            # SPELLED/DIGITS prompts own the line entirely: "start over" /
            # "cancel" are spelling commands (CLEAR/...) there, not globals
            # (reference: alphanumeric listener consumes lines first).
            if (
                self._active is not None
                and isinstance(self._active.pending, Ask)
                and self._active.pending.mode in (SPELLED, DIGITS)
            ):
                self._resume_with_input(text_norm)
                return
            # Global handlers first.
            g_key = self._match_global(text_norm)
            if g_key is not None:
                self._run_global(g_key)
                return
            if self._active is not None and self._active.pending is not None:
                self._resume_with_input(text_norm)
                return
            if self._active is not None:
                # Flow running but not waiting for input: drop the line.
                return
            self._try_trigger(text_norm)

    def _match_global(self, text: str) -> Optional[str]:
        active = self._active is not None
        keys = [
            k for k in self._globals
            if active or k not in self._flow_scoped_globals
        ]
        if not keys:
            return None
        matcher = self._make_matcher({k: [k] for k in keys}, self._trigger_threshold)
        return matcher.match(text)

    def _run_global(self, key: str) -> None:
        handler = self._globals[key]
        dialog = self._active.dialog if self._active else Dialog()
        try:
            result = handler(dialog)
            if isinstance(result, Say):
                self._speak(result.text)
        except DialogCancelled:
            self._end_flow()
        except DialogRestart:
            self._restart_flow()
        except Exception as e:  # noqa: BLE001
            self._report_error(e)
            self._end_flow()

    def _try_trigger(self, text: str) -> None:
        if not self._flows:
            if self._otherwise_fn:
                self._otherwise_fn(text)
            return
        if self._trigger_matcher is None:
            self._trigger_matcher = self._make_matcher(
                {k: [k] for k in self._flows}, self._trigger_threshold
            )
        key = self._trigger_matcher.match(text)
        if key is None:
            if self._otherwise_fn:
                self._otherwise_fn(text)
            return
        self._start_flow(self._flows[key], trigger_phrase=text)

    def _start_flow(self, fn: FlowFn, trigger_phrase: str = "") -> None:
        dialog = Dialog(trigger_phrase=trigger_phrase)
        gen = fn(dialog)
        if not hasattr(gen, "send"):
            return  # non-generator flow: ran to completion already
        self._active = _ActiveFlow(fn, dialog, gen)
        self._advance(None)

    def _restart_flow(self) -> None:
        if self._active is None:
            return
        fn = self._active.fn
        trigger = self._active.dialog.trigger_phrase
        self._end_flow()
        self._start_flow(fn, trigger)

    def _end_flow(self) -> None:
        if self._active is not None and self._active.timer is not None:
            try:
                self._active.timer.cancel()
            except Exception:
                pass
        self._active = None

    def _report_error(self, e: BaseException) -> None:
        if self._error_fn:
            try:
                self._error_fn(e)
            except Exception:
                pass
        else:
            print(f"AgentFlow: flow raised {e!r}", file=sys.stderr)

    def _advance(self, value) -> None:
        """Drive the generator until it completes or waits for input.

        A throwing flow is torn down without wedging the runner
        (reference: README.md:1493).
        """
        active = self._active
        if active is None:
            return
        try:
            prompt = active.gen.send(value)
        except StopIteration:
            self._end_flow()
            return
        except DialogCancelled:
            self._end_flow()
            return
        except DialogRestart:
            self._restart_flow()
            return
        except Exception as e:  # noqa: BLE001
            self._report_error(e)
            self._end_flow()
            return

        while isinstance(prompt, Say):
            self._speak(prompt.text)
            try:
                prompt = active.gen.send(None)
            except StopIteration:
                self._end_flow()
                return
            except DialogCancelled:
                self._end_flow()
                return
            except DialogRestart:
                self._restart_flow()
                return
            except Exception as e:  # noqa: BLE001
                self._report_error(e)
                self._end_flow()
                return

        if isinstance(prompt, (Ask, Confirm, Choose)):
            active.pending = prompt
            active.retries_left = prompt.max_retries
            self._speak(prompt.prompt)
            self._arm_timeout(prompt)
        else:
            self._report_error(TypeError(f"Flow yielded non-Prompt {prompt!r}"))
            self._end_flow()

    def _arm_timeout(self, prompt) -> None:
        active = self._active
        if active is None or prompt.timeout is None:
            return
        timer = self._timer_factory(prompt.timeout, self._on_timeout)
        active.timer = timer
        start = getattr(timer, "start", None)
        if start:
            start()

    def _on_timeout(self) -> None:
        with self._lock:
            active = self._active
            if active is None or active.pending is None:
                return
            prompt = active.pending
            if active.retries_left > 0:
                active.retries_left -= 1
                reprompt = prompt.no_input_reprompt
                if reprompt:
                    self._speak(reprompt.format(prompt=prompt.prompt))
                self._arm_timeout(prompt)
            else:
                # Give up: send None into the flow.
                active.pending = None
                self._advance(None)

    def _resume_with_input(self, text: str) -> None:
        active = self._active
        prompt = active.pending
        if active.timer is not None:
            try:
                active.timer.cancel()
            except Exception:
                pass
            active.timer = None

        result: Any
        if isinstance(prompt, Ask) and prompt.mode in (SPELLED, DIGITS):
            # Characters accumulate across utterances until "stop"
            # (reference: alphanumeric_listener.py flow).
            from .alphanumeric import AlphanumericSession

            if active.alpha_session is None:
                active.alpha_session = AlphanumericSession(
                    mode="digits" if prompt.mode == DIGITS else "spelled"
                )
            ev = active.alpha_session.handle_utterance(text)
            if ev.action != "stop":
                self._arm_timeout(prompt)  # keep waiting for more characters
                return
            result = active.alpha_session.value
            active.alpha_session = None
        elif isinstance(prompt, Ask):
            result = text
        elif isinstance(prompt, Confirm):
            matcher = self._make_matcher(
                {"yes": prompt.yes_phrases, "no": prompt.no_phrases},
                prompt.threshold,
            )
            key = matcher.match(text)
            if key is None:
                self._retry_or_give_up(text)
                return
            result = key == "yes"
        elif isinstance(prompt, Choose):
            groups = {
                k: list(v) + [k] for k, v in prompt.options.items()
            }
            matcher = self._make_matcher(groups, prompt.threshold)
            key = matcher.match(text)
            if key is None:
                self._retry_or_give_up(text)
                return
            result = key
        else:
            result = text
        active.pending = None
        self._advance(result)

    def _retry_or_give_up(self, text: str) -> None:
        active = self._active
        prompt = active.pending
        if active.retries_left > 0:
            active.retries_left -= 1
            reprompt = prompt.no_input_reprompt
            if reprompt:
                self._speak(reprompt.format(prompt=prompt.prompt))
            self._arm_timeout(prompt)
        else:
            active.pending = None
            self._advance(None)
