"""The port's ``AgentFlow``, matchers and cached embeddings against the
JAX package's, on the CPU.

- The contracts of tests/test_agent_flow.py, run on the port's copies
  (``agent/flow.py`` and ``agent/cached_embeddings.py`` are copied from the
  JAX package; only their imports point into the port).
- A ``PhraseMatcher`` over the port's ``GemmaEmbedder`` against one over
  JAX's, on bridged weights at tests/test_gemma.py's ``SMALL`` config with
  a byte tokenizer: the same keys, scores within 1e-5 (the embeddings
  agree to 1e-5; a score is their cosine).  The same scripted
  conversation through both packages' ``AgentFlow`` speaks the same
  prompts and takes the same branches.
- A cached-embeddings TSV written by either package loads in the other,
  and makes the same decisions as the live embedder.
"""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from moonshine_tpu_torch.agent.flow import (
    AgentFlow,
    Ask,
    Choose,
    Confirm,
    Dialog,
    DialogCancelled,
    PhraseMatcher,
    Say,
    SubstringMatcher,
)


class ManualTimer:
    """Injectable timer: fires only when the test calls .fire()."""

    instances = []

    def __init__(self, timeout, callback):
        self.timeout = timeout
        self.callback = callback
        self.cancelled = False
        ManualTimer.instances.append(self)

    def start(self):
        pass

    def cancel(self):
        self.cancelled = True

    def fire(self):
        if not self.cancelled:
            self.callback()


@pytest.fixture(autouse=True)
def clear_timers():
    ManualTimer.instances.clear()
    yield



def make_agent(**kw):
    spoken = []
    agent = (
        AgentFlow()
        .use_embeddings(False)
        .speak_with(spoken.append)
        .timers_with(ManualTimer)
    )
    agent.load()
    return agent, spoken


# -- matchers --------------------------------------------------------------

def test_substring_matcher_longest_wins():
    m = SubstringMatcher({"lights": ["lights"], "lights_off": ["turn off the lights"]})
    assert m.match("please turn off the lights now") == "lights_off"
    # Bidirectional substring: "the lights" is inside the longer phrase too,
    # and the longest phrase wins (reference semantics).
    assert m.match("the lights") == "lights_off"
    assert m.match("lights flickering") == "lights"
    assert m.match("open the door") is None
    assert m.match("") is None


def test_substring_matcher_score():
    m = SubstringMatcher({"a": ["hello"]})
    key, score = m.match_with_score("hello")
    assert key == "a" and score == 1.0


class FakeBackend:
    """Embeds strings as bag-of-chars vectors for deterministic cosine."""

    def calculate_embedding(self, text):
        import numpy as np

        v = np.zeros(26, np.float32)
        for ch in text.lower():
            if "a" <= ch <= "z":
                v[ord(ch) - 97] += 1
        return v

    def distance(self, a, b):
        from moonshine_tpu_torch.models.gemma import cosine_similarity

        return cosine_similarity(a, b)


def test_phrase_matcher_with_backend():
    m = PhraseMatcher(
        FakeBackend(),
        {"yes": ["yes", "yeah"], "no": ["no", "nope"]},
        threshold=0.6,
    )
    assert m.match("yes") == "yes"
    assert m.match("nope") == "no"
    key, score = m.match_with_score("qqq")
    assert score <= 1.0


def test_phrase_matcher_requires_backend():
    with pytest.raises(ValueError):
        PhraseMatcher(None, {})


# -- dialog ----------------------------------------------------------------

def test_dialog_prompt_builders():
    d = Dialog("hi there")
    assert d.trigger_phrase == "hi there"
    s = d.say("hello")
    assert isinstance(s, Say) and s.text == "hello"
    a = d.ask("name?")
    assert isinstance(a, Ask)
    c = d.confirm("sure?")
    assert isinstance(c, Confirm)
    ch = d.choose("pick", {"a": ["one"]})
    assert isinstance(ch, Choose)
    replay = d.replay_last_prompt()
    assert replay.text == "pick"
    with pytest.raises(DialogCancelled):
        d.cancel()


# -- runner ----------------------------------------------------------------

def test_trigger_starts_flow_and_say_speaks():
    agent, spoken = make_agent()
    ran = []

    def flow(d):
        yield d.say("starting")
        ran.append(True)

    agent.listen_for("set up wifi", flow)
    agent.handle_utterance("set up wifi")
    assert spoken == ["starting"]
    assert ran == [True]


def test_unmatched_goes_to_otherwise():
    agent, spoken = make_agent()
    other = []
    agent.otherwise(other.append)
    agent.listen_for("do the thing", lambda d: iter(()))
    agent.handle_utterance("completely unrelated words")
    assert other == ["completely unrelated words"]


def test_ask_round_trip():
    agent, spoken = make_agent()
    answers = []

    def flow(d):
        name = yield d.ask("what is your name?")
        answers.append(name)
        yield d.say(f"hello {name}")

    agent.listen_for("introduce", flow)
    agent.handle_utterance("introduce")
    assert spoken == ["what is your name?"]
    agent.handle_utterance("alice")
    assert answers == ["alice"]
    assert spoken[-1] == "hello alice"


def test_confirm_yes_no():
    agent, spoken = make_agent()
    results = []

    def flow(d):
        ok = yield d.confirm("launch the rocket?")
        results.append(ok)

    agent.listen_for("launch", flow)
    agent.handle_utterance("launch")
    agent.handle_utterance("yes")
    assert results == [True]

    agent.handle_utterance("launch")
    agent.handle_utterance("nope")
    assert results == [True, False]


def test_choose_matches_option_key_and_phrases():
    agent, spoken = make_agent()
    picks = []

    def flow(d):
        pick = yield d.choose("which?", {"tea": ["a cuppa"], "coffee": ["espresso"]})
        picks.append(pick)

    agent.listen_for("drinks", flow)
    agent.handle_utterance("drinks")
    agent.handle_utterance("espresso please")
    assert picks == ["coffee"]


def test_timeout_reprompts_then_gives_up():
    agent, spoken = make_agent()
    answers = []

    def flow(d):
        a = yield d.ask("question?", max_retries=1)
        answers.append(a)

    agent.listen_for("go", flow)
    agent.handle_utterance("go")
    assert len(ManualTimer.instances) == 1
    ManualTimer.instances[-1].fire()  # first timeout -> reprompt
    assert "Sorry, I didn't catch that. question?" in spoken[-1]
    ManualTimer.instances[-1].fire()  # second timeout -> give up with None
    assert answers == [None]


def test_cancel_global_mid_flow():
    agent, spoken = make_agent()
    finished = []

    def flow(d):
        yield d.ask("step one?")
        finished.append(True)

    agent.listen_for("begin", flow)
    agent.handle_utterance("begin")
    agent.handle_utterance("cancel")
    assert finished == []
    # Flow gone: next utterance re-triggers.
    agent.handle_utterance("begin")
    assert spoken.count("step one?") == 2


def test_cancel_is_flow_scoped():
    """'cancel' with no active flow must fall through to triggers/otherwise
    (reference: agent_flow.py flow-scoped globals rationale)."""
    agent, spoken = make_agent()
    other = []
    agent.otherwise(other.append)
    agent.listen_for("something", lambda d: iter(()))
    agent.handle_utterance("cancel")
    assert other == ["cancel"]


def test_start_over_restarts_flow():
    agent, spoken = make_agent()

    def flow(d):
        yield d.say("welcome")
        yield d.ask("name?")

    agent.listen_for("hello", flow)
    agent.handle_utterance("hello")
    agent.handle_utterance("start over")
    assert spoken.count("welcome") == 2


def test_throwing_flow_does_not_wedge_runner():
    agent, spoken = make_agent()
    errors = []
    agent.on_error(errors.append)

    def bad_flow(d):
        yield d.say("about to blow")
        raise RuntimeError("boom")

    agent.listen_for("explode", bad_flow)
    agent.handle_utterance("explode")
    assert len(errors) == 1
    # Runner still alive:
    agent.handle_utterance("explode")
    assert len(errors) == 2


def test_mute_during_speech():
    agent, spoken = make_agent()
    mutes = []
    agent.mute_with(mutes.append)
    agent.listen_for("talk", lambda d: iter([Say("hi")]))

    def flow(d):
        yield d.say("hi")

    agent.listen_for("talk", flow)
    agent.handle_utterance("talk")
    assert mutes == [True, False]


def test_ask_spelled_mode_accumulates_until_stop():
    from moonshine_tpu_torch.agent.flow import SPELLED

    agent, spoken = make_agent()
    answers = []

    def flow(d):
        code = yield d.ask("spell it", mode=SPELLED)
        answers.append(code)

    agent.listen_for("spell", flow)
    agent.handle_utterance("spell")
    for u in ("bravo", "oscar", "bee"):
        agent.handle_utterance(u)
    assert answers == []  # still collecting
    agent.handle_utterance("stop")
    assert answers == ["bob"]


def test_ask_digits_mode():
    from moonshine_tpu_torch.agent.flow import DIGITS

    agent, spoken = make_agent()
    answers = []

    def flow(d):
        pin = yield d.ask("say your pin", mode=DIGITS)
        answers.append(pin)

    agent.listen_for("pin", flow)
    agent.handle_utterance("pin")
    agent.handle_utterance("four")
    agent.handle_utterance("bravo")  # rejected in digits mode
    agent.handle_utterance("seven")
    agent.handle_utterance("done")
    assert answers == ["47"]


def test_spelled_mode_owns_command_words():
    """'start over' during a SPELLED ask clears the buffer instead of
    restarting the whole flow."""
    from moonshine_tpu_torch.agent.flow import SPELLED

    agent, spoken = make_agent()
    answers = []

    def flow(d):
        yield d.say("welcome")
        code = yield d.ask("spell", mode=SPELLED)
        answers.append(code)

    agent.listen_for("dictate", flow)
    agent.handle_utterance("dictate")
    agent.handle_utterance("alpha")
    agent.handle_utterance("start over")  # CLEAR, not flow restart
    assert spoken.count("welcome") == 1
    agent.handle_utterance("bravo")
    agent.handle_utterance("stop")
    assert answers == ["b"]


class TestCachedEmbeddings:
    def test_tsv_roundtrip(self, tmp_path):
        import numpy as np

        from moonshine_tpu_torch.agent.cached_embeddings import (
            load_cached_embeddings, save_cached_embeddings,
        )

        vecs = {"yes": np.arange(4, dtype=np.float32),
                "no way": np.ones(4, np.float32) * -0.5}
        p = tmp_path / "cache.tsv"
        save_cached_embeddings(p, vecs, {"model_name": "test"})
        loaded, meta = load_cached_embeddings(p)
        assert meta["model_name"] == "test"
        assert meta["embedding_dim"] == "4"
        assert set(loaded) == set(vecs)
        np.testing.assert_array_equal(loaded["yes"], vecs["yes"])

    def test_cache_hits_skip_embedder(self, tmp_path):
        import numpy as np

        from moonshine_tpu_torch.agent.cached_embeddings import (
            build_cached_embeddings,
        )
        from moonshine_tpu_torch.agent.flow import AgentFlow

        calls = []

        class FakeEmbedder:
            def get_embeddings(self, text):
                calls.append(text)
                # deterministic fake embedding
                v = np.zeros(8, np.float32)
                v[hash(text) % 8] = 1.0
                return v

        emb = FakeEmbedder()
        p = tmp_path / "cache.tsv"
        build_cached_embeddings(emb, ["hello there", "set a timer"], p)
        assert calls == ["hello there", "set a timer"]
        calls.clear()

        agent = (
            AgentFlow()
            .use_embedder(emb)
            .with_cached_embeddings(p)
            .speak_with(lambda t: None)
            .listen_for("set a timer", lambda d: iter(()))
            .load()
        )
        agent.handle_utterance("set a timer")  # exact cached phrase
        assert "set a timer" not in calls  # served from the TSV cache


# -- the port's embedder behind the matchers and the flow --------------------

import jax  # noqa: E402

from moonshine_tpu.agent import cached_embeddings as jcache  # noqa: E402
from moonshine_tpu.agent import flow as jflow  # noqa: E402
from moonshine_tpu.models import gemma as jg  # noqa: E402
from moonshine_tpu_torch import weights  # noqa: E402
from moonshine_tpu_torch.agent import cached_embeddings as tcache  # noqa: E402
from moonshine_tpu_torch.agent import flow as tflow  # noqa: E402
from moonshine_tpu_torch.models import gemma as tg  # noqa: E402
from chip_smoke import ByteTokenizer, converse  # noqa: E402

SMALL = jg.GemmaTextConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
    num_kv_heads=2, head_dim=16, sliding_window=8, global_layer_interval=2,
    query_pre_attn_scalar=16.0, projection_hidden=96, embedding_dim=48, max_seq_length=64,
)
SCORE_TOL = 1e-5
UTTERANCES = ["yes", "yeah sure", "no", "nope", "stop that", "maybe later", "do it",
              "tea please", "an espresso", "cancel", "what", "", "start over", "set a timer"]


@pytest.fixture(scope="module")
def embedders():
    jparams = jg.init_params(SMALL, jax.random.PRNGKey(0))
    model = weights.gemma_params_from_jax_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return (jg.GemmaEmbedder(jparams, SMALL, ByteTokenizer()),
            tg.GemmaEmbedder(model, tg.GemmaTextConfig(**SMALL.__dict__), ByteTokenizer(),
                             device="cpu"))


PHRASE_SETS = [
    ({"yes": list(tflow._DEFAULT_YES), "no": list(tflow._DEFAULT_NO)}, 0.55),
    ({"tea": ["a cuppa", "tea"], "coffee": ["espresso", "coffee"], "water": ["water"]}, 0.55),
    ({"cancel": ["cancel"], "start over": ["start over"]}, 0.7),
]


@pytest.mark.parametrize("phrases,threshold", PHRASE_SETS)
def test_phrase_matcher_matches_jax(embedders, phrases, threshold):
    jemb, temb = embedders
    ours = tflow.PhraseMatcher(tflow.EmbeddingBackend(temb), phrases, threshold=threshold)
    ref = jflow.PhraseMatcher(jflow.EmbeddingBackend(jemb), phrases, threshold=threshold)
    for u in UTTERANCES:
        (k1, s1), (k2, s2) = ours.match_with_score(u), ref.match_with_score(u)
        print(f"{u!r}: port {k1} {s1:.6f}, jax {k2} {s2:.6f}, margin {s1 - threshold:+.6f}")
        assert k1 == k2, u
        assert abs(s1 - s2) <= SCORE_TOL, u


def test_scripted_conversation_matches_jax(embedders, tmp_path):
    """chip_smoke.py's conversation (a trigger, an Ask with a timeout
    reprompt, a Confirm, a Choose, a cancel) through both packages'
    AgentFlow: the same prompts, results and keys, scores within 1e-5; and
    through the port's again on a cached-embeddings TSV of its phrases."""
    jemb, temb = embedders
    ours, ref = converse(tflow, temb), converse(jflow, jemb)
    for k in ("spoken", "results", "otherwise"):
        assert ours[k] == ref[k]
    assert [m[:2] + m[3:] for m in ours["matches"]] == [m[:2] + m[3:] for m in ref["matches"]]
    assert max(abs(a[2] - b[2]) for a, b in zip(ours["matches"], ref["matches"])) <= SCORE_TOL
    assert ours["spoken"][:2] == ["what is your name?",
                                  "Sorry, I didn't catch that. what is your name?"]
    phrases = sorted({m[0] for m in ours["matches"]} | set(tflow._DEFAULT_YES))
    path = tmp_path / "phrases.tsv"
    tcache.build_cached_embeddings(temb, phrases, path)
    cached = converse(tflow, temb, cached_path=path)
    assert [cached[k] for k in ("spoken", "results")] == [ours[k] for k in ("spoken", "results")]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cached_embeddings_across_packages(embedders, tmp_path, writer):
    jemb, temb = embedders
    phrases = list(tflow._DEFAULT_YES) + list(tflow._DEFAULT_NO) + ["order a drink"]
    path = tmp_path / "cache.tsv"
    if writer == "jax":
        built = jcache.build_cached_embeddings(jemb, phrases, path, {"model_name": "small"})
    else:
        built = tcache.build_cached_embeddings(temb, phrases, path, {"model_name": "small"})
    (ours, tmeta), (ref, jmeta) = tcache.load_cached_embeddings(path), \
        jcache.load_cached_embeddings(path)
    assert tmeta == jmeta and tmeta["embedding_dim"] == str(SMALL.embedding_dim)
    assert list(ours) == list(ref) == phrases
    for p in phrases:
        np.testing.assert_array_equal(ours[p], ref[p])
        np.testing.assert_array_equal(ours[p], built[p])
        np.testing.assert_allclose(ours[p], temb.get_embeddings(p), atol=SCORE_TOL, rtol=0)
    # A flow on the cache decides as the live embedder does.
    cached = tflow.AgentFlow().use_embedder(temb).with_cached_embeddings(path)
    live = tflow.AgentFlow().use_embedder(temb)
    yes_no = {"yes": list(tflow._DEFAULT_YES), "no": list(tflow._DEFAULT_NO)}
    for u in UTTERANCES:
        assert cached._make_matcher(yes_no, 0.55).match(u) == \
            live._make_matcher(yes_no, 0.55).match(u)
