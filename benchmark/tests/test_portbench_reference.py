"""The plain reference against moonshine_tpu_torch at a small size on the
CPU, float32 on both sides: the encoder's memory, the decoder's logits
through the int8 KV cache, and the memory and decoder of a service's
streams after its updates (the schedule replayed by the reference)."""

import numpy as np
import pytest
import torch
from portbench import gap, spec
from portbench.drivers.common import benchmark_weights, meta_model, program_model, tuples
from portbench.weights import leaf_shapes
from reference import moonshine as ref_base
from reference import streaming as ref_stream
from reference.numerics import Products
from tiny import TINY_ARCH

F32 = Products("float32")


def _base():
    from moonshine_tpu_torch.core.config import MoonshineArchConfig
    from moonshine_tpu_torch.models import moonshine as mm

    arch = dict(spec.load_json(spec.BENCH_DIR / "configs" / "moonshine_base.json")["arch"],
                **TINY_ARCH["moonshine_base"])
    cfg = MoonshineArchConfig(**tuples(arch))
    meta = meta_model(mm.init_params, cfg)
    w = benchmark_weights(leaf_shapes(meta), 99, "cpu", ())
    model = mm.prepare_rotary_params(program_model(meta, w, "cpu"), cfg, refresh=True)
    return arch, cfg, mm, model, w


def test_encode_matches_the_program():
    arch, cfg, mm, model, w = _base()
    audio = torch.randn(16000 * 3 + 123, generator=torch.Generator().manual_seed(1)) * 0.1
    padded = torch.nn.functional.pad(audio, (0, 9000))[None]
    with torch.inference_mode():
        memory, mask = mm.encode(model, cfg, padded, torch.tensor([audio.numel()]))
    ref = ref_base.encode(w, arch, audio, F32)
    t = ref.shape[0]
    assert int(mask.sum()) == t
    torch.testing.assert_close(memory[0, :t], ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_int8", [True, False])
def test_decoder_logits_match_the_program(kv_int8):
    arch, cfg, mm, model, w = _base()
    audio = torch.randn(16000 * 2, generator=torch.Generator().manual_seed(2)) * 0.1
    with torch.inference_mode():
        memory, mask = mm.encode(model, cfg, audio[None], torch.tensor([audio.numel()]))
        kc, vc = mm.compute_cross_kv(model.decoder, cfg, memory)
        tokens = [1, 17, 300, 300, 4, 511, 2, 9]
        cache = mm.init_cache(cfg, 1, len(tokens), kc, vc, mask, kv_int8=kv_int8)
        rows = []
        for tok in tokens:  # one position a call, as greedy_decode feeds it
            logits, cache, _ = mm.decoder_apply(model.decoder, cfg, torch.tensor([[tok]]), cache)
            rows.append(logits[0, -1])
        program = torch.stack(rows)
    ref = ref_base.forced_logits(w, ref_base.decoder_dims(arch), memory[0], torch.tensor(tokens),
                                 F32, kv_int8)
    torch.testing.assert_close(program, ref, atol=2e-4, rtol=1e-4)
    assert gap.served_gap(ref, program.argmax(-1)) < 1e-4


def test_service_streams_match_the_replayed_reference():
    """Two float32 streams through StreamingService for seven updates, the
    first past its third block of memory (where the window's read clamps
    at depth 10), the second closing a segment at the 4 s split: the
    memory of the open segment, and the decoder over it, against the
    reference's replay of the same feeds."""
    from moonshine_tpu_torch.core.config import StreamingConfig
    from moonshine_tpu_torch.models import streaming as ms
    from moonshine_tpu_torch.models import streaming_batch as sb
    from moonshine_tpu_torch.serving import StreamingService

    arch = dict(spec.load_json(spec.BENCH_DIR / "configs" / "moonshine_medium_streaming.json")
                ["arch"], **TINY_ARCH["moonshine_medium_streaming"])
    cfg = StreamingConfig(**arch)
    meta = meta_model(ms.init_params, cfg)
    w = benchmark_weights(leaf_shapes(meta), 5, "cpu", ())
    model = program_model(meta, w, "cpu")
    svc = StreamingService(model, cfg, None, 2, update_frames=128, mem_bucket=896, draft_cap=32,
                           max_segment_seconds=4.0, device="cpu")
    for i in range(2):
        svc.open_slot(i)
    sched = ref_stream.ServiceSchedule(arch, 2, 128, 4.0, 6.5)
    audio = (np.random.default_rng(0).standard_normal((2, 16000 * 8)) * 0.1).astype(np.float32)
    fed = [0, 0]
    for u in range(7):
        for i, n in ((0, 10240 if u < 6 else 0), (1, 10240 + (4000 if u == 0 else 0))):
            svc.add_audio(i, audio[i, fed[i]:fed[i] + n])
            sched.add_audio(i, n)
            fed[i] += n
        svc.update()
        sched.update([0, 1])
    state = svc.state
    open_segments = [s for s in sched.segments if not s.final and s.samples]
    assert max(s.samples for s in open_segments) > 3 * 128 * 80
    for seg in open_segments:
        slot = seg.slot
        stream = torch.from_numpy(audio[slot, seg.start_sample:seg.start_sample + seg.samples])
        mem = ref_stream.segment_memory(w, arch, stream, seg.passes, F32)
        n = int(state.mem_len[slot])
        assert n == mem.shape[0]
        torch.testing.assert_close(state.memory[slot, :n], mem, atol=2e-4, rtol=1e-4)
        one = sb._single(state, slot)
        tokens = torch.tensor([1, 40, 41, 7, 7])
        with torch.inference_mode():
            logits, _, _ = ms.decode_tokens(model, cfg, tokens, ms.decoder_reset(one),
                                            mem_bucket=896)
        ref = ref_stream.forced_logits(w, arch, mem, tokens, F32, kv_int8=False)
        torch.testing.assert_close(logits, ref, atol=2e-4, rtol=1e-4)
    assert any(s.final for s in sched.segments)  # slot 1's first segment closed
