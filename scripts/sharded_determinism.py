#!/usr/bin/env python3
"""Run-to-run determinism of the sharded inference path on one CUDA card.

    python3 scripts/sharded_determinism.py [--tree ROOT] [--k1-runs 400] [--encodes 40]
                                           [--cudnn-deterministic] [--after-batched]

``chip_smoke.py [sharded path]`` holds the sharded encode (``attn_impl=
"pallas_shmap"`` on a world-1 NCCL group and its 1x1 mesh) bit for bit
against ``attn_impl="auto"``.  This script looks for run-to-run differences
behind that check, in the checkout at ROOT (this one unless named; a
parent unpacked with ``git archive`` into a directory that .gitignore
lists runs with this script): Base bf16 at the bench's B=64 clips of
9.26 s, it runs K1 on the first encoder layer's q, k, v ``--k1-runs``
times in bf16 and half as many in float32, then encodes the clips
``--encodes`` times each way; before every twentieth K1 run and every
encode it churns the CUDA caching allocator (random allocations, sometimes
an ``empty_cache``), as the phases before ``[sharded path]`` leave it.
Every output is compared bit for bit with the first.  Then it runs
``chip_smoke.phase_sharded`` itself.  ``--after-batched`` first runs
``chip_smoke.phase_batched`` (greedy, B=64) and ``phase_beam`` (beam 4, 128
clips) in the same process, as chip_smoke.py runs them before ``[sharded
path]``.  Prints the card and one line per
check; exits 1 if anything differed.

Two settings that nothing in the port fixes can be tried here:
``--cudnn-deterministic`` sets ``torch.backends.cudnn.deterministic`` (the
frontend's convolutions), and ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
environment fixes cuBLAS's workspace (products issued while NCCL's stream
is live).  The script prints both.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="root of the checkout to test")
    parser.add_argument("--k1-runs", type=int, default=400)
    parser.add_argument("--encodes", type=int, default=40)
    parser.add_argument("--cudnn-deterministic", action="store_true",
                        help="set torch.backends.cudnn.deterministic")
    parser.add_argument("--after-batched", action="store_true",
                        help="run chip_smoke's batched greedy and beam phases first")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)

    import torch

    if not torch.cuda.is_available():
        print("sharded_determinism.py needs a CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    import chip_smoke as cs
    from moonshine_tpu_torch.core.config import BASE, TINY
    from moonshine_tpu_torch.models import moonshine as mm
    from moonshine_tpu_torch.ops import _build
    from moonshine_tpu_torch.ops import beam_gather as bg
    from moonshine_tpu_torch.ops import encoder_attention as ea
    from moonshine_tpu_torch.ops.rotary import rotary_tables
    from moonshine_tpu_torch.parallel.distributed import initialize
    from moonshine_tpu_torch.parallel.mesh import make_mesh
    from moonshine_tpu_torch.parallel.sharding import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.cudnn_deterministic
    _build.build()
    print(f"{cs.card_line()}; checkout {tree}; cudnn.deterministic="
          f"{torch.backends.cudnn.deterministic}; CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}", flush=True)
    if args.after_batched:
        t0 = time.perf_counter()
        cs.phase_batched(ea, BASE, 64, cs.card_line())
        cs.phase_beam(ea, bg, BASE, 128, cs.card_line())
        print(f"phase_batched and phase_beam ran first, in {time.perf_counter() - t0:.1f} s",
              flush=True)
    g = torch.Generator().manual_seed(5)
    held = []

    def churn():
        held.clear()
        for _ in range(int(torch.randint(1, 20, (1,), generator=g))):
            n = int(torch.randint(1, 50_000_000, (1,), generator=g))
            held.append(torch.empty(n, dtype=torch.uint8, device="cuda").fill_(7))
        if torch.rand(1, generator=g).item() < 0.5:
            held.clear()
            torch.cuda.empty_cache()

    differed = 0
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # a group of one host
    initialize()
    mesh = make_mesh(data=1, model=1)
    with torch.inference_mode():
        model, audio, caps, _ = cs._bench_inputs(BASE, 64)
        feats, _ = mm.frontend_apply(model.frontend, BASE, audio)
        cos, sin = rotary_tables(torch.arange(feats.shape[1], device="cuda"), BASE.rotary_dim,
                                 BASE.rope_theta)
        q, k, v = mm._encoder_qkv(BASE, feats, model.encoder.layers[0], cos, sin)
        kt = k.transpose(1, 2).contiguous()
        for dtype, runs in ((torch.bfloat16, args.k1_runs), (torch.float32, args.k1_runs // 2)):
            qd, ktd, vd = q.to(dtype), kt.to(dtype), v.to(dtype)
            ref = ea.encoder_attention_packed(qd, ktd, vd, None, BASE.encoder_heads).clone()
            bad = 0
            for i in range(runs):
                if i % 20 == 0:
                    churn()
                out = ea.encoder_attention_packed(qd, ktd, vd, None, BASE.encoder_heads)
                bad += not torch.equal(out, ref)
            differed += bad
            print(f"K1 {str(dtype)[6:]} at {tuple(q.shape)}: {bad} of {runs} runs differ from "
                  "the first", flush=True)
        ref = mm.encode(model, BASE, audio, attn_impl="auto")[0].clone()
        rows, _ = shard_batch(mesh, (audio, caps))
        counts = {"auto": 0, "pallas_shmap": 0}
        for _ in range(args.encodes):
            churn()
            for impl in counts:
                kw = {"mesh": mesh} if impl == "pallas_shmap" else {}
                memory = mm.encode(model, BASE, rows if kw else audio, attn_impl=impl, **kw)[0]
                counts[impl] += not torch.equal(memory, ref)
        differed += sum(counts.values())
        print(f"encode B=64 bf16, {args.encodes} runs each way: differing from the first auto "
              f"encode {counts}", flush=True)
    held.clear()
    dist.destroy_process_group()
    t0 = time.perf_counter()
    try:
        checks = cs.phase_sharded(ea, bg, BASE, TINY, 64, cs.card_line())["checks"]
        print(f"chip_smoke.phase_sharded passed in {time.perf_counter() - t0:.1f} s: {checks}")
    except SystemExit as e:
        differed += 1
        print(f"chip_smoke.phase_sharded failed: {e}")
    return 1 if differed else 0


if __name__ == "__main__":
    sys.exit(main())
