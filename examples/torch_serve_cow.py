"""Serving example of the PyTorch port: batched requests + parallel
sampling via CoW fork.

The counterpart of ``examples/serve_cow.py``: admission (prefill staged
into the pool with FPM copies), fork-heavy parallel sampling (CoW shares,
lazy zeros), decode over the shared paged pool driven by the engine's
**CommandStream** (each round's bulk movement drains as one launch whose
FlushTicket is counted), and the engine stats that mirror the paper's
Table 1 / Fig 2 quantities.  The weights are random, from seed 0.

    PYTHONPATH=src python examples/torch_serve_cow.py --arch yi-6b \\
        --requests 4 [--device cpu]

It serves the reduced config of ``--arch`` on any device, as the
reference does (fp32 at head dim 32: the card runs K1-K3's fp32
instances).
"""
import argparse
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import BlockRef
from repro_torch.launch.serve import ServingEngine
from repro_torch.obs import metrics as obs_metrics
from repro_torch.weights import init_params


class ServeRun(NamedTuple):
    """What a run leaves: the engine, its decode rounds, the largest bulk
    launch count of a round, and the decode's seconds and tokens."""

    engine: ServingEngine
    rounds: int
    max_launches: int
    seconds: float
    tokens: int


def main(argv=None) -> ServeRun:
    """Admit, fork, sample and report on ``--device`` (default the card;
    without a GPU pass ``--device cpu``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--samples-per-request", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--staging-ring", type=int, default=4,
                    help="staging slots (max_admit_pages): a small ring "
                         "instead of full-size staging twins halves the "
                         "engine's resident pool bytes; 0 = full twin, "
                         "-1 = derive from the admission policy")
    ap.add_argument("--double-buffer", action="store_true",
                    help="double-buffered ring: admission bursts past "
                         "the ring capacity stay at 1.0 launches/round")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, seed=0, device=args.device)
    eng = ServingEngine(cfg, params,
                        max_seqs=args.requests * (args.samples_per_request
                                                  + 1) + 2,
                        max_admit_pages=(None if args.staging_ring < 0
                                         else args.staging_ring),
                        double_buffer=args.double_buffer,
                        device=args.device)
    g = eng.engine.group
    print("[serve] pool address space: " + "  ".join(
        f"{s.name}[nblk={s.nblk} base={g.base(s.name)}]" for s in g))
    print(f"[serve] resident pool bytes: "
          f"{eng.engine.pool_bytes_resident() / 1e6:.1f} MB "
          f"(staging ring: {eng.engine.stage_capacity} slots)")
    rng = np.random.default_rng(0)

    print(f"[serve] admitting {args.requests} prompts "
          f"({args.prompt_len} tokens each)")
    parents = []
    for _ in range(args.requests):
        p = rng.integers(2, cfg.vocab_size,
                         size=args.prompt_len).astype(np.int32)
        parents.append(eng.add_request(p))

    print(f"[serve] forking {args.samples_per_request} samples per prompt "
          f"(CoW: zero bytes move)")
    for sid in parents:
        eng.fork(sid, args.samples_per_request)
    a = eng.engine.alloc.stats
    print(f"         cow_shares={a.cow_shares} "
          f"fpm_copies={eng.engine.stats.fpm_copies}")

    # temperature sampling so forks diverge
    def sampler(logits):
        z = logits / 1.0
        z = z - z.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(rng.choice(len(p), p=p))

    # keep only the tickets' COUNTERS: a retained ticket pins the pools'
    # generation it describes
    rounds = moved_rounds = total_cmds = max_launches = 0
    on_card = eng.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(eng.device)
    with obs_metrics.Stopwatch() as sw:
        for step in range(args.new_tokens):
            eng.decode_round(sample_fn=sampler)
            t = eng.last_ticket
            rounds += 1
            if t is not None and t.moved:
                moved_rounds += 1
                total_cmds += t.commands
                max_launches = max(max_launches, t.launches)
        if on_card:
            torch.cuda.synchronize(eng.device)
    dt = sw.s
    n = len(eng.cache.seqs)
    print(f"[serve] generated {args.new_tokens} tokens x {n} sequences in "
          f"{dt:.1f}s ({args.new_tokens * n / dt:.1f} tok/s on "
          f"{eng.device})")
    print(f"[serve] stream '{eng.stream.name}': {rounds} round flushes, "
          f"{moved_rounds} moved bulk bytes ({total_cmds} commands, max "
          f"{max_launches} launch/round)")

    # explicit-stream coda: post-hoc bulk movement through a minted
    # stream — enqueue, flush, read the ticket's post-drain state
    demo = eng.engine.stream("demo")
    src = BlockRef("k", int(eng.cache.blocks_of(parents[0])[0]))
    spare = int(eng.engine.alloc.alloc(1)[0])   # a free block to copy into
    demo.memcopy([(src, BlockRef("k", spare))])
    ticket = demo.flush()
    blk = ticket.block_state(BlockRef("k", spare))
    print(f"[serve] demo stream flush: {ticket.commands} command(s), "
          f"{ticket.launches} launch(es), copied block shape "
          f"{tuple(blk.shape)}")

    s = eng.engine.stats
    a = eng.engine.alloc.stats
    print("\n=== RowClone effect (paper Fig.2 quantities) ===")
    print(f"  CoW shares (fork, 0 bytes):        {a.cow_shares}")
    print(f"  FPM copies (divergence CoW):        {s.fpm_copies}")
    print(f"  FPM same-slab placement hits:       {a.fpm_eligible}")
    print(f"  lazy-zeroed blocks (ZI):            {s.zero_lazy}")
    print(f"  bytes moved through compute:        {s.bytes_baseline}")
    print(f"  bytes moved by DMA (FPM):           {s.bytes_fpm}")
    print(f"  bytes avoided entirely (ZI+alias):  {s.bytes_avoided}")
    sample = parents[0]
    print("\nfirst prompt's sampled continuations (token ids):")
    kids = [sid for sid in eng.cache.seqs
            if eng.tokens[sid][:args.prompt_len] ==
            eng.tokens[sample][:args.prompt_len]]
    for sid in kids[:4]:
        print(f"  seq {sid}: {eng.tokens[sid][args.prompt_len:][:12]}...")
    return ServeRun(eng, rounds, max_launches, dt, args.new_tokens * n)


if __name__ == "__main__":
    main()
