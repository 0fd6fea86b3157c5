#!/usr/bin/env python3
"""Can the Mamba2 logits check judge K4's precision?  A witness on one
NVIDIA GPU.

    python3 chip_k4_logits.py [--seeds 0 1 2 3 4 5]

For each seed, mamba2-780m at full width (random weights from that seed)
runs what ``chip_smoke.py``'s phase 10 reads: a batch prefill of 4 x 384
tokens, a ragged prefill of 250 and the first greedy decode step (its
tokens from the plain path's prefill).  Each variant's logits are read
against the plain versions' as phase 10 reads them: max |diff| over
``SERVE_RTOL`` x max |logit|, so a reading above 1 fails that check.
mamba2-780m has no attention, so K4 is the only kernel in which the
variants and the plain path differ.  The variants:

- ``parts3``: the kernels as they ship (K4's W in three bf16 parts);
- ``parts2``: K4's W in two bf16 parts (``ssd_chunk.W_PARTS = 2``);
- ``fma``: K4 through its fp32 FMA instance on the same bf16 values
  cast to fp32;
- ``fp64``: K4's plain formula in float64, rounded to fp32 once: no bf16
  parts, each call off the plain version only by the plain version's own
  fp32 rounding.

Each reading also gives K4's largest per-call error over the run's calls,
over its limit ``K4_RTOL`` x max |plain| (``chip_smoke.tapped``).  Before
the seeds, what the third part costs: K4's device-only ms at phase 9's
two batch-prefill shapes with W in three and in two parts, in turns 3, 2,
2, 3.  Prints one line per reading, then one JSON line of them all.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import chip_smoke as cs

VARIANTS = ("parts3", "parts2", "fma", "fp64")


def _fma_k4(ssd):
    """``ops.ssd_intra_chunk`` with its kernel calls sent to the fp32
    instance on the same values."""
    def call(xb, dtb, cum, Bb, Cb, *, use_kernel=None):
        if use_kernel is False:
            return ssd(xb, dtb, cum, Bb, Cb, use_kernel=False)
        return ssd(xb.float(), dtb, cum, Bb.float(), Cb.float(),
                   use_kernel=use_kernel)
    return call


def _fp64_k4(ssd):
    """``ops.ssd_intra_chunk`` with its kernel calls replaced by the plain
    formula in float64."""
    def call(xb, dtb, cum, Bb, Cb, *, use_kernel=None):
        if use_kernel is False:
            return ssd(xb, dtb, cum, Bb, Cb, use_kernel=False)
        Q = xb.shape[1]
        scores = Cb.double() @ Bb.double().transpose(1, 2)
        seg = cum.double()[:, :, None, :] - cum.double()[:, None, :, :]
        mask = torch.ones((Q, Q), dtype=torch.bool,
                          device=xb.device).tril()[None, :, :, None]
        W = scores[..., None] * torch.where(mask, seg.exp(), 0.0) * \
            dtb.double()[:, None, :, :]
        return torch.einsum("bijh,bjhp->bihp", W, xb.double()).float()
    return call


def time_parts() -> dict:
    """K4's device-only ms per W part count at phase 9's two batch-prefill
    shapes (``chip_smoke.K4_CASES[:2]``), on phase 9's inputs."""
    from repro_torch.kernels import ops, ssd_chunk
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    parts, out = ssd_chunk.W_PARTS, {}
    for arch, Bc, Q, H, N in cs.K4_CASES[:2]:
        args = cs._ssd_inputs(gen, Bc, Q, H, N)
        row = out[arch] = {"parts3": [], "parts2": []}
        for n in (3, 2, 2, 3):
            try:
                ssd_chunk.W_PARTS = n
                row[f"parts{n}"].append(cs.device_ms(
                    lambda: ops.ssd_intra_chunk(*args, use_kernel=True),
                    key="ssd_intra"))
            finally:
                ssd_chunk.W_PARTS = parts
        cs.log(f"[{arch} Bc={Bc} Q={Q} H={H} N={N}] K4 device-only ms: "
               f"three parts {row['parts3']}, two parts {row['parts2']}")
        del args
    return out


def read_seed(seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ssd_chunk
    from repro_torch.weights import init_params
    cfg = get_config("mamba2-780m")
    model = init_params(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    batch = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (cs.SSM_BATCH, cs.SSM_PROMPT))).cuda()
    single = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (1, cs.SSM_RAGGED))).cuda()
    with ops.plain_versions():
        p_batch, st = model.prefill_state(batch)
        p_single, _ = model.prefill_state(single)
        tok = p_batch.argmax(-1)
        p_step, _ = model.decode_state(st, tok)

    def path():
        b_logits, st = model.prefill_state(batch)
        s_logits, _ = model.prefill_state(single)
        step, _ = model.decode_state(st, tok)
        return b_logits, s_logits, step

    out = {}
    parts, ssd = ssd_chunk.W_PARTS, ops.ssd_intra_chunk
    for variant in VARIANTS:
        try:
            ssd_chunk.W_PARTS = 2 if variant == "parts2" else parts
            if variant in ("fma", "fp64"):
                ops.ssd_intra_chunk = (_fma_k4 if variant == "fma"
                                       else _fp64_k4)(ssd)
            logits, reads = cs.tapped(path)
        finally:
            ssd_chunk.W_PARTS, ops.ssd_intra_chunk = parts, ssd
        torch.cuda.synchronize()
        r = {what: float((a - p).abs().max())
             / (cs.SERVE_RTOL * float(p.abs().max()))
             for what, a, p in zip(("batch", "ragged", "step"), logits,
                                   (p_batch, p_single, p_step))}
        k4 = reads["ssd_intra_chunk"]
        r["k4_call"] = k4["err"] / k4["limit"]
        r["k4_err"] = k4["err"]
        out[variant] = r
        cs.log(f"[seed {seed}] {variant}: logits / limit: batch prefill "
               f"{r['batch']:.4f}, ragged prefill {r['ragged']:.4f}, first "
               f"step {r['step']:.4f}; K4 per call max |diff| "
               f"{k4['err']:.3e} ({r['k4_call']:.5f} of its limit, "
               f"{k4['calls']} calls)")
    del model
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[0, 1, 2, 3, 4, 5])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_k4_logits: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_device()
    ms = time_parts()
    res = {str(seed): read_seed(seed) for seed in args.seeds}
    print(json.dumps({"smi": smi, "device_ms": ms, "readings": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
