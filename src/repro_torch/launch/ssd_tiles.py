"""Time K5 (the SSD intra-chunk kernel) at mamba2-2.7b's chunk shapes,
beside its bound, its plain version and two fp32 ``torch.bmm`` calls, and
profile one full-width mamba2 chunk step.

    python -m repro_torch.launch.ssd_tiles [--profile] [--out f.json]

Rows (operands from a seed; each time the median of CUDA-event timed
single calls with the L2 cache flushed between them, ``launch/timing.py``):

  path Q=256, path Q=32  the call ``ssd_chunked`` makes for one chunk
        step of 8 slots (B 8, nc 1, H 80, G 1, P 64, N 128) from x, dt,
        cums, B and C in their stored layout.  A tree with the grouped
        entry (``ssd_intra_chunked``) is timed on that call; an older tree
        through the per-head route its ``ssd_chunked`` took, timed whole:
        B and C broadcast to heads (``repeat_interleave``), the five
        operands copied heads-first, ``ssd_intra``, y viewed back.
  per-head G=640  ``ssd_intra`` on the reference's (G, Q, .) layout.

Bounds: the operands read once and y written once at 3.35 TB/s, or the
products (causal pairs; the score product once a group on the path, once
a head in the per-head layout) in 3xTF32 -- three TF32 products each --
at 495 TFLOP/s, whichever is longer.  No PyTorch call computes the
masked two-GEMM chain; two fp32 ``torch.bmm`` with the mask precomputed
are the context.

``--profile`` serves full-width mamba2-2.7b (random bf16 weights from
``--seed``, 8 slots, prompts of 2.5 chunks of 256) under both GEMM
backends and profiles the second chunk step: device time, kernel
launches, K5's time and the aten ops that launched the most device time
(the profiler's CPU-side names: which copies and elementwise passes the
step pays for).

The script reads only the public wrappers, so it also times an older
tree: copy this file and ``timing.py`` into that tree's ``launch/`` and
run it there.  Needs the card; prints the card's name and one line a
row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import ssd as SSD
from repro_torch.launch.timing import (bound_ms, card_line, kernel_ms,
                                       time_ms, top_ops)

PATH = dict(B=8, nc=1, H=80, G=1, P=64, N=128)


def path_inputs(Q: int, seed: int, dev, B=8, nc=1, H=80, G=1, P=64, N=128,
                fall=None, pad=0, strided=False):
    """x, b, c ~ N(0, 1), dt = softplus(N(0, 1)) (A = -1, the full-width
    init), cums = cumsum(-dt) within the chunk: (B, nc, Q, H, .) and B, C
    per group (B, nc, Q, G, N).  ``fall``: cums fall linearly by that much
    over the chunk instead; ``pad``: dt = 0 on the last rows (the engine's
    pad tail); ``strided``: x, B and C slices of one wider tensor, as the
    conv output's are."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = torch.randn(B, nc, Q, H * P + 2 * G * N, generator=gen,
                       device=dev)
    x, b, c = (wide[..., lo:hi] for lo, hi in (
        (0, H * P), (H * P, H * P + G * N), (H * P + G * N, None)))
    x = x.unflatten(-1, (H, P))
    b, c = (t.unflatten(-1, (G, N)) for t in (b, c))
    if not strided:
        x, b, c = (t.contiguous() for t in (x, b, c))
    dt = torch.nn.functional.softplus(
        torch.randn(B, nc, Q, H, generator=gen, device=dev))
    if pad:
        dt[:, :, Q - pad:] = 0.0
    cums = torch.cumsum(-dt, dim=2)
    if fall is not None:
        cums = torch.linspace(0.0, -fall, Q, device=dev)[:, None].expand(
            B, nc, Q, H).contiguous()
    return x, dt, cums, b, c


def per_head_route(x, dt, cums, b, c):
    """The per-head route of a tree without the grouped entry."""
    Bb, nc, Q, H, P = x.shape
    rep = H // b.shape[3]

    def heads_first(t):
        return t.movedim(3, 2).reshape(Bb * nc * H, Q, *t.shape[4:]) \
            .contiguous()

    bh, ch = (t.repeat_interleave(rep, dim=3) for t in (b, c))
    y = SSD.ssd_intra(*map(heads_first, (x, dt, cums, bh, ch)))
    return y.reshape(Bb, nc, H, Q, P).permute(0, 1, 3, 2, 4)


def path_call():
    """(label, the path's K5 call) of this tree."""
    if hasattr(SSD, "ssd_intra_chunked"):
        return "grouped entry", SSD.ssd_intra_chunked
    return "per-head route with its copies", per_head_route


def k5_bound_ms(n_seq: int, Q: int, H: int, G: int, P: int, N: int
                ) -> tuple[float, str]:
    """Bound of ``n_seq`` chunks of Q rows, H heads reading B and C of G
    groups: bytes of x, y, dt, cums, B, C; 3xTF32 products of the causal
    pairs (scores once a group, S.X once a head)."""
    nbytes = 4 * n_seq * Q * (2 * H * P + 2 * H + 2 * G * N)
    pairs = Q * (Q + 1) // 2
    flops = 3 * n_seq * pairs * 2 * (G * N + H * P)
    return bound_ms(nbytes, flops, "tfloat32")


def time_rows(dev, seed: int) -> list[dict]:
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    label, call = path_call()
    rows = []
    for Q in (256, 32):
        x, dt, cums, b, c = path_inputs(Q, seed + Q, dev)
        ms = time_ms(lambda: call(x, dt, cums, b, c), 50, flush)
        b_ms, b_by = k5_bound_ms(PATH["B"] * PATH["nc"], Q, PATH["H"],
                                 PATH["G"], PATH["P"], PATH["N"])
        rows.append({"row": f"path Q={Q}", "call": label, "Q": Q, **PATH,
                     "ms": ms, "bound_ms": b_ms, "bound_by": b_by})
    for Q in (256, 32):
        G_, P, N = 640, 64, 128
        gen = torch.Generator(device=dev).manual_seed(seed + 1000 + Q)
        x = torch.randn(G_, Q, P, generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn(G_, Q, generator=gen, device=dev))
        cums = torch.cumsum(-dt, dim=1)
        b = torch.randn(G_, Q, N, generator=gen, device=dev)
        c = torch.randn(G_, Q, N, generator=gen, device=dev)
        ms = time_ms(lambda: SSD.ssd_intra(x, dt, cums, b, c), 50, flush)
        plain = time_ms(lambda: SSD.ssd_intra_ref(x, dt, cums, b, c), 20,
                        flush)
        causal = torch.ones(Q, Q, dtype=torch.bool, device=dev).tril()
        ldt = torch.exp((cums[:, :, None] - cums[:, None, :]).masked_fill(
            ~causal, float("-inf"))) * dt[:, None, :]
        bt = b.transpose(1, 2)
        ctx = time_ms(lambda: torch.bmm(torch.bmm(c, bt) * ldt, x), 50,
                      flush)
        b_ms, b_by = k5_bound_ms(G_, Q, 1, 1, P, N)
        rows.append({"row": f"per-head G={G_} Q={Q}", "G": G_, "Q": Q,
                     "P": P, "N": N, "ms": ms, "plain_ms": plain,
                     "context_ms": ctx, "bound_ms": b_ms, "bound_by": b_by})
    return rows


def profile_chunk_steps(dev, seed: int) -> dict:
    """The second chunk step of full-width mamba2-2.7b under each backend,
    profiled (the first is a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs as CONFIGS
    from repro_torch.models import network as N
    from repro_torch.serving.engine import ContinuousEngine, Request
    m2 = CONFIGS.get("mamba2_2_7b")
    params = N.init(m2, seed, dev)
    out = {}
    for backend in ("xla", "scheduled"):
        cfg = dataclasses.replace(m2, gemm_backend=backend)
        eng = ContinuousEngine(cfg, params, slots=8, max_len=1024,
                               prefill_chunk=m2.ssm.chunk, device=dev)
        rng = np.random.default_rng(7)
        plen = 5 * m2.ssm.chunk // 2
        for i in range(8):
            eng.submit(Request(i, rng.integers(3, m2.vocab, plen)
                               .astype(np.int32), 16, eos=-1))
        eng.step()
        torch.cuda.synchronize()
        SSD.launches.reset()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        dev_ms, kernels = kernel_ms(prof)
        out[backend] = {"profiled_wall_ms": wall, "device_ms": dev_ms,
                        "device_kernels": kernels,
                        "k5_ms": kernel_ms(prof, "ssd_intra")[0],
                        "k5_launches": SSD.launches.count,
                        "top_ops": top_ops(prof, 12)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile a full-width mamba2 chunk step")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    rows = time_rows(dev, args.seed)
    for r in rows:
        extra = "".join(f", {k[:-3]} {r[k] * 1e3:.1f} us"
                        for k in ("plain_ms", "context_ms") if k in r)
        print(f"K5 {r['row']} ({r.get('call', 'ssd_intra')}): "
              f"{r['ms'] * 1e3:.1f} us{extra}, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
    result = {"card": card, "rows": rows}
    if args.profile:
        result["chunk_step"] = prof = profile_chunk_steps(dev, args.seed)
        for b, r in prof.items():
            print(f"mamba2 chunk step (8 x 256), {b}: {r['device_ms']:.2f} "
                  f"ms on the device, {r['device_kernels']} kernels, K5 "
                  f"{r['k5_ms']:.2f} ms ({r['k5_launches']} launches); top "
                  "ops: " + "; ".join(f"{k} {t:.2f} ms x{n}"
                                      for k, t, n in r["top_ops"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")


if __name__ == "__main__":
    main()
