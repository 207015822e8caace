"""Serving driver of the port: random weights from a seed, a batch of
random requests through the paged continuous-batching engine (or, with
``--engine``, the dense one or the wave baseline), and a report of
throughput, time to first token (TTFT), time per output token (TPOT),
request latency, schedule-cache hits, KV-pool use, the policy's
preemptions and pool utilisation, and the speculation counters.

    python -m repro_torch.launch.serve --arch qwen2_0_5b
    python -m repro_torch.launch.serve --arch qwen2_0_5b --scaled-down \\
        --gemm-backend scheduled --device cpu
    python -m repro_torch.launch.serve --arch qwen2_0_5b --quant
    python -m repro_torch.launch.serve --arch mamba2_2_7b \
        [--gemm-backend scheduled]
    python -m repro_torch.launch.serve --arch gemma2_9b \
        [--gemm-backend scheduled]   # or qwen1_5_4b, chatglm3_6b,
                                     # llava_next_mistral_7b, zamba2_7b,
                                     # llama4_scout_17b_a16e
    python -m repro_torch.launch.serve --arch zamba2_7b --quant
    python -m repro_torch.launch.serve --arch qwen2_0_5b \
        --policy slo_preempt --ttft-slo 0.05 --arrival-ms 20
    python -m repro_torch.launch.serve --arch qwen2_0_5b \
        --spec ngram|model:qwen2_0_5b --spec-k 4
    python -m repro_torch.launch.serve --arch qwen2_0_5b --temperature 0.8
    python -m repro_torch.launch.serve --arch qwen2_0_5b --engine dense|wave
    python -m repro_torch.launch.serve --arch qwen2_0_5b \
        --trace-out trace.json --metrics-out metrics.json|metrics.prom
    python -m repro_torch.launch.serve --arch qwen2_0_5b --profile \
        --trace-out trace.json
    python -m repro_torch.launch.trace_report trace.json --validate
    python -m repro_torch.launch.plan_report drift trace.json \
        --arch qwen2_0_5b --slots 4 --max-len 256

Runs on the CUDA card unless ``--device cpu`` is given.  ``--quant`` on
an SSM config makes ``in_proj``, ``out_proj`` and the untied head int8
(mamba2 has no KV pool; zamba2's shared attention takes int8 KV blocks);
``--spec`` on it is refused, as the reference refuses it.  llama4-scout
(``--arch llama4_scout_17b_a16e``) serves its MoE blocks: 16 experts,
top-1, and a shared expert; under ``--quant`` its attention, shared
expert and head go int8 while the stacked routed experts and the router
stay float, as in the reference.  llava serves its text path (its patch
prefix enters through ``network.prefill``).  The continuous engines serve
through their async API, as the reference's launcher does: ``start()``,
one ``submit()`` a request (``--arrival-ms`` sleeps an exponential gap
of that mean before each), ``get_result()`` for each, ``stop()``.
``--trace-out`` writes the lifecycle tracer's Chrome trace (open it in
Perfetto) and ``--metrics-out`` the metrics registry (JSON, or the
Prometheus text with a ``.prom`` suffix); both print the registry's
report and are refused on the wave, which is not instrumented.
``--profile`` adds the dispatch profiler (``obs.profile``: a sync after
every step dispatch, a calibration pass at construction, ``dispatch``
spans in the trace) and is refused on the dense engine and the wave;
``launch.trace_report`` and ``launch.plan_report`` read its trace.
``--engine continuous`` is the
paged pool (default), ``dense`` continuous batching over dense stripes,
``wave`` the seed baseline; ``--spec`` needs the paged engine, and the
policies that reserve pool blocks are refused on ``dense`` by the
engine.  Under ``--quant`` the wave takes the weights-only rewrite
(``quantize_params``) and keeps its fp config, as in the reference; the
dense engine quantizes its weights but keeps fp KV stripes.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as CONFIGS
from repro_torch.device import resolve_device
from repro_torch.models import network as N
from repro_torch.obs import Telemetry, render_report
from repro_torch.quant.policy import QuantPolicy, quantize_params
from repro_torch.serving.engine import ContinuousEngine, Request, WaveEngine
from repro_torch.serving.policy import POLICY_NAMES
from repro_torch.serving.spec import ModelDraft


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scaled-down", action="store_true")
    ap.add_argument("--gemm-backend", choices=("xla", "scheduled"),
                    default="xla",
                    help="scheduled = projections and the LM head through "
                         "the mpgemm kernels under the paper-§5 schedule "
                         "cache; xla = torch.matmul (default)")
    ap.add_argument("--quant", action="store_true",
                    help="int8 serving: QuantTensor projection weights "
                         "(quant_matmul under --gemm-backend scheduled) "
                         "and int8 paged KV blocks with scale sidecars")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--engine", choices=("continuous", "dense", "wave"),
                    default="continuous",
                    help="continuous = paged KV pool (default); dense = "
                         "continuous batching over dense stripes; wave = "
                         "seed baseline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival-ms", type=float, default=0.0,
                    help="mean inter-arrival gap; 0 = offered all at once")
    ap.add_argument("--policy", choices=POLICY_NAMES, default="fifo",
                    help="admission policy: fifo = arrival order; best_fit "
                         "= the reservation that best fits the free list; "
                         "slo_preempt = FIFO, TTFT deadlines jump the queue "
                         "and may preempt a decoder (it resumes through the "
                         "prefix cache); model_fit / model_preempt = the "
                         "same on modeled step costs")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="TTFT deadline of every request in seconds (0 = "
                         "none); the preempting policies act on it")
    ap.add_argument("--spec", default=None, metavar="ngram|model:<arch>",
                    help="speculative decoding (greedy only): 'ngram' = "
                         "prompt lookup; 'model:<arch>' = a draft model on "
                         "the target's block tables (the target's arch "
                         "self-drafts with its weights, another arch runs "
                         "random weights from --seed + 1)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens verified a step at most")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of every request (0 = "
                         "greedy)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run (open "
                         "in Perfetto / chrome://tracing); enables the "
                         "lifecycle tracer")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics-registry snapshot (.prom suffix "
                         "= Prometheus text exposition, else JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="wrap the four hot dispatches with synced timing "
                         "and modeled-cost cross-checks (see "
                         "repro_torch.launch.trace_report); implies "
                         "tracing")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CONFIGS.get(args.arch)
    if args.scaled_down:
        cfg = cfg.scaled_down()
    cfg = dataclasses.replace(cfg, gemm_backend=args.gemm_backend).validate()
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    base_cfg = cfg
    quant_policy = None
    if args.quant and args.engine != "wave":
        cfg = dataclasses.replace(cfg, quant_serving=True,
                                  name=cfg.name + "+int8").validate()
        # scaled-down projections sit below the default 65536-element
        # floor, so nothing would be quantized there
        quant_policy = (QuantPolicy(min_size=0) if args.scaled_down
                        else QuantPolicy())
    params = N.init(cfg, args.seed, dev)
    if args.quant and args.engine == "wave":
        # the seed baseline predates QuantPolicy: weights-only rewrite
        params = quantize_params(params)

    spec = None
    if args.spec == "ngram":
        spec = "ngram"
    elif args.spec and args.spec.startswith("model:"):
        draft_cfg = CONFIGS.get(args.spec.split(":", 1)[1])
        if args.scaled_down:
            draft_cfg = draft_cfg.scaled_down()
        if draft_cfg.name == base_cfg.name:
            # self-draft on the target's weights; under --quant the engine
            # quantizes its own copy and the draft keeps the fp config
            # (only block tables are shared)
            spec = ModelDraft(base_cfg, params)
        else:
            spec = ModelDraft(draft_cfg, N.init(draft_cfg, args.seed + 1,
                                                dev))
    elif args.spec:
        raise SystemExit(f"--spec {args.spec!r}: expected 'ngram' or "
                         f"'model:<arch>'")
    if spec is not None and args.temperature > 0:
        raise SystemExit("--spec is greedy-only: drop --temperature")
    if spec is not None and args.engine != "continuous":
        raise SystemExit("--spec needs the paged engine (KV rollback "
                         "lives in the block pool)")
    want_telemetry = bool(args.trace_out or args.metrics_out
                          or args.profile)
    if want_telemetry and args.engine == "wave":
        raise SystemExit("--trace-out/--metrics-out/--profile need the "
                         "continuous engine (the wave baseline is "
                         "uninstrumented)")
    if args.profile and args.engine == "dense":
        raise SystemExit("--profile wraps the paged dispatches: use the "
                         "continuous (paged) engine")

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(3, cfg.vocab, max(1, int(
                        rng.integers(args.prompt_len // 2,
                                     args.prompt_len + 1)))).astype(np.int32),
                    max_new_tokens=max(1, int(rng.integers(
                        args.max_new // 2, args.max_new + 1))), eos=-1,
                    temperature=args.temperature,
                    ttft_slo=args.ttft_slo or None)
            for i in range(args.requests)]
    t_build = time.perf_counter()
    if args.engine == "wave":
        eng = WaveEngine(cfg, params, slots=args.slots,
                         max_len=args.max_len, seed=args.seed, device=dev)
    else:
        eng = ContinuousEngine(cfg, params, slots=args.slots,
                               max_len=args.max_len, seed=args.seed,
                               paged=args.engine == "continuous",
                               policy=args.policy, spec=spec,
                               spec_k=args.spec_k, quant_policy=quant_policy,
                               telemetry=(Telemetry.on(profile=args.profile)
                                          if want_telemetry else None),
                               device=dev)
    # construction: the schedule pre-resolve, and under --profile the
    # profiler's step_cost count and calibration pass
    build_s = time.perf_counter() - t_build
    schedule = getattr(eng, "schedule", None)   # the wave has none
    if schedule is not None:
        schedule.reset()        # count only the run, not construction
    t0 = time.perf_counter()
    if args.engine == "wave":
        results = eng.run(reqs)
    else:
        eng.start()
        for r in reqs:
            if args.arrival_ms > 0:
                time.sleep(rng.exponential(args.arrival_ms / 1e3))
            eng.submit(r)
        results = [eng.get_result(timeout=600) for _ in reqs]
        eng.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    toks = sum(len(r.tokens) for r in results)
    ttft = [r.ttft_s for r in results]
    tpot = [r.decode_s / (len(r.tokens) - 1) for r in results
            if len(r.tokens) > 1]
    lats = [r.latency_s for r in results]
    report = {"device": str(dev), "engine": args.engine,
              "requests": len(results),
              "ok": sum(r.status == "ok" for r in results),
              "new_tokens": toks, "wall_s": wall,
              "tok_per_s": toks / max(wall, 1e-9),
              "ttft_p50_ms": _pct(ttft, 50) * 1e3,
              "ttft_p95_ms": _pct(ttft, 95) * 1e3,
              "tpot_p50_ms": _pct(tpot, 50) * 1e3,
              "latency_p50_ms": _pct(lats, 50) * 1e3,
              "latency_p99_ms": _pct(lats, 99) * 1e3,
              "decode_steps": eng.steps, "quant": bool(args.quant),
              "build_s": build_s}
    if args.quant:
        kv_kind = ("no KV pool" if cfg.attention_free
                   else "int8 KV blocks" if cfg.quant_kv
                   and args.engine == "continuous" else "fp KV")
        print(f"[serve] int8 serving: QuantTensor weights + {kv_kind}")
    print(f"[serve:{args.engine}] {len(results)} requests, {toks} tokens "
          f"in {wall:.2f}s ({report['tok_per_s']:.1f} tok/s)  latency "
          f"p50={report['latency_p50_ms']:.0f}ms "
          f"p99={report['latency_p99_ms']:.0f}ms")
    print(f"[serve:{cfg.name} {args.gemm_backend} on {dev}] "
          f"{len(results)} requests, {toks} tokens in {wall:.2f}s "
          f"({report['tok_per_s']:.1f} tok/s)  TTFT p50 "
          f"{report['ttft_p50_ms']:.1f} ms p95 {report['ttft_p95_ms']:.1f} "
          f"ms  TPOT p50 {report['tpot_p50_ms']:.2f} ms")
    if schedule is not None:
        st = schedule.stats()
        report.update(schedule_hits=st["hits"], schedule_misses=st["misses"])
        print(f"[serve] schedule cache: {st['entries']} schedules, "
              f"{st['hits']} hits / {st['misses']} misses during the run")
    if args.engine == "wave":
        return report
    kv = eng.kv_bytes()
    report.update(kv_peak_bytes=kv["peak"], kv_allocated_bytes=kv["allocated"],
                  policy=eng.policy.name,
                  ttft_steps_p95=_pct([r.ttft_steps for r in results], 95),
                  spec=eng.spec_stats())
    if not eng.paged:
        print(f"[serve] dense stripes: KV {kv['allocated']} B allocated "
              f"(peak = allocated)")
        return _export(args, eng, report, wall)
    ps = eng.pool.stats()
    report.update(kv_quantized=ps["quantized"],
                  pool_peak_blocks=ps["peak_used"],
                  pool_blocks=ps["num_blocks"],
                  shared_token_hits=ps["shared_token_hits"],
                  preemptions=eng.preemptions, resumes=eng.resumes,
                  avg_pool_util=eng.avg_pool_util())
    print(f"[serve] kv pool: peak {ps['peak_used']}/{ps['num_blocks']} "
          f"blocks, {ps['shared_token_hits']} shared-prefix token hits, "
          f"peak KV {kv['peak']} / allocated {kv['allocated']} B")
    print(f"[serve] policy {eng.policy.name}: mean pool util "
          f"{report['avg_pool_util']:.2f}, {eng.preemptions} preemptions, "
          f"{ps['backoffs']} admission backoffs, TTFT p95 "
          f"{report['ttft_steps_p95']:.0f} engine steps")
    if eng.spec is not None:
        sp = report["spec"]
        print(f"[serve] spec {sp['provider']} k={sp['k']}: "
              f"{sp['verify_steps']} verify steps, {sp['accepted']}/"
              f"{sp['drafted']} drafts accepted, mean accept length "
              f"{sp['avg_accept_len']:.2f}")
    return _export(args, eng, report, wall)


def _export(args, eng: ContinuousEngine, report: dict, wall: float) -> dict:
    """The registry's report and the ``--trace-out`` / ``--metrics-out``
    files, when asked for."""
    if not (args.trace_out or args.metrics_out or args.profile):
        return report
    print(render_report(eng.metrics, wall_s=wall))
    if eng.obs.profiler is not None:
        spans = eng.obs.profiler.spans
        report["profile_spans"] = len(spans)
        print(f"[serve] profiler: {len(spans)} dispatch spans "
              f"({sum(s['kind'] == 'calibration' for s in spans)} "
              f"calibration)")
    if args.trace_out:
        eng.obs.export_trace(args.trace_out)
        print(f"[serve] trace -> {args.trace_out} ({len(eng.obs.tracer)} "
              f"events, {eng.obs.tracer.dropped} dropped)")
    if args.metrics_out:
        eng.obs.export_metrics(args.metrics_out)
        print(f"[serve] metrics -> {args.metrics_out}")
    report.update(trace_out=args.trace_out, metrics_out=args.metrics_out)
    return report


if __name__ == "__main__":
    main()
