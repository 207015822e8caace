"""Opt-in dispatch profiling with a modeled-vs-measured cross-check (a
port of ``repro.obs.profile``).

``DispatchProfiler.attach(engine)`` times the four hot dispatches of the
paged serving engine -- ``decode_step``, ``prefill_paged_chunk``,
``verify_paged_chunk``, ``head_apply`` -- by host wall clock from the call
until its output is ready (``torch.cuda.synchronize`` on the card), and
attaches the paper-§5 model's view of each dispatch to every span:

  * ``modeled_cycles`` / ``modeled_traffic``: the ScheduleCache cycle and
    HBM-traffic estimates summed over the GEMM shapes the dispatch runs
    (interior projections x ``cfg.n_layers``, the LM head once, the
    paged-gather p-GEMMs x layers on the decode step), read through
    :meth:`~repro_torch.core.scheduler.ScheduleCache.modeled_cycles`,
    which moves no hit/miss counter;
  * ``flops`` / ``bytes``: the cost of the whole dispatch from
    ``launch.step_cost`` (its aten ops on fake tensors at engine
    geometry).

``python -m repro_torch.launch.trace_report`` turns the spans into the
drift table per dispatch and GEMM shape.

Two kinds of span:

  * ``calibration``: ``attach`` runs each dispatch alone on the engine's
    parameters, block tables and cursors, with zero tokens and zero
    lengths, on a clone of the cache tree (the serving functions write
    pools and recurrent state in place) and through private forks of the
    schedule caches: one warm-up call, then ``reps`` timed calls.  The
    engine's caches, tables, pool, cursors, sampler and schedule
    statistics are left as they were.  This is what puts ``head_apply``
    (inside the decode dispatch at serve time) and
    ``verify_paged_chunk`` (absent from a run without ``spec=``) into the
    drift table.
  * ``serve``: the engine's three step dispatches (``ContinuousEngine._fns``,
    each from its inputs to the tokens read back on the host, sampling
    included) are wrapped with :func:`profiled_dispatch`, so real serving
    steps give spans too.  The added synchronize launches nothing: the
    step already syncs at its token readback.
"""

from __future__ import annotations

import time
from typing import Any

import torch

#: the four dispatch names the drift table must cover
DISPATCH_NAMES = ("decode_step", "prefill_paged_chunk",
                  "verify_paged_chunk", "head_apply")


def _synchronizer(device):
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.synchronize(dev)


def profiled_dispatch(fn, record=None, device=None):
    """Wrap a dispatch with host wall-clock timing: ``record(t0, dur_s)``
    is called once the output is ready (after ``torch.cuda.synchronize``
    when ``device`` is a CUDA device)."""
    sync = _synchronizer(device)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        if record is not None:
            record(t0, time.perf_counter() - t0)
        return out
    return wrapped


def dispatch_gemm_shapes(cfg, *, slots: int, prefill_chunk: int,
                         spec_k: int, block_size: int
                         ) -> dict[str, list[tuple[int, int, int, int]]]:
    """Per-dispatch GEMM attribution: name -> [(M, N, K, count)].

    The shapes the engine pre-resolves, with their multiplicity in one
    dispatch: block-interior projections once a layer, the LM head once
    a dispatch, and the paged-gather p-GEMMs on the decode step.  Configs
    with recurrent state have no ``verify_paged_chunk`` (speculation is
    attention-only)."""
    from repro_torch.kernels.paged_attention import gather_gemm_shapes

    d = cfg.d_model
    nl = cfg.n_layers

    def family(m: int, head_rows: int) -> list[tuple[int, int, int, int]]:
        shapes = [(m, cfg.n_heads * cfg.hd, d, nl),
                  (m, cfg.n_kv_heads * cfg.hd, d, nl),
                  (m, d, cfg.n_heads * cfg.hd, nl)]
        if cfg.moe is not None:
            shapes += [(m, cfg.moe.d_ff_expert, d, nl),
                       (m, d, cfg.moe.d_ff_expert, nl)]
        else:
            shapes += [(m, cfg.d_ff, d, nl), (m, d, cfg.d_ff, nl)]
        shapes.append((head_rows, cfg.vocab, d, 1))
        return [(M, Nn, K, c) for M, Nn, K, c in shapes
                if M > 0 and Nn > 0 and K > 0]

    out = {"decode_step": family(slots, slots)
           + [(M, Nn, K, nl)
              for M, Nn, K in gather_gemm_shapes(cfg, block_size)],
           "prefill_paged_chunk": family(slots * prefill_chunk, slots),
           "head_apply": [(slots, cfg.vocab, d, 1)]}
    if not cfg.has_recurrent_state:
        L = spec_k + 1
        out["verify_paged_chunk"] = family(slots * L, slots * L)
    return out


class DispatchProfiler:
    """Measured-vs-modeled profiler of the engine's hot dispatches.

    Pass one to the engine through ``Telemetry(profiler=...)`` (or
    ``Telemetry.on(profile=True)``): the engine calls :meth:`attach` at
    the end of its constructor.  ``spans`` then collects dicts ``{name,
    kind, ts, dur_s, step, ...model args}``; every span is also a
    ``dispatch`` trace event and an observation of the
    ``profile.<name>_us`` histogram.
    """

    def __init__(self, reps: int = 3, calibrate: bool = True):
        self.reps = reps
        self.calibrate = calibrate
        self.spans: list[dict[str, Any]] = []
        self.model: dict[str, dict[str, Any]] = {}
        self._engine = None

    # -- model attribution ----------------------------------------------------

    def _build_model(self, eng) -> None:
        """ScheduleCache cycles/traffic and step_cost flops/bytes per
        dispatch at the live engine's geometry; no hit/miss counter
        moves."""
        from repro_torch.launch.step_cost import dispatch_costs

        cfg = eng.cfg
        shapes = dispatch_gemm_shapes(
            cfg, slots=eng.slots, prefill_chunk=eng.prefill_chunk,
            spec_k=eng.spec_k, block_size=eng.pool.block_size)
        for name, lst in shapes.items():
            cyc = traffic = 0.0
            rows = []
            for M, Nn, K, count in lst:
                ch = eng.schedule.modeled_cycles(M, Nn, K, eng._prec)
                cyc += count * ch.cycles
                traffic += count * ch.traffic_bytes
                rows.append([M, Nn, K, count, ch.cycles])
            self.model[name] = {"modeled_cycles": cyc,
                                "modeled_traffic": traffic,
                                "shape_cycles": rows}
        for name, flops, nbytes in dispatch_costs(
                cfg, slots=eng.slots, max_len=eng.max_len,
                block_size=eng.pool.block_size,
                prefill_chunk=eng.prefill_chunk, spec_k=eng.spec_k):
            if name in self.model:
                self.model[name].update(flops=flops, bytes=nbytes)

    # -- recording ------------------------------------------------------------

    def _record(self, name: str, kind: str, t0: float, dur_s: float
                ) -> None:
        eng = self._engine
        step = eng.steps + eng.chunk_steps if eng is not None else -1
        span = {"name": name, "kind": kind, "ts": t0, "dur_s": dur_s,
                "step": step}
        span.update(self.model.get(name, {}))
        self.spans.append(span)
        if eng is not None:
            eng.metrics.histogram(
                f"profile.{name}_us",
                help=f"wall time of the {name} dispatch (us)",
                buckets=(50, 100, 250, 500, 1000, 2500, 5000, 10000,
                         25000, 50000, 100000)).observe(dur_s * 1e6)
            tr = eng.obs.tracer
            if tr.enabled:
                tr.event("dispatch", step=step, ts=t0, dur=dur_s,
                         dispatch=name, kind=kind,
                         **self.model.get(name, {}))

    def _recorder(self, name: str, kind: str):
        return lambda t0, dur: self._record(name, kind, t0, dur)

    # -- engine hookup --------------------------------------------------------

    def attach(self, eng) -> None:
        """Wrap the engine's step dispatches and (optionally) run the
        calibration pass.  Paged engines only: the four profiled
        dispatches are the paged serving functions."""
        if not eng.paged:
            raise ValueError(
                "DispatchProfiler profiles the paged serving dispatches "
                "(decode_step / prefill_paged_chunk / verify_paged_chunk "
                "/ head_apply); construct the engine with paged=True")
        self._engine = eng
        self._build_model(eng)
        eng._fns = dict(eng._fns)
        wrap = [("decode_sample_paged", "decode_step"),
                ("prefill_chunk", "prefill_paged_chunk"),
                ("verify_chunk", "verify_paged_chunk")]
        for key, name in wrap:
            if name in self.model:
                eng._fns[key] = profiled_dispatch(
                    eng._fns[key], self._recorder(name, "serve"),
                    device=eng.device)
        if self.calibrate:
            self.run_calibration(eng)

    def run_calibration(self, eng) -> None:
        """Time each hot dispatch alone (module docstring): zero tokens
        and zero lengths on the engine's parameters, tables and cursors,
        a cloned cache tree, private schedule caches; one warm-up call,
        then ``reps`` timed calls give ``calibration`` spans."""
        from repro_torch.kernels import ops as OPS
        from repro_torch.models import network as N
        from repro_torch.models.layers import head_apply, tree_map

        cfg, dev = eng.cfg, eng.device
        i32 = torch.int32
        slots = eng.slots
        zeros_tok = torch.zeros((slots, 1), dtype=i32, device=dev)
        zeros_vec = torch.zeros((slots,), dtype=i32, device=dev)
        temps = torch.zeros((slots,), dtype=torch.float32).numpy()
        pos = torch.as_tensor(eng._pos.copy(), device=dev)
        L = eng.prefill_chunk
        K1 = eng.spec_k + 1
        head = (eng.params["embed"]["table"] if cfg.tie_embeddings
                else eng.params["lm_head"])
        x_head = torch.zeros((slots, 1, cfg.d_model),
                             dtype=getattr(torch, cfg.compute_dtype),
                             device=dev)
        caches = tree_map(lambda _p, a: a.clone(), eng.caches)
        fns = eng._engine_fns()      # unwrapped: calibration times itself
        calls = {
            "decode_step": lambda: fns["decode_sample_paged"](
                eng.params, zeros_tok, caches, pos, eng._bt, zeros_vec,
                temps),
            "prefill_paged_chunk": lambda: fns["prefill_chunk"](
                eng.params, torch.zeros((slots, L), dtype=i32, device=dev),
                caches, eng._slot_ids, eng._bt, zeros_vec, zeros_vec,
                temps),
            "head_apply": lambda: head_apply(
                head, x_head, cfg.final_logit_softcap,
                backend=N.gemm_backend(cfg)),
        }
        if "verify_paged_chunk" in self.model:
            calls["verify_paged_chunk"] = lambda: fns["verify_chunk"](
                eng.params, torch.zeros((slots, K1), dtype=i32, device=dev),
                caches, eng._slot_ids, eng._bt, zeros_vec)
        sync = _synchronizer(dev)
        with OPS.private_backends():
            for name, call in calls.items():
                call()                       # warm-up
                sync()
                for _ in range(self.reps):
                    t0 = time.perf_counter()
                    call()
                    sync()
                    self._record(name, "calibration", t0,
                                 time.perf_counter() - t0)
