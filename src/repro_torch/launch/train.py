"""Training entry point of the port: the train step, the restart-exact
loop and its fault tolerance (port of ``repro.launch.train``).

``make_train_step`` builds the step: ``loss_fn``'s gradient by autograd
(micro-batch accumulation summed in fp32 where ``accum > 1``), then
``adamw.update`` in place on the parameters and moments.  ``train`` runs
the loop over the seekable synthetic data stream with async checkpoints,
a heartbeat, an optional failure injector and a restart from the last
checkpoint (``run_with_restarts``).  On mamba2 and zamba2 the SSD's
intra-chunk term runs K5 forward and K5-bwd backward on the card (with
``cfg.remat`` each layer runs K5 twice a step: the forward and the
recompute); the other GEMMs are PyTorch's, as the reference's training
dots are XLA's.

    python -m repro_torch.launch.train --arch qwen2-0.5b --scaled-down \\
        --steps 3 --device cpu
    python -m repro_torch.launch.train --arch hubert-xlarge --steps 4 \\
        --global-batch 8 --seq 1024 --ckpt-dir /tmp/ckpt

Runs on the CUDA card unless ``--device cpu`` is given.  A config under
``gemm_backend="scheduled"`` is refused: the reference cannot
differentiate its Pallas GEMMs either.  The reference's compressed
data-parallel step (int8 gradients over a data axis) waits for the
port's multi-device work; ``optim.compression`` holds its per-device
half.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections.abc import Callable
from typing import Any

import torch

from repro_torch import configs as CONFIGS
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve_device
from repro_torch.models import network as N
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw
from repro_torch.runtime.faults import (FailureInjector, HeartbeatMonitor,
                                        RestartPolicy, run_with_restarts)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The reference's fields.  ``fsdp`` and ``compress_grads`` are kept
    for its interface and mean nothing on one device."""

    steps: int = 100
    global_batch: int = 8
    seq_len: int = 256
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    accum: int = 1                     # gradient-accumulation microbatches
    compress_grads: bool = False       # int8 DP all-reduce (pure-DP mode)
    seed: int = 0
    fsdp: bool = True


def _check_trainable(cfg: ModelConfig) -> None:
    if cfg.gemm_backend == "scheduled":
        raise ValueError(
            f"{cfg.name}: gemm_backend 'scheduled' cannot train: the "
            f"reference cannot differentiate its Pallas GEMMs either; "
            f"train under 'xla'")


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *,
                    accum: int = 1, device=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    The step updates ``params`` and ``opt_state``'s tensors in place (the
    reference donates them) and returns them.  ``batch`` holds tensors
    (numpy arrays are moved to ``device``).  Metrics: ``loss``, ``ce``,
    ``aux``, ``tokens``, ``lr``, ``grad_norm``; under ``accum > 1`` only
    ``loss``, ``lr`` and ``grad_norm``, as in the reference."""
    _check_trainable(cfg)
    dev = resolve_device(device)

    def grads_of(params, batch):
        ps = adamw.leaves(params)
        for p in ps:
            p.requires_grad_(True)
        try:
            loss, metrics = N.loss_fn(params, cfg, batch)
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for p in ps:
                p.requires_grad_(False)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(ps, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    def unflatten(params, flat):
        it = iter(flat)
        return tree_map(lambda _p, _a: next(it), params)

    def step(params, opt_state, batch):
        batch = to_device(batch, dev)
        if accum > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in adamw.leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + v.shape[1:])[i] for k, v in batch.items()}
                loss, _m, gs = grads_of(params, mb)
                gsum = [a + g for a, g in zip(gsum, gs)]
                lsum = lsum + loss
            grads = [g / accum for g in gsum]
            lossv = lsum / accum
            metrics: dict[str, torch.Tensor] = {}
        else:
            lossv, metrics, grads = grads_of(params, batch)
        params2, opt2, om = adamw.update(opt_cfg, unflatten(params, grads),
                                         opt_state, params)
        return params2, opt2, {"loss": lossv, **metrics, **om}

    return step


def make_eval_step(cfg: ModelConfig, device=None):
    """step(params, batch) -> {"loss", "ce", "aux", "tokens"}, without a
    graph."""
    dev = resolve_device(device)

    def step(params, batch):
        batch = to_device(batch, dev)
        with torch.no_grad():
            loss, metrics = N.loss_fn(params, cfg, batch)
        return {"loss": loss, **metrics}

    return step


def _template(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig) -> dict:
    """The checkpoint's tree on the meta device (shapes and dtypes)."""
    dtype = getattr(torch, cfg.param_dtype)
    params = tree_map(lambda _p, d: torch.empty(d.shape, dtype=dtype,
                                                device="meta"),
                      N.param_defs(cfg))
    return {"params": params, "opt": adamw.init(opt_cfg, params)}


# ---------------------------------------------------------------------------
# Loop with fault tolerance
# ---------------------------------------------------------------------------

def train(cfg: ModelConfig, tc: TrainConfig, *,
          injector: FailureInjector | None = None,
          restart_policy: RestartPolicy | None = None,
          log: Callable[[str], None] = print, params: PyTree | None = None,
          device=None) -> dict[str, float]:
    """Train ``tc.steps`` steps; returns the last step's metrics as
    floats.  ``params`` (initial weights, left untouched) defaults to
    ``N.init(cfg, tc.seed)``; a restart with no checkpoint starts again
    from them."""
    dev = resolve_device(device)
    opt_cfg = adamw.AdamWConfig(total_steps=tc.steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=tc.seq_len,
                          global_batch=tc.global_batch, seed=tc.seed)
    step_fn = make_train_step(cfg, opt_cfg, accum=tc.accum, device=dev)

    mgr = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
    monitor = HeartbeatMonitor(n_hosts=1)

    state: dict[str, Any] = {}

    def fresh_state():
        if params is None:
            p = N.init(cfg, tc.seed, device=dev)
        else:
            p = tree_map(lambda _p, a: a.detach().to(dev, copy=True),
                         params)
        return p, adamw.init(opt_cfg, p)

    def restore_state() -> int:
        assert mgr is not None
        latest = mgr.latest_step()
        if latest is None:
            state["params"], state["opt"] = fresh_state()
            return 0
        restored, _ = mgr.restore(_template(cfg, opt_cfg), device=dev)
        state["params"], state["opt"] = restored["params"], restored["opt"]
        log(f"[restore] resumed from step {latest}")
        return latest

    last_metrics: dict[str, float] = {}

    def loop(start_step: int) -> int:
        for step in range(start_step, tc.steps):
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.perf_counter()
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], make_batch(cfg, data_cfg, step))
            last_metrics.update({k: float(v) for k, v in metrics.items()})
            dt = time.perf_counter() - t0
            monitor.beat(0, dt)
            if step % tc.log_every == 0 or step == tc.steps - 1:
                log(f"step {step:5d} loss {last_metrics['loss']:.4f} "
                    f"lr {last_metrics['lr']:.2e} "
                    f"gnorm {last_metrics['grad_norm']:.2f} {dt*1e3:.0f}ms")
            if mgr is not None and ((step + 1) % tc.ckpt_every == 0
                                    or step == tc.steps - 1):
                mgr.save(step + 1,
                         {"params": state["params"], "opt": state["opt"]},
                         extra={"step": step + 1})
        return tc.steps

    def on_restart(step: int, exc: Exception) -> int:
        log(f"[fault] {exc}; restarting from last checkpoint")
        if mgr is not None:
            mgr.wait()
            return restore_state()
        state["params"], state["opt"] = fresh_state()
        return 0

    if mgr is not None and mgr.latest_step() is not None:
        start = restore_state()
    else:
        state["params"], state["opt"] = fresh_state()
        start = 0

    run_with_restarts(loop, start_step=start, final_step=tc.steps,
                      policy=restart_policy or RestartPolicy(),
                      on_restart=on_restart)
    if mgr is not None:
        mgr.wait()
    return last_metrics


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--scaled-down", action="store_true",
                    help="reduced same-family config (CPU runs)")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (with --scaled-down)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = CONFIGS.get(args.arch)
    if args.scaled_down:
        over = {}
        if args.d_model:
            over["d_model"] = args.d_model
        if args.n_layers:
            over["n_layers"] = args.n_layers
        cfg = cfg.scaled_down(**over)
    tc = TrainConfig(steps=args.steps, global_batch=args.global_batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, accum=args.accum)
    metrics = train(cfg, tc, device=args.device)
    print("final:", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
