"""Flop and byte accounting of one engine dispatch, counted over the aten
ops it runs (the port of ``repro.launch.jaxpr_cost.step_cost`` and of
``repro.analysis.jaxpr_lint``'s ``abstract_engine_inputs`` /
``hot_dispatches``).

:func:`step_cost` runs the dispatch once on fake CPU tensors
(``FakeTensorMode``): every op computes shapes only, so a full-width
geometry costs no memory and no arithmetic, nothing is launched and
nothing is allocated on the card.  On CPU tensors the kernel wrappers
take their plain versions, which is the path the reference counts on the
CPU (its gather fallback and its interpreted kernels).  A scheduled GEMM
backend resolves through private forks of the shared schedule caches
(``ops.private_backends``), so the engine's hit/miss counters and
applied log do not move.

:func:`hot_dispatches` prices a scheduled config's projections as the
dots they compute (``gemm_backend="xla"``): the reference counts a
Pallas GEMM as one kernel that reads its operands and writes its output
once, and K2's plain version is a loop over K blocks, the kernel's
accumulation-order oracle -- counted op by op it would charge the output
once a block and take seconds a dispatch under fake tensors at full
width.  :func:`dispatch_costs` memoizes the four counts per (config,
geometry).

The convention is the reference's:

  * a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, a convolution, a
    two-operand ``torch.einsum`` taken whole) costs 2 * numel(out) * K
    flops and reads both operands and writes the output;
  * a reduction or arg-reduction (a softmax counts as its two) costs
    numel(in) flops and in + out bytes;
  * a gather, scatter, index, dynamic slice or dynamic update costs
    in + out bytes (an in-place update counts the tensor it updates as
    its output);
  * elementwise ops, views and copies count nothing;
  * the step's inputs are read once and its outputs written once.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.kernels import ops as OPS
from repro_torch.models import network as N
from repro_torch.models.layers import tree_map
from repro_torch.serving.kv_pool import blocks_for

#: the engine's default geometry (``ContinuousEngine``)
SLOTS = 8
MAX_LEN = 2048
BLOCK_SIZE = 16
PREFILL_CHUNK = 32
SPEC_K = 4

_aten = torch.ops.aten

_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default, _aten.dot.default, _aten.mv.default}
_CONVS = {_aten.convolution.default, _aten._convolution.default}
#: the reference's reduce_sum / max / min / prod, cumsum, argmax, argmin
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "prod", "cumsum"}
#: a softmax is a max and a sum over the same input (the reference's
#: jaxpr carries both reductions)
_SOFTMAXES = {"_softmax", "_log_softmax"}
#: gathers, scatters, dynamic slices and updates
_MOVES = {
    "index", "index_select", "gather", "embedding", "take", "sort",
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "index_copy", "index_copy_",
    "index_add", "index_add_", "slice_scatter", "select_scatter"}


def _tensors(obj: Any) -> list[torch.Tensor]:
    """Every tensor leaf of a nested structure (dicts, sequences and
    dataclasses such as ``QuantTensor``)."""
    out: list[torch.Tensor] = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
    walk(obj)
    return out


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], obj: Any
                 ) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_cost(func, args: tuple, kwargs: dict, out: Any
             ) -> tuple[float, float]:
    """(flops, bytes) of one aten op under the module's convention."""
    if func in _DOTS:
        a, b = (args[1], args[2]) if func in (
            _aten.addmm.default, _aten.baddbmm.default) else args[:2]
        outs = _tensors(out)
        k = a.shape[-1]
        return (2.0 * outs[0].numel() * k,
                float(_nbytes(a) + _nbytes(b) + _nbytes(outs[0])))
    if func in _CONVS:
        x, w = args[0], args[1]
        o = _tensors(out)[0]
        k = w.numel() // max(1, w.shape[0])
        return (2.0 * o.numel() * k,
                float(_nbytes(x) + _nbytes(w) + _nbytes(o)))
    name = func.overloadpacket.__name__
    if name in _REDUCTIONS or name in _SOFTMAXES:
        x = args[0]
        o = _tensors(out)[0]
        n = 2 if name in _SOFTMAXES else 1
        return (n * float(x.numel()),
                n * float(_nbytes(x) + _nbytes(o)))
    if name in _MOVES:
        ins = _tensors((args, kwargs))
        return 0.0, float(sum(_nbytes(t) for t in ins)
                          + sum(_nbytes(t) for t in _tensors(out)))
    return 0.0, 0.0


def _einsum_cost(eq: str, a: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor) -> tuple[float, float]:
    """A two-operand einsum is one dot: K is the product of the indices
    that appear in an operand and not in the output (1 for an outer
    product, which aten runs as a broadcast ``mul``)."""
    ins, res = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    sizes = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))
    k = 1
    for c in set(sa + sb) - set(res):
        k *= int(sizes[c])
    return (2.0 * out.numel() * k,
            float(_nbytes(a) + _nbytes(b) + _nbytes(out)))


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums :func:`_op_cost` over every aten op it sees, except inside a
    two-operand ``torch.einsum``, which :class:`_Einsums` counts whole."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.muted:
            f, b = _op_cost(func, args, kwargs, out)
            self.flops += f
            self.bytes += b
        return out


class _Einsums(torch.overrides.TorchFunctionMode):
    """Counts a two-operand ``torch.einsum`` as the one dot the reference's
    jaxpr holds (aten splits it into permutes, a ``bmm`` or a ``mul``,
    and sums)."""

    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ops = args[1:]
        if len(ops) == 1 and isinstance(ops[0], (tuple, list)):
            ops = tuple(ops[0])
        if (func is not torch.einsum or len(ops) != 2 or kwargs
                or self.counter.muted):
            return func(*args, **kwargs)
        self.counter.muted += 1
        try:
            out = func(*args)
        finally:
            self.counter.muted -= 1
        f, b = _einsum_cost(args[0], ops[0], ops[1], out)
        self.counter.flops += f
        self.counter.bytes += b
        return out


def step_cost(fn: Callable, *args) -> dict[str, float]:
    """(flops, bytes) of ``fn(*args)`` (module docstring).

    ``args`` may hold tensors on any device, ``meta`` included
    (:func:`abstract_engine_inputs`): only their shapes and dtypes are
    read.  Each becomes a fake CPU tensor of the same shape and dtype, so
    the count allocates nothing and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = _map_tensors(lambda t: torch.empty(
            tuple(t.shape), dtype=t.dtype, device="cpu"), args)
        counter = _Counter()
        with OPS.private_backends(), counter, _Einsums(counter):
            out = fn(*fake)
        io = sum(_nbytes(t) for t in _tensors(fake))
        io += sum(_nbytes(t) for t in _tensors(out))
    return {"flops": counter.flops, "bytes": counter.bytes + float(io)}


def abstract_engine_inputs(cfg, *, slots: int = SLOTS,
                           max_len: int = MAX_LEN,
                           block_size: int = BLOCK_SIZE) -> dict:
    """Parameters, paged caches and step vectors at engine geometry as
    ``meta`` tensors: full-width shapes, no storage.  Under
    ``cfg.quant_serving`` the weights take the engine's int8 rewrite."""
    meta = torch.device("meta")
    per_slot = blocks_for(max_len, block_size)
    kv_blocks = max(per_slot + 1, 1 + (3 * slots * per_slot + 3) // 4)
    dt = getattr(torch, cfg.param_dtype)
    params = tree_map(lambda _p, d: torch.empty(d.shape, dtype=dt,
                                                device=meta),
                      N.param_defs(cfg))
    if cfg.quant_serving:
        from repro_torch.quant.policy import serving_quant_params
        params = serving_quant_params(cfg, params)
    caches = N.expand_cache_pos(
        N.init_paged_caches(cfg, slots, kv_blocks, block_size,
                            device=meta), slots)
    i32 = torch.int32
    return {
        "params": params,
        "caches": caches,
        "bt": torch.empty((slots, per_slot), dtype=i32, device=meta),
        "slot_ids": torch.empty((slots,), dtype=i32, device=meta),
        "pos": torch.empty((slots,), dtype=i32, device=meta),
    }


def hot_dispatches(cfg, *, slots: int = SLOTS, max_len: int = MAX_LEN,
                   block_size: int = BLOCK_SIZE,
                   prefill_chunk: int = PREFILL_CHUNK, spec_k: int = SPEC_K
                   ) -> list[tuple[str, Callable, tuple]]:
    """(name, fn, abstract args) for each steady-state dispatch of the
    paged engine, at the signatures of the reference's programs:
    ``decode_step``, ``prefill_paged_chunk``, ``verify_paged_chunk``
    (attention-only configs) and ``head_apply``; projections run as
    ``torch.matmul`` dots (module docstring)."""
    if cfg.is_encoder_only:
        return []
    from repro_torch.models.layers import head_apply

    cfg = dataclasses.replace(cfg, gemm_backend="xla")
    ab = abstract_engine_inputs(cfg, slots=slots, max_len=max_len,
                                block_size=block_size)
    meta = torch.device("meta")
    i32 = torch.int32
    ct = getattr(torch, cfg.compute_dtype)

    def toks(n: int) -> torch.Tensor:
        return torch.empty((slots, n), dtype=i32, device=meta)

    def decode_step(params, toks, caches, pos, bt, adv):
        return N.decode_step(params, cfg, toks, caches, pos,
                             block_table=bt, pos_advance=adv)

    def prefill_chunk_fn(params, toks, caches, slot_ids, bt, lens,
                         last_idx):
        return N.prefill_paged_chunk(params, cfg, toks, caches, slot_ids,
                                     bt, lens, last_idx)

    def verify_chunk_fn(params, toks, caches, slot_ids, bt, lens):
        return N.verify_paged_chunk(params, cfg, toks, caches, slot_ids,
                                    bt, lens)

    def head_fn(w, x):
        return head_apply(w, x, cfg.final_logit_softcap,
                          backend=N.gemm_backend(cfg))

    out: list[tuple[str, Callable, tuple]] = [
        ("decode_step", decode_step,
         (ab["params"], toks(1), ab["caches"], ab["pos"], ab["bt"],
          ab["pos"])),
        ("prefill_paged_chunk", prefill_chunk_fn,
         (ab["params"], toks(prefill_chunk), ab["caches"], ab["slot_ids"],
          ab["bt"], ab["pos"], ab["pos"]))]
    if not cfg.has_recurrent_state:     # spec/verify is attention-only
        out.append(("verify_paged_chunk", verify_chunk_fn,
                    (ab["params"], toks(spec_k + 1), ab["caches"],
                     ab["slot_ids"], ab["bt"], ab["pos"])))
    head = (ab["params"]["embed"]["table"] if cfg.tie_embeddings
            else ab["params"]["lm_head"])
    out.append(("head_apply", head_fn,
                (head, torch.empty((slots, 1, cfg.d_model), dtype=ct,
                                   device=meta))))
    return out


def dispatch_costs(cfg, *, slots: int, max_len: int, block_size: int,
                   prefill_chunk: int, spec_k: int
                   ) -> tuple[tuple[str, float, float], ...]:
    """((name, flops, bytes), ...) of every hot dispatch at one engine
    geometry, memoized per (config, geometry): engines of one geometry
    pay the count once."""
    return _dispatch_costs(cfg, slots, max_len, block_size, prefill_chunk,
                           spec_k)


@functools.lru_cache(maxsize=32)
def _dispatch_costs(cfg, slots, max_len, block_size, prefill_chunk, spec_k):
    costs = ((name, step_cost(fn, *args)) for name, fn, args in
             hot_dispatches(
                 cfg, slots=slots, max_len=max_len, block_size=block_size,
                 prefill_chunk=prefill_chunk, spec_k=spec_k))
    return tuple((name, c["flops"], c["bytes"]) for name, c in costs)
