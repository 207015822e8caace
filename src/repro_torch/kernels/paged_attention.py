"""Paged-decode attention (K1): gather K/V through a block table.

The paged KV pool (``serving.kv_pool``) stores each attention layer's K/V
as ``(num_blocks, block_size, KV, hd)``; a slot's logical sequence is the
concatenation of the pool blocks named by its block-table row.  Decode
attention over that layout is a chain of two skinny p-GEMMs per block --
scores (G, block_size, hd) and the weighted values (G, hd, block_size) --
stitched by an online softmax.

Two implementations, one contract:

  * :func:`paged_decode` -- the wrapper of the CUDA kernel
    ``csrc/paged_decode.cu`` (the port of the reference's Pallas
    ``paged_decode_kernel``).  On a CUDA tensor it launches the kernel or
    raises; on CPU tensors it runs the plain version.
  * :func:`gather_fallback` -- the plain PyTorch version: gather each
    row's blocks into a contiguous view and run one masked softmax.  It is
    the kernel's oracle and the CPU path.

Int8 pools (the quantized KV of ``cfg.quant_kv``) come with fp32
``k_scale``/``v_scale`` sidecars (num_blocks, block_size, KV), one scale
per written position and KV head; both implementations dequantize in
fp32, ``float(int8) * scale``, as the reference's Pallas kernel does (its
gather fallback dequantizes through q.dtype instead, which differs in
bf16).  The int8 variant (K1-int8) counts its launches apart from the fp
one.

A row of length 0 attends over nothing and yields zeros in both (the
reference's Pallas kernel does the same; its gather fallback returns the
mean of the gathered V instead, see ROADMAP Queue 3).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

NEG_INF = -1e30

#: launches of the CUDA kernel with fp pools, K1 (reset before a run)
launches = _build.LaunchCounter()
#: launches of the CUDA kernel with int8 pools, K1-int8
launches_int8 = _build.LaunchCounter()

_TAIL = ([ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_SIGNATURES = {
    "paged_decode_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 6 + _TAIL,
                            ctypes.c_int),
    "paged_decode_int8_launch": ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                 + _TAIL, ctypes.c_int)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: shared memory the kernel may use without an opt-in (bytes)
_SMEM_LIMIT = 48 * 1024


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    return x if cap is None else torch.tanh(x / cap) * cap


def gather_pool_blocks(buf: torch.Tensor, block_table: torch.Tensor
                       ) -> torch.Tensor:
    """Pool (num_blocks, block_size, ...) + table (B, nbs) -> contiguous
    per-row KV (B, nbs * block_size, ...).  Every paged read path goes
    through here so paged index semantics live in one place."""
    B, nbs = block_table.shape
    out = buf.index_select(0, block_table.reshape(-1).long())
    return out.reshape((B, nbs * buf.shape[1]) + tuple(buf.shape[2:]))


def gather_fallback(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float,
                    window: int | None = None,
                    logit_cap: float | None = None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: q (B, KV, G, hd); pools (nb, bs, KV,
    hd), int8 with ``k_scale``/``v_scale`` (nb, bs, KV); block_table
    (B, nbs) int32; lengths (B,) int32 -> (B, KV, G, hd) in q.dtype,
    computed (and dequantized) in fp32."""
    nbs, bs = block_table.shape[1], k_pool.shape[1]
    k = gather_pool_blocks(k_pool, block_table).float()
    v = gather_pool_blocks(v_pool, block_table).float()
    if k_scale is not None:
        k = k * gather_pool_blocks(k_scale, block_table).float()[..., None]
        v = v * gather_pool_blocks(v_scale, block_table).float()[..., None]
    s = torch.einsum("bkgd,btkd->bkgt", q.float() * scale, k)
    s = _softcap(s, logit_cap)
    kvpos = torch.arange(nbs * bs, device=q.device)
    ln = lengths.long()[:, None, None, None]
    mask = kvpos < ln
    if window is not None:
        mask &= (ln - 1) - kvpos < window
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1) * mask
    return torch.einsum("bkgt,btkd->bkgd", p, v).to(q.dtype)


def _check(q, k_pool, v_pool, block_table, lengths, k_scale=None,
           v_scale=None) -> None:
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q must be (B, KV, G, hd) and the pools "
                         "(num_blocks, block_size, KV, hd)")
    B, KV, G, hd = q.shape
    if k_pool.shape[2:] != (KV, hd) or v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    quant = k_pool.dtype == torch.int8
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(f"paged decode takes float32 or bfloat16 q with "
                        f"pools of the same type or int8 pools, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if quant != (k_scale is not None) or quant != (v_scale is not None):
        raise TypeError("int8 pools need k_scale and v_scale, and scales "
                        "go only with int8 pools")
    if quant:
        for sc in (k_scale, v_scale):
            if sc.shape != k_pool.shape[:3] or sc.dtype != torch.float32:
                raise ValueError(f"scales must be float32 "
                                 f"{tuple(k_pool.shape[:3])}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError("block_table must be (B, nbs) and lengths (B,)")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    devs = {t.device for t in (q, k_pool, v_pool, block_table, lengths,
                               k_scale, v_scale) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"paged decode operands on several devices: {devs}")


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_table: torch.Tensor, lengths: torch.Tensor, *,
                 scale: float, window: int | None = None,
                 logit_cap: float | None = None,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged-decode attention: the CUDA kernel on a CUDA tensor (K1, or
    K1-int8 for int8 pools with scales), the plain version on CPU
    tensors.  Same contract as :func:`gather_fallback`."""
    _check(q, k_pool, v_pool, block_table, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return gather_fallback(q, k_pool, v_pool, block_table, lengths,
                               scale=scale, window=window,
                               logit_cap=logit_cap, k_scale=k_scale,
                               v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode runs on cuda or cpu, not {q.device}")
    quant = k_scale is not None
    tensors = (q, k_pool, v_pool, block_table, lengths) \
        + ((k_scale, v_scale) if quant else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode needs contiguous operands")
    B, KV, G, hd = q.shape
    bs, hdv, nbs = k_pool.shape[1], v_pool.shape[3], block_table.shape[1]
    # all fp32: int8 pools are dequantized as they are staged
    smem = 4 * (G * hd + bs * hd + bs * hdv + G * bs + G * hdv + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged decode tile needs {smem} B of shared "
                         f"memory (> {_SMEM_LIMIT})")
    out = torch.empty((B, KV, G, hdv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = _build.load("paged_decode", _SIGNATURES)
    tail = (block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B,
            KV, G, hd, hdv, bs, nbs, float(scale),
            -1 if window is None else int(window),
            0.0 if logit_cap is None else float(logit_cap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if quant:
        rc = lib.paged_decode_int8_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), *tail)
        _build.check_launch(rc, "paged_decode_int8")
        launches_int8.count += 1
    else:
        rc = lib.paged_decode_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), *tail)
        _build.check_launch(rc, "paged_decode")
        launches.count += 1
    return out


def decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float,
                     window: int | None = None,
                     logit_cap: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
    """Public paged-decode entry point: runs on ``device`` (CUDA unless the
    caller names another) and raises if the operands lie elsewhere."""
    dev = resolve_device(device)
    if q.device.type != dev.type:
        raise ValueError(f"operands on {q.device}, expected {dev}")
    return paged_decode(q, k_pool, v_pool, block_table, lengths, scale=scale,
                        window=window, logit_cap=logit_cap, k_scale=k_scale,
                        v_scale=v_scale)


# ---------------------------------------------------------------------------
# Schedule-space registration (paper §5 over the gather-GEMM shapes)
# ---------------------------------------------------------------------------

def gather_gemm_shapes(cfg, block_size: int) -> list[tuple[int, int, int]]:
    """The two per-block p-GEMMs of the paged-decode chain, per KV head:
    scores (G, block_size, hd) and weighted values (G, hd, block_size)."""
    G = cfg.n_heads // cfg.n_kv_heads
    return [(G, block_size, cfg.hd), (G, cfg.hd, block_size)]


def resolve_gather_gemms(schedule, cfg, block_size: int, precision: str
                         ) -> list:
    """Resolve the gather GEMMs through the schedule cache (does not mark
    them applied; see :func:`note_gather_applied`)."""
    return [(M, N, K, schedule.resolve(M, N, K, precision))
            for M, N, K in gather_gemm_shapes(cfg, block_size)]


def note_gather_applied(schedule, cfg, block_size: int,
                        precision: str) -> None:
    """Record one paged-decode application of the gather-GEMM shapes,
    called by the engine right after each decode step that ran them."""
    for M, N, K, choice in resolve_gather_gemms(schedule, cfg, block_size,
                                                precision):
        schedule.note_applied(M, N, K, precision, choice)
