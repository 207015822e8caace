"""SSD (Mamba2) intra-chunk kernel (K5): the paper's p-GEMM classification
made concrete for the SSM family.

The chunked SSD algorithm's hot spot is the intra-chunk piece

    y[g, s] = sum_{t <= s} (C_s . B_t) * exp(cums_s - cums_t) * dt_t * x_t

per flattened (batch, chunk, head) index g: two back-to-back GEMMs, (Q x N)
by (N x Q) and (Q x Q) by (Q x P), with the causal decay mask between
them.  :func:`ssd_intra` wraps ``csrc/ssd_intra.cu`` (the port of the
reference's Pallas ``ssd_intra``): on CUDA tensors it launches the kernel
or raises; on CPU tensors it runs :func:`ssd_intra_ref`, the plain
version.  Any Q, P, N is taken: the kernel masks its edges.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel (reset before a run, read after it)
launches = _build.LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_intra_launch": ([_P] * 6 + [_I] * 4 + [_P], _I)}


def ssd_intra_ref(x: torch.Tensor, dt: torch.Tensor, cums: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version (the reference's ``ssd_intra_ref``): fp32 (G, Q, P).

    The decay exponent is masked to -inf above the diagonal before
    ``exp``: for s < t, ``cums_s - cums_t`` is positive and its ``exp``
    overflows within a full-width chunk, so no masked value is ever
    ``inf`` and no product ever meets one."""
    Q = x.shape[1]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cums.float()[:, :, None] - cums.float()[:, None, :]
    L = torch.exp(seg.masked_fill(~causal, float("-inf")))
    s = torch.bmm(c.float(), b.float().transpose(1, 2)) * L \
        * dt.float()[:, None, :]
    return torch.bmm(s, x.float())


def _check(x, dt, cums, b, c) -> None:
    if x.dim() != 3 or b.dim() != 3 or c.dim() != 3 \
            or dt.shape != x.shape[:2] or cums.shape != x.shape[:2] \
            or b.shape[:2] != x.shape[:2] or c.shape != b.shape:
        raise ValueError(f"ssd_intra needs x (G, Q, P), dt and cums (G, Q), "
                         f"b and c (G, Q, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(cums.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if any(t.dtype != torch.float32 for t in (x, dt, cums, b, c)):
        raise TypeError("ssd_intra takes float32 operands (the caller "
                        "casts, as the reference's ssd_chunked does)")
    devs = {t.device for t in (x, dt, cums, b, c)}
    if len(devs) != 1:
        raise ValueError(f"ssd_intra operands on several devices: {devs}")


def ssd_intra(x: torch.Tensor, dt: torch.Tensor, cums: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD contributions: x (G, Q, P), dt and cums (G, Q), b
    and c (G, Q, N), all fp32 -> y (G, Q, P) fp32; the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    _check(x, dt, cums, b, c)
    if x.device.type == "cpu":
        return ssd_intra_ref(x, dt, cums, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, cums, b, c)):
        raise ValueError("ssd_intra needs contiguous operands")
    G, Q, P = x.shape
    N = b.shape[2]
    if min(G, Q, P, N) == 0:
        raise ValueError(f"degenerate ssd_intra {(G, Q, P, N)}")
    y = torch.empty((G, Q, P), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_intra", _SIGNATURES)
    rc = lib.ssd_intra_launch(
        x.data_ptr(), dt.data_ptr(), cums.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), G, Q, P, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(rc, f"ssd_intra {(G, Q, P, N)}")
    launches.count += 1
    return y
