"""The paper's nine evaluation workloads (Table 2), decomposed into p-GEMM +
vector operators (copy of ``repro.core.workloads``).

Table 2 in the source text lists workload names and precisions but its size
column is garbled; sizes below are re-derived from the canonical definitions
of the named applications (AlexNet layer table, GPT-3 175B FFN dims, 2048-bit
modular multiplication, etc.).  Precisions follow Table 2:

  BNM INT64 (big-number limbs) | RGB INT8 | FFE INT16 | MD INT32 | PCA FP64
  ALT FP32 | FFL BP16 | ALI INT8 | Nerf FP32
"""

from __future__ import annotations

from collections.abc import Sequence

from repro_torch.core.pgemm import (PGEMM, Operator, VectorOp,
                                    bignum_mult_as_pgemm, conv2d_as_pgemm,
                                    linear_as_pgemm)
from repro_torch.core.precision import (BP16, FP32, FP64, INT8, INT16,
                                        INT32, INT64, Precision)


def _alexnet_convs(precision: Precision, batch: int) -> list[PGEMM]:
    """AlexNet's five conv layers as im2col p-GEMMs."""
    specs = [
        ("conv1", 3, 96, (227, 227), (11, 11), 4, 0),
        ("conv2", 96, 256, (27, 27), (5, 5), 1, 2),
        ("conv3", 256, 384, (13, 13), (3, 3), 1, 1),
        ("conv4", 384, 384, (13, 13), (3, 3), 1, 1),
        ("conv5", 384, 256, (13, 13), (3, 3), 1, 1),
    ]
    ops = []
    for name, cin, cout, hw, khw, s, p in specs:
        ops.append(conv2d_as_pgemm(f"alexnet.{name}", batch=batch, in_ch=cin,
                                   out_ch=cout, img_hw=hw, kernel_hw=khw,
                                   stride=s, pad=p, precision=precision))
    return ops


def _alexnet_fcs(precision: Precision, batch: int) -> list[PGEMM]:
    return [
        linear_as_pgemm("alexnet.fc6", batch_tokens=batch, d_in=9216,
                        d_out=4096, precision=precision),
        linear_as_pgemm("alexnet.fc7", batch_tokens=batch, d_in=4096,
                        d_out=4096, precision=precision),
        linear_as_pgemm("alexnet.fc8", batch_tokens=batch, d_in=4096,
                        d_out=1000, precision=precision),
    ]


def bnm() -> list[Operator]:
    """Big-number multiplication: 2048-bit x 2048-bit modular multiplies
    (RSA/NTT-style), 4096 of them, on INT64 limb arithmetic."""
    return [
        bignum_mult_as_pgemm("bnm.mul2048", digits_bits=2048, n_mults=4096,
                             precision=INT64),
        VectorOp("bnm.carry_prop", n_elems=4096 * 64, precision=INT64,
                 ops_per_elem=2),
    ]


def rgb() -> list[Operator]:
    """sRGB->XYZ: a 3x3 color-space matrix applied per pixel of a 1080p
    frame (M = H*W, N = 3, K = 3) + gamma-decode vector pass."""
    return [
        PGEMM("rgb.csc", M=1920 * 1080, N=3, K=3, precision=INT8),
        VectorOp("rgb.gamma", n_elems=1920 * 1080 * 3, precision=INT8,
                 ops_per_elem=2),
    ]


def ffe() -> list[Operator]:
    """Feed-forward equalizer: 128-tap FIR over 1 s of 48 kHz stereo audio,
    INT16 — a skinny p-GEMM (M=samples, N=channels, K=taps)."""
    return [
        PGEMM("ffe.fir", M=48000, N=2, K=128, precision=INT16),
        VectorOp("ffe.agc", n_elems=48000 * 2, precision=INT16,
                 ops_per_elem=3),
    ]


def md() -> list[Operator]:
    """Blocked LU decomposition of a 1024x1024 INT32 matrix: the trailing
    rank-b updates dominate — model the update sweep as shrinking GEMMs
    (block 64) plus pivoting/scaling vector work."""
    n, b = 1024, 64
    ops: list[Operator] = []
    k = n
    while k > b:
        k -= b
        ops.append(PGEMM(f"md.update{k}", M=k, N=k, K=b, precision=INT32))
    ops.append(VectorOp("md.pivot_scale", n_elems=n * n, precision=INT32,
                        ops_per_elem=2))
    return ops


def pca() -> list[Operator]:
    """PCA on a 8192-sample x 1024-feature FP64 matrix: covariance GEMM +
    a few power-iteration matvecs + mean-centering vector pass."""
    return [
        PGEMM("pca.cov", M=1024, N=1024, K=8192, precision=FP64),
        PGEMM("pca.power_iter", M=1024, N=1, K=1024, precision=FP64, batch=16),
        VectorOp("pca.center", n_elems=8192 * 1024, precision=FP64,
                 ops_per_elem=2),
    ]


def alt() -> list[Operator]:
    """AlexNet training step (batch 128, FP32): fwd + ~2x bwd GEMM volume
    (dgrad + wgrad), plus activation/loss vector work."""
    fwd = _alexnet_convs(FP32, 128) + _alexnet_fcs(FP32, 128)
    ops: list[Operator] = []
    for g in fwd:
        ops.append(g)                                        # forward
        ops.append(g.scaled(g.name + ".dgrad"))              # data grad
        ops.append(g.scaled(g.name + ".wgrad"))              # weight grad
    ops.append(VectorOp("alt.relu_fwd_bwd", n_elems=128 * 650_000,
                        precision=FP32, ops_per_elem=2))
    ops.append(VectorOp("alt.sgd_update", n_elems=61_000_000, precision=FP32,
                        ops_per_elem=4))
    return ops


def ffl() -> list[Operator]:
    """GPT-3 175B feed-forward layer, BP16: d=12288, ffn=49152, 2048 tokens
    (one layer fwd; up + down projections) + GeLU vector pass."""
    return [
        linear_as_pgemm("ffl.up", batch_tokens=2048, d_in=12288, d_out=49152,
                        precision=BP16),
        linear_as_pgemm("ffl.down", batch_tokens=2048, d_in=49152,
                        d_out=12288, precision=BP16),
        VectorOp("ffl.gelu", n_elems=2048 * 49152, precision=BP16,
                 ops_per_elem=4),
    ]


def ali() -> list[Operator]:
    """AlexNet INT8 inference, batch 32."""
    ops: list[Operator] = list(_alexnet_convs(INT8, 32))
    ops += _alexnet_fcs(INT8, 32)
    ops.append(VectorOp("ali.relu", n_elems=32 * 650_000, precision=INT8,
                        ops_per_elem=1))
    ops.append(VectorOp("ali.requant", n_elems=32 * 650_000, precision=INT8,
                        ops_per_elem=2))
    return ops


def nerf() -> list[Operator]:
    """NeRF MLP, FP32: 8 hidden layers of width 256 over 65536 ray samples +
    positional-encoding and volume-rendering vector passes."""
    ops: list[Operator] = [
        linear_as_pgemm("nerf.in", batch_tokens=65536, d_in=60, d_out=256,
                        precision=FP32)]
    for i in range(7):
        d_in = 256 + (60 if i == 4 else 0)  # skip connection at layer 5
        ops.append(linear_as_pgemm(f"nerf.h{i}", batch_tokens=65536,
                                   d_in=d_in, d_out=256, precision=FP32))
    ops.append(linear_as_pgemm("nerf.sigma_rgb", batch_tokens=65536,
                               d_in=256, d_out=4, precision=FP32))
    ops.append(VectorOp("nerf.posenc", n_elems=65536 * 60, precision=FP32,
                        ops_per_elem=4))
    ops.append(VectorOp("nerf.volrender", n_elems=65536 * 4, precision=FP32,
                        ops_per_elem=6))
    return ops


WORKLOADS: dict[str, Sequence[Operator]] = {}


def _register():
    for fn in (bnm, rgb, ffe, md, pca, alt, ffl, ali, nerf):
        WORKLOADS[fn.__name__.upper()] = tuple(fn())


_register()

WORKLOAD_PRECISION: dict[str, Precision] = {
    "BNM": INT64, "RGB": INT8, "FFE": INT16, "MD": INT32, "PCA": FP64,
    "ALT": FP32, "FFL": BP16, "ALI": INT8, "NERF": FP32,
}


def workload(name: str) -> Sequence[Operator]:
    key = name.upper()
    if key not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(WORKLOADS)}")
    return WORKLOADS[key]
