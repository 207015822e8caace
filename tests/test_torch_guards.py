"""Guards of the port's boundary: ``repro_torch`` and ``chip_smoke.py``
never import JAX or the reference package, and the public entry points
refuse to run on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules() -> list[str]:
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py (imported, not run),
    loads in a process where ``import jax`` fails."""
    code = "\n".join([
        "import importlib, importlib.util, sys",
        "sys.modules['jax'] = None",
        f"sys.path.insert(0, {str(ROOT / 'src')!r})",
        f"for name in {_modules()!r}:",
        "    importlib.import_module(name)",
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})",
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "assert not any(m == 'repro' or m.startswith(('repro.', 'jax'))",
        "               for m in sys.modules if sys.modules[m] is not None)",
        "print('ok')",
    ])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    from repro_torch import configs
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import network as N
    from repro_torch.serving.engine import ContinuousEngine
    cfg = configs.get("qwen2_0_5b").scaled_down()
    params = N.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, params, slots=2, max_len=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        N.init(cfg)
    q = torch.zeros(1, 1, 1, 8)
    pool = torch.zeros(2, 4, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PA.decode_attention(q, pool, pool, torch.ones(1, 1, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32), scale=1.0)


def test_kernel_wrappers_never_fall_back():
    """A tensor on a device other than the CPU never reaches the plain
    version: the wrappers launch the kernel or raise."""
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.kernels import mpgemm as MP
    a = torch.zeros(4, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        MP.mpgemm(a, torch.zeros(32, 64, device="meta"),
                  dataflow=Dataflow.IS, bm=16, bn=64, bk=32)


def test_spill_kernel_wrapper_never_falls_back():
    """K6 likewise, called directly, through ``mpgemm(epilogue="spill")``
    or through ``ops.matmul``: a meta tensor is neither launched nor sent
    to the plain version."""
    from repro_torch.core.dataflow import Dataflow
    from repro_torch.kernels import mpgemm as MP
    from repro_torch.kernels import ops as OPS
    a = torch.zeros(4, 64, device="meta")
    b = torch.zeros(64, 64, device="meta")
    MP.reset_launches()
    for df in (Dataflow.OS, Dataflow.WS, Dataflow.IS):
        with pytest.raises(ValueError, match="cuda or cpu"):
            MP.mpgemm_spill(a, b, dataflow=df, bm=16, bn=64, bk=32,
                            k_fold=2)
        with pytest.raises(ValueError, match="cuda or cpu"):
            MP.mpgemm(a, b, dataflow=df, bm=16, bn=64, bk=32, k_fold=2,
                      epilogue="spill")
        with pytest.raises(ValueError, match="cuda or cpu"):
            OPS.matmul(a, b, dataflow=df, k_fold=2, epilogue="spill")
    assert MP.spill_launches.count == 0 and MP.launches.count == 0


def test_quant_kernel_wrappers_never_fall_back():
    """K3 and K1-int8 likewise: a meta tensor is neither launched nor sent
    to the plain version."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quant_matmul as QM
    with pytest.raises(ValueError, match="cuda or cpu"):
        QM.quant_matmul(torch.zeros(4, 32, device="meta"),
                        torch.zeros(32, 16, dtype=torch.int8, device="meta"),
                        torch.zeros(16, device="meta"))
    pool = torch.zeros(2, 4, 1, 8, dtype=torch.int8, device="meta")
    scales = torch.zeros(2, 4, 1, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        PA.paged_decode(torch.zeros(1, 1, 1, 8, device="meta"), pool, pool,
                        torch.ones(1, 1, dtype=torch.int32, device="meta"),
                        torch.ones(1, dtype=torch.int32, device="meta"),
                        scale=1.0, k_scale=scales, v_scale=scales)


def test_chip_smoke_refuses_without_port(tmp_path):
    """Alone in a directory, chip_smoke.py exits non-zero with no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_limb_kernel_wrapper_never_falls_back():
    """K4 likewise, called directly or through ops.limb_matmul: a tensor
    off the CPU is launched or refused, never sent to the plain version."""
    from repro_torch.kernels import limb_gemm as LG
    from repro_torch.kernels import ops as OPS
    before = LG.launches.count
    with pytest.raises(ValueError, match="cuda or cpu"):
        LG.limb_gemm_diagonals(
            torch.zeros(5, 4, 32, dtype=torch.int8, device="meta"),
            torch.zeros(5, 32, 16, dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        OPS.limb_matmul(torch.zeros(4, 32, dtype=torch.int32, device="meta"),
                        torch.zeros(32, 16, dtype=torch.int32,
                                    device="meta"))
    assert LG.launches.count == before


def test_multiprecision_entry_point_refuses_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    from repro_torch.launch import multiprecision_gemm
    with pytest.raises(RuntimeError, match="CUDA"):
        multiprecision_gemm.main([])


def test_ssd_kernel_wrapper_never_falls_back():
    """K5 likewise: a meta tensor is neither launched nor sent to the
    plain version."""
    from repro_torch.kernels import ssd as K
    before = K.launches.count
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.ssd_intra(*(torch.zeros(shape, device="meta") for shape in (
            (2, 8, 4), (2, 8), (2, 8), (2, 8, 3), (2, 8, 3))))
    assert K.launches.count == before


def test_mamba_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    from repro_torch import configs
    from repro_torch.models import network as N
    from repro_torch.serving.engine import ContinuousEngine
    cfg = configs.get("mamba2-2.7b").scaled_down()
    params = N.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousEngine(cfg, params, slots=2, max_len=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        N.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        N.init_paged_caches(cfg, 2, 8, 16)
