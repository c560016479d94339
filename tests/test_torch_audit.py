"""Import audit: no module of the port, and not chip_smoke.py, imports JAX,
jaxlib, flax or the JAX package ``ao_tpu`` (``ao_tpu_torch`` itself is fine)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ao_tpu"}


def _port_files():
    # _build/ holds what the kernels' build writes, not sources of the port
    files = sorted(p for p in (ROOT / "ao_tpu_torch").rglob("*.py")
                   if "_build" not in p.relative_to(ROOT).parts)
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_the_slice_modules():
    rel = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("ao_tpu_torch/quantization/primitives.py", "ao_tpu_torch/quantization/qarrays/int4.py",
                "ao_tpu_torch/quantization/granularity.py",
                "ao_tpu_torch/quantization/qarrays/int8.py",
                "ao_tpu_torch/quantization/qarrays/float8.py",
                "ao_tpu_torch/quantization/qarrays/fp4.py",
                "ao_tpu_torch/quantization/qarrays/fp6.py", "ao_tpu_torch/quantization/qarrays/mx.py",
                "ao_tpu_torch/quantization/qarrays/nvfp4.py",
                "ao_tpu_torch/quantization/qarrays/nf4.py", "ao_tpu_torch/prototype/mx.py",
                "ao_tpu_torch/ops/hopper/fp4_matmul.py", "ao_tpu_torch/ops/hopper/lut4_matmul.py",
                "ao_tpu_torch/ops/hopper/int8_matmul.py", "ao_tpu_torch/ops/hopper/fp8_matmul.py",
                "ao_tpu_torch/quantization/configs.py", "ao_tpu_torch/ops/act_quant.py",
                "ao_tpu_torch/ops/kernels.py", "ao_tpu_torch/ops/linear.py",
                "ao_tpu_torch/ops/hopper/int4_matmul.py", "ao_tpu_torch/ops/hopper/decode_attention.py",
                "ao_tpu_torch/ops/hopper/fused_act.py", "ao_tpu_torch/ops/hopper/flash_attention.py",
                "ao_tpu_torch/ops/hopper/paged_attention.py",
                "ao_tpu_torch/models/llama.py", "ao_tpu_torch/serving/decode.py",
                "ao_tpu_torch/serving/kvcache.py", "ao_tpu_torch/serving/sampling.py",
                "ao_tpu_torch/serving/paged.py", "ao_tpu_torch/serving/engine.py",
                "ao_tpu_torch/weights.py", "ao_tpu_torch/ops/conv.py",
                "ao_tpu_torch/ops/hopper/window_attention.py", "ao_tpu_torch/models/vit.py",
                "ao_tpu_torch/models/sam.py", "ao_tpu_torch/moe/grouped.py",
                "ao_tpu_torch/moe/layer.py", "ao_tpu_torch/ops/hopper/grouped_matmul.py",
                "ao_tpu_torch/sparsity/blocksparse.py", "ao_tpu_torch/sparsity/sparse24.py",
                "ao_tpu_torch/sparsity/configs.py", "ao_tpu_torch/algorithms/observe.py",
                "ao_tpu_torch/ops/hopper/bsr_matmul.py", "chip_smoke.py"):
        assert mod in rel, mod
    for src in ("int4_matmul.cu", "decode_attention.cu", "int4_w4a8.cu", "fused_act.cu",
                "flash_attention.cu", "paged_attention.cu", "int8_matmul.cu", "fp8_matmul.cu",
                "fp4_matmul.cu", "lut4_matmul.cu", "window_attention.cu", "grouped_matmul.cu",
                "bsr_matmul.cu", "int4_tiles.cuh"):
        assert (ROOT / "ao_tpu_torch" / "csrc" / src).exists()
    from ao_tpu_torch.ops.hopper import build

    assert set(build.SOURCES) == {p.stem for p in (ROOT / "ao_tpu_torch" / "csrc").glob("*.cu")}
