"""The port stands alone: no JAX, nothing of the JAX package, and no
silent drift to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.runtime.steps, "
            "repro_torch.kernels.ops, repro_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serve_without_gpu_raises_unless_cpu_requested(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--prompt-len", "4", "--gen", "2"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced("starcoder2-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_quant_state(cfg)
    assert resolve_device("cpu").type == "cpu"
