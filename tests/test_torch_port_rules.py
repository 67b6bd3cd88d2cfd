"""Rules the PyTorch/CUDA port keeps: it imports neither JAX nor the JAX
package, its entry points never fall back to the CPU on their own, it
refuses what is not ported yet, and chip_smoke.py fails without a card
(and outside the repo)."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "paddle_tpu")


def _forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_jax_imports_ast():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {m}" for m in mods
                    if _forbidden(m)]
    assert len(_port_files()) > 10
    assert bad == []


def test_no_jax_in_sys_modules_after_import():
    code = (
        "import sys, pkgutil, importlib, paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,"
        " 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu')"
        " or m.startswith(('jax.', 'paddle_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")


def _tiny():
    return TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32"), device="cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.LlamaForCausalLM(TL.llama_tiny(dtype="float32"))
    ContinuousBatchingEngine(model, device="cpu")       # explicit CPU runs


@pytest.mark.parametrize("knob", [
    {"ragged": False}, {"speculative": True}, {"slo": True},
    {"request_trace": True}, {"quantize": "int8"},
    {"max_queue_tokens": 512}],
    ids=["bucketed", "speculative", "slo", "request_trace", "int8",
         "queue_bound"])
def test_unported_features_raise(knob):
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousBatchingEngine(_tiny(), device="cpu", **knob)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    if where == "repo":
        cwd, script = REPO, os.path.join(REPO, "chip_smoke.py")
    else:
        cwd = str(tmp_path)
        script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
