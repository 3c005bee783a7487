"""jaxlsq_torch stands alone: importing every module of the port (and the
card's scripts, chip_smoke.py, profiler_check.py and wo_compare.py) loads
neither jax nor the jaxlsq package, and the entry
points refuse to fall back to the CPU when no device was asked for."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "jaxlsq_torch", "jaxlsq_torch._build", "jaxlsq_torch._device",
    "jaxlsq_torch.core", "jaxlsq_torch.core.spec", "jaxlsq_torch.core.golden",
    "jaxlsq_torch.observers", "jaxlsq_torch.observers.quantizer",
    "jaxlsq_torch.observers.minmax", "jaxlsq_torch.observers.histogram",
    "jaxlsq_torch.ops", "jaxlsq_torch.ops.fake_quant", "jaxlsq_torch.ops.functional",
    "jaxlsq_torch.ops.flash_attention", "jaxlsq_torch.ops.observers",
    "jaxlsq_torch.models", "jaxlsq_torch.models.qconfig", "jaxlsq_torch.models.calibrate",
    "jaxlsq_torch.models.layers", "jaxlsq_torch.models.norm",
    "jaxlsq_torch.models.toggles", "jaxlsq_torch.models.zoo", "jaxlsq_torch.models.quantize",
    "jaxlsq_torch.models.moe",
    "jaxlsq_torch.parallel", "jaxlsq_torch.parallel.train", "jaxlsq_torch.parallel.optim",
    "jaxlsq_torch._dist", "jaxlsq_torch.parallel.mesh", "jaxlsq_torch.parallel.fsdp",
    "jaxlsq_torch.parallel.moe", "jaxlsq_torch.parallel.placement",
    "jaxlsq_torch.parallel.pipeline", "jaxlsq_torch.lab.parallel_qat",
    "jaxlsq_torch.serve", "jaxlsq_torch.serve.pack", "jaxlsq_torch.serve.convert",
    "jaxlsq_torch.serve.matmul", "jaxlsq_torch.serve.attention",
    "jaxlsq_torch.serve.decode", "jaxlsq_torch.serve.paged",
    "jaxlsq_torch.serve.paged_engine", "jaxlsq_torch.serve.engine", "jaxlsq_torch.interop",
    "jaxlsq_torch.lab", "jaxlsq_torch.lab.int4_kernel_lab", "jaxlsq_torch.lab.timing",
    "jaxlsq_torch.lab.accuracy_parity", "jaxlsq_torch.lab.stock_resnet",
    "jaxlsq_torch.lab.speculative_decode",
    "jaxlsq_torch.utils", "jaxlsq_torch.utils.bn", "jaxlsq_torch.utils.checkpoint",
    "jaxlsq_torch.utils.report", "jaxlsq_torch.utils.sensitivity",
    "jaxlsq_torch.utils.mixed_precision", "jaxlsq_torch.utils.migrate",
    "jaxlsq_torch.utils.profiling", "jaxlsq_torch.serve.custom_ops",
    "jaxlsq_torch.serve.export", "jaxlsq_torch.native", "jaxlsq_torch.native.build",
    "jaxlsq_torch.native.ops", "jaxlsq_torch.native.loader",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "runpy.run_path('profiler_check.py', run_name='not_main')\n"
        "runpy.run_path('wo_compare.py', run_name='not_main')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'jaxlsq'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_need_a_device_without_cuda():
    from jaxlsq_torch.lab.stock_resnet import stock_resnet18
    from jaxlsq_torch.models import (QuantCNN, QuantDense, QuantDenseGeneral, QuantEmbed,
                                     QuantMLP, QuantMobileNetV2, QuantResNet,
                                     QuantTransformerLM, default_qconfig, quantize_model)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantTransformerLM(32, 16, 1, 2, default_qconfig(8, 8).for_serving())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantTransformerLM(32, 16, 1, 2, default_qconfig(8, 8), train_attn_impl="flash")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantResNet(10, default_qconfig(8, 8), stage_sizes=(1,), widths=(8,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantMLP(8, (4,), default_qconfig(8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantMobileNetV2(10, default_qconfig(8, 8), stages=((1, 8, 1, 1),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantMobileNetV2(10, default_qconfig(8, 8).for_serving("static"),
                         stages=((1, 8, 1, 1),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantCNN(10, default_qconfig(8, 8), widths=(8,))
    qc = default_qconfig(8, 8)
    for act_mode in ("none", "static"):  # the serve-mode layers resolve it too
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QuantDense(16, 8, qc.for_serving(act_mode))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuantEmbed(16, 8, qc.for_serving())
    for mode_qc in (qc, qc.for_serving("static")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QuantDenseGeneral((3, 5), (4, 2), mode_qc, axis=(1, 2))
    stock = stock_resnet18(10, widths=(8, 16), stage_sizes=(1, 1))
    for mode_qc in (qc, qc.for_serving("static")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            quantize_model(stock, mode_qc)
        swapped = quantize_model(stock, mode_qc, device="cpu")
        assert all(t.device.type == "cpu" for t in swapped.state_dict().values())
    model = QuantResNet(10, default_qconfig(8, 8), stage_sizes=(1,), widths=(8,),
                        device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_initialize_distributed_needs_a_device_without_cuda(monkeypatch):
    """Under torchrun's variables, with no card and no device named, the
    bring-up raises rather than fall back to gloo on the CPU; with none of
    them set it is a single-process no-op."""
    from jaxlsq_torch.parallel import initialize_distributed

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: NCCL is the default backend")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed()
