"""The port stands apart from the JAX package and runs on CUDA unless asked.

* Importing every ``repro_torch`` module, ``chip_smoke.py``, the ranks of
  the multi-rank tests (``tests/multidevice_ranks.py``) and the multi-card
  tools (``tools/{elastic_cards,tp_serve}.py``) loads neither jax nor any
  module of ``repro`` (checked in a fresh interpreter).
* The port's copy of each config equals the JAX package's, field for field.
* Entry points asked for no device try CUDA, and raise where it is absent:
  the LM, the encoder-decoder, the Engine.
* ``attn_impl="pallas"`` (the hand-written kernels) raises for CPU tensors,
  in attention, in the Mamba-2 block, in the encoder-decoder's encoder and
  cross-attention and in the MoE model's attention.
* The kernel rule (``layers.use_kernel``): ``"auto"`` takes the kernels on
  CUDA only while autograd does not record, JAX's plain rule otherwise;
  ``"pallas"`` raises under autograd.  The training entry points default to
  CUDA too, and so do the elastic trainer and the train launcher.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.coord import ElasticTrainer
from repro_torch.launch import train as launch_train
from repro_torch.models import LM, EncDecLM, get_model
from repro_torch.models import layers, mamba2
from repro_torch.serve import Engine
from repro_torch.train import OptConfig, init_state
from repro_torch.train.data import DataConfig, TokenPipeline

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, {root!r})
import chip_smoke
sys.path.insert(0, {root!r} + "/tests")
import multidevice_ranks  # the gloo ranks of tests/test_torch_multidevice.py
sys.path.insert(0, {root!r} + "/tools")
import elastic_cards, tp_serve  # the multi-card tools
import json, os, subprocess, time, torch  # what chip_smoke's phases import
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "ml_dtypes", "repro") or n.startswith(("jax.", "repro.")))
print("LEAKED", bad)
"""


def test_port_imports_no_jax_and_no_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT))],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_config_copies_match(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    for mine, theirs in [(get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_get_smoke_config(arch))]:
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def _tiny_model():
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    return LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    model = _tiny_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(model.cfg).init(torch.Generator())
    Engine(model, device="cpu")  # asking for the CPU works


def test_pallas_impl_raises_on_cpu():
    model = _tiny_model()
    cfg = model.cfg.replace(attn_impl="pallas")
    p = model.blocks.layers()[0]["attn"]
    x = torch.randn(1, 4, cfg.d_model)
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.attn_apply(cfg, p, x)
    cache = torch.zeros(1, 8, cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.attn_decode_apply(cfg, p, x[:, :1], (cache, cache.clone()),
                                 torch.tensor([2], dtype=torch.int32))


def test_pallas_impl_raises_on_cpu_ssm():
    cfg = get_smoke_config("mamba2_2p7b").replace(dtype="float32")
    model = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    p = model.blocks.layers()[0]["mamba"]
    x = torch.randn(1, 32, cfg.d_model)
    mamba2.mamba_apply(cfg, p, x)  # the plain path runs
    with pytest.raises(RuntimeError, match="CUDA"):
        mamba2.mamba_apply(cfg.replace(attn_impl="pallas"), p, x)


def test_default_device_is_cuda_encdec():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    cfg = get_smoke_config("seamless_m4t_large_v2").replace(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        EncDecLM(cfg).init(torch.Generator())
    model = EncDecLM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model)
    Engine(model, device="cpu")


def test_pallas_impl_raises_on_cpu_encdec_and_moe():
    cfg = get_smoke_config("seamless_m4t_large_v2").replace(dtype="float32")
    model = EncDecLM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    emb = torch.randn(1, cfg.enc_len, cfg.d_model)
    model.encode(emb)  # the plain path runs
    pallas = EncDecLM(cfg.replace(attn_impl="pallas"))
    pallas.load_state_dict(model.state_dict(), assign=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        pallas.encode(emb)
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.cross_attn_apply(pallas.cfg, model.dec_blocks.layers()[0]["xattn"],
                                torch.randn(1, 3, cfg.d_model), emb)
    moe_cfg = get_smoke_config("grok_1_314b").replace(dtype="float32", attn_impl="pallas")
    moe = get_model(moe_cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.prefill(torch.zeros(1, 4, dtype=torch.long), max_len=8)


@pytest.mark.parametrize("impl", ["auto", "pallas", "naive", "chunked"])
def test_kernel_rule(impl):
    """Which path attention and the SSD take, for each device and grad mode:
    the kernels under "pallas", and under "auto" on CUDA unless autograd
    records; "pallas" raises on the CPU and under autograd, naming the
    plain path."""
    for on_cuda in (False, True):
        for grad in (False, True):
            if impl == "pallas" and not on_cuda:
                with pytest.raises(RuntimeError, match="CPU tensor"):
                    layers.use_kernel(impl, on_cuda, grad)
            elif impl == "pallas" and grad:
                with pytest.raises(RuntimeError, match="no backward.*plain path"):
                    layers.use_kernel(impl, on_cuda, grad)
            else:
                want = impl == "pallas" or (impl == "auto" and on_cuda and not grad)
                assert layers.use_kernel(impl, on_cuda, grad) is want


def test_autograd_takes_the_plain_path_on_cpu():
    """Under autograd "auto" runs JAX's rule (naive at 8 tokens) and the
    gradient reaches the layers before attention; "pallas" raises."""
    model = _tiny_model().requires_grad_(True)
    tokens = torch.randint(0, model.cfg.vocab, (1, 8))
    model.hidden_states(tokens, remat=True).float().pow(2).mean().backward()
    assert model.blocks.attn["wq"].grad.abs().sum() > 0
    pallas = LM(model.cfg.replace(attn_impl="pallas"))
    pallas.load_state_dict(model.state_dict(), assign=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        pallas.hidden_states(tokens, remat=True)


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    cfg = get_smoke_config("stablelm_12b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg, OptConfig(), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenPipeline(DataConfig(vocab=16, seq_len=4, global_batch=1)).torch_batch_at(0)
    init_state(cfg, OptConfig(), torch.Generator(), device="cpu")  # asking for the CPU works


def test_elastic_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    cfg = get_smoke_config("stablelm_12b").replace(dtype="float32")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticTrainer(cfg, OptConfig(), dcfg, pods=["pod0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "stablelm_12b", "--smoke", "--steps", "1",
                           "--checkpoint-dir", str(tmp_path)])
    ElasticTrainer(cfg, OptConfig(), dcfg, pods=["pod0"], device="cpu")  # asking for the CPU works
