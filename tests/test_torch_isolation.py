"""simlingo_tpu_torch stands alone: it imports no jax, flax or simlingo_tpu.

A subprocess blocks those imports, imports every module of the port
(the training modules included), drives the tiny agent and two training
steps with LoRA dropout on the CPU, then two more with both fused-kernel
gates on; an entry point built without `device` must refuse on a machine
without a GPU.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "flax", "jaxlib") or name == "simlingo_tpu" \\
                    or name.startswith("simlingo_tpu."):
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    import simlingo_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        simlingo_tpu_torch.__path__, "simlingo_tpu_torch.")]
    for n in names:
        importlib.import_module(n)
    print("imported", len(names))

    from simlingo_tpu_torch.agent.agent import AgentFrame, LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig

    tok = SimLingoTokenizer()
    cfg = simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=64, num_layers=2, num_heads=4,
                      intermediate_size=128, image_size=448, patch_size=56,
                      projector_out=64),
        llm=Qwen2Config.tiny(vocab_size=tok.tk.vocab_size + 8),
        img_context_token_id=tok.img_context_id)
    params = simlingo.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    agent = LingoAgent(params, cfg, AgentConfig(
        max_new_tokens=4, spec_k=4, initial_frames_delay=0,
        jpeg_roundtrip=False), tokenizer=tok, max_prompt_len=256,
        compute_dtype=torch.float32, device="cpu")
    frame = AgentFrame(rgb=np.zeros((512, 1024, 3), np.uint8), speed=2.0,
                       target_point=np.array([8.0, 0.0]),
                       next_target_point=np.array([16.0, 0.0]))
    for _ in range(2):
        r = agent.run_step(frame)
        assert np.isfinite(r["route"]).all() and len(r["language_tokens"]) == 4
    assert len(agent.spec_stats) == 1

    import dataclasses
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    from simlingo_tpu_torch.kernels import dropout as TD
    from simlingo_tpu_torch.train import trainer
    tcfg = compose(["max_steps=2", "data.batch_size=2", "data.max_text_len=96",
                    "precision=fp32"])
    tiny = simlingo.SimLingoConfig.tiny()
    tcfg.model = dataclasses.replace(tiny, llm=dataclasses.replace(
        tiny.llm, lora_r=4, lora_alpha=8, lora_dropout=0.1))
    recs = trainer.train(tcfg, device="cpu")["records"]
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    assert TD.dropout.launches == 0          # CPU tensors take the plain version

    import os
    from simlingo_tpu_torch.kernels import fused_ce as TCE, layernorm as TLN
    os.environ.update(SIMLINGO_CE_IMPL="pallas", SIMLINGO_LN_IMPL="pallas")
    gated = trainer.train(tcfg, device="cpu")["records"]
    del os.environ["SIMLINGO_CE_IMPL"], os.environ["SIMLINGO_LN_IMPL"]
    assert len(gated) == 2 and all(np.isfinite(r["loss"]) for r in gated)
    assert abs(gated[0]["loss"] - recs[0]["loss"]) <= 1e-4 * abs(recs[0]["loss"])
    assert all(fn.launches == 0 for fn in (
        TCE.fused_ce_fwd, TCE.fused_ce_bwd, TLN.layernorm_fwd, TLN.layernorm_bwd,
        TLN.rmsnorm_fwd, TLN.rmsnorm_bwd))

    if not torch.cuda.is_available():
        for build in (lambda: LingoAgent(params, cfg),
                      lambda: simlingo.init_params(cfg, torch.Generator()),
                      lambda: trainer.train(tcfg),
                      lambda: synthetic_example(tiny, 1, 96)):
            try:
                build()
            except RuntimeError as e:
                assert "no CUDA GPU" in str(e), e
            else:
                raise AssertionError("entry point without device did not raise")
    assert not any(m == "simlingo_tpu" or m.startswith(("simlingo_tpu.", "jax", "flax"))
                   for m in sys.modules), "a blocked module got imported"
    print("ok")
""")


def test_port_imports_no_jax_and_runs_agent_on_cpu():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok"), res.stdout


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero with no result line when there is no
    GPU, and when it stands alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    cases = [(str(alone), tmp_path)]
    if not torch.cuda.is_available():
        cases.append(("chip_smoke.py", ROOT))
    runs = [subprocess.Popen([sys.executable, script], cwd=cwd, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for script, cwd in cases]                 # both at once
    for proc in runs:
        stdout, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in stdout
