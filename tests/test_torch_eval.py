"""The port's offline evaluation against the JAX package's (CPU, fp32).

- `eval/metrics.py`: every metric function and `evaluation_suite` give
  JAX's numbers exactly on the same corpora; the threaded, mocked
  `gpt_judge` drops failed and non-numeric replies as JAX's does.
- `eval/dreamer_rules.py`: the per-mode success rules and the aggregate.
- `eval/eval_sets.py`: building, parsing and matching eval sets on the
  routes of `tests/torch_routes.py`, equal to JAX's.
- `eval/language_eval.py:run_language_eval` in QA (an eval set's forced
  templates), commentary and Dreaming mode on those routes, from the same
  JAX-initialised tiny model (LoRA r=4): the language strings and every
  written JSON equal JAX's, the route and speed waypoints within 2e-4.
"""

import json
import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.data import dreamer_dataset as jdd
from simlingo_tpu.data import driving_dataset as jds
from simlingo_tpu.data import index as jindex
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.eval import dreamer_rules as JD
from simlingo_tpu.eval import eval_sets as JS
from simlingo_tpu.eval import language_eval as JL
from simlingo_tpu.eval import metrics as JM
from simlingo_tpu.infer import runner as jrun
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data import dreamer_dataset as tdd
from simlingo_tpu_torch.data import driving_dataset as tds
from simlingo_tpu_torch.data import index as tindex
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.eval import dreamer_rules as TD
from simlingo_tpu_torch.eval import eval_sets as TS
from simlingo_tpu_torch.eval import language_eval as TL
from simlingo_tpu_torch.eval import metrics as TM
from simlingo_tpu_torch.infer import runner as trun
from tests import torch_routes as R
from tests.test_torch_train import _port_cfg

TOL = dict(atol=2e-4, rtol=2e-4)

REFS = ["the red car stops at the light", "the ego turns left",
        "The ego vehicle stays behind the red vehicle and stops because of the "
        "red traffic light.", "Keep driving along the lane.", ""]
PREDS = ["the red car stops at the light", "the ego turns left now",
         "To stay behind the red vehicle, the ego vehicle slows down.",
         "banana banana banana", "anything"]
SYN = {"automobile": {"car", "auto"}, "halts": {"stop", "stops"}}
METRICS = {
    "exact_match": lambda M, p, r: M.exact_match(p, r),
    "bleu": lambda M, p, r: M.bleu(p, r),
    "bleu_2": lambda M, p, r: M.bleu(p, r, max_n=2),
    "rouge_l": lambda M, p, r: M.rouge_l(p, r),
    "cider": lambda M, p, r: M.cider(p, r),
    "meteor": lambda M, p, r: M.meteor(p, r),
    "meteor_synonyms": lambda M, p, r: M.meteor(
        p + ["the automobile halts for the person"], r + ["the car stops for the person"],
        synonyms=lambda w: SYN.get(w, set())),
    "spice": lambda M, p, r: M.spice(p, r),
    "scene_tuples": lambda M, p, r: [sorted(M.scene_tuples(x)) for x in p + r],
    "porter_stem": lambda M, p, r: [M._porter_stem(w) for x in p + r for w in x.split()],
    "evaluation_suite": lambda M, p, r: M.evaluation_suite(p, r),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_equals_jax(name):
    fn = METRICS[name]
    for preds, refs in ((PREDS, REFS), (REFS, REFS), (PREDS[::-1], REFS)):
        assert fn(TM, preds, refs) == fn(JM, preds, refs)


def _fake_openai(monkeypatch):
    calls = {"n": 0, "threads": set()}
    lock = threading.Lock()

    class _Resp:
        def __init__(self, content):
            self.choices = [types.SimpleNamespace(message=types.SimpleNamespace(
                content=content))]

    class _Completions:
        def create(self, model, messages):
            with lock:
                calls["n"] += 1
                calls["threads"].add(threading.get_ident())
                i = calls["n"]
            if i == 3:
                raise RuntimeError("transient API error")
            if i == 4:
                return _Resp("not a number")
            return _Resp("80")

    class _Client:
        def __init__(self, api_key=None, base_url=None):
            self.chat = types.SimpleNamespace(completions=_Completions())

    fake = types.ModuleType("openai")
    fake.OpenAI = _Client
    monkeypatch.setitem(sys.modules, "openai", fake)
    return calls


def test_gpt_judge_threaded(monkeypatch):
    """As JAX's test_eval.py: 6 requests over the pool, the failing and the
    non-numeric reply dropped from the mean; no key, no judge."""
    calls = _fake_openai(monkeypatch)
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")
    preds = [f"pred {i}" for i in range(6)]
    refs = [f"ref {i}" for i in range(6)]
    assert TM.gpt_judge(preds, refs) == 80.0 and calls["n"] == 6
    monkeypatch.delenv("OPENAI_API_KEY")
    assert TM.gpt_judge(preds, refs) is None
    assert "gpt_judge" not in TM.evaluation_suite(preds, refs, use_judge=True)


def _wps(speed, n=10, decel=0.0):
    t = np.arange(1, n + 1) * 0.25
    v = np.maximum(speed + decel * t, 0.0)
    return np.stack([np.cumsum(v * 0.25), np.zeros(n)], 1)


def test_dreamer_rules_equal_jax():
    """The cases of JAX's test_dreamer_rules, each evaluated by both."""
    org_wps = _wps(5.0)
    org_route = np.stack([np.arange(1, 21), np.zeros(20)], 1)
    new_route = np.stack([np.arange(1, 21), np.full(20, 3.5)], 1)
    pred_route = np.stack([np.arange(1, 21), np.full(20, 3.0)], 1)
    cases = [
        ("stop", _wps(0.0), org_route, org_wps, org_route, 5.0, None, True),
        ("stop", _wps(5.0), org_route, org_wps, org_route, 5.0, None, False),
        ("slower", _wps(5.0, decel=-1.5), org_route, org_wps, org_route, 5.0, None, True),
        ("slower", _wps(5.0), org_route, org_wps, org_route, 5.0, None, False),
        ("faster", _wps(5.0, decel=1.5), org_route, org_wps, org_route, 5.0, None, True),
        ("lane_change", org_wps, pred_route, org_wps, new_route, 5.0, None, True),
        ("lane_change", org_wps, org_route, org_wps, new_route, 5.0, None, False),
        ("target_speed", _wps(8.0), org_route, _wps(8.0), org_route, 5.0, None, True),
        ("target_speed", _wps(2.0), org_route, _wps(8.0), org_route, 5.0, None, False),
        ("target_speed", _wps(6.0), org_route, org_wps, org_route, 5.0, 6.0, None),
        ("crash", _wps(4.0), new_route, org_wps, new_route, 5.0, None, None),
    ]
    for mode, wps, route, new_wps, new_path, speed, target, want in cases:
        args = (mode, wps, route, org_wps, org_route, new_wps, new_path, speed, target)
        got = TD.evaluate_sample(*args)
        assert got == JD.evaluate_sample(*args), mode
        if want is not None:
            assert got is want, mode
    rows = [{"mode": "stop", "success": True, "allowed": True},
            {"mode": "stop", "success": False, "allowed": True},
            {"mode": "faster", "success": True, "allowed": True},
            {"mode": "lane_change", "success": False, "allowed": False}]
    agg = TD.aggregate(rows)
    assert agg == JD.aggregate(rows)
    assert abs(agg["success_rate_stop"] - 0.5) < 1e-12
    for name in ("desired_end_speed", "speed_slope"):
        assert getattr(TD, name)(_wps(5.0, decel=-1.0)) == getattr(JD, name)(_wps(5.0, decel=-1.0))


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_eval"))
    R.write_dataset(root)
    return root


@pytest.mark.parametrize("mode", ["QA", "commentary"])
def test_eval_sets_equal_jax(routes, tmp_path, mode):
    built = TS.build_eval_set(routes, mode, samples_per_template=3, seed=1)
    assert built == JS.build_eval_set(routes, mode, samples_per_template=3, seed=1)
    assert built
    path = tmp_path / "evalset.json"
    path.write_text(json.dumps(built))
    entries = TS.parse_eval_set(str(path), mode)
    assert entries == JS.parse_eval_set(str(path), mode) and entries
    found = 0
    for split in ("train", "val"):
        kw = dict(split=split, use_town13=False)
        matched = TS.match_index(tindex.build_index(routes, **kw), entries)
        assert matched == JS.match_index(jindex.build_index(routes, **kw), entries)
        found += len(matched)
    assert found


# --------------------------------------------------------------------------
# run_language_eval
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    tok = JTokenizer()
    jcfg = jsim.SimLingoConfig(
        vit=JViTConfig(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                       image_size=56, patch_size=14, projector_out=32),
        llm=JQwen2Config(vocab_size=tok.tk.vocab_size + 8, hidden_size=32, num_layers=1,
                         num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64,
                         lora_r=4, lora_alpha=8, lora_dropout=0.0),
        img_context_token_id=tok.img_context_id, remat_vision=False, remat_llm=False)
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(4), jcfg)
    params["lora"] = jax.tree_util.tree_map(lambda x: x + 0.02, params["lora"])
    return jcfg, params, _port_cfg(jcfg), params_from_jax(params, device="cpu")


def _datasets(routes, mode):
    kw = dict(data_root=routes, split="train" if mode == "Dreaming" else "val",
              use_town13=False, image_size=56, use_commentary=mode == "commentary",
              use_qa=mode == "QA", commentary_augmentation=False, qa_augmentation=False,
              img_shift_augmentation=False)
    if mode == "Dreaming":
        return (jdd.DreamerDataset(jdd.DreamerDatasetConfig(**kw, use_safety_flag=True)),
                tdd.DreamerDataset(tdd.DreamerDatasetConfig(**kw, use_safety_flag=True)))
    return jds.DrivingDataset(jds.DrivingDatasetConfig(**kw)), \
        tds.DrivingDataset(tds.DrivingDatasetConfig(**kw))


def _samples(routes, tmp_path, mode, jdata):
    if mode != "QA":
        return list(range(5))
    path = tmp_path / "qa_set.json"
    path.write_text(json.dumps(JS.build_eval_set(routes, "QA", samples_per_template=2)))
    return JS.match_index(jdata.index, JS.parse_eval_set(str(path), "QA"))[:5]


@pytest.mark.parametrize("mode", ["QA", "commentary", "Dreaming"])
def test_run_language_eval_matches_jax(routes, model, tmp_path, monkeypatch, mode):
    jcfg, jparams, tcfg, tparams = model
    jdata, tdata = _datasets(routes, mode)
    samples = _samples(routes, tmp_path, mode, jdata)
    assert len(samples) == 5

    jout, tout = [], []
    orig_j, orig_t = jrun.generate_and_drive, trun.generate_and_drive

    def jgen(*a, **k):
        out = orig_j(*a, **k)
        jax.debug.callback(lambda r, s: jout.append((np.asarray(r), np.asarray(s))),
                           out.route, out.speed_wps)
        return out

    def tgen(*a, **k):
        out = orig_t(*a, **k)
        tout.append((out.route.numpy(), out.speed_wps.numpy()))
        return out

    monkeypatch.setattr(jrun, "generate_and_drive", jgen)
    monkeypatch.setattr(trun, "generate_and_drive", tgen)
    ecfg = dict(mode=mode, batch_size=4, max_new_tokens=6, max_text_len=768)
    jres = JL.run_language_eval(jparams, jcfg, samples, jdata, JTokenizer(),
                                JL.EvalConfig(output_dir=str(tmp_path / "jax"), **ecfg),
                                compute_dtype=jnp.float32)
    tres = TL.run_language_eval(tparams, tcfg, samples, tdata, SimLingoTokenizer(),
                                TL.EvalConfig(output_dir=str(tmp_path / "torch"), **ecfg),
                                compute_dtype=torch.float32, device="cpu")

    assert len(tout) == len(jout) == 2                      # 5 samples: 4 + 1 padded to 4
    for (tr, ts_), (jr, js) in zip(tout, jout):
        np.testing.assert_allclose(tr, jr, **TOL)
        np.testing.assert_allclose(ts_, js, **TOL)
    assert tres == jres
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    want = {"eval_results.json", "language_preds_all.json", "language_preds_cot.json",
            "language_preds_qa.json"} | ({"dreamer_results.json"} if mode == "Dreaming"
                                         else set()) | (
        {"sorted_qa_templates.json"} if mode == "QA" else set())
    assert set(names) == want
    for name in names:
        j = json.loads((tmp_path / "jax" / name).read_text())
        assert json.loads((tmp_path / "torch" / name).read_text()) == j, name
    language = json.loads((tmp_path / "torch" / "language_preds_all.json").read_text())
    assert len(language) == 5 and all(isinstance(row[0], str) for row in language)
    if mode == "Dreaming":
        assert tres["dreamer"]["num_samples"] > 0
