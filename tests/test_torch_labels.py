"""The port's label generators and their leftovers against JAX's, on the CPU.

The label modules (`simlingo_tpu_torch/labels/`), `sim/route_map.py`,
`data/synthetic.synthesize_route`, the presets `production_shaped` and
`small_shardable`, `utils/profiling.py` and the native loader's
`decode_crop_batch`:

  * JAX's own tests of them run through the port (`tests/torch_ported.py`:
    each test's source with `simlingo_tpu.` read as `simlingo_tpu_torch.`),
    one case a JAX test: all of `tests/test_labels.py`,
    `tests/test_vqa_inventory.py` and `tests/test_route_tools.py`, the two
    label CLIs of `tests/test_cli_tools.py` and the microsim route map of
    `tests/test_microsim.py`;
  * both packages' generators label the same route and write the same
    files (gzip payloads equal, the header's MTIME masked);
  * `synthesize_route` writes JAX's bytes, the presets equal JAX's field
    for field, `decode_crop_batch` equals JAX's on the same JPEG bytes,
    and `timed` / `LatencyHistogram` give JAX's keys and percentiles on
    the same samples.

`OPENAI_API_KEY` is unset in every case, so the paraphraser never leaves
its rule-based branch.
"""

import dataclasses
import gzip
import inspect
import os
import pickle
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu import native as jnative
from simlingo_tpu.core import presets as jpresets
from simlingo_tpu.data import synthetic as jsynthetic
from simlingo_tpu.labels import buckets as jbuckets
from simlingo_tpu.labels import commentary as jcommentary
from simlingo_tpu.labels import dreamer_gen as jdreamer
from simlingo_tpu.labels import vqa as jvqa
from simlingo_tpu.utils import profiling as jprof
from simlingo_tpu_torch.core import presets as tpresets
from simlingo_tpu_torch.data import imageio
from simlingo_tpu_torch.data import synthetic as tsynthetic
from simlingo_tpu_torch.labels import buckets as tbuckets
from simlingo_tpu_torch.labels import commentary as tcommentary
from simlingo_tpu_torch.labels import dreamer_gen as tdreamer
from simlingo_tpu_torch.labels import vqa as tvqa
from simlingo_tpu_torch.utils import profiling as tprof
from tests.test_data_pipeline import _write_route
from tests.torch_ported import jax_test_names, ported_module

LABEL_DIRS = ("commentary", "vqa", "dreamer")


@pytest.fixture(autouse=True)
def _no_openai_key(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)


def gz_equal(a: Path, b: Path) -> None:
    """Equal gzip files but for the header's MTIME (bytes 4..8)."""
    x, y = a.read_bytes(), b.read_bytes()
    assert x[:4] + x[8:] == y[:4] + y[8:], a
    assert gzip.decompress(x) == gzip.decompress(y), a


def same_label_files(a: Path, b: Path) -> int:
    """The label directories of two copies of one route hold the same
    files; returns how many."""
    n = 0
    for sub in LABEL_DIRS:
        names = sorted(os.listdir(a / sub)) if (a / sub).is_dir() else []
        assert names == (sorted(os.listdir(b / sub)) if (b / sub).is_dir() else []), sub
        for name in names:
            gz_equal(a / sub / name, b / sub / name)
        n += len(names)
    return n


def bucket_table(out_dir: Path, root: Path) -> dict:
    """buckets_paths.pkl with `root` stripped from its paths."""
    with open(out_dir / "buckets_paths.pkl", "rb") as f:
        table = pickle.load(f)
    return {k: [os.path.relpath(p, root) for p in v] for k, v in table.items()}


# ---------------------------------------------------------------------------
# JAX's tests through the port
# ---------------------------------------------------------------------------

PORTED_FILES = ("test_labels", "test_vqa_inventory", "test_route_tools")
ONE_TESTS = [("test_cli_tools", "test_dataset_tools_cli"),
             ("test_cli_tools", "test_augment_templates_cli"),
             ("test_microsim", "test_microsim_route_map_backs_route_tools")]
CASES = jax_test_names(*PORTED_FILES) + ONE_TESTS
_PORTED = {}


def _ported(name: str) -> types.ModuleType:
    if name not in _PORTED:
        _PORTED[name] = ported_module(name)
    return _PORTED[name]


@pytest.fixture(scope="module")
def ported_label_route(tmp_path_factory):
    """`tests/test_labels.py`'s module fixture `route`, through the port."""
    return _ported("test_labels").route.__wrapped__(tmp_path_factory)


@pytest.mark.parametrize("module,test", CASES, ids=[f"{m}::{t}" for m, t in CASES])
def test_jax_label_tests_through_the_port(module, test, request):
    fn = getattr(_ported(module), test)
    fixtures = {"route": "ported_label_route", "tmp_path": "tmp_path", "capsys": "capsys"}
    params = inspect.signature(fn).parameters
    unknown = set(params) - set(fixtures)
    assert not unknown, unknown
    fn(**{p: request.getfixturevalue(fixtures[p]) for p in params})


# ---------------------------------------------------------------------------
# both packages' generators on one route
# ---------------------------------------------------------------------------

def test_generators_write_jaxs_files(tmp_path):
    """Commentary, VQA, dreamer labels and the buckets of two copies of a
    seeded route, one labelled by each package."""
    roots = {}
    for tag, (comm, vqa, dreamer, buckets) in {
            "jax": (jcommentary, jvqa, jdreamer, jbuckets),
            "torch": (tcommentary, tvqa, tdreamer, tbuckets)}.items():
        root = tmp_path / tag
        rd = _write_route(str(root), "v1/b0/routes_training/Town12_l", n_frames=30)
        counts = (comm.generate_route_commentary(rd), vqa.generate_route_vqa(rd),
                  dreamer.generate_route_dreamer(rd))
        stats = buckets.generate_buckets(str(root), str(root / "bucketsv2"))
        roots[tag] = (root, Path(rd), counts, stats)
    (jroot, jrd, jcounts, jstats), (troot, trd, tcounts, tstats) = roots["jax"], roots["torch"]
    assert tcounts == jcounts and tstats == jstats
    assert same_label_files(jrd, trd) > 0
    assert bucket_table(troot / "bucketsv2", troot) == bucket_table(jroot / "bucketsv2", jroot)


# ---------------------------------------------------------------------------
# the leftovers
# ---------------------------------------------------------------------------

def test_synthesize_route_writes_jaxs_bytes(tmp_path):
    kw = dict(n_frames=4, seed=3, image_hw=(64, 128))
    j = Path(jsynthetic.synthesize_route(str(tmp_path / "jax"), "v1/b0/routes_training/Town12_s",
                                         **kw))
    t = Path(tsynthetic.synthesize_route(str(tmp_path / "torch"),
                                         "v1/b0/routes_training/Town12_s", **kw))
    assert os.path.relpath(t, tmp_path / "torch") == os.path.relpath(j, tmp_path / "jax")
    for sub in ("rgb", "measurements"):
        names = sorted(os.listdir(j / sub))
        assert names == sorted(os.listdir(t / sub)) and len(names) == 4
        for n in names:
            if sub == "rgb":
                assert (j / sub / n).read_bytes() == (t / sub / n).read_bytes()
            else:
                gz_equal(j / sub / n, t / sub / n)
    gz_equal(j / "results.json.gz", t / "results.json.gz")


@pytest.mark.parametrize("name,kwargs", [("production_shaped", {}),
                                         ("production_shaped", {"num_layers": 3,
                                                                "image_size": 448}),
                                         ("small_shardable", {})])
def test_presets_equal_jaxs(name, kwargs):
    j = dataclasses.asdict(getattr(jpresets, name)(**kwargs))
    t = dataclasses.asdict(getattr(tpresets, name)(**kwargs))
    assert set(t) == set(j)
    for part in ("vit", "llm"):
        assert t[part] == j[part], part
    assert {k: v for k, v in t.items() if k not in ("vit", "llm")} == \
        {k: v for k, v in j.items() if k not in ("vit", "llm")}


@pytest.mark.skipif(not jnative.available(), reason="native loader unavailable (no g++?)")
@pytest.mark.parametrize("crop", [True, False], ids=["crop", "no_crop"])
def test_decode_crop_batch_equals_jaxs(crop):
    import cv2
    rng = np.random.RandomState(0)
    blobs = [cv2.imencode(".jpg", rng.randint(0, 255, (96, 160, 3), np.uint8))[1].tobytes()
             for _ in range(3)]
    j = jnative.decode_crop_batch(blobs, 96, 160, do_bottom_crop=crop)
    t = imageio.decode_crop_batch(blobs, 96, 160, do_bottom_crop=crop)
    assert t.dtype == np.uint8 and t.shape == (3, 96 - int(96 * 4.8 // 16) if crop else 96, 160, 3)
    np.testing.assert_array_equal(t, j)
    full = imageio.decode_jpeg_batch(blobs, 96, 160)
    np.testing.assert_array_equal(t, full[:, :t.shape[1]])


class _Clock:
    """time.perf_counter over a fixed sequence of readings."""

    def __init__(self, readings):
        self.readings = iter(readings)

    def perf_counter(self):
        return next(self.readings)


def test_timed_gives_jaxs_keys_and_percentiles(monkeypatch):
    rng = np.random.RandomState(1)
    lats = rng.rand(7) * 0.01
    readings = [x for lat in lats for x in (0.0, float(lat))]
    out = {}
    for tag, prof, value in (("jax", jprof, jnp.ones(3)), ("torch", tprof, torch.ones(3))):
        monkeypatch.setattr(prof, "time", _Clock(readings))
        out[tag] = prof.timed(lambda v=value: v * 2, iters=len(lats), warmup=1)
    assert list(out["torch"]) == list(out["jax"])
    assert out["torch"] == out["jax"]
    assert out["torch"]["min_ms"] == pytest.approx(lats.min() * 1e3)


@pytest.mark.parametrize("drop_first", [0, 1, 30])
def test_latency_histogram_gives_jaxs_summary(drop_first):
    samples = np.random.RandomState(2).rand(25) * 0.2
    j, t = jprof.LatencyHistogram(), tprof.LatencyHistogram()
    for s in samples:
        j.add(float(s))
        t.add(float(s))
    assert list(t.summary(drop_first)) == list(j.summary(drop_first))
    assert t.summary(drop_first) == j.summary(drop_first)


def test_sync_value_and_trace(tmp_path):
    assert tprof.sync_value(torch.arange(3.0) + 2) == 2.0
    assert tprof.sync_value({"a": [None, torch.full((2, 2), 5.0)]}) == 5.0
    assert tprof.sync_value(1.5) == 1.5
    with tprof.trace(str(tmp_path), name="step") as prof:
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert (tmp_path / "step.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
