"""The port's data pipeline against the JAX package's, on routes on disk.

Routes written and labelled as `tests/torch_routes.py` says. Held exactly
equal: the sample index (quality gate, split, warm-up frames), the
buckets and the sampler's picks, every RawSample of 8 steps of one seed
with every augmentation on (strings, labels, raw frames; and tiles on the
CPU path), and the collated batches (ids, masks, placeholders, labels,
frames). The decoder: the native loader equals cv2 on the committed
frames, falls back to cv2, and names both when neither is there.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simlingo_tpu.core.config import compose as jcompose
from simlingo_tpu.data import collate as JC
from simlingo_tpu.data import image_pipe as JIP
from simlingo_tpu.data import index as JI
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.train import trainer as JT
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.data import collate as TC
from simlingo_tpu_torch.data import image_pipe as TIP
from simlingo_tpu_torch.data import imageio as TIO
from simlingo_tpu_torch.data import index as TI
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.train import trainer as TT
from tests import torch_routes as R

FRAMES = sorted((Path(__file__).parent / "data" / "torch_frames").glob("*.jpg"))
STEPS, SEED = 8, 5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data"))
    return root, R.write_dataset(root)


def _configs(root, tdir, *extra):
    ov = R.data_overrides(root, tdir) + [
        f"seed={SEED}", "data.train_partitions=" + json.dumps(R.partitions()), *extra]
    return jcompose(overrides=ov), compose(ov)


def test_index_matches_jax(dataset):
    root, _ = dataset
    for split in ("train", "val"):
        for dreamer in (False, True):
            ref = JI.build_index(root, split, use_town13=False, dreamer=dreamer)
            got = TI.build_index(root, split, use_town13=False, dreamer=dreamer)
            for f in ("route_dirs", "route_id", "frame", "has_augmented"):
                np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    got = TI.build_index(root, "train", use_town13=False)
    assert {got.route_dir(i).rsplit("/", 1)[1] for i in range(len(got))} == {
        "Town12_Rep0_0", "Town12_Rep0_1"}        # the crashed route is gated out
    assert got.frame.min() == 10 and got.has_augmented.all()


@pytest.mark.parametrize("path", ["raw_frames", "cpu_tiles"])
def test_batches_match_jax(dataset, path):
    """8 steps: the sampler's picks, each sample (with every augmentation),
    and the collated batch, exactly. `cpu_tiles`: device_preprocess off and
    the image augmenter off, so both take the native decode-and-tile call."""
    root, tdir = dataset
    extra = [] if path == "raw_frames" else ["data.base.device_preprocess=false",
                                             "data.base.img_augmentation=false"]
    jcfg, tcfg = _configs(root, tdir, *extra)
    jb, jds = JT.build_buckets(jcfg)
    tb, tds = TT.build_buckets(tcfg)
    assert [(b.name, b.size, b.weight) for b in tb] == [(b.name, b.size, b.weight) for b in jb]
    assert {b.name for b in tb} == {"all", "junction", "all_dreamer"}
    from simlingo_tpu.data.sampler import WeightedBucketSampler as JS
    from simlingo_tpu_torch.data.sampler import WeightedBucketSampler as TS
    js, ts_ = JS(jb, seed=SEED), TS(tb, seed=SEED)
    assert ts_.num_samples == js.num_samples
    jtok, tok = JTokenizer(), SimLingoTokenizer()
    jccfg = JC.CollateConfig(max_text_len=768, num_image_tokens=8)
    tccfg = TC.CollateConfig(max_text_len=768, num_image_tokens=8)
    B = tcfg.data.batch_size
    kinds = set()
    for step in range(STEPS):
        picks = ts_.batch_at(step, B)
        assert picks == js.batch_at(step, B)
        jrng = np.random.RandomState(SEED * 7919 + step)
        trng = np.random.RandomState(SEED * 7919 + step)
        jsamples = [jds[b].get(i, jrng) for b, i in picks]
        tsamples = [tds[b].get(i, trng) for b, i in picks]
        for js_, ts__ in zip(jsamples, tsamples):
            assert (ts__.question, ts__.answer, ts__.dataset, ts__.measurement_path) == (
                js_.question, js_.answer, js_.dataset, js_.measurement_path)
            for f in ("image", "waypoints", "waypoints_1d", "path", "target_points"):
                np.testing.assert_array_equal(getattr(ts__, f), getattr(js_, f))
            assert ts__.speed == js_.speed
            kinds.add(ts__.dataset)
        ref = JC.collate(jsamples, jtok, jccfg)
        got = TC.collate(tsamples, tok, tccfg)
        _assert_batch_equal(ref, got)
    assert kinds == {"driving", "dreamer"}
    if path == "cpu_tiles":
        assert got.driving_input.pixel_values.shape == (B, 2, 56, 56, 3)
    else:
        assert got.driving_input.pixel_values.dtype == torch.uint8


def _assert_batch_equal(ref, got):
    rd, gd = ref.driving_input, got.driving_input
    pairs = [(rd.pixel_values, gd.pixel_values), (rd.vehicle_speed, gd.vehicle_speed),
             (rd.target_point, gd.target_point)]
    for rl, gl in ((rd.prompt, gd.prompt), (rd.prompt_inference, gd.prompt_inference)):
        pairs += [(getattr(rl, f), getattr(gl, f))
                  for f in ("ids", "valid", "loss_mask", "ph_slots", "ph_coords")]
    pairs += [(getattr(ref.driving_label, f), getattr(got.driving_label, f))
              for f in ("waypoints", "path", "waypoints_1d")]
    for want, have in pairs:
        np.testing.assert_array_equal(R.np_tree(have), R.np_tree(want))


def test_pack_round_trip(dataset):
    """The one-buffer layout of `to_device`: every tensor comes back exactly."""
    root, tdir = dataset
    _, tcfg = _configs(root, tdir)
    tb, tds = TT.build_buckets(tcfg)
    rng = np.random.RandomState(0)
    ex = TC.collate([tds[0].get(i, rng) for i in range(3)], SimLingoTokenizer(),
                    TC.CollateConfig(max_text_len=768, num_image_tokens=8))
    host, specs = TC.pack(ex)
    assert all(off % 16 == 0 for off, _, _ in specs)
    back = TC.unpack(host, specs)
    for a, b in zip(TC._tensors(ex), TC._tensors(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert TC.to_device(ex, "cpu") == (ex, None)


def test_cpu_tile_path_matches_jax():
    import cv2
    img = cv2.cvtColor(cv2.imread(str(FRAMES[0])), cv2.COLOR_BGR2RGB)
    for size in (448, 56):
        np.testing.assert_array_equal(TIP.preprocess_numpy(img, size),
                                      JIP.preprocess_numpy(img, size))
    np.testing.assert_array_equal(TIP.bottom_crop(img), JIP.bottom_crop(img))


def test_decoder_matches_cv2_and_falls_back(monkeypatch):
    import cv2
    assert len(FRAMES) == 4 and sum(p.stat().st_size for p in FRAMES) <= 200_000
    assert TIO.decoder() == ("native", None)
    for p in FRAMES:
        ref = cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
        got = TIO.load_rgb(str(p))
        assert got.shape == (512, 1024, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    monkeypatch.setattr(TIO, "_lib", None)
    monkeypatch.setattr(TIO, "_native_error", "no jpeglib.h")
    assert TIO.decoder() == ("cv2", "no jpeglib.h")
    np.testing.assert_array_equal(TIO.load_rgb(str(FRAMES[1])),
                                  cv2.cvtColor(cv2.imread(str(FRAMES[1])), cv2.COLOR_BGR2RGB))
    assert TIO.load_rgb_preprocessed(str(FRAMES[1])) is None
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no jpeglib.h.*cv2"):
        TIO.load_rgb(str(FRAMES[1]))
