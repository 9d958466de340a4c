"""Training loops: SimLingo from a dataset on disk (or a synthetic batch),
and SimLingo-Base.

`train` is the counterpart of `simlingo_tpu/train/trainer.py:_train_impl`
(:229-477): parameters from a seed, from an HF / torch checkpoint
(`hf_checkpoint`) or given; the trainable partition, AdamW + OneCycle;
batches drawn by the weighted bucket sampler (a pure function of (seed,
step)) from the driving and dreamer datasets, collated and copied to the
device by a pool of prefetch threads (`Prefetcher`), or one synthetic
batch (`make_synthetic`); the validation split every `val_every_n_epochs`
and after the last step; metrics to `<output_dir>/<name>/metrics.jsonl`
(and wandb where WANDB_MODE is set); periodic async checkpoints, a final
blocking one, and `resume` from the newest. A run resumed at step k takes
the same batches and dropout seeds as one run straight through: the
picks and the per-step `RandomState(seed * 7919 + step)` depend on the
step only, and the dropout seed is `step_seed(seed, step)`.

On several ranks (one process a rank, started by torchrun or SLURM:
`parallel/multihost.py`) the trainer lays `cfg.mesh`'s dp x fsdp x tp x sp
x pp over them (`parallel/mesh.py`), as `trainer.py:234-271, 330-346`
does, with the sequence and pipeline contexts (`parallel/sequence.py`,
`parallel/pipeline.py`) set for the run and cleared when it ends, however
it ends (JAX :195-203, 237-247); sp or pp that never engaged in the first
step raise RuntimeError (JAX :405-424):
`batch_size` is per rank of dp x fsdp (Lightning's per-GPU semantics), so
the global batch is batch_size x dp x fsdp, and data rank r of n draws
`sampler.batch_at(step, B n)[r B:(r + 1) B]` with augmentations from
`RandomState(seed * 7919 + step * n + r)` (JAX's `make_batch`; tp, sp and
pp ranks share their data rank's batch); the metrics, validation and grad norm are
the global batch's; `config.json`, the logs and the printed summary come
from the primary alone, and checkpoints are gathered there
(`core/checkpoint.py`).

Differences from JAX: an empty `output_dir` writes nothing (no run directory, no checkpoint); the
model's `<IMG_CONTEXT>` id is taken from the tokenizer where they differ
(the byte-level fallback tokenizer has its own ids); where a checkpoint
lacks a subtree (a raw InternVL2 one has no driving adaptors), it keeps
its seeded init; and every step's loss is read back, so each record has
the step's ms, its batch's host ms and the prefetch wait.

`train_base` is the loop of `train_base.py` (SimLingo-Base): a fresh
`base_batch` a step from `RandomState(seed)`, the two-group step of
`train/base_step.py`, and a final checkpoint where `output_dir` is set;
over dp x fsdp each rank draws the global batch of batch_size x dp x fsdp
rows and keeps its own; tp ranks share their data rank's rows.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from simlingo_tpu_torch.core import checkpoint as ckpt
from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.core.config import BaseTrainConfig, TrainConfig, to_dict
from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.data.synthetic import base_batch, synthetic_example
from simlingo_tpu_torch.models import simlingo, simlingo_base
from simlingo_tpu_torch.parallel import mesh as meshlib
from simlingo_tpu_torch.parallel import multihost, pipeline, sequence
from simlingo_tpu_torch.train import base_step
from simlingo_tpu_torch.train import train_step as ts


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step (qwen2.layer_seeds hashes it further)."""
    return (seed << 32) ^ step


def _dump_git_state(run_dir: str) -> None:
    """Record the code state beside the run (nothing outside a git checkout)."""
    import subprocess
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], text=True,
                             capture_output=True, timeout=10).stdout.strip()
        diff = subprocess.run(["git", "diff"], text=True, capture_output=True,
                              timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return
    with open(os.path.join(run_dir, "git_state.txt"), "w") as f:
        f.write(f"sha: {sha}\n\n{diff}")


class JsonlLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.f = open(path, "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self.f.write(json.dumps({"step": step, **metrics}) + "\n")
        self.f.flush()

    def log_image(self, name: str, step: int, image) -> None:
        self.f.write(json.dumps({"step": step, "image": name}) + "\n")
        self.f.flush()


class WandbLogger:
    """wandb sink, where the package imports and WANDB_MODE is not 'disabled'."""

    def __init__(self, name: str, config: Dict[str, Any]):
        import wandb
        self.run = wandb.init(project=os.environ.get("WANDB_PROJECT", "simlingo_tpu"),
                              name=name, config=config, resume="allow")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        self.run.log(metrics, step=step)

    def log_image(self, name: str, step: int, image) -> None:
        import wandb
        self.run.log({name: wandb.Image(image)}, step=step)


class MultiLogger:
    def __init__(self, loggers):
        self.loggers = loggers

    def log(self, step, metrics):
        for lg in self.loggers:
            lg.log(step, metrics)

    def log_image(self, name, step, image):
        for lg in self.loggers:
            lg.log_image(name, step, image)


def make_logger(run_dir: str, name: str, config: Dict[str, Any]) -> MultiLogger:
    loggers = [JsonlLogger(os.path.join(run_dir, "metrics.jsonl"))]
    if os.environ.get("WANDB_MODE", "disabled") != "disabled":
        try:
            loggers.append(WandbLogger(name, config))
        except Exception as e:          # noqa: BLE001 -- the JSONL log stays
            print(f"wandb disabled: {e}", flush=True)
    return MultiLogger(loggers)


class Prefetcher:
    """A pool of threads computing make_batch(step) for start_step,
    start_step + 1, ...; `get(step)` waits for that step's result (and
    raises its error). At most ~2 x num_workers results are held."""

    def __init__(self, make_batch: Callable[[int], Any], start_step: int,
                 num_workers: int = 4):
        self.make_batch = make_batch
        self.next_step = start_step
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.results: Dict[int, Any] = {}
        self.cv = threading.Condition()
        self.threads = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(num_workers)]
        for t in self.threads:
            t.start()

    def _worker(self):
        while not self.stop.is_set():
            with self.lock:
                step = self.next_step
                self.next_step += 1
            try:
                batch = self.make_batch(step)
            except Exception as e:      # noqa: BLE001 -- raised by get(step)
                batch = e
            with self.cv:                 # store first: get() never waits on a full pool
                self.results[step] = batch
                self.cv.notify_all()
                self.cv.wait_for(lambda: len(self.results) <= 2 * len(self.threads)
                                 or self.stop.is_set())

    def get(self, step: int) -> Any:
        with self.cv:
            self.cv.wait_for(lambda: step in self.results)
            batch = self.results.pop(step)
            self.cv.notify_all()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self):
        self.stop.set()
        with self.cv:
            self.cv.notify_all()
        for t in self.threads:
            t.join(timeout=60)


class Batch(NamedTuple):
    example: Any                       # DrivingExample
    buffer: Optional[torch.Tensor]     # its one device buffer (CUDA), else None
    ready: Optional[torch.cuda.Event]  # recorded after the copy (CUDA), else None
    host_ms: float                     # the worker's time to draw, collate and copy


def _take(batch: Batch):
    """The example, usable on the current stream (waits for its copy)."""
    if batch.ready is not None:
        stream = torch.cuda.current_stream()
        stream.wait_event(batch.ready)
        batch.buffer.record_stream(stream)
    return batch.example


def build_buckets(cfg: TrainConfig):
    """([Bucket], [dataset]) honouring train_partitions and the dreamer mix
    (`trainer.py:build_buckets` :161)."""
    from simlingo_tpu_torch.data.driving_dataset import DrivingDataset
    from simlingo_tpu_torch.data.dreamer_dataset import (DreamerDataset,
                                                         DreamerDatasetConfig)
    from simlingo_tpu_torch.data.sampler import normalize_buckets
    base = dataclasses.replace(cfg.data.base, data_root=cfg.data.data_root,
                               bucket_path=cfg.data.bucket_path)
    driving = {name: (DrivingDataset(dataclasses.replace(base, bucket_name=name)), w)
               for name, w in (cfg.data.train_partitions or {"all": 1.0}).items()}
    dreamer = {}
    if cfg.data.use_dreamer:
        dcfg = DreamerDatasetConfig(**{f.name: getattr(base, f.name)
                                       for f in dataclasses.fields(base)})
        dreamer = {name: (DreamerDataset(dcfg), w)
                   for name, w in (cfg.data.train_partitions_dreamer or {"all": 1.0}).items()}
    drv = {n: (len(d), w) for n, (d, w) in driving.items() if len(d) > 0}
    drm = {n: (len(d), w) for n, (d, w) in dreamer.items() if len(d) > 0}
    by_name = {**{n: d for n, (d, _) in driving.items()},
               **{f"{n}_dreamer": d for n, (d, _) in dreamer.items()}}
    buckets = normalize_buckets(drv, drm if drm else None)
    return buckets, [by_name[b.name] for b in buckets]


def _print_model_summary(state: ts.TrainState, trainable_fn) -> None:
    """Parameters and trainable parameters by tower (the whole model's)."""
    shapes = ({p: lay.shape for p, lay in state.layouts.items()} if state.layouts else
              {p: tuple(x.shape) for p, x in ts.flatten(state.params).items()})
    print("model summary (params / trainable):", flush=True)
    total = total_t = 0
    for name in sorted({p.split("/")[0] for p in shapes}):
        leaves = {p: math.prod(sh) for p, sh in shapes.items() if p.split("/")[0] == name}
        n = sum(leaves.values())
        n_t = sum(k for p, k in leaves.items() if trainable_fn(p))
        total, total_t = total + n, total_t + n_t
        print(f"  {name:<10s} {n / 1e6:9.2f} M  {n_t / 1e6:9.2f} M", flush=True)
    print(f"  {'total':<10s} {total / 1e6:9.2f} M  {total_t / 1e6:9.2f} M", flush=True)


def _make_mesh(cfg, dev) -> "meshlib.Mesh":
    """Join the job's processes (a no-op in one) and lay `cfg.mesh` over them."""
    cfg.mesh.check_supported()
    multihost.initialize(device=dev.type)
    m = cfg.mesh
    return meshlib.make_mesh(m.dp, m.fsdp, m.tp, m.sp, m.pp, device=dev)


def _initial_params(cfg: TrainConfig, model_cfg, dev) -> Dict[str, Any]:
    """Seeded init, with the subtrees of `cfg.hf_checkpoint` over it (their
    leaves must have the init's shapes)."""
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = simlingo.init_params(model_cfg, gen, device=dev)
    if not cfg.hf_checkpoint:
        return params
    loaded = ckpt.load_hf_checkpoint(cfg.hf_checkpoint, model_cfg)
    init = ts.flatten(params)
    for path, x in ts.flatten(loaded).items():
        if path not in init or init[path].shape != x.shape:
            raise ValueError(f"{cfg.hf_checkpoint}: {path} {tuple(x.shape)} does not fit "
                             f"the model ({tuple(init[path].shape) if path in init else 'absent'})")
    for key, sub in loaded.items():
        params[key] = ts.map_leaves(lambda _, x: x.to(dev), sub)
    print(f"weights from {cfg.hf_checkpoint}: {sorted(loaded)}; seeded init for "
          f"{sorted(set(params) - set(loaded))}", flush=True)
    return params


def train(cfg: TrainConfig, make_synthetic: bool = False,
          params: Optional[Dict[str, Any]] = None, device="cuda",
          after_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
          trainable_fn: Callable[[str], bool] = ts.production_trainable
          ) -> Dict[str, Any]:
    """Train to max_steps (<= 0: max_epochs of the sampler's epoch, or 100
    synthetic steps). Returns the state, the step function, the last
    batch, the per-step records ({step, ms, host_ms, wait_ms, loss,
    grad_norm, ...}), the last logged metrics and total_steps. On several
    ranks `params` is the full tree (every rank's the same) and the state
    returned holds this rank's shards."""
    try:
        return _train(cfg, make_synthetic, params, device, after_step, trainable_fn)
    finally:
        sequence.disable()      # never leak the sp context past train()
        pipeline.disable()      # ... nor the pp context


def _train(cfg, make_synthetic, params, device, after_step, trainable_fn):
    dev = resolve_device(device)
    mesh = _make_mesh(cfg, dev)
    sequence.enable(mesh)
    pipeline.enable(mesh, microbatches=cfg.mesh.pp_microbatches)
    primary = multihost.is_primary()
    say = print if primary else (lambda *a, **k: None)
    np.random.seed(cfg.seed)
    say(f"gates {gates.resolved()}", flush=True)
    if mesh.world > 1:
        say("mesh " + " ".join(f"{a}={n}" for a, n in mesh.shape.items())
            + f" over {mesh.world} ranks", flush=True)
    compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    model_cfg = cfg.model
    tok = None
    if not make_synthetic:
        from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
        tok = SimLingoTokenizer(cfg.tokenizer_path)
        if tok.tk.vocab_size > model_cfg.llm.vocab_size:
            raise ValueError(f"tokenizer vocabulary {tok.tk.vocab_size} > the model's "
                             f"{model_cfg.llm.vocab_size}")
        if tok.img_context_id != model_cfg.img_context_token_id:
            say(f"<IMG_CONTEXT> is id {tok.img_context_id} in the tokenizer "
                  f"({model_cfg.img_context_token_id} in the config): using the "
                  f"tokenizer's", flush=True)
            model_cfg = dataclasses.replace(model_cfg, img_context_token_id=tok.img_context_id)

    meshlib.check_tp(model_cfg, mesh.shape["tp"])
    meshlib.check_pp(model_cfg, mesh.shape["pp"])
    if params is None:
        params = _initial_params(cfg, model_cfg, dev)
    state = ts.init_train_state(params, cfg.optimizer, trainable_fn, mesh=mesh)
    del params
    if primary:
        _print_model_summary(state, trainable_fn)
    lr_schedule = ts.onecycle_schedule(cfg.optimizer)
    step_fn = ts.make_train_step(model_cfg, cfg.optimizer, compute_dtype, trainable_fn)

    run_dir = os.path.join(cfg.output_dir, cfg.name) if cfg.output_dir else None
    ckpt_dir = os.path.join(run_dir, "checkpoints") if run_dir else None
    logger = MultiLogger([])
    if run_dir and primary:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(to_dict(cfg), f, indent=2, default=str)
        _dump_git_state(run_dir)
        logger = make_logger(run_dir, cfg.name, to_dict(cfg))

    start_step = 0
    if cfg.resume and ckpt_dir:
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest:
            ckpt.restore_checkpoint(latest, state)
            start_step = state.step
            say(f"resumed from {latest} at step {start_step}", flush=True)

    # ---- data: this data rank's B rows of a global batch of B x nb ----
    B, nb, bi = cfg.data.batch_size, mesh.batch_size, mesh.batch_index
    if make_synthetic:
        synthetic = Batch(meshlib.put_batch(synthetic_example(
            model_cfg, batch=B * nb, seq_len=cfg.data.max_text_len, num_patches=2,
            device=dev), mesh), None, None, 0.0)

        def make_batch(step):
            return synthetic
        total_steps = cfg.max_steps if cfg.max_steps > 0 else 100
    else:
        from simlingo_tpu_torch.data.collate import CollateConfig, collate, to_device
        from simlingo_tpu_torch.data.sampler import WeightedBucketSampler
        buckets, datasets = build_buckets(cfg)
        sampler = WeightedBucketSampler(buckets, seed=cfg.seed)
        ccfg = CollateConfig(max_text_len=cfg.data.max_text_len,
                             num_image_tokens=(model_cfg.vit.tokens_per_patch_image
                                               * cfg.data.base.max_num_grid))
        steps_per_epoch = max(1, sampler.num_samples // (B * nb))
        total_steps = cfg.max_steps if cfg.max_steps > 0 else steps_per_epoch * cfg.max_epochs
        copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def make_batch(step):
            t0 = time.perf_counter()
            rng = np.random.RandomState(cfg.seed * 7919 + step * nb + bi)
            picks = sampler.batch_at(step, B * nb)[bi * B:(bi + 1) * B]
            samples = [datasets[b].get(i, rng) for b, i in picks]
            ex, buf = to_device(collate(samples, tok, ccfg), dev, copy_stream)
            ready = None
            if buf is not None:
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return Batch(ex, buf, ready, (time.perf_counter() - t0) * 1e3)

    # ---- validation: the routes_validation split, augmentations off ----
    val_ds, val_interval = None, 0
    if not make_synthetic and cfg.val_every_n_epochs > 0:
        from simlingo_tpu_torch.data.driving_dataset import DrivingDataset
        val_ds = DrivingDataset(dataclasses.replace(
            cfg.data.base, data_root=cfg.data.data_root, split="val", bucket_name="all",
            bucket_path=None, commentary_augmentation=False, qa_augmentation=False,
            img_shift_augmentation=False, img_augmentation=False))
        if len(val_ds) >= B * nb:
            val_interval = steps_per_epoch * cfg.val_every_n_epochs
        else:
            val_ds = None
    viz = None
    viz_every = cfg.visualise_every_n_steps if run_dir else 0
    if viz_every > 0 and primary:
        from simlingo_tpu_torch.train.visualise import VisualiseCallback
        viz = VisualiseCallback(viz_every, os.path.join(run_dir, "viz"),
                                logger=logger, tokenizer=tok)
    eval_step = (ts.make_eval_step(model_cfg, compute_dtype)
                 if viz_every > 0 or val_ds is not None else None)

    def run_validation() -> Dict[str, float]:
        """Mean forward-loss metrics over the validation split (no grads),
        batches of B x nb rows, this data rank's B of each."""
        n_batches = len(val_ds) // (B * nb)
        if cfg.val_max_batches > 0:
            n_batches = min(n_batches, cfg.val_max_batches)
        sums: Dict[str, float] = {}
        for vb in range(n_batches):
            rng_v = np.random.RandomState(9973 + vb)
            samples = [val_ds.get((vb * nb + bi) * B + j, rng_v) for j in range(B)]
            ex, _ = to_device(collate(samples, tok, ccfg), dev)
            metrics, _ = eval_step(state, ex)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        return {f"val_{k}": v / max(n_batches, 1) for k, v in sums.items()}

    # ---- loop ----
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prefetch = Prefetcher(make_batch, start_step, num_workers=max(1, cfg.data.num_workers))
    records: List[Dict[str, float]] = []
    last_metrics: Dict[str, float] = {}
    batch = None
    t_log, logged = time.perf_counter(), start_step - 1
    try:
        for step in range(start_step, total_steps):
            t0 = time.perf_counter()
            got = prefetch.get(step)
            batch = _take(got)
            sync()
            t1 = time.perf_counter()
            metrics = step_fn(state, batch, step_seed(cfg.seed, step))
            if step == start_step:
                _check_engaged(mesh)
            host = {k: float(v) for k, v in metrics.items()}
            ms = (time.perf_counter() - t1) * 1e3
            records.append(dict(step=step + 1, ms=ms, host_ms=got.host_ms,
                                wait_ms=(t1 - t0) * 1e3, **host))
            if step == start_step or (step + 1) % max(cfg.log_every_n_steps, 1) == 0 \
                    or step + 1 == total_steps:
                dt = time.perf_counter() - t_log
                t_log = time.perf_counter()
                host["samples_per_sec"] = B * nb * (step - logged) / dt
                logged = step
                host["lr"] = float(lr_schedule(step))
                logger.log(step + 1, host)
                last_metrics = dict(host)
                say(f"step {step + 1}/{total_steps} loss={host['loss']:.4f} "
                      f"grad_norm={host['grad_norm']:.4f} {ms:.1f} ms "
                      f"({host['samples_per_sec']:.2f} samples/s)", flush=True)
            if ckpt_dir and cfg.checkpoint_every_n_steps > 0 \
                    and (step + 1) % cfg.checkpoint_every_n_steps == 0:
                ckpt.save_checkpoint(ckpt_dir, state, step + 1, keep=cfg.keep_checkpoints,
                                     block=False)
            if viz_every > 0 and (step + 1) % viz_every == 0:
                _, preds = eval_step(state, batch)       # collective on a mesh
                if viz is not None:
                    try:
                        viz.maybe_plot(step + 1, batch, preds)
                    except Exception as e:      # noqa: BLE001 -- never kills a run
                        print(f"visualise failed: {e}", flush=True)
            if val_ds is not None and ((val_interval > 0 and (step + 1) % val_interval == 0)
                                       or step + 1 == total_steps):
                vm = run_validation()
                logger.log(step + 1, vm)
                last_metrics.update(vm)
                say(f"step {step + 1}: val_loss={vm['val_loss']:.4f} "
                      f"({len(val_ds)} val samples)", flush=True)
            if after_step is not None:
                after_step(step, host)
    finally:
        prefetch.close()

    if ckpt_dir:
        try:
            ckpt.save_checkpoint(ckpt_dir, state, total_steps, keep=cfg.keep_checkpoints)
        except Exception as e:      # noqa: BLE001 -- the state is in memory; loud
            print(f"WARNING: final checkpoint save failed: {e!r}; returning the "
                  f"in-memory state (re-save with core.checkpoint.save_checkpoint)",
                  flush=True)
            last_metrics["final_checkpoint_error"] = repr(e)
    return dict(state=state, step_fn=step_fn, batch=batch, records=records,
                metrics=last_metrics, total_steps=total_steps, model_cfg=model_cfg)


def _check_engaged(mesh) -> None:
    """Fail loudly where sp or pp is configured but the first step never
    used it (JAX `trainer.py:405-424`): the ranks would train replicated."""
    if sequence.active_axis() is not None and sequence.trace_count() == 0:
        raise RuntimeError(
            f"mesh.sp={mesh.shape['sp']} but no attention call ring-routed in the first "
            "step; check that the LLM sequence length divides sp "
            "(parallel/sequence.py dispatch rules)")
    if pipeline.active_axis() is not None and pipeline.trace_count() == 0:
        raise RuntimeError(
            f"mesh.pp={mesh.shape['pp']} but the first step never entered the layer "
            "pipeline (parallel/pipeline.py)")


def train_base(cfg: BaseTrainConfig, params: Optional[Dict[str, Any]] = None,
               device="cuda",
               after_step: Optional[Callable[[int, Dict[str, float]], None]] = None
               ) -> Dict[str, Any]:
    """Run `cfg.max_steps` SimLingo-Base steps, each on a new batch. Returns
    the state, the step function, the last batch and the per-step records
    ({step, ms, batch_ms, loss, route_loss, speed_wps_loss, grad_norm_*}):
    ms is the step alone, batch_ms the batch's draw and copy before it."""
    dev = resolve_device(device)
    mesh = _make_mesh(cfg, dev)
    primary = multihost.is_primary()
    say = print if primary else (lambda *a, **k: None)
    say(f"gates {gates.resolved()}", flush=True)
    compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    meshlib.check_tp(cfg.model, mesh.shape["tp"])
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        params = simlingo_base.init_params(cfg.model, gen, device=dev)
    sizes = {g: sum(x.numel() for p, x in ts.flatten(params).items()
                    if base_step.group_of(p) == g) / 1e6 for g in base_step.GROUPS}
    state = base_step.init_base_state(params, cfg.optimizer, mesh=mesh)
    del params
    say(f"params {sum(sizes.values()):.2f} M (vision {sizes['vision']:.2f} M at lr x "
        f"{base_step.VISION_LR_SCALE}, rest {sizes['rest']:.2f} M)"
        + (f"; mesh dp={mesh.shape['dp']} fsdp={mesh.shape['fsdp']} tp={mesh.shape['tp']}"
           if mesh.world > 1 else ""),
        flush=True)
    step_fn = base_step.make_base_train_step(cfg.model, cfg.optimizer, compute_dtype)
    total = cfg.max_steps if cfg.max_steps > 0 else 100
    B, S = cfg.data.batch_size, cfg.model.clip.image_size
    nb = mesh.batch_size
    rng = np.random.RandomState(cfg.seed)
    # `train_base.py:89-92`: the run directory and its config.json
    run_dir = os.path.join(cfg.output_dir, cfg.name + "_base") if cfg.output_dir else None
    if run_dir and primary:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(to_dict(cfg), f, indent=2, default=str)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    records = []
    for step in range(total):
        t0 = time.perf_counter()
        batch = meshlib.put_batch(base_batch(rng, B * nb, S, device=dev), mesh)
        sync()
        t1 = time.perf_counter()
        metrics = step_fn(state, batch)
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        host = {k: float(v) for k, v in metrics.items()}
        records.append(dict(step=step + 1, ms=ms, batch_ms=(t1 - t0) * 1e3, **host))
        if (step + 1) % cfg.log_every_n_steps == 0 or step == 0 or step + 1 == total:
            # `train_base.py:104-106` logs speed_wps_loss as the loss
            say(f"step {step + 1}/{total} loss={host['speed_wps_loss']:.4f} "
                f"(total {host['loss']:.4f}, grad norms vision "
                f"{host['grad_norm_vision']:.4f} rest {host['grad_norm_rest']:.4f}) "
                f"{ms:.1f} ms ({B * nb * 1e3 / ms:.2f} samples/s)", flush=True)
        if after_step is not None:
            after_step(step, host)
    if run_dir:
        path = ckpt.save_checkpoint(os.path.join(run_dir, "checkpoints"), state, total)
        say(f"done: checkpoint {path}", flush=True)
    else:
        say("done (no checkpoint saved: output_dir is empty)", flush=True)
    return dict(state=state, step_fn=step_fn, batch=batch, records=records)
