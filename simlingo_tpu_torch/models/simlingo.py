"""The composed SimLingo VLA model: InternViT + Qwen2 + adaptors.

Counterpart of `simlingo_tpu/models/simlingo.py`: the hybrid sequence is
token embeddings with waypoint placeholders spliced in (one-hot over padded
(slot, coord) lists) and image features spliced at the `<IMG_CONTEXT>`
positions (cumsum-gather), followed by the 30 driving queries;
`forward_loss` is the training forward. Remat is on by default, as in
JAX (`simlingo_tpu/models/simlingo.py:45-46`): `remat_vision` (False,
True or "mlp"; `vit.py`'s docstring) and `remat_llm` (every decoder layer
recomputed in the backward; `qwen2.forward`). They change when values
are computed, not what: losses and gradients equal remat off's. They act
only while autograd records, so serving and evaluation never recompute.
`tiny()` turns both off, as JAX's does.

On a dp x fsdp x tp x sp x pp mesh (`parallel/mesh.py`)
`forward_loss(mesh=...)` runs this rank's part: its batch rows, the towers
split over tp, dropout masks placed at its rows, and each loss average
its share of the global batch's (`summarise_losses(count_reduce=...)`).
Under sequence parallelism (`parallel/sequence.py`) every sp rank builds
the whole sequence and runs the LLM on its slab;
each loss term is computed by the rank that holds its position (an
answer token's CE where its predicting state lies, the driving losses on
the last sp rank, which holds the queries), so the losses and counts
summed over dp x fsdp x sp are the global batch's. Under pipeline
parallelism (`parallel/pipeline.py`) every stage ends with the final
hidden and computes the losses; only the last stage's head is
differentiated (`pipeline.anchor`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.core.structs import (DrivingExample, LanguageLabel,
                                             TrainingOutput, summarise_losses)
from simlingo_tpu_torch.models import adaptors as A
from simlingo_tpu_torch.models import qwen2, vit
from simlingo_tpu_torch.parallel import pipeline, sequence


@dataclasses.dataclass(frozen=True)
class SimLingoConfig:
    vit: vit.ViTConfig = dataclasses.field(default_factory=vit.ViTConfig)
    llm: qwen2.Qwen2Config = dataclasses.field(default_factory=qwen2.Qwen2Config)
    img_context_token_id: int = 151648   # <IMG_CONTEXT> in InternVL2-1B
    speed_wps_mode: str = "2d"
    predict_route_as_wps: bool = True
    adaptor_mlp_dim: int = 256
    freeze_vision: bool = False          # no gradient into the vision tower
    # False | True (each layer keeps only the attention output) | "mlp"
    # (only the MLP's GELU output is recomputed)
    remat_vision: Any = True
    remat_llm: bool = True
    # CE on the gathered (contiguous) answer positions; 0 => full-sequence CE
    max_answer_len: int = 160

    @property
    def num_queries(self) -> int:
        return ((A.NUM_ROUTE_QUERIES if self.predict_route_as_wps else 0)
                + A.NUM_SPEED_QUERIES)

    @staticmethod
    def tiny() -> "SimLingoConfig":
        return SimLingoConfig(vit=vit.ViTConfig.tiny(),
                              llm=qwen2.Qwen2Config.tiny(),
                              img_context_token_id=500,
                              remat_vision=False, remat_llm=False)


def init_params(cfg: SimLingoConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Random weights from `generator` (which must live on `device`)."""
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    H = cfg.llm.hidden_size
    p = {
        "vision": vit.init_params(generator, cfg.vit, **kw),
        "llm": qwen2.init_params(generator, cfg.llm, **kw),
        "adaptors": A.init_driving_adaptor(
            generator, H, cfg.adaptor_mlp_dim, cfg.speed_wps_mode,
            cfg.predict_route_as_wps, **kw),
        "wp_encoder": A.init_wp_encoder(generator, H, **kw),
    }
    if cfg.llm.lora_r > 0:
        p["lora"] = qwen2.init_lora_params(generator, cfg.llm, **kw)
    return p


def build_text_embeddings(params: Dict[str, Any], label: LanguageLabel,
                          pixel_values: Optional[torch.Tensor],
                          cfg: SimLingoConfig, dtype=None, tp=None) -> torch.Tensor:
    """Token embeddings with waypoint + image features spliced in.
    pixel_values: [B, NP, H, W, 3] normalized, [B, H, W, 3] uint8 raw
    frames (preprocessed here), or None (text only)."""
    ids = label.ids
    B, T = ids.shape
    embeds = qwen2.embed_tokens(params["llm"], ids, dtype=dtype)      # [B, T, H]

    ph_slots = label.ph_slots                                         # [B, P]
    wp = A.wp_encode(params["wp_encoder"], label.ph_coords.to(embeds.dtype))
    onehot = ((ph_slots[:, :, None] == torch.arange(T, device=ids.device))
              & (ph_slots >= 0)[:, :, None])                          # [B, P, T]
    spliced = torch.einsum("bpt,bph->bth", onehot.to(embeds.dtype), wp)
    embeds = torch.where(onehot.any(dim=1)[..., None], spliced, embeds)

    if pixel_values is not None:
        if pixel_values.dim() == 4:
            from simlingo_tpu_torch.data.image_pipe import (device_grid_for,
                                                            preprocess_device)
            grid = device_grid_for(pixel_values.shape[2], pixel_values.shape[1],
                                   cfg.vit.image_size)
            pixel_values = preprocess_device(pixel_values, cfg.vit.image_size,
                                             grid=grid)
        NP = pixel_values.shape[1]
        imgs = pixel_values.reshape((B * NP,) + tuple(pixel_values.shape[2:]))
        feats = vit.extract_features(params["vision"], imgs, cfg.vit,
                                     remat=cfg.remat_vision, tp=tp)
        if cfg.freeze_vision:
            feats = feats.detach()
        n_img = NP * feats.shape[1]
        feats = feats.reshape(B, n_img, -1).to(embeds.dtype)
        img_mask = ids == cfg.img_context_token_id                    # [B, T]
        idx = (torch.cumsum(img_mask.long(), dim=1) - 1).clamp(0, n_img - 1)
        gathered = torch.gather(feats, 1, idx[..., None].expand(-1, -1, feats.shape[-1]))
        embeds = torch.where(img_mask[..., None], gathered, embeds)
    return embeds


def text_positions(label: LanguageLabel) -> torch.Tensor:
    """cumsum(valid) - 1, clipped at 0: slot index under right padding,
    content-relative position under left padding."""
    return (torch.cumsum(label.valid.long(), dim=1) - 1).clamp(min=0)


def assemble_sequence(params, label: LanguageLabel, pixel_values,
                      cfg: SimLingoConfig, dtype=None, tp=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[text | driving queries]: (embeds [B, T+Q, H], valid, position ids)."""
    text = build_text_embeddings(params, label, pixel_values, cfg, dtype, tp)
    B = text.shape[0]
    queries = A.query_tokens(params["adaptors"], B, dtype=text.dtype)
    Q = queries.shape[1]
    embeds = torch.cat([text, queries], dim=1)
    valid = torch.cat([label.valid, torch.ones(B, Q, dtype=torch.bool,
                                               device=text.device)], dim=1)
    q_pos = label.num_valid[:, None] + torch.arange(Q, device=text.device)
    return embeds, valid, torch.cat([text_positions(label), q_pos], dim=1)


def forward_loss(params: Dict[str, Any], example: DrivingExample,
                 cfg: SimLingoConfig, dropout_seed: Optional[int] = None,
                 compute_dtype=torch.float32, mesh=None,
                 batch_offset: Optional[int] = None, count_reduce=None
                 ) -> Tuple[TrainingOutput, Dict[str, torch.Tensor]]:
    """Training forward: language CE + route / speed smooth-L1 ->
    (TrainingOutput, predictions). `dropout_seed` turns LoRA dropout on.
    `mesh`: this rank's part of a multi-GPU step (module docstring), whose
    rows start at batch row `batch_offset` of the global batch and whose
    counts `count_reduce` makes global; both default to the mesh's."""
    di = example.driving_input
    label = di.prompt
    tp = mesh.tp if mesh is not None else None
    if mesh is not None and mesh.batch_size > 1 and batch_offset is None:
        batch_offset = mesh.batch_index * label.ids.shape[0]
    embeds, valid, pos = assemble_sequence(params, label, di.pixel_values, cfg,
                                           dtype=compute_dtype, tp=tp)
    T = label.ids.shape[1]
    slab = sequence.slab_of(embeds.shape[1])
    lo, hi = 0, embeds.shape[1]
    if slab is not None:
        n = embeds.shape[1] // slab[1]
        lo, hi = slab[0] * n, (slab[0] + 1) * n
        if hi - lo <= cfg.num_queries:
            raise ValueError(f"sp={slab[1]}: a slab of {hi - lo} positions cannot hold "
                             f"the {cfg.num_queries} driving queries and a text position")
        embeds, valid, pos = embeds[:, lo:hi], valid[:, lo:hi], pos[:, lo:hi]
    if mesh is not None and count_reduce is None and (mesh.batch_size > 1 or slab is not None):
        count_reduce = mesh.comm["loss"].all_reduce
    hidden, _ = qwen2.forward(params["llm"], embeds, cfg.llm, pos, kv_valid=valid,
                              causal=True, lora_params=params.get("lora"),
                              remat=cfg.remat_llm, dropout_seed=dropout_seed, tp=tp,
                              batch_offset=batch_offset or 0, slab=slab)
    anchor = pipeline.anchor(hidden)
    if anchor is not None:
        hidden = hidden.detach()
    last = hi == T + cfg.num_queries            # this rank holds the queries
    text_h, query_h = hidden[:, :T - lo], hidden[:, hidden.shape[1] - cfg.num_queries:]

    def logits_fn(h):
        return qwen2.logits_from_hidden(params["llm"], h, cfg.llm)

    if cfg.max_answer_len > 0:
        hg, labels_g, valid_g = A.gather_answer_states(
            text_h, label.ids, label.loss_mask, cfg.max_answer_len, lo)
        # the tied [V, H] head enables the fused CE (SIMLINGO_CE_IMPL=pallas);
        # an lm_head or an int8 table keeps the chunked CE
        emb = params["llm"]["embed"]
        head_w = None if ("lm_head" in params["llm"] or "w_q" in emb) else emb["w"]
        losses = A.language_loss_gathered(hg, labels_g, valid_g, logits_fn,
                                          head_w=head_w)
    else:
        if slab is not None:
            raise ValueError("sequence parallelism needs the gathered CE (max_answer_len > 0)")
        losses = A.language_loss(logits_fn(text_h), label.ids, label.loss_mask)

    dl = example.driving_label
    route_label = dl.path if cfg.predict_route_as_wps else None
    if cfg.speed_wps_mode == "2d":
        speed_label = dl.waypoints[:, :A.NUM_SPEED_QUERIES]
    else:              # 1d: the cumulative arc length only ([d, 0] pairs)
        speed_label = dl.waypoints_1d[:, :A.NUM_SPEED_QUERIES, :1]
    d_losses, preds = A.driving_loss(params["adaptors"], query_h, route_label,
                                     speed_label)
    if not last:                # another sp rank holds the queries: no terms here
        d_losses = {k: (v, torch.zeros_like(m)) for k, (v, m) in d_losses.items()}
    losses.update(d_losses)
    out = summarise_losses(losses, count_reduce)
    if anchor is not None:      # not the last stage: the head's value, not its graph
        out.loss = out.loss.detach() + anchor
    if slab is not None:        # the last sp rank's predictions, on every sp rank
        comm = sequence.active_axis()[0].comm["sp"]
        preds = {k: comm.all_reduce(v.detach() * float(last)) for k, v in preds.items()}
    return out, preds
