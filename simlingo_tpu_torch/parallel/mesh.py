"""The dp x fsdp x tp x sp x pp mesh over torch.distributed ranks: layout
rules, sharding of parameter trees, per-rank batches and the collectives.

Counterpart of `simlingo_tpu/parallel/mesh.py`. JAX declares shardings
and XLA inserts the collectives; the port runs one process per rank and
calls them itself:

  * dp: batch rows split; gradients all-reduced;
  * fsdp (ZeRO-3): parameters, fp32 masters and AdamW moments stored as
    1/fsdp shards, the compute copy all-gathered before the forward,
    gradients reduce-scattered; batch rows split as over dp;
  * tp (Megatron): attention heads and MLP hidden widths of the ViT and
    Qwen2 blocks split over ranks; column-parallel linears (q, k, v, fc1,
    gate, up, the projector's fc1) take a replicated input and give local
    features, row-parallel ones (o, fc2, down, the projector's fc2) take
    local features and all-reduce their partial outputs
    (`models/layers.py`);
  * sp: the LLM's sequence cut into contiguous slabs, attention as a ring
    over the sp group (`parallel/sequence.py`); parameters never mention
    it, and every gradient is a partial sum over sp;
  * pp: the LLM's layers cut into contiguous stages, run as a GPipe
    pipeline over microbatches (`parallel/pipeline.py`); a stage holds
    only its layers (and their LoRA factors and AdamW moments), every
    other leaf is replicated over pp.

Ranks are ordered dp-major, pp innermost: rank = (((dp_i * fsdp + fsdp_i)
* tp + tp_i) * sp + sp_i) * pp + pp_i, the device order of JAX's
`make_mesh` (:31-54). `PARTITION_RULES`, `spec_for_path` and `_shardable`
are a copy of JAX's (:57-116), specs as tuples in JAX's [in, out] layout;
`leaf_layout` maps them onto the port's layout (linears and LoRA factors
transposed, `core/from_jax.py`). The port keeps the LLM's layers as a
dict of layers, so JAX's stacked-layer rules (`P("pp", "fsdp", "tp")`
...) read as: layer i of L belongs to stage i // (L / pp)
(`LeafLayout.stage`), and within its stage it is split over fsdp and tp
as the unstacked rules split it.

How each leaf is stored and used (`LeafLayout.tp_use`):
  * "local": stored as its tp shard and used as it is (the split heads
    and widths);
  * "gather": stored as its tp shard but all-gathered for use, as fsdp
    leaves are: `llm/embed/w` (tp over the vocabulary; the embedding and
    the tied head read it whole) and an untied `llm/lm_head/w`. This
    changes no number;
  * "partial": replicated over tp, but its gradient is a partial sum on
    each tp rank and is all-reduced over tp: every LoRA factor (JAX's
    rules keep them off tp) and the biases of column-parallel linears that
    JAX stores replicated (the ViT's q / k / v / fc1 biases, the
    projector's fc1 bias);
  * "full": replicated and used whole.

One difference from JAX: the port splits whole heads, so tp must divide
the kv-head count of Qwen2 (2 at full width) and the ViT's heads (16),
or SimLingo-Base's CLIP heads (16) and LLaMA heads (8 in `tiny`);
`check_tp` refuses other tp (JAX shards by divisibility alone). A leaf
whose split dimension tp does not divide is replicated, as JAX's
`_shardable` replicates it: SimLingo-Base's `llm/embed/w` [1, 512] (no
vocabulary) is "full", never read. A batch
whose rows do not divide over dp x fsdp is refused (JAX replicates it).
pp must divide the LLM's layer count, as JAX asserts (`check_pp`).

With one process, `make_mesh()` gives a mesh of one rank whose
collectives are the identity. On a gloo group holding CUDA tensors (several
ranks sharing one GPU) every collective, and every send and receive, is
staged through host memory: copied to the CPU, run, copied back
(`Comm.staged`). Each `Comm` counts its calls and bytes, and a staged one
also times every operation on the host (the device synchronised around
it); NCCL's collectives are kernels, which a profiler times.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import time
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from simlingo_tpu_torch.parallel import multihost

AXES = ("dp", "fsdp", "tp", "sp", "pp")

warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r"` is deprecated", category=FutureWarning)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class Comm:
    """Sum-collectives over one process group of `size` ranks (identity at
    size 1): all-reduce, and all-gather / reduce-scatter along a dimension;
    broadcast; and point-to-point sends and receives (`send`, `recv`,
    `sendrecv`), whose peers are indices in the group. `ranks` are the
    group's global ranks. `stats` counts calls and bytes (of the whole
    tensor a collective reduces or assembles: all-reduce's, all-gather's
    output, reduce-scatter's input; of the tensor sent or received) and,
    where the group is staged, host ms (the device synchronised before and
    after)."""

    def __init__(self, group=None, size: int = 1, rank: int = 0, staged: bool = False,
                 ranks: Optional[Sequence[int]] = None):
        self.group, self.size, self.rank, self.staged = group, size, rank, staged
        self.ranks = list(ranks) if ranks is not None else list(range(size))
        self.stats = dict(calls=0, bytes=0, ms=0.0)

    def _run(self, fn, src: torch.Tensor, dst: Optional[torch.Tensor] = None) -> None:
        """fn(src, dst) -- or fn(src) in place where dst is None -- with the
        statistics; staged: src copied to the host, dst (or src) back."""
        whole = src if dst is None or dst.numel() < src.numel() else dst
        self.stats["calls"] += 1
        self.stats["bytes"] += whole.numel() * whole.element_size()
        if not self.staged:
            fn(src) if dst is None else fn(src, dst)
            return
        if src.is_cuda:
            torch.cuda.synchronize(src.device)
        t0 = time.perf_counter()
        hsrc = src.cpu()
        hdst = None if dst is None else torch.empty(dst.shape, dtype=dst.dtype)
        fn(hsrc) if dst is None else fn(hsrc, hdst)
        (src if dst is None else dst).copy_(hsrc if dst is None else hdst)
        if src.is_cuda:
            torch.cuda.synchronize(src.device)
        self.stats["ms"] += (time.perf_counter() - t0) * 1e3

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Send x to the group's rank `dst` (blocking)."""
        x = x.contiguous()
        self._run(lambda t: dist.send(t, self.ranks[dst], group=self.group), x)

    def recv(self, shape, dtype, device, src: int) -> torch.Tensor:
        """A tensor of `shape` and `dtype` received from the group's rank
        `src` (blocking)."""
        out = torch.empty(shape, dtype=dtype, device=device)
        self._run(lambda t: dist.recv(t, self.ranks[src], group=self.group), out)
        return out

    def sendrecv(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """Send x to rank `dst` and receive a tensor like it from rank `src`
        at once (one batched pair, so a ring of sends cannot deadlock)."""
        x = x.contiguous()
        out = torch.empty_like(x)

        def pair(s, o):
            ops = [dist.P2POp(dist.isend, s, self.ranks[dst], self.group),
                   dist.P2POp(dist.irecv, o, self.ranks[src], self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self._run(pair, x, out)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """x of the group's rank `src` on every rank, in place; returns x."""
        if self.size > 1:
            self._run(lambda t: dist.broadcast(t, self.ranks[src], group=self.group), x)
        return x

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable `obj`, in group order (counted as a call;
        its bytes are the pickles', which are not counted)."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        self.stats["calls"] += 1
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group, in place; returns x."""
        if self.size > 1:
            self._run(lambda t: dist.all_reduce(t, group=self.group), x)
        return x

    def _gather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        out = flat.new_empty(self.size * flat.numel())
        self._run(lambda s, o: dist.all_gather_into_tensor(o, s, group=self.group), flat, out)
        return out.view(self.size, -1)

    def _scatter_flat(self, flat: torch.Tensor) -> torch.Tensor:
        out = flat.new_empty(flat.numel() // self.size)
        self._run(lambda s, o: dist.reduce_scatter_tensor(o, s, group=self.group), flat, out)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The group's shards concatenated along `dim`, in rank order."""
        return self.all_gather_many([x], [dim])[0]

    def all_gather_many(self, xs: Sequence[torch.Tensor], dims: Sequence[int]) -> list:
        """`all_gather` of each x along its dim, through one flat buffer a
        dtype (one collective where a leaf at a time would take hundreds)."""
        if self.size == 1:
            return list(xs)
        out: list = [None] * len(xs)
        for idx in _by_dtype(xs):
            full = self._gather_flat(torch.cat([xs[i].reshape(-1) for i in idx]))
            off = 0
            for i in idx:
                n = xs[i].numel()
                out[i] = torch.cat([full[r, off:off + n].view(xs[i].shape)
                                    for r in range(self.size)], dims[i])
                off += n
        return out

    def reduce_scatter_many(self, xs: Sequence[torch.Tensor], dims: Sequence[int]) -> list:
        """Each x summed over the group and cut along its dim (this rank's
        chunk), through one flat buffer a dtype: rank r's chunks of every x
        lie together at the r-th slice."""
        if self.size == 1:
            return list(xs)
        out: list = [None] * len(xs)
        for idx in _by_dtype(xs):
            chunks = {i: xs[i].chunk(self.size, dims[i]) for i in idx}
            flat = self._scatter_flat(torch.cat([chunks[i][r].reshape(-1) for r in range(self.size)
                                                 for i in idx]))
            off = 0
            for i in idx:
                shape = chunks[i][0].shape
                n = chunks[i][0].numel()
                out[i] = flat[off:off + n].view(shape)
                off += n
        return out

    def all_reduce_flat(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the group, in place, through one flat
        buffer a dtype."""
        if self.size == 1 or not tensors:
            return
        for idx in _by_dtype(tensors):
            ts = [tensors[i] for i in idx]
            flat = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]))
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def _by_dtype(xs: Sequence[torch.Tensor]) -> list:
    """Indices of xs grouped by dtype, in first-seen order."""
    groups: Dict[torch.dtype, list] = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    return list(groups.values())


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class Mesh:
    """This rank's place in a dp x fsdp x tp x sp x pp mesh, and one `Comm`
    an axis plus "batch" (dp x fsdp: the ranks that split the batch),
    "loss" (dp x fsdp x sp: the ranks whose losses and counts sum to the
    global batch's) and "world"."""

    GROUPS = AXES + ("batch", "loss", "world")

    def __init__(self, dp: int, fsdp: int, tp: int, rank: int = 0, groups=None,
                 staged: bool = False, sp: int = 1, pp: int = 1):
        self.shape = {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp, "pp": pp}
        self.world = dp * fsdp * tp * sp * pp
        self.rank = rank
        self.coords = {}
        rest = rank
        for a in reversed(AXES):
            rest, self.coords[a] = divmod(rest, self.shape[a])
        self.coords = {a: self.coords[a] for a in AXES}
        self.staged = staged
        groups = groups or {}
        self.comm: Dict[str, Comm] = {}
        for name in self.GROUPS:
            ranks = group_ranks(self.shape, name, self.coords)
            self.comm[name] = Comm(groups.get(name), len(ranks), ranks.index(rank), staged, ranks)

    @property
    def batch_size(self) -> int:
        """How many ranks split the batch (dp x fsdp)."""
        return self.shape["dp"] * self.shape["fsdp"]

    @property
    def batch_index(self) -> int:
        return self.coords["dp"] * self.shape["fsdp"] + self.coords["fsdp"]

    @property
    def tp(self) -> Optional[Comm]:
        """The tp group, or None where tp is 1 (the model runs unsplit)."""
        return self.comm["tp"] if self.shape["tp"] > 1 else None

    def comm_stats(self) -> Dict[str, Dict[str, float]]:
        return {name: dict(c.stats) for name, c in self.comm.items()
                if name != "world" or c.stats["calls"]}

    def __repr__(self) -> str:
        return ("Mesh(" + ", ".join(f"{a}={self.shape[a]}" for a in AXES)
                + f", rank={self.rank} at {self.coords})")


def _rank_of(shape, coords) -> int:
    rank = 0
    for a in AXES:
        rank = rank * shape[a] + coords[a]
    return rank


def group_ranks(shape, name: str, coords) -> list:
    """The ranks sharing every coordinate with `coords` except those of
    axis `name` (batch: dp and fsdp; loss: dp, fsdp and sp; world: all)."""
    free = {"batch": ("dp", "fsdp"), "loss": ("dp", "fsdp", "sp"),
            "world": AXES}.get(name, (name,))
    ranges = [range(shape[a]) if a in free else [coords[a]] for a in AXES]
    return sorted(_rank_of(shape, dict(zip(AXES, c))) for c in itertools.product(*ranges))


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
              device="cuda") -> Mesh:
    """The mesh over the processes of the default group (one process: a mesh
    of one). dp = -1 fills the world; the product must equal it (JAX
    :46-49). Every rank builds every group, in the same order."""
    world = multihost.world_size()
    if dp == -1:
        dp = world // (fsdp * tp * sp * pp)
    if dp < 1 or dp * fsdp * tp * sp * pp != world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}x{sp}x{pp} != {world} processes")
    rank = multihost.rank()
    staged = (world > 1 and torch.device(device).type == "cuda"
              and dist.get_backend() == "gloo")
    shape = {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp, "pp": pp}
    groups: Dict[str, Any] = {}
    if world > 1:
        for name in Mesh.GROUPS[:-1]:
            seen = set()
            for c in itertools.product(*(range(shape[a]) for a in AXES)):
                ranks = tuple(group_ranks(shape, name, dict(zip(AXES, c))))
                if len(ranks) == 1 or ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if rank in ranks:
                    groups[name] = g
        groups["world"] = dist.group.WORLD
    mesh = Mesh(dp, fsdp, tp, rank, groups, staged, sp, pp)
    if staged and multihost.is_primary():
        print(f"mesh {mesh.shape}: gloo on CUDA tensors, every collective staged "
              "through host memory (several ranks share one GPU)", flush=True)
    return mesh


# ---------------------------------------------------------------------------
# Layout rules: a copy of JAX's (simlingo_tpu/parallel/mesh.py:57-116)
# ---------------------------------------------------------------------------

# (regex over tree path, spec) -- first match wins; specs in JAX's layout
PARTITION_RULES: Sequence[Tuple[str, tuple]] = (
    (r"llm/layers/attn/(q|k|v)/w$",  ("pp", "fsdp", "tp")),
    (r"llm/layers/attn/(q|k|v)/b$",  ("pp", "tp")),
    (r"llm/layers/attn/o/w$",        ("pp", "tp", "fsdp")),
    (r"llm/layers/mlp/(gate|up)/w$", ("pp", "fsdp", "tp")),
    (r"llm/layers/mlp/down/w$",      ("pp", "tp", "fsdp")),
    (r"llm/layers/ln[12]/",          ("pp",)),
    (r"lora/layers/[a-z]+/a$",       ("pp", "fsdp", None)),
    (r"lora/layers/[a-z]+/b$",       ("pp", None, "fsdp")),
    (r"llm/embed/w$",              ("tp", "fsdp")),
    (r"llm/lm_head/w$",            ("fsdp", "tp")),
    (r"llm/.*attn/(q|k|v)/w$",     ("fsdp", "tp")),
    (r"llm/.*attn/(q|k|v)/b$",     ("tp",)),
    (r"llm/.*attn/o/w$",           ("tp", "fsdp")),
    (r"llm/.*mlp/(gate|up)/w$",    ("fsdp", "tp")),
    (r"llm/.*mlp/down/w$",         ("tp", "fsdp")),
    (r"lora/.*/(a)$",              ("fsdp", None)),
    (r"lora/.*/(b)$",              (None, "fsdp")),
    (r"vision/.*attn/(q|k|v)/w$",  ("fsdp", "tp")),
    (r"vision/.*attn/o/w$",        ("tp", "fsdp")),
    (r"vision/.*mlp/fc1/w$",       ("fsdp", "tp")),
    (r"vision/.*mlp/fc2/w$",       ("tp", "fsdp")),
    (r"vision/patch_embed/w$",     (None, "fsdp")),
    (r"vision/pos_embed$",         (None, None, "fsdp")),
    (r"vision/projector/fc1/w$",   ("fsdp", "tp")),
    (r"vision/projector/fc2/w$",   ("tp", "fsdp")),
    (r".*",                        ()),
)

# stored tp-sharded but gathered for use ("gather" above)
TP_GATHERED = re.compile(r"llm/(embed|lm_head)/w$")


def spec_for_path(path: str, rules=PARTITION_RULES) -> tuple:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return ()


def _shardable(spec: tuple, shape, sizes: Dict[str, int]) -> tuple:
    """Drop spec entries that do not divide the dimension evenly (JAX
    :106-116); `sizes` maps axis names to mesh sizes (absent: 1)."""
    out = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            out.append(None)
            continue
        names_t = (names,) if isinstance(names, str) else tuple(names)
        size = 1
        for n in names_t:
            size *= sizes.get(n, 1)
        out.append(names if dim % size == 0 else None)
    return tuple(out)


def transposed(path: str, ndim: int) -> bool:
    """Whether the port stores the leaf transposed from JAX's layout
    (`core/from_jax.py`): a linear's 2-D weight, scale or int8 code, and
    the LoRA factors."""
    parts = path.split("/")
    if parts[0] == "lora" and parts[-1] in ("a", "b"):
        return True
    return ndim == 2 and parts[-1] in ("w", "w_q", "scale") and len(parts) > 1 \
        and parts[-2] != "embed"


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    shape: tuple                 # the full leaf's shape
    spec: tuple                  # the port's layout, one entry a dimension
    fsdp_dim: Optional[int]
    tp_dim: Optional[int]
    tp_use: str                  # "local", "gather", "partial" or "full"
    stage: Optional[int] = None  # the pp stage holding it; None: every stage


# an LLM layer's leaves and its LoRA factors: the leaves a pp stage owns
STAGED = re.compile(r"^(llm|lora)/layers/(\d+)/")


def stage_of(path: str, num_layers: int, pp: int) -> Optional[int]:
    """The pp stage that holds leaf `path` (None: replicated over pp):
    layer i of `num_layers` lies on stage i // (num_layers / pp)."""
    m = STAGED.match(path)
    if m is None or pp == 1:
        return None
    return int(m.group(2)) // (num_layers // pp)


def num_layers_of(paths) -> int:
    """The LLM's layer count, from the paths of a full tree."""
    return 1 + max((int(m.group(2)) for m in map(STAGED.match, paths) if m), default=-1)


def leaf_layout(path: str, shape, sizes: Dict[str, int], num_layers: int = 0) -> LeafLayout:
    """How the leaf `path` of full shape `shape` (the port's layout) lies on
    a mesh of `sizes`, whose LLM has `num_layers` layers."""
    spec = tuple(spec_for_path(path)) + (None,) * (len(shape) - len(spec_for_path(path)))
    if transposed(path, len(shape)):
        spec = spec[::-1]
    spec = _shardable(spec, shape, sizes)
    # an axis of size 1 splits nothing (JAX's spec names it all the same)
    fsdp_dim = spec.index("fsdp") if "fsdp" in spec and sizes.get("fsdp", 1) > 1 else None
    tp_dim = spec.index("tp") if "tp" in spec and sizes.get("tp", 1) > 1 else None
    if tp_dim is not None:
        use = "gather" if TP_GATHERED.search(path) else "local"
    elif sizes.get("tp", 1) > 1 and (path.startswith("lora/") or _column_bias(path)):
        use = "partial"
    else:
        use = "full"
    return LeafLayout(tuple(shape), spec, fsdp_dim, tp_dim, use,
                      stage_of(path, num_layers, sizes.get("pp", 1)))


def _column_bias(path: str) -> bool:
    """A bias whose linear is column-parallel (JAX's [in, out] weight split
    over tp on its output)."""
    if not path.endswith("/b"):
        return False
    w = spec_for_path(path[:-1] + "w")
    return len(w) == 2 and w[1] == "tp"


def layouts(tree: Dict[str, Any], mesh: Mesh) -> Dict[str, LeafLayout]:
    """path -> LeafLayout for a full (unsharded) flat tree {path: tensor}."""
    n = num_layers_of(tree)
    if mesh.shape["pp"] > 1 and n % mesh.shape["pp"]:
        raise ValueError(f"pp={mesh.shape['pp']} must divide the LLM's {n} layers")
    return {p: leaf_layout(p, tuple(x.shape), mesh.shape, n) for p, x in tree.items()}


def held(lay: LeafLayout, mesh: Mesh) -> bool:
    """Whether this rank holds (a shard of) the leaf: every leaf but the
    layers of other pp stages."""
    return lay.stage is None or lay.stage == mesh.coords["pp"]


def check_pp(model_cfg, pp: int) -> None:
    """Refuse a pp that does not divide the LLM's layers (JAX asserts it,
    `simlingo_tpu/parallel/pipeline.py:170`)."""
    if model_cfg.llm.num_layers % pp:
        raise ValueError(f"pp={pp} must divide the LLM's {model_cfg.llm.num_layers} layers")


def check_tp(model_cfg, tp: int) -> None:
    """Refuse a tp the port cannot split by whole heads and widths: of
    SimLingo's ViT and Qwen2, or of SimLingo-Base's CLIP tower (a config
    with `clip`; the ResNet, replicated, puts no condition) and LLaMA."""
    if tp == 1:
        return
    q = model_cfg.llm
    if hasattr(model_cfg, "clip"):
        need = {"the LLaMA's heads": q.num_heads}
        if model_cfg.encoder == "llavanext":
            c = model_cfg.clip
            need.update({"CLIP's heads": c.num_heads, "CLIP's MLP width": c.intermediate_size,
                         "the projector's width": c.projector_hidden})
    else:
        v = model_cfg.vit
        need = {"the ViT's heads": v.num_heads, "the ViT's MLP width": v.intermediate_size,
                "the projector's width": v.projector_out}
    need.update({"the LLM's kv heads": q.num_kv_heads, "the LLM's MLP width": q.intermediate_size})
    bad = {k: n for k, n in need.items() if n % tp}
    if bad:
        raise ValueError(f"tp={tp} must divide {bad}: the port splits whole heads and "
                         "widths (ROADMAP C, differences by design)")


# ---------------------------------------------------------------------------
# Sharding trees and batches
# ---------------------------------------------------------------------------

def _chunk(x: torch.Tensor, dim: Optional[int], n: int, i: int) -> torch.Tensor:
    if dim is None or n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def shard_leaf(x: torch.Tensor, lay: LeafLayout, mesh: Mesh) -> torch.Tensor:
    """A full leaf -> this rank's shard (a copy)."""
    x = _chunk(x, lay.fsdp_dim, mesh.shape["fsdp"], mesh.coords["fsdp"])
    x = _chunk(x, lay.tp_dim, mesh.shape["tp"], mesh.coords["tp"])
    return x.clone()


def gather_leaf(x: torch.Tensor, lay: LeafLayout, mesh: Mesh, tp: bool = True
                ) -> torch.Tensor:
    """This rank's shard -> the full leaf (fsdp, then tp unless tp=False);
    collective over the leaf's groups."""
    if lay.fsdp_dim is not None:
        x = mesh.comm["fsdp"].all_gather(x, lay.fsdp_dim)
    if tp and lay.tp_dim is not None:
        x = mesh.comm["tp"].all_gather(x, lay.tp_dim)
    return x


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested tree -> {path: leaf}, paths "vision/layers/0/attn/q/w" as
    JAX's _path_str; `unflatten` is its inverse."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, x in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = x
    return out


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A full parameter tree -> this rank's tree of local shards (a pp
    stage's tree holds only its own layers, keyed by their global index)."""
    flat = flatten(params)
    lays = layouts(flat, mesh)
    return unflatten({p: shard_leaf(x, lays[p], mesh) for p, x in flat.items()
                      if held(lays[p], mesh)})


def gather_stages(flat: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """{path: value} of this rank's stage -> every stage's, on every rank
    (collective over pp; the values are pickled, so a tensor arrives on the
    host); the identity at pp = 1."""
    if mesh.shape["pp"] == 1:
        return flat
    host = {p: (x.detach().cpu() if isinstance(x, torch.Tensor) else x) for p, x in flat.items()}
    out: Dict[str, Any] = {}
    for part in mesh.comm["pp"].all_gather_object(host):
        out.update(part)
    return out


def gather_tree(flat: Dict[str, torch.Tensor], lays: Dict[str, LeafLayout],
                mesh: Mesh, order=None) -> Dict[str, torch.Tensor]:
    """This rank's shards {path: shard} -> every leaf whole, on every rank
    (collective over fsdp, tp and pp), in the order of `lays` (or of
    `order`). Leaves of another pp stage arrive on the host."""
    whole = gather_stages({p: gather_leaf(x, lays[p], mesh) for p, x in flat.items()}, mesh)
    return {p: whole[p] for p in (order if order is not None else lays) if p in whole}


def gather_params(local: Dict[str, Any], lays: Dict[str, LeafLayout],
                  mesh: Mesh) -> Dict[str, Any]:
    """Inverse of `shard_params`: the full tree on every rank (collective).
    `lays`: `layouts` of the full tree."""
    return unflatten(gather_tree(flatten(local), lays, mesh))


def local_rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    """(first row, rows) of this rank's slice of a global batch of n rows."""
    nb = mesh.batch_size
    if n % nb:
        raise ValueError(f"a global batch of {n} rows does not divide over dp x fsdp = {nb}")
    return mesh.batch_index * (n // nb), n // nb


def put_batch(batch: Any, mesh: Mesh) -> Any:
    """The rank's rows of a global batch: every tensor with a leading
    (batch) dimension is sliced; 0-d tensors and other values pass. Works
    on dataclasses, named tuples, dicts and lists of tensors."""
    def rows(x):
        if isinstance(x, torch.Tensor):
            if x.dim() == 0:
                return x
            r0, n = local_rows(x.shape[0], mesh)
            return x[r0:r0 + n]
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return type(x)(**{f.name: rows(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rows(v) for v in x))
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rows(v) for v in x)
        return x
    if mesh.batch_size == 1:
        return batch
    return rows(batch)
