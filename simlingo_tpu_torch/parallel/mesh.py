"""The dp x fsdp x tp mesh over torch.distributed ranks: layout rules,
sharding of parameter trees, per-rank batches and the collectives.

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
    (`models/layers.py`).

Ranks are ordered dp-major: rank = (dp_i * fsdp + fsdp_i) * tp + tp_i, the
device order of JAX's `make_mesh` (:49-51). `PARTITION_RULES`,
`spec_for_path` and `_shardable` are a copy of JAX's (:57-116), specs as
tuples in JAX's [in, out] layout; `leaf_layout` maps them onto the port's
layout (linears and LoRA factors transposed, `core/from_jax.py`).

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
the kv-head count of Qwen2 (2 at full width) and the ViT's heads (16);
`check_tp` refuses other tp (JAX shards by divisibility alone). A batch
whose rows do not divide over dp x fsdp is refused (JAX replicates it).

With one process, `make_mesh()` gives a mesh of one rank whose
collectives are the identity. On a gloo group holding CUDA tensors (several
ranks sharing one GPU) every collective is staged through host memory:
copied to the CPU, run, copied back (`Comm.staged`). Each `Comm` counts its
calls and bytes, and a staged one also times every collective on the host
(the device synchronised around it); NCCL's collectives are kernels, which
a profiler times.
"""

from __future__ import annotations

import dataclasses
import re
import time
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from simlingo_tpu_torch.parallel import multihost

AXES = ("dp", "fsdp", "tp")

warnings.filterwarnings("ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
                        r"` is deprecated", category=FutureWarning)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class Comm:
    """Sum-collectives over one process group of `size` ranks (identity at
    size 1): all-reduce, and all-gather / reduce-scatter along a dimension.
    `stats` counts calls and bytes (of the whole tensor a collective
    reduces or assembles: all-reduce's, all-gather's output,
    reduce-scatter's input) and, where the group is staged, host ms (the
    device synchronised before and after)."""

    def __init__(self, group=None, size: int = 1, rank: int = 0, staged: bool = False):
        self.group, self.size, self.rank, self.staged = group, size, rank, staged
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
    """This rank's place in a dp x fsdp x tp mesh, and one `Comm` an axis
    plus "batch" (dp x fsdp: the ranks that split the batch) and "world"."""

    def __init__(self, dp: int, fsdp: int, tp: int, rank: int = 0, groups=None,
                 staged: bool = False):
        self.shape = {"dp": dp, "fsdp": fsdp, "tp": tp}
        self.world = dp * fsdp * tp
        self.rank = rank
        self.coords = {"dp": rank // (fsdp * tp), "fsdp": (rank // tp) % fsdp,
                       "tp": rank % tp}
        self.staged = staged
        groups = groups or {}
        self.comm: Dict[str, Comm] = {}
        for name in ("dp", "fsdp", "tp", "batch", "world"):
            ranks = group_ranks(self.shape, name, self.coords)
            self.comm[name] = Comm(groups.get(name), len(ranks), ranks.index(rank), staged)

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
        return (f"Mesh(dp={self.shape['dp']}, fsdp={self.shape['fsdp']}, "
                f"tp={self.shape['tp']}, rank={self.rank} at {self.coords})")


def _rank_of(shape, d, f, t) -> int:
    return (d * shape["fsdp"] + f) * shape["tp"] + t


def group_ranks(shape, name: str, coords) -> list:
    """The ranks sharing every coordinate with `coords` except those of
    axis `name` (batch: dp and fsdp; world: all)."""
    free = {"dp": ("dp",), "fsdp": ("fsdp",), "tp": ("tp",), "batch": ("dp", "fsdp"),
            "world": AXES}[name]
    ranges = [range(shape[a]) if a in free else [coords[a]] for a in AXES]
    return sorted(_rank_of(shape, d, f, t) for d in ranges[0] for f in ranges[1]
                  for t in ranges[2])


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, device="cuda") -> Mesh:
    """The mesh over the processes of the default group (one process: a mesh
    of one). dp = -1 fills the world; the product must equal it (JAX
    :46-49). Every rank builds every group, in the same order."""
    world = multihost.world_size()
    if dp == -1:
        dp = world // (fsdp * tp)
    if dp < 1 or dp * fsdp * tp != world:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp} != {world} processes")
    rank = multihost.rank()
    staged = (world > 1 and torch.device(device).type == "cuda"
              and dist.get_backend() == "gloo")
    groups: Dict[str, Any] = {}
    if world > 1:
        shape = {"dp": dp, "fsdp": fsdp, "tp": tp}
        for name in ("dp", "fsdp", "tp", "batch"):
            seen = set()
            for d in range(dp):
                for f in range(fsdp):
                    for t in range(tp):
                        ranks = tuple(group_ranks(shape, name, {"dp": d, "fsdp": f, "tp": t}))
                        if len(ranks) == 1 or ranks in seen:
                            continue
                        seen.add(ranks)
                        g = dist.new_group(list(ranks))
                        if rank in ranks:
                            groups[name] = g
        groups["world"] = dist.group.WORLD
    mesh = Mesh(dp, fsdp, tp, rank, groups, staged)
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


def leaf_layout(path: str, shape, sizes: Dict[str, int]) -> LeafLayout:
    """How the leaf `path` of full shape `shape` (the port's layout) lies on
    a mesh of `sizes`."""
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
    return LeafLayout(tuple(shape), spec, fsdp_dim, tp_dim, use)


def _column_bias(path: str) -> bool:
    """A bias whose linear is column-parallel (JAX's [in, out] weight split
    over tp on its output)."""
    if not path.endswith("/b"):
        return False
    w = spec_for_path(path[:-1] + "w")
    return len(w) == 2 and w[1] == "tp"


def layouts(tree: Dict[str, Any], mesh: Mesh) -> Dict[str, LeafLayout]:
    """path -> LeafLayout for a full (unsharded) flat tree {path: tensor}."""
    return {p: leaf_layout(p, tuple(x.shape), mesh.shape) for p, x in tree.items()}


def check_tp(model_cfg, tp: int) -> None:
    """Refuse a tp the port cannot split by whole heads and widths."""
    if tp == 1:
        return
    v, q = model_cfg.vit, model_cfg.llm
    need = {"the ViT's heads": v.num_heads, "the ViT's MLP width": v.intermediate_size,
            "the projector's width": v.projector_out, "Qwen2's kv heads": q.num_kv_heads,
            "Qwen2's MLP width": q.intermediate_size}
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
    """A full parameter tree -> this rank's tree of local shards."""
    flat = flatten(params)
    lays = layouts(flat, mesh)
    return unflatten({p: shard_leaf(x, lays[p], mesh) for p, x in flat.items()})


def gather_params(local: Dict[str, Any], lays: Dict[str, LeafLayout],
                  mesh: Mesh) -> Dict[str, Any]:
    """Inverse of `shard_params`: the full tree on every rank (collective).
    `lays`: `layouts` of the full tree."""
    return unflatten({p: gather_leaf(x, lays[p], mesh)
                       for p, x in flatten(local).items()})


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
