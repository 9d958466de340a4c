"""parallel/mesh.py's layout rules against JAX's (no spawn).

For `SimLingoConfig()` (shapes from `jax.eval_shape`, no init) and
`tiny()`, at meshes (2,2,2), (1,1,2), (4,1,1) and (1,2,1): the port's
`spec_for_path` + `_shardable` equal the specs of JAX's `param_shardings`
leaf for leaf; the port's own layout of each bridged leaf is that spec
in the port's orientation; the leaves stored tp-split but gathered for use
and those whose gradients are partial over tp are exactly the ones the
module names. Every rank's `shard_params` of the tiny tree, put back
together along the layout's dimensions, is `params_from_jax`'s tree
exactly (the collective `gather_params` runs in the spawned ranks of
test_torch_parallel_train.py)."""

import jax
import numpy as np
import pytest
import torch

from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.parallel import mesh as jmesh
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.parallel import mesh as M
from simlingo_tpu_torch.train import train_step as ts

MESHES = [(2, 2, 2), (1, 1, 2), (4, 1, 1), (1, 2, 1)]


def _jax_tree(which):
    cfg = jsim.SimLingoConfig() if which == "default" else jsim.SimLingoConfig.tiny()
    return jax.eval_shape(lambda k: jsim.init_params(k, cfg), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def trees():
    return {w: _jax_tree(w) for w in ("default", "tiny")}


def _mesh(shape):
    d, f, t = shape
    return jmesh.make_mesh(dp=d, fsdp=f, tp=t, devices=jax.devices()[:d * f * t])


@pytest.mark.parametrize("which", ["default", "tiny"])
@pytest.mark.parametrize("shape", MESHES)
def test_specs_equal_jax_param_shardings(trees, which, shape):
    tree = trees[which]
    shardings = jmesh.param_shardings(tree, _mesh(shape))
    sizes = dict(zip(M.AXES, shape))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    specs = dict(jax.tree_util.tree_flatten_with_path(shardings)[0])
    assert len(flat) > 40
    split = 0
    for path, leaf in flat:
        p = jmesh._path_str(path)
        want = tuple(specs[path].spec)
        got = M._shardable(M.spec_for_path(p), leaf.shape, sizes)
        assert got == want, p
        split += any(a is not None for a in got)
    assert split > 10


def _port_shapes(tree):
    """{path: (shape, whether the bridge transposed it)} of the bridged tree."""
    ramp = jax.tree_util.tree_map(
        lambda s: np.arange(np.prod(s.shape), dtype=np.float32).reshape(s.shape), tree)
    flat = {jmesh._path_str(p): a for p, a in jax.tree_util.tree_flatten_with_path(ramp)[0]}
    return {p: (tuple(x.shape), x.dim() == 2 and not np.array_equal(x.numpy(), flat[p]))
            for p, x in ts.flatten(params_from_jax(ramp, device="cpu")).items()}


@pytest.mark.parametrize("shape", MESHES)
def test_port_layouts_follow_the_specs(trees, shape):
    tree = trees["tiny"]
    sizes = dict(zip(M.AXES, shape))
    jflat = {jmesh._path_str(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    port = _port_shapes(tree)
    assert set(port) == set(jflat)
    gathered, partial = set(), set()
    for p, (shp, flipped) in port.items():
        assert M.transposed(p, len(shp)) == flipped, p
        lay = M.leaf_layout(p, shp, sizes)
        jspec = M._shardable(M.spec_for_path(p), jflat[p].shape, sizes)
        want = jspec[::-1] if flipped else jspec
        assert lay.spec == want, p
        for axis, dim in (("fsdp", lay.fsdp_dim), ("tp", lay.tp_dim)):
            split = axis in want and sizes[axis] > 1
            assert dim == (want.index(axis) if split else None), (p, axis)
        gathered |= {p} if lay.tp_use == "gather" else set()
        partial |= {p} if lay.tp_use == "partial" else set()
    if sizes["tp"] == 1:
        assert not gathered and not partial
        return
    assert gathered == {"llm/embed/w"}
    vit_bias = {f"vision/layers/{i}/{n}/b" for i in range(2)
                for n in ("attn/q", "attn/k", "attn/v", "mlp/fc1")}
    assert partial == vit_bias | {"vision/projector/fc1/b"}         # tiny has no LoRA
    lora = M.leaf_layout("lora/layers/0/q/a", (4, 64), sizes)
    assert lora.tp_use == "partial" and lora.tp_dim is None


@pytest.mark.parametrize("shape", MESHES)
def test_shards_put_back_together_are_the_tree(shape):
    cfg = jsim.SimLingoConfig.tiny()
    params = params_from_jax(jax.jit(jsim.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg), device="cpu")
    full = ts.flatten(params)
    d, f, t = shape
    meshes = [M.Mesh(d, f, t, rank=r) for r in range(d * f * t)]
    lays = M.layouts(full, meshes[0])
    shards = [ts.flatten(M.shard_params(params, m)) for m in meshes]
    for p, x in full.items():
        lay = lays[p]

        def block(fi, ti):
            r = next(i for i, m in enumerate(meshes)
                     if m.coords == {"dp": 0, "fsdp": fi, "tp": ti, "sp": 0, "pp": 0})
            return shards[r][p]
        rows = []
        for fi in range(f if lay.fsdp_dim is not None else 1):
            parts = [block(fi, ti) for ti in range(t if lay.tp_dim is not None else 1)]
            rows.append(torch.cat(parts, lay.tp_dim) if len(parts) > 1 else parts[0])
        back = torch.cat(rows, lay.fsdp_dim) if len(rows) > 1 else rows[0]
        assert torch.equal(back, x), p
        for m, sh in zip(meshes, shards):      # dp replicas hold the same shard
            if m.coords["dp"] > 0:
                c = m.coords
                assert torch.equal(sh[p], block(c["fsdp"] if lay.fsdp_dim is not None else 0,
                                                c["tp"] if lay.tp_dim is not None else 0))
