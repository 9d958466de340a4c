"""Token selection of the port's generator against JAX's (CPU).

`infer/runner.py:sample_categorical` follows JAX's order and tie rules:
the restriction masks the logits before the greedy argmax too; top-k keeps
every logit >= the k-th (ties included) before the temperature; top-p
keeps sorted tokens while the cumulative probability before them is <=
top_p, the first always, then thresholds at the smallest kept logit (ties
included). Greedy tokens must equal JAX's; a sampled draw's stream differs
by design (a `torch.Generator`, not a JAX key), so JAX's draws are held
against the port's filtered softmax both ways: every id JAX draws lies in
the port's support, every id the port expects at least `SEEN` times is
among JAX's draws, and JAX's frequencies pass a chi-square test against
the port's probabilities; the port's own draws pass the same test. One
generator seed gives one stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from simlingo_tpu.infer import runner as jrun
from simlingo_tpu_torch.infer import runner as trun
from simlingo_tpu_torch.infer import speculative as tspec
from tests.test_torch_infer import _assert_same, _example, setup  # noqa: F401

V = 64
DRAWS = 4096
SEEN = 20          # expected count above which an id must be drawn


def _tied_logits(seed, rows=3):
    """[rows, V] logits on a 0.5 grid, so many values tie."""
    return np.round(np.random.RandomState(seed).randn(rows, V) * 2) / 2


@pytest.mark.parametrize("restrict", [None, (0, 10), (20, 7), (63, 1)])
def test_greedy_selection_matches_jax(restrict):
    logits = _tied_logits(0, rows=16).astype(np.float32)
    want = np.asarray(jrun.sample_categorical(
        jax.random.PRNGKey(0), jnp.asarray(logits),
        jrun.GenerateConfig(restrict_tokens=restrict)))
    got = trun.sample_categorical(torch.from_numpy(logits),
                                  trun.GenerateConfig(restrict_tokens=restrict))
    np.testing.assert_array_equal(got.numpy(), want)
    if restrict is None:        # the default path: the first argmax, as before
        for dt in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(logits).to(dt)
            assert torch.equal(trun.sample_categorical(t), torch.argmax(t.float(), -1))


def test_generate_with_restriction_matches_jax(setup):  # noqa: F811
    """The whole greedy generator with restrict_tokens: tokens equal JAX's,
    all inside the range, waypoints within 2e-4."""
    jcfg, jparams, tcfg, tparams = setup
    jdi, tdi = _example(jcfg, batch=2, seed=11)
    lo, n = 40, 25
    out_j = jax.jit(lambda p, d: jrun.generate_and_drive(
        p, d, jcfg, jrun.GenerateConfig(max_new_tokens=5, eos_token_id=-1,
                                        cache_dtype=jnp.float32, restrict_tokens=(lo, n)),
        compute_dtype=jnp.float32))(jparams, jdi)
    out_t = trun.generate_and_drive(
        tparams, tdi, tcfg,
        trun.GenerateConfig(max_new_tokens=5, eos_token_id=-1, cache_dtype=torch.float32,
                            restrict_tokens=(lo, n)),
        compute_dtype=torch.float32)
    _assert_same(out_t, out_j)
    toks = out_t.language_tokens
    assert bool(((toks >= lo) & (toks < lo + n)).all())


SAMPLING = [dict(temperature=0.7, top_k=5), dict(temperature=1.0, top_p=0.5),
            dict(temperature=1.3, top_k=12, top_p=0.8), dict(temperature=0.5),
            dict(temperature=1.0, top_k=3, restrict_tokens=(8, 40)),
            dict(temperature=2.0, top_p=0.3, restrict_tokens=(0, 32))]


def _chisquare_pvalue(counts, p):
    """Chi-square p-value of `counts` against probabilities `p` (both over
    the support), the bins expected fewer than 5 times merged into one."""
    small = p * DRAWS < 5
    obs, exp = counts[~small].astype(float), p[~small]
    if small.any():
        obs, exp = np.append(obs, counts[small].sum()), np.append(exp, p[small].sum())
    exp = exp / exp.sum() * DRAWS
    if len(obs) == 1:
        return 1.0 if obs[0] == DRAWS else 0.0
    return stats.chisquare(obs, exp).pvalue


@pytest.mark.parametrize("kw", SAMPLING, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_sampling_support_and_frequencies(kw):
    logits = _tied_logits(1, rows=1).astype(np.float32)            # [1, V]
    jcfg, tcfg = jrun.GenerateConfig(**kw), trun.GenerateConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(3), DRAWS)
    jax_ids = np.asarray(jax.jit(jax.vmap(
        lambda k: jrun.sample_categorical(k, jnp.asarray(logits), jcfg)))(keys))[:, 0]
    filt = trun.filter_logits(torch.from_numpy(logits), tcfg)[0]
    support = torch.isfinite(filt).numpy()
    p_all = torch.softmax(filt, -1).double().numpy()
    assert support[jax_ids].all(), sorted(set(jax_ids[~support[jax_ids]].tolist()))
    jax_counts = np.bincount(jax_ids, minlength=V)
    unseen = (p_all * DRAWS >= SEEN) & (jax_counts == 0)     # a support wider than JAX's
    assert not unseen.any(), np.flatnonzero(unseen).tolist()
    if kw.get("top_k"):                                       # ties kept: >= k ids
        assert support.sum() >= min(kw["top_k"], kw.get("restrict_tokens", (0, V))[1])
    p = p_all[support]
    pv = _chisquare_pvalue(jax_counts[support], p)
    assert pv > 1e-3, (jax_counts[support], p * DRAWS)

    gen = torch.Generator().manual_seed(5)
    ids = trun.sample_categorical(torch.from_numpy(logits).expand(DRAWS, V), tcfg, gen)
    assert support[ids.numpy()].all()
    counts = np.bincount(ids.numpy(), minlength=V)[support]
    assert _chisquare_pvalue(counts, p) > 1e-3, (counts, p * DRAWS)


def test_same_generator_seed_same_tokens(setup):  # noqa: F811
    jcfg, _, tcfg, tparams = setup
    _, tdi = _example(jcfg, batch=2, seed=13)
    gcfg = trun.GenerateConfig(max_new_tokens=6, eos_token_id=-1, cache_dtype=torch.float32,
                               temperature=1.5, top_k=40, top_p=0.95)

    def run(seed):
        return trun.generate_and_drive(
            tparams, tdi, tcfg, gcfg, compute_dtype=torch.float32,
            generator=torch.Generator().manual_seed(seed)).language_tokens

    first = run(7)
    assert torch.equal(first, run(7))
    greedy = trun.generate_and_drive(
        tparams, tdi, tcfg, trun.GenerateConfig(max_new_tokens=6, eos_token_id=-1,
                                                cache_dtype=torch.float32),
        compute_dtype=torch.float32).language_tokens
    assert not torch.equal(first, greedy)     # the sampling path did sample


def test_speculative_decode_refuses_sampling(setup):  # noqa: F811
    jcfg, _, tcfg, tparams = setup
    _, tdi = _example(jcfg, batch=1, seed=2)
    tables = tspec.build_draft_tables([[1, 2, 3]], tcfg.llm.vocab_size)
    with pytest.raises(ValueError, match="greedy-only"):
        tspec.generate_and_drive_spec(
            tparams, tdi, tcfg, trun.GenerateConfig(temperature=1.0), tables)
