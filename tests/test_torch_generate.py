"""Parity of the port's decoding (`ray_tpu_torch.models.generate`) with
the JAX package's (`ray_tpu.models.generate`) on the CPU, in f32.

A tiny GQA model (vocab 128, dim 64, 2 layers, 4 heads on 2 KV heads);
the JAX parameters, perturbed with numpy noise, go to the port through
`load_jax_params`, and the same numpy inputs go through both packages.
Logits, caches and pools are held at rtol = atol = 1e-5; greedy tokens
are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jax_gen
from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.models import generate as gen
from ray_tpu_torch.models import llama

from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

TOL = 1e-5

KW = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
          intermediate=128, max_seq_len=128)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, attention="reference",
                                 **KW)
    cfg = llama.LlamaConfig(dtype=torch.float32, attention="reference",
                            remat=False, **KW)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        jax_llama.init_params(jax.random.PRNGKey(0), jcfg),
    )
    model = llama.Llama(cfg, device="cpu")
    model.load_state_dict(llama.load_jax_params(tree, cfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 128, shape).astype(np.int32)


@pytest.mark.parametrize("form", ["scalar", "rows"])
def test_forward_with_cache_matches_jax(models, form):
    jcfg, params, cfg, model = models
    prompt, extra = _tokens((2, 10), 1), _tokens((2, 3), 2)
    jcache = jax_gen.init_kv_cache(jcfg, 2, 16)
    cache = gen.init_kv_cache(cfg, 2, 16, device="cpu")
    if form == "scalar":
        steps = [(prompt, 0, 10), (extra, 10, 13)]
    else:  # per-row offsets and valid lengths: rows at 10 and 7
        steps = [(prompt, 0, np.array([10, 7], np.int32)),
                 (extra, np.array([10, 7], np.int32),
                  np.array([13, 10], np.int32))]
    for toks, pos, valid in steps:
        want, jcache = jax_gen._forward_with_cache(
            params, jcfg, jnp.asarray(toks), jcache, jnp.asarray(pos),
            jnp.asarray(valid))
        got, cache = gen._forward_with_cache(
            model, cfg, torch.from_numpy(toks), cache,
            pos if isinstance(pos, int) else torch.from_numpy(pos),
            valid if isinstance(valid, int) else torch.from_numpy(valid))
        assert got.dtype == torch.float32
        _close(got, want)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])


def test_paged_prefill_and_decode_match_jax(models):
    """Two rows prefilled chunk by chunk into scattered blocks, then
    greedy decode steps over both rows, with row 1 dead for the last
    step (its table masked to the null block)."""
    jcfg, params, cfg, model = models
    bl, chunk = 4, 8
    tables = np.array([[3, 9, 5, 1, 0, 0], [7, 2, 11, 4, 0, 0]], np.int32)
    prompts = _tokens((2, 16), 3)
    jpool = jax_gen.init_block_pool(jcfg, 12, bl)
    pool = gen.init_block_pool(cfg, 12, bl, device="cpu")
    last_j, last_t = [], []
    for row in range(2):
        for off in range(0, 16, chunk):
            toks = prompts[row:row + 1, off:off + chunk]
            table = tables[row:row + 1]
            want, jpool = jax_gen.paged_prefill(
                params, jcfg, jnp.asarray(toks), jpool, jnp.asarray(table),
                jnp.int32(off), jnp.int32(off + chunk))
            got, pool = gen.paged_prefill(
                model, cfg, torch.from_numpy(toks), pool,
                torch.from_numpy(table), off, off + chunk)
            _close(got, want)
        last_j.append(want[0, -1])
        last_t.append(got[0, -1])
    _close(pool["k"], jpool["k"])
    _close(pool["v"], jpool["v"])
    jlast, tlast = jnp.stack(last_j), torch.stack(last_t)
    positions = np.array([16, 16], np.int32)
    for alive in ([True, True], [True, True], [True, False]):
        alive = np.array(alive)
        jtok, jpool, jlast = jax_gen.paged_decode_step(
            params, jcfg, jpool, jnp.asarray(tables), jlast,
            jnp.asarray(positions), jnp.asarray(alive),
            jax.random.PRNGKey(0))
        ttok, pool, tlast = gen.paged_decode_step(
            model, cfg, pool, torch.from_numpy(tables), tlast,
            torch.from_numpy(positions), torch.from_numpy(alive))
        assert ttok.tolist() == np.asarray(jtok).tolist()
        _close(tlast, jlast)
        _close(pool["k"], jpool["k"])
        _close(pool["v"], jpool["v"])
        positions = positions + 1


def _generate_both(models, prompts, lengths, **kw):
    jcfg, params, cfg, model = models
    want, want_len = jax_gen.generate(params, jnp.asarray(prompts),
                                      jnp.asarray(lengths), jcfg, **kw)
    got, got_len = gen.generate(model, torch.from_numpy(prompts),
                                torch.from_numpy(lengths), cfg, **kw)
    return (np.asarray(want), np.asarray(want_len), got.numpy(),
            got_len.numpy())


@pytest.mark.parametrize("batch", ["equal", "ragged"])
def test_greedy_generate_matches_jax(models, batch):
    prompts = _tokens((3, 9), 4)
    lengths = np.array([9, 9, 9] if batch == "equal" else [9, 5, 7],
                       np.int32)
    want, want_len, got, got_len = _generate_both(models, prompts, lengths,
                                                  max_new_tokens=10)
    assert got.tolist() == want.tolist()
    assert got_len.tolist() == want_len.tolist() == [10, 10, 10]
    # Declare row 0's third token EOS: its length counts the EOS, and it
    # emits 0 after it (other rows stop wherever they emit it).
    eos = int(want[0, 2])
    want, want_len, got, got_len = _generate_both(
        models, prompts, lengths, max_new_tokens=10, eos_token=eos)
    assert got.tolist() == want.tolist()
    assert got_len.tolist() == want_len.tolist()
    assert got_len[0] <= 3 and got[0, 2] in (eos, 0)
    assert (got[0, got_len[0]:] == 0).all()


def test_generate_stream_matches_jax_on_ragged_batch(models):
    jcfg, params, cfg, model = models
    prompts = _tokens((3, 9), 5)
    lengths = np.array([9, 4, 6], np.int32)
    want = np.stack(list(jax_gen.generate_stream(
        params, jnp.asarray(prompts), jnp.asarray(lengths), jcfg,
        max_new_tokens=8)))
    got = np.stack(list(gen.generate_stream(
        model, torch.from_numpy(prompts), torch.from_numpy(lengths), cfg,
        max_new_tokens=8)))
    assert got.tolist() == want.tolist()
    # With every row's first token as EOS the stream stops after one step.
    stream = gen.generate_stream(model, prompts, lengths, cfg,
                                 max_new_tokens=8, eos_token=int(got[0, 0]),
                                 cache_len=24)
    assert len(list(stream)) >= 1
    with pytest.raises(ValueError, match="cache_len"):
        list(gen.generate_stream(model, prompts, lengths, cfg,
                                 max_new_tokens=8, cache_len=12))


def test_top_k_samples_stay_in_the_top_k_with_ties_kept():
    logits = torch.tensor([[5.0, 4.0, 3.0, 3.0, 1.0, 0.5]] * 4000)
    g = torch.Generator().manual_seed(0)
    tokens = gen._sample(logits, g, temperature=20.0, top_k=3)
    # The cutoff is the third largest, 3.0; both tokens at it are kept.
    assert set(tokens.tolist()) == {0, 1, 2, 3}
    rnd = torch.randn(64, 128, generator=g)
    tokens = gen._sample(rnd, g, temperature=1.0, top_k=5)
    top = torch.topk(rnd, 5).indices
    assert (top == tokens[:, None]).any(dim=1).all()
    assert gen._sample(rnd, None, 0.0, 0).tolist() == rnd.argmax(-1).tolist()


def test_sampled_decoding_reproducible_from_one_generator(models):
    _, _, cfg, model = models
    prompts = _tokens((3, 5), 6)
    lengths = np.array([5, 5, 5], np.int32)

    def sample(seed):
        toks, lens = gen.generate(model, prompts, lengths, cfg,
                                  max_new_tokens=8, temperature=0.8,
                                  top_k=20,
                                  rng=torch.Generator().manual_seed(seed))
        assert toks.shape == (3, 8) and (lens == 8).all()
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        return toks.tolist()

    assert sample(9) == sample(9)
    assert sample(9) != sample(10)
