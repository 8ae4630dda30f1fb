"""The port's HuggingFace conversion (`ray_tpu_torch.models.hf_convert`)
on the CPU, against random-init `transformers` models of the six
families built locally (no download), as `tests/test_hf_parity.py`
builds them: the port's logits match transformers', its state dict
equals the JAX converter's tree mapped through `load_jax_params`, its
greedy decode matches `transformers.generate`, and every checkpoint
feature it cannot represent is refused loudly, as the JAX converter
refuses it."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from ray_tpu.models import hf_convert as jax_hf  # noqa: E402
from ray_tpu_torch.models import generate as gen  # noqa: E402
from ray_tpu_torch.models import hf_convert, llama  # noqa: E402

from _torch_port import isolated_module  # noqa: E402,F401 (autouse fixture)

GEOMETRY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, max_position_embeddings=64,
                rope_theta=10000.0, attn_implementation="eager")

#: family -> (config class, model class, extra config, logits tolerance)
FAMILIES = {
    "llama_mha": ("LlamaConfig", "LlamaForCausalLM",
                  dict(num_attention_heads=4, num_key_value_heads=4,
                       tie_word_embeddings=False), 2e-4),
    "llama_gqa": ("LlamaConfig", "LlamaForCausalLM",
                  dict(num_attention_heads=8, num_key_value_heads=2,
                       rms_norm_eps=1e-5, tie_word_embeddings=False), 2e-4),
    "qwen2_tied": ("Qwen2Config", "Qwen2ForCausalLM",
                   dict(num_attention_heads=8, num_key_value_heads=2,
                        use_sliding_window=False, tie_word_embeddings=True),
                   2e-4),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                   tie_word_embeddings=False), 2e-4),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(num_attention_heads=4, num_key_value_heads=2,
                     sliding_window=None, tie_word_embeddings=False), 2e-4),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(num_attention_heads=4, num_key_value_heads=1, head_dim=32,
                   hidden_activation="gelu_pytorch_tanh"), 5e-4),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(num_attention_heads=4, num_key_value_heads=2,
                  tie_word_embeddings=False, pad_token_id=0, eos_token_id=1,
                  bos_token_id=2), 2e-4),
}
families = pytest.mark.parametrize("family", sorted(FAMILIES))


def _hf_model(family, seed=0):
    config_cls, model_cls, extra, _ = FAMILIES[family]
    torch.manual_seed(seed)
    hf_cfg = getattr(transformers, config_cls)(**GEOMETRY, **extra)
    return getattr(transformers, model_cls)(hf_cfg).eval()


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 128, shape).astype(np.int64)


@families
def test_logits_match_transformers(family):
    model = _hf_model(family, seed=1)
    tokens = torch.from_numpy(_tokens((2, 33), 1))
    with torch.no_grad():
        want = model(tokens).logits
    ours, cfg = hf_convert.load_hf_llama(model, device="cpu")
    assert cfg.dtype == torch.float32 and cfg.attention == "reference"
    with torch.no_grad():
        got = llama.forward(ours, tokens)
    diff = (got - want).abs().max().item()
    assert diff < FAMILIES[family][3], diff
    assert (got.argmax(-1) == want.argmax(-1)).all()


@families
def test_state_dict_equals_the_jax_converters_tree(family):
    model = _hf_model(family, seed=2)
    cfg = hf_convert.config_from_hf(model.config)
    jcfg = jax_hf.config_from_hf(model.config)
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "intermediate", "head_dim", "norm_eps", "rope_theta",
                  "rope_scaling", "attn_bias", "qk_norm", "act",
                  "norm_offset", "embed_scale", "max_seq_len"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    state = hf_convert.convert_hf_llama(model.state_dict(), cfg)
    tree = jax.tree.map(np.asarray,
                        jax_hf.convert_hf_llama(model.state_dict(), jcfg))
    want = llama.load_jax_params(tree, cfg)
    assert set(state) == set(want) == set(llama.Llama(cfg, device="meta").state_dict())
    for name in want:
        torch.testing.assert_close(state[name], want[name], rtol=0, atol=0)


@pytest.mark.parametrize("family", ["qwen2_tied", "qwen3", "phi3"])
def test_greedy_decode_matches_transformers_generate(family):
    """Biases, q/k norms and split fused projections reach the KV-cache
    serving path."""
    model = _hf_model(family, seed=3)
    prompt = _tokens((2, 11), 3)
    with torch.no_grad():
        want = model.generate(torch.from_numpy(prompt), max_new_tokens=10,
                              do_sample=False, pad_token_id=0,
                              eos_token_id=None)[:, prompt.shape[1]:]
    ours, cfg = hf_convert.load_hf_llama(model, device="cpu")
    got, lengths = gen.generate(ours, prompt, np.full(2, 11), cfg,
                                max_new_tokens=10)
    assert got.tolist() == want.tolist()
    assert lengths.tolist() == [10, 10]


def _ns(**kw):
    return types.SimpleNamespace(**kw)


REFUSALS = {
    "yarn_rope": (lambda: transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        rope_scaling={"rope_type": "yarn", "factor": 2.0}),
        NotImplementedError, "rope_scaling"),
    "dynamic_rope": (lambda: _ns(
        rope_scaling={"type": "dynamic", "factor": 2.0}),
        NotImplementedError, "rope_scaling"),
    "model_type": (lambda: _ns(model_type="gpt_bigcode", rope_scaling=None),
                   NotImplementedError, "model_type"),
    "mistral_window": (lambda: transformers.MistralConfig(
        **GEOMETRY, num_attention_heads=4, num_key_value_heads=2,
        sliding_window=32), NotImplementedError, "sliding-window"),
    "qwen2_window": (lambda: _ns(model_type="qwen2", use_sliding_window=True),
                     NotImplementedError, "sliding-window"),
    "partial_rotary": (lambda: _ns(model_type="phi3",
                                   partial_rotary_factor=0.5),
                       NotImplementedError, "partial_rotary_factor"),
    "o_proj_bias": (lambda: transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        attention_bias=True), NotImplementedError, "attention_bias"),
    "gemma_activations": (lambda: _ns(model_type="gemma",
                                      hidden_act="gelu_pytorch_tanh",
                                      hidden_activation="gelu"),
                          NotImplementedError, "conflicting"),
    "gemma_act": (lambda: _ns(model_type="gemma", hidden_act="relu"),
                  NotImplementedError, "hidden_act"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_config_refusals_match_the_jax_converter(case):
    make, error, match = REFUSALS[case]
    for convert in (hf_convert.config_from_hf, jax_hf.config_from_hf):
        with pytest.raises(error, match=match):
            convert(make())


def test_unmapped_and_partially_split_tensors_are_refused():
    model = _hf_model("llama_gqa")
    cfg = hf_convert.config_from_hf(model.config)
    state = dict(model.state_dict())
    state["model.layers.0.self_attn.o_proj.bias"] = torch.zeros(64)
    with pytest.raises(ValueError, match="unconverted"):
        hf_convert.convert_hf_llama(state, cfg)
    phi = _hf_model("phi3")
    pcfg = hf_convert.config_from_hf(phi.config)
    state = dict(phi.state_dict())
    key = "model.layers.0.self_attn.qkv_proj.weight"
    state[key] = state[key][:-8]
    with pytest.raises(ValueError, match="partial split"):
        hf_convert.convert_hf_llama(state, pcfg)
