"""The port's HF imports against the JAX package's, on the CPU.

A random ``transformers`` model is built from a small config (no
download) and saved with ``save_pretrained``. The JAX package loads the
directory with ``transformers``; the port reads the saved state_dict
file (or the mapping) with no ``transformers`` at all. The two mappings
agree leaf by leaf, exactly (both copy f32 tensors), and the port's
forward on the imported weights agrees with the JAX one's and with the
HF model's own within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tpu.models import gpt2 as JG
from ray_tpu.models import llama as JL
from ray_tpu_torch.models import gpt2 as TG
from ray_tpu_torch.models import llama as TL

transformers = pytest.importorskip("transformers")

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _save(hf, tmp_path):
    """``save_pretrained`` as a torch file: the port reads
    ``pytorch_model.bin``, the JAX package the directory."""
    hf.save_pretrained(tmp_path, safe_serialization=False)
    return tmp_path / "pytorch_model.bin"


def _hold_equal(port_sd, ref_sd):
    assert set(port_sd) == set(ref_sd)
    for k, v in ref_sd.items():
        assert port_sd[k].dtype == torch.float32, k
        np.testing.assert_array_equal(port_sd[k].numpy(), v.numpy(), err_msg=k)


def test_import_hf_llama_matches_jax(tmp_path):
    """GQA (4 heads over 2 kv heads), untied head."""
    cfg_j = JL.LlamaConfig(vocab_size=128, max_seq_len=64, dim=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, ffn_hidden=128,
                           dtype=jnp.float32, attention_backend="reference")
    cfg_t = TL.LlamaConfig(vocab_size=128, max_seq_len=64, dim=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, ffn_hidden=128,
                           dtype=torch.float32, attention_backend="reference")
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=10000.0, rms_norm_eps=1e-5,
        attention_bias=False, tie_word_embeddings=False)).eval()
    path = _save(hf, tmp_path)
    tree = JL.import_hf_llama(str(tmp_path), cfg_j)
    ref = TL.params_from_flax(tree)
    model = TL.LlamaModel(cfg_t).eval()
    _hold_equal(TL.import_hf_llama(path, cfg_t, model), ref)
    _hold_equal(TL.import_hf_llama(str(path), cfg_t), ref)
    _hold_equal(TL.import_hf_llama(hf.state_dict(), cfg_t), ref)

    ids = np.random.default_rng(0).integers(0, 128, (2, 16))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
        theirs = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(
        got, np.asarray(JL.LlamaModel(cfg_j).apply(tree, jnp.asarray(ids))),
        **TOL)
    np.testing.assert_allclose(got, theirs, **TOL)
    with pytest.raises(KeyError, match="layers.2"):
        TL.import_hf_llama(path, TL.LlamaConfig(
            vocab_size=128, dim=64, n_layers=3, n_heads=4, n_kv_heads=2,
            ffn_hidden=128))


def test_load_hf_gpt2_params_matches_jax(tmp_path):
    """Conv1D weights [in, out] land transposed; the head stays tied."""
    cfg_j = JG.GPT2Config(vocab_size=128, n_positions=64, n_embd=64,
                          n_layer=2, n_head=4, dtype=jnp.float32,
                          attention_backend="reference")
    cfg_t = TG.GPT2Config(vocab_size=128, n_positions=64, n_embd=64,
                          n_layer=2, n_head=4, dtype=torch.float32,
                          attention_backend="reference")
    torch.manual_seed(0)
    # flax's LayerNorm eps (1e-6) so that the HF model computes the same
    # function
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        layer_norm_epsilon=1e-6)).eval()
    path = _save(hf, tmp_path)
    tree = JG.load_hf_gpt2_params(str(tmp_path), cfg_j)
    ref = TG.params_from_flax(tree)
    model = TG.GPT2(cfg_t).eval()
    _hold_equal(TG.load_hf_gpt2_params(path, cfg_t, model), ref)
    _hold_equal(TG.load_hf_gpt2_params(hf.state_dict(), cfg_t), ref)

    ids = np.random.default_rng(1).integers(0, 128, (2, 16))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
        theirs = hf(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(
        got, np.asarray(JG.GPT2(cfg_j).apply(tree, jnp.asarray(ids))), **TOL)
    np.testing.assert_allclose(got, theirs, **TOL)
