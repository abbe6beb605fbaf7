"""The port's HuBERT encoder (``geneface_tpu_torch/datagen/wav2vec2.py``) and
``extract_hubert`` against the JAX package on the CPU, at a tiny size.

Tolerance: float32 on both sides, the same weights (every leaf perturbed
from the flax init so that no scale is 1 and no bias 0); sums in another
order only: hidden states to 1e-4 absolute and relative.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.datagen.wav2vec2 import Wav2Vec2Config as JConfig
from geneface_tpu.datagen.wav2vec2 import Wav2Vec2CTC as JWav2Vec2
from geneface_tpu.utils.audio import extract_hubert as jextract_hubert
from geneface_tpu_torch.convert import flax_variables, load_flax_variables
from geneface_tpu_torch.datagen.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC
from geneface_tpu_torch.utils.audio import extract_hubert

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

TINY = dict(
    vocab_size=0, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
    intermediate_size=128, conv_dim=(32, 32, 32), conv_stride=(5, 2, 2),
    conv_kernel=(10, 3, 3), conv_bias=True, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4,
)
VARIANTS = {"layer_stable": dict(feat_extract_norm="layer", do_stable_layer_norm=True),
            "group_post_ln": dict(feat_extract_norm="group", do_stable_layer_norm=False)}


def perturbed(variables, seed=0, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + scale * rng.randn(*np.shape(x)).astype(np.float32),
        variables)


def jax_model(variant):
    cfg = {**TINY, **VARIANTS[variant]}
    model = JWav2Vec2(JConfig(**cfg))
    variables = perturbed(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000))))
    return cfg, model, variables


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hidden_states_match_jax(variant):
    cfg, jmodel, variables = jax_model(variant)
    model = load_flax_variables(Wav2Vec2CTC(Wav2Vec2Config(**cfg)), variables).eval()
    wav = np.random.RandomState(1).randn(2, 4000).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(wav)))
    with torch.no_grad():
        ours = model(torch.from_numpy(wav)).numpy()
    assert ours.shape == ref.shape == (2, 199, 64)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    # the converter's inverse gives back the flax tree
    back = flax_variables(model)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_extract_hubert_matches_jax(tmp_path, monkeypatch):
    cfg, _, variables = jax_model("layer_stable")
    path = tmp_path / "hubert.pkl"
    with open(path, "wb") as f:
        pickle.dump({"config": dataclasses.asdict(JConfig(**cfg)), "params": variables}, f)
    monkeypatch.setenv("GF_HUBERT_CKPT", str(path))
    wav = (0.3 * np.random.RandomState(2).randn(4000)).astype(np.float32)
    ref = jextract_hubert(wav)
    ours = extract_hubert(wav, device="cpu")
    assert ours.shape == ref.shape == (398, 64) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[0::2], ours[1::2])  # each row twice
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    monkeypatch.setenv("GF_HUBERT_CKPT", str(tmp_path / "absent.pkl"))
    assert extract_hubert(wav, device="cpu") is None
