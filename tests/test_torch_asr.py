"""The port's ASR conditions against the JAX package on the CPU, at small
widths: the MFCC rows and the windows (numpy on both sides: bit-identical),
the frozen-graph reader and the param map (identical arrays), the
DeepSpeech net and ``extract_deepspeech_features``, the esperanto windows
of a converted wav2vec2 checkpoint, and ``StreamingASR`` on one stream.

Tolerances: float32 on both sides, the same weights; the products sum in
another order only. The DeepSpeech logits are held within 1e-5 of max |ref|
(the LSTM carries the difference across 40 steps); the wav2vec2 logits and
windows within 1e-4 absolute and relative, as the HuBERT encoder's are
(``tests/test_torch_hubert.py``); the streaming CTC text exactly.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneface_tpu.datagen import _ds_audio as j_ds_audio
from geneface_tpu.datagen import asr_features as j_asr
from geneface_tpu.datagen import deepspeech as j_ds
from geneface_tpu.datagen.streaming_asr import StreamingASR as JStreamingASR
from geneface_tpu.datagen.wav2vec2 import Wav2Vec2Config as JConfig
from geneface_tpu.datagen.wav2vec2 import Wav2Vec2CTC as JWav2Vec2
from geneface_tpu_torch.convert import deepspeech_params, deepspeech_state_dict
from geneface_tpu_torch.datagen import _ds_audio, asr_features, deepspeech
from geneface_tpu_torch.datagen.streaming_asr import CHUNK, StreamingASR
from tests.test_deepspeech import ORDER, _graph_def, _random_ds_params

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

DS_BOUND = 1e-5
W2V_TOL = dict(rtol=1e-4, atol=1e-4)
TINY_W2V = dict(vocab_size=44, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=128, conv_dim=(32, 32, 32), conv_stride=(5, 2, 2),
                conv_kernel=(10, 3, 3), conv_bias=True, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, feat_extract_norm="layer",
                do_stable_layer_norm=True)


def close(got, ref, bound=DS_BOUND):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= bound, err


def wav_of(seconds, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 3 * t))
            + 0.02 * rng.randn(len(t))).astype(np.float32)


def ds_params(seed=0, n_input=494, hidden=64, cell=32, n_classes=29):
    """The small DeepSpeech of the satellite widths: 494→64→64→64, cell 32."""
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) / np.sqrt(s[0] if len(s) > 1 else 4)).astype(np.float32)
    return {"h1": r(n_input, hidden), "b1": r(hidden), "h2": r(hidden, hidden), "b2": r(hidden),
            "h3": r(hidden, hidden), "b3": r(hidden),
            "lstm_kernel": r(hidden + cell, 4 * cell), "lstm_bias": r(4 * cell),
            "h5": r(cell, hidden), "b5": r(hidden), "h6": r(hidden, n_classes),
            "b6": r(n_classes)}


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """A GraphDef ``.pb`` of the small net under Mozilla's names, and its params."""
    p = ds_params()
    names = [(k if not k.startswith("lstm") else f"lstm_fused_cell/{k.split('_')[1]}", p[k])
             for k in ORDER]
    path = tmp_path_factory.mktemp("ds") / "output_graph.pb"
    path.write_bytes(_graph_def(names))
    return str(path), p


@pytest.fixture(scope="module")
def w2v_ckpt(tmp_path_factory):
    """A converted esperanto checkpoint at tiny widths (vocab 44): every
    leaf of the flax init perturbed, so no scale is 1 and no bias 0."""
    model = JWav2Vec2(JConfig(**TINY_W2V))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4000)))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.1 * rng.randn(*np.shape(x)).astype(np.float32),
        variables)
    path = tmp_path_factory.mktemp("w2v") / "esperanto.pkl"
    with open(path, "wb") as f:
        pickle.dump({"config": dataclasses.asdict(JConfig(**TINY_W2V)), "params": variables}, f)
    return str(path)


@pytest.mark.parametrize("seconds", [0.01, 0.8, 2.03])
def test_mfcc_windows_bit_identical(seconds):
    wav = wav_of(seconds, seed=1)
    rows, T = _ds_audio.audio_to_mfcc_windows(wav)
    jrows, jT = j_ds_audio.audio_to_mfcc_windows(wav)
    assert T == jT and rows.shape == (T, 494)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(_ds_audio.mfcc(wav * 32767.0), j_ds_audio.mfcc(wav * 32767.0))


@pytest.mark.parametrize("T,n_frames", [(0, None), (1, None), (37, None), (40, 12), (40, 31),
                                        (0, 5)])
def test_logits_to_windows_bit_identical(T, n_frames):
    logits = np.random.RandomState(T).randn(T, 29).astype(np.float32)
    got = asr_features.logits_to_windows(logits, n_frames=n_frames)
    np.testing.assert_array_equal(got, j_asr.logits_to_windows(logits, n_frames=n_frames))
    assert got.dtype == np.float32 and got.shape[1:] == (16, 29)


@pytest.mark.parametrize("use_content", [True, False], ids=["tensor_content", "float_val"])
def test_graph_reader_matches_jax(use_content):
    rng = np.random.RandomState(2)
    consts = [("a/kernel", rng.randn(3, 5).astype(np.float32)),
              ("b", rng.randn(7).astype(np.float32)),
              ("scalar", np.full((2, 2), 1.5, np.float32))]
    pb = _graph_def(consts, use_content=use_content)
    got = deepspeech.read_frozen_graph_consts(pb)
    ref = j_ds.read_frozen_graph_consts(pb)
    assert [n for n, _ in got] == [n for n, _ in ref] == [n for n, _ in consts]
    for (_, a), (_, b), (_, c) in zip(got, ref, consts):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_param_map_by_name_and_by_order_matches_jax():
    p = _random_ds_params(np.random.RandomState(1))
    named = [(k if not k.startswith("lstm") else f"lstm_fused_cell/{k.split('_')[1]}", p[k])
             for k in ORDER]
    opaque = [(f"const_{i}", p[k]) for i, k in enumerate(ORDER)]
    for consts in (named, opaque):
        got, ref = deepspeech.map_deepspeech_params(consts), j_ds.map_deepspeech_params(consts)
        assert list(got) == list(ref) and sorted(got) == sorted(ORDER)
        for k in ORDER:
            np.testing.assert_array_equal(got[k], ref[k])
    with pytest.raises(ValueError, match="LSTM kernel"):
        deepspeech.map_deepspeech_params([("x", np.zeros((3, 5), np.float32))])


def test_deepspeech_net_matches_jax(graph):
    path, p = graph
    net = deepspeech.load_deepspeech(path, "cpu")
    back = deepspeech_params(net)
    for k in ORDER:
        np.testing.assert_array_equal(back[k], p[k])
    x = np.random.RandomState(3).randn(40, 494).astype(np.float32)
    ref = np.asarray(jax.jit(j_ds.DeepSpeechNet())({k: jnp.asarray(v) for k, v in p.items()},
                                                   jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (40, 29)
    close(got, ref)
    # the reader's arrays are read-only views of the file's bytes: the
    # state dict holds writable copies
    consts = deepspeech.map_deepspeech_params(deepspeech.read_frozen_graph_consts(path))
    assert not consts["h1"].flags.writeable
    sd = deepspeech_state_dict(consts)
    sd["h1.weight"].add_(1.0)
    np.testing.assert_array_equal(consts["h1"], p["h1"])


def test_extract_deepspeech_features_matches_jax(graph, monkeypatch):
    path, _ = graph
    wav = wav_of(0.8, seed=4)
    ref = j_asr.extract_deepspeech_features(wav, n_frames=25, graph_pb=path)
    got = asr_features.extract_deepspeech_features(wav, n_frames=25, graph_pb=path,
                                                   device="cpu")
    assert got.shape == ref.shape == (25, 16, 29) and got.dtype == np.float32
    close(got, ref)
    monkeypatch.setenv("GF_DEEPSPEECH_PB", path)
    np.testing.assert_array_equal(
        asr_features.extract_deepspeech_features(wav, n_frames=25, device="cpu"), got)


def test_deepspeech_without_graph_raises(monkeypatch):
    monkeypatch.delenv("GF_DEEPSPEECH_PB", raising=False)
    wav = np.zeros(16000, np.float32)
    with pytest.raises(RuntimeError, match="frozen graph"):
        j_asr.extract_deepspeech_features(wav)
    with pytest.raises(RuntimeError, match="frozen graph"):
        asr_features.extract_deepspeech_features(wav, device="cpu")


def test_unreadable_graph_raises_value_error(tmp_path):
    """The port re-raises the mapper's ValueError (no TensorFlow fallback)."""
    pb = tmp_path / "odd.pb"
    pb.write_bytes(_graph_def([("w", np.zeros((3, 5), np.float32))]))
    with pytest.raises(ValueError, match="LSTM kernel"):
        asr_features.extract_deepspeech_features(wav_of(0.2), graph_pb=str(pb), device="cpu")


def test_extract_esperanto_features_matches_jax(w2v_ckpt, monkeypatch):
    wav = wav_of(1.0, seed=5)
    ref = j_asr.logits_to_windows(j_asr._wav2vec2_logits_flax(wav, w2v_ckpt)[:, :44],
                                  n_frames=20)
    got = asr_features.extract_esperanto_features(wav, n_frames=20, flax_ckpt=w2v_ckpt,
                                                  device="cpu")
    assert got.shape == ref.shape == (20, 16, 44) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **W2V_TOL)
    monkeypatch.setenv("GF_W2V2_ESPERANTO", w2v_ckpt)
    np.testing.assert_array_equal(
        asr_features.extract_esperanto_features(wav, n_frames=20, device="cpu"), got)
    monkeypatch.delenv("GF_W2V2_ESPERANTO")
    with pytest.raises(RuntimeError, match="GF_W2V2_ESPERANTO"):
        asr_features.extract_esperanto_features(wav, device="cpu")
    with pytest.raises(RuntimeError, match="GF_W2V2_ESPERANTO"):
        StreamingASR(wav, device="cpu")


def test_streaming_asr_matches_jax(w2v_ckpt, tmp_path):
    """One stream through both: the windows of ``run`` (the short final
    flush segment included), the ``get_next_feat`` sequence of a chunk
    iterator, and the CTC text."""
    wav = wav_of(1.0, seed=6)
    vocab = [chr(ord("a") + i % 26) for i in range(43)] + ["<blank>"]
    kw = dict(context_size=6, stride_left=2, stride_right=2, save_feats=True, vocab=vocab)
    ours = StreamingASR(wav, flax_ckpt=w2v_ckpt, device="cpu", **kw)
    theirs = JStreamingASR(wav, flax_ckpt=w2v_ckpt, **kw)
    out = str(tmp_path / "stream.npy")
    wins, ref = ours.run(out_npy=out), theirs.run()
    assert ours.terminated and wins.shape == ref.shape and wins.shape[1:] == (16, 44)
    np.testing.assert_allclose(wins, ref, **W2V_TOL)
    np.testing.assert_array_equal(np.load(out), wins)
    assert ours.text == theirs.text and len(ours.text) > len("[START]")
    assert [f.shape for f in ours.all_logits] == [f.shape for f in theirs.all_logits]

    chunks = np.split(wav[: CHUNK * 40], 40)
    ours = StreamingASR(iter(chunks), model=ours.model, **dict(kw, save_feats=False))
    theirs = JStreamingASR(iter(chunks), flax_ckpt=w2v_ckpt, **dict(kw, save_feats=False))
    for step in range(44):
        assert ours.run_step() == theirs.run_step()
        if step % 4 == 3:
            got, ref = ours.get_next_feat(), theirs.get_next_feat()
            assert got.shape == (8, 44, 16)
            np.testing.assert_allclose(got, ref, **W2V_TOL)
    assert ours.terminated and theirs.terminated and not ours.run_step()
