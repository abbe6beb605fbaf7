"""The port's datagen networks — BiSeNet (``datagen/face_parser.py``), FAN
(``datagen/face_landmarker.py``) and ReconNet (``datagen/face_recon.py``) —
against the JAX package's on the CPU at seeded weights, with their host
helpers and the two OpenCV/Pillow-free resizes.

Weights: every leaf of the port's model drawn from a seeded generator
(``init_weights_``: BatchNorm scales and running statistics away from 1
and 0), carried to the flax layout by ``convert.flax_variables``; the flax
modules apply that tree, so a name or layout the two sides disagree on
fails the apply. Outputs held to 1e-5 of max |ref| (float32 convolutions
in another order on each side; measured ≤ 1.1e-6 on all three).

The resizes are held bit for bit against OpenCV's ``INTER_LINEAR`` and
Pillow's ``BICUBIC`` (+ crop) on random sizes.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_datagen_helpers import max_rel

from geneface_tpu.datagen import face_landmarker as JL
from geneface_tpu.datagen import face_parser as JP
from geneface_tpu.datagen import face_recon as JR
from geneface_tpu_torch.convert import flax_variables
from geneface_tpu_torch.datagen import face_landmarker as PL
from geneface_tpu_torch.datagen import face_parser as PP
from geneface_tpu_torch.datagen import face_recon as PR
from geneface_tpu_torch.datagen.resize import resize_bilinear_u8, resize_crop_bicubic_u8
from geneface_tpu_torch.models.layers import init_weights_

# one intra-op thread: the suite runs in parallel workers, where torch's
# default of one thread per core oversubscribes the host
torch.set_num_threads(1)

TOL = 1e-5


def _seeded(model, seed):
    return init_weights_(model, torch.Generator().manual_seed(seed)).eval()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


NETS = {
    # name: (port model, flax module, input side, seed)
    "bisenet": (lambda: PP.BiSeNet(), lambda: JP.BiSeNet(), 64, 0),
    "fan": (lambda: PL.FAN(num_modules=2), lambda: JL.FAN(num_modules=2), 64, 1),
    "recon": (lambda: PR.ReconNet(), lambda: JR.ReconNet(), 64, 2),
}


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name, (port, flax_mod, side, seed) in NETS.items():
        model = _seeded(port(), seed)
        variables = flax_variables(model)
        x = np.random.RandomState(seed).rand(2, side, side, 3).astype(np.float32)
        jmod = flax_mod()
        apply = jax.jit(lambda v, x, m=jmod: m.apply(v, x))
        out[name] = {"model": model, "variables": variables, "x": x, "jmod": jmod,
                     "ref": np.asarray(apply(variables, jnp.asarray(x)))}
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_network_matches_jax_at_seeded_weights(nets, name):
    n = nets[name]
    with torch.no_grad():
        got = n["model"](torch.as_tensor(n["x"])).numpy()
    assert got.shape == n["ref"].shape
    assert np.isfinite(got).all() and float(np.abs(n["ref"]).max()) > 0
    assert max_rel(got, n["ref"]) <= TOL, name


@pytest.mark.parametrize("name", sorted(NETS))
def test_variable_tree_is_the_flax_one(nets, name):
    """The converted tree has exactly the flax module's leaves and shapes
    (``jax.eval_shape`` of its init: no eager flax init)."""
    n = nets[name]
    shapes = jax.eval_shape(n["jmod"].init, jax.random.PRNGKey(0), jnp.asarray(n["x"][:1]))
    want = {k: tuple(s.shape) for k, s in _flat_shapes(shapes).items()}
    got = {k: v.shape for k, v in _flat(n["variables"]).items()}
    assert got == want


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat_shapes(v, key) if hasattr(v, "items") else {key: v})
    return out


def test_loaders_read_the_jax_layout(nets, tmp_path, monkeypatch):
    """``load_parser_npz`` and ``FANLandmarker.from_npz`` read a flattened
    ``params/…``/``batch_stats/…`` ``.npz``; ``Reconstructor.from_npz`` the
    pickled tree of ``tools/convert_deep3drecon.py``."""
    p = tmp_path / "bisenet.npz"
    np.savez(p, **_flat(nets["bisenet"]["variables"]))
    parser = PP.load_parser_npz(str(p), device="cpu")
    for a, b in zip(parser.state_dict().values(), nets["bisenet"]["model"].state_dict().values()):
        assert torch.equal(a, b)

    # FANLandmarker builds the 4-module FAN; 2 modules keep the file small
    monkeypatch.setattr(PL, "FAN", functools.partial(PL.FAN, num_modules=2))
    p = tmp_path / "fan.npz"
    np.savez(p, **_flat(nets["fan"]["variables"]))
    fan = PL.FANLandmarker.from_npz(str(p), device="cpu")
    for a, b in zip(fan.model.state_dict().values(), nets["fan"]["model"].state_dict().values()):
        assert torch.equal(a, b)

    p = tmp_path / "recon.npz"
    blob = pickle.dumps(nets["recon"]["variables"])
    np.savez(p, params=np.frombuffer(blob, np.uint8))  # the tool compresses; same layout
    recon = PR.Reconstructor.from_npz(str(p), device="cpu")
    for a, b in zip(recon.net.state_dict().values(), nets["recon"]["model"].state_dict().values()):
        assert torch.equal(a, b)


def test_parse_frame_matches_jax(nets):
    frame = np.random.RandomState(4).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    ref = JP.parse_frame(nets["bisenet"]["jmod"], nets["bisenet"]["variables"], frame)
    logits = PP.parse_logits(nets["bisenet"]["model"], frame[None])[0].numpy()
    got = PP.parse_frame(nets["bisenet"]["model"], frame)
    assert got.shape == ref.shape == (64, 64)
    # a pixel may only differ where its top two logits are within the bound
    top2 = np.sort(logits, -1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 2 * TOL * np.abs(logits).max()
    assert ((got == ref) | near_tie).all()


def test_collapse_to_regions():
    labels = np.arange(19).reshape(1, 19).repeat(2, 0)
    np.testing.assert_array_equal(PP.collapse_to_regions(labels), JP.collapse_to_regions(labels))


def test_decode_heatmaps_and_head_crop():
    rng = np.random.RandomState(5)
    hm = rng.rand(68, 16, 16).astype(np.float32)
    hm[:, 0, 0] = 2.0  # a corner peak: no neighbour shift
    hm[3] = 0.0  # a tie: the first maximum
    np.testing.assert_array_equal(PL.decode_heatmaps(hm), JL.decode_heatmaps(hm))
    for mask in (np.zeros((40, 60), int), np.pad(np.ones((10, 14), int), ((5, 25), (30, 16)))):
        assert PL.head_crop_from_mask(mask) == JL.head_crop_from_mask(mask)


def test_landmarker_matches_jax(nets):
    """``FANLandmarker`` end to end (crop, resize, FAN, decode) at
    2 modules on a 96² frame with a head mask."""
    rng = np.random.RandomState(6)
    frame = rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)
    mask = np.zeros((96, 96), int)
    mask[20:70, 30:75] = 1
    n = nets["fan"]
    jl = JL.FANLandmarker(n["variables"])
    jl.model = n["jmod"]
    ref = jl(frame, mask)
    pl = PL.FANLandmarker(n["model"], device="cpu")
    crop, x0, y0, side = pl.crop(frame, mask)
    hm = pl.heatmaps(crop[None])[0].numpy()
    jhm = np.asarray(jl._apply(n["variables"], crop[None].astype(np.float32) / 255.0))[0]
    assert max_rel(hm, jhm) <= TOL
    got = pl(frame, mask)
    assert got.shape == (68, 2)
    # the heatmaps' peaks and their neighbours' order are the same here
    np.testing.assert_array_equal(got, ref)


def test_extract_5p_pos_and_align_img():
    rng = np.random.RandomState(7)
    lm = rng.rand(68, 2) * 60 + 34
    np.testing.assert_array_equal(PR.extract_5p(lm), JR.extract_5p(lm))
    xp, x = rng.rand(2, 5), rng.rand(3, 5)
    for a, b in zip(PR.POS(xp, x), JR.POS(xp, x)):
        np.testing.assert_array_equal(a, b)
    img = rng.randint(0, 256, (128, 128, 3)).astype(np.uint8)
    lm_up = lm.copy()
    lm_up[:, 1] = 127 - lm_up[:, 1]
    got = PR.align_img(img, lm_up, PR._DEFAULT_LM3D_STD)
    ref = JR.align_img(img, lm_up, JR._DEFAULT_LM3D_STD)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])  # Pillow's bicubic, bit for bit
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=0)


def test_reconstructor_matches_jax(nets):
    rng = np.random.RandomState(8)
    imgs = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    lms = rng.rand(2, 68, 2) * 40 + 44
    n = nets["recon"]
    jr = JR.Reconstructor(params=n["variables"])
    pr = PR.Reconstructor(net=n["model"], device="cpu")
    ref, ref_img = jr.recon_coeff(imgs, lms)
    got, got_img = pr.recon_coeff(imgs, lms)
    np.testing.assert_array_equal(got_img, ref_img)
    assert got.shape == (2, 257) and max_rel(got, ref) <= TOL
    split = PR.split_coeff(got)
    assert [v.shape[-1] for v in split.values()] == [80, 64, 80, 3, 27, 3]


@pytest.mark.parametrize("seed", range(3))
def test_resizes_match_opencv_and_pillow_bit_for_bit(seed):
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    rng = np.random.RandomState(seed)
    for _ in range(8):
        h, w = (int(v) for v in rng.randint(16, 700, 2))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ref = cv2.resize(img, (256, 256), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(resize_bilinear_u8(img, (256, 256)), ref)
        ow, oh = (int(v) for v in rng.randint(40, 800, 2))
        left, up = (int(v) for v in rng.randint(-60, 400, 2))
        box = (left, up, left + 224, up + 224)
        ref = np.asarray(Image.fromarray(img).resize((ow, oh), resample=Image.BICUBIC).crop(box))
        np.testing.assert_array_equal(resize_crop_bicubic_u8(img, (ow, oh), box), ref)
    # exact halving, where OpenCV takes its area path
    img = rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        resize_bilinear_u8(img, (256, 256)),
        cv2.resize(img, (256, 256), interpolation=cv2.INTER_LINEAR))
