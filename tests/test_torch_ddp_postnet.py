"""The post-net's GAN step (``PostnetAdvSyncTask``: the generator with its
person MSE, ``reg``, ``continuity``, adversarial and SyncNet terms, then the
discriminator) split over two gloo ranks on the CPU
(``tests/torch_ddp_helpers.py``) against the same steps on one rank, on
the synthetic LRS3 store of ``tests/test_torch_postnet_train.py`` and its
config, plain and pitch.

One step on an LRS3 batch whose clip count is even, so that its clips
split over the ranks (the masked losses divided by the global mask sums,
the SyncNet clips mined from the gathered refinement), and one on a batch
whose count is odd, which stays whole on every rank; a person batch of
either count. Tolerances: the step's losses within rel 1e-5 of one rank
(the masked sums are regrouped), every generator and discriminator
gradient within relative L2 1e-5, the two ranks' gradients equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from geneface_tpu_torch.data.lrs3_dataset import LRS3SeqDataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch_ddp_helpers as ddp  # noqa: E402
from test_torch_postnet_train import PITCH_CLS, _cfg  # noqa: E402
from tools.make_synthetic_lrs3 import make_lrs3  # noqa: E402

torch.set_num_threads(1)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("pitch", [False, True], ids=["plain", "pitch"])
def test_two_rank_gan_steps_match_one_rank(tmp_path, pitch):
    store = make_lrs3(str(tmp_path / "lrs3"), n_train=8, n_val=2)
    cfg = _cfg(store, pitch, max_tokens=1500)
    assert ("audio2motion_task_cls" in cfg) == pitch and (not pitch or cfg[
        "audio2motion_task_cls"] == PITCH_CLS)
    ds = LRS3SeqDataset("train", store, max_tokens=cfg["max_tokens"])
    first = list(zip(ds.iter_batches(seed=0), range(12)))
    even = [b for b, _ in first if len(b["y"]) % 2 == 0 and len(b["y"]) > 2]
    assert even
    B = len(even[0]["y"])
    odd = [{k: v[:B - 1] if hasattr(v, "shape") and v.shape[:1] == (B,) else v
            for k, v in even[0].items()}]  # one clip fewer: an odd count
    # one step each (RMSprop's first step turns last-bit differences of a
    # gradient into up to lr·1e4 of them, see test_torch_postnet_train.py,
    # so later steps start from other parameters)
    cases = {"split": dict(kind="postnet", cfg=cfg, batches=even[:1]),
             "whole": dict(kind="postnet", cfg=cfg, batches=odd[:1])}
    ranks = ddp.run_ranks("steps", {"cases": cases}, 2, str(tmp_path / "ranks"))
    for name, case in cases.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        one = ddp.step_result(**case)
        assert len(one["grads"]) == 2  # the generator's, then the discriminator's
        for k in ("total_loss", "mse", "adv", "sync", "reg", "continuity", "disc_fake_loss",
                  "disc_true_loss"):
            np.testing.assert_allclose(r0["losses"][0][k], one["losses"][0][k], rtol=1e-5,
                                       err_msg=f"{name}: {k}")
        for s, (g1, g2) in enumerate(zip(one["grads"], r0["grads"])):
            assert set(g1) == set(g2) and g1
            for p, g in g1.items():
                assert rel_l2(g2[p], g) <= 1e-5, (name, s, p, rel_l2(g2[p], g))
                np.testing.assert_array_equal(r1["grads"][s][p], g2[p])


def test_two_rank_gan_losses_match_jax_mesh(tmp_path):
    """The generator's and the discriminator's losses and gradients on two
    ranks against the JAX task's jitted ``gen_step``/``disc_step`` with the
    batches sharded over ``make_mesh(devices=jax.devices()[:2])`` (the
    task's ``_dev``), at ``make_pair``'s parameters and the same prior
    noise, clips and refinement, ``adv_on`` 0: the bounds of
    ``test_torch_postnet_train.py`` (losses rtol 1e-4, gradients relative
    L2 1e-4); and against the same function on one rank, loss rel 1e-5 and
    gradients 1e-5."""
    import jax
    import jax.numpy as jnp

    from geneface_tpu.parallel import make_mesh as jmake_mesh
    from geneface_tpu.tasks.syncnet import mine_sync_clips
    from geneface_tpu_torch.convert import flax_param_tree, flax_variables
    from test_torch_postnet_train import make_pair
    from torch_audio_helpers import flat

    store = make_lrs3(str(tmp_path / "lrs3"), n_train=8, n_val=2)
    jt, t, state, _ = make_pair(store, pitch=False)
    batches = jt.train_ds.iter_batches(seed=0)
    lrs3, person = next(batches), next(batches)
    assert len(lrs3["y"]) % 2 == 0 and len(person["y"]) % 2 == 0  # both split
    idx = mine_sync_clips(lrs3["y_mask"].sum(-1).astype(int), 8, np.random.RandomState(0),
                          infer=True)[:4]
    rng = jax.random.PRNGKey(11)
    jt.mesh = jmake_mesh(devices=jax.devices()[:2])
    jl, jp = jt._dev(lrs3), jt._dev(person)
    assert len(jl["y"].sharding.device_set) == 2
    gen0 = jax.tree_util.tree_map(jnp.asarray, state["gen_params"])
    disc0 = jax.tree_util.tree_map(jnp.asarray, state["disc_params"])
    _, jgen, jlosses, jpred = jt._gen_step_fn(gen0, disc0, jt.gen_tx.init(gen0), jl, jp,
                                              tuple(map(jnp.asarray, idx)), rng, jnp.float32(0))
    _, jdisc, jdl = jt._disc_step_fn(disc0, jt.disc_tx.init(disc0), jpred, jp["y"],
                                     jp["y_mask"])
    k1, k2 = jax.random.split(rng)
    noises = tuple(np.asarray(jax.random.normal(k, t.vae.noise_shape(*b["y_mask"].shape)))
                   for k, b in ((k1, lrs3), (k2, person)))
    keys = ("hubert", "y", "y_mask")
    case = dict(fn="postnet", cfg=t.cfg,
                variables={"model": jax.tree_util.tree_map(np.asarray, state["gen_params"]),
                           "disc": jax.tree_util.tree_map(np.asarray, state["disc_params"]),
                           "vae": flax_variables(t.vae)},
                lrs3={k: lrs3[k] for k in keys}, person={k: person[k] for k in keys},
                clip_idx=idx, noises=noises, adv_on=0.0, fake=np.asarray(jpred))
    two = ddp.run_ranks("steps", {"cases": {"gan": dict(case)}}, 2, str(tmp_path / "ranks"))
    two = two[0]["gan"]
    case.pop("fn")
    one = ddp.postnet_grads(**case)
    for k, v in {**jlosses, **jdl}.items():
        np.testing.assert_allclose(two["losses"][k], float(v), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(two["losses"][k], one["losses"][k], rtol=1e-5, err_msg=k)
    for name, model, jg in (("gen", t.model, jgen["g"]), ("disc", t.disc, jdisc["g"])):
        want = flat(jax.tree_util.tree_map(np.asarray, jg))
        got = flat(flax_param_tree(model, {n: torch.as_tensor(g)
                                           for n, g in two[name].items()}))
        assert set(got) == set(want)
        for k in want:
            assert rel_l2(got[k], want[k]) <= 1e-4, (name, k, rel_l2(got[k], want[k]))
        for n, g in one[name].items():
            assert rel_l2(two[name][n], g) <= 1e-5, (name, n)
