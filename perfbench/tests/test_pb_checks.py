"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a tiny size: sound runs pass, the lower-precision control
(the program's bfloat16 grids) fails, and so does each fault a cell can
have, planted in the timed path: a step that returns its state unchanged,
half of the batch left out of the mean, a frame altered where it is
produced. (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

from conftest import TINY, TINY_LIMITS

SEED = 2**31 + 11


def _run(harness, cell, patch=None, control=False, seconds=0.6):
    spec = dict(harness.cell_spec(cell), limits=TINY_LIMITS[cell])
    return harness.run_cell(spec, SEED, seconds, False, control=control,
                            device="cpu", patch=patch, config_over=TINY)


def _failed(res):
    return [c["name"] for c in res["checks"] if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", ["head_train", "head_video", "torso_train", "torso_live"])
def test_sound_run_is_correct(harness, cell):
    res = _run(harness, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", ["head_train", "head_video", "torso_train", "torso_live"])
def test_lower_precision_control_fails(harness, cell):
    res = _run(harness, cell, control=True)
    assert not res["correct"]


def _frame_altered(cell):
    """One pixel of each rendered frame is altered where the frame is made."""
    infer = cell.infer
    real = infer.render_rays

    def render(*a, **kw):
        out = real(*a, **kw)
        out["rgb_map"][0] = 1.0 - out["rgb_map"][0]
        return out

    infer.render_rays = render


@pytest.mark.parametrize("cell, fault", [
    ("head_train", "state_unchanged"), ("head_train", "half_batch"),
    ("torso_train", "state_unchanged"), ("torso_train", "half_batch"),
])
def test_training_faults_fail(harness, cell, fault):
    """The check follows set-up's first steps, so the faults are planted
    before set-up, through the program's classes: the optimizer's step
    leaves the state unchanged, or each step takes the first half of its
    batch's rays and means its loss over them."""
    from geneface_tpu_torch.tasks.radnerf import RADNeRFTask
    from geneface_tpu_torch.tasks.radnerf_torso import RADNeRFTorsoTask
    from geneface_tpu_torch.training.optim import MultiGroupAdam

    hit = {}
    if fault == "state_unchanged":
        owner, name = MultiGroupAdam, "step"
        orig = MultiGroupAdam.step

        def planted(self, closure=None):
            hit["n"] = 1
    else:
        owner = RADNeRFTorsoTask if cell == "torso_train" else RADNeRFTask
        name, orig = "loss_fn", owner.loss_fn

        def planted(self, batch, noises, train, *a, **kw):
            n = batch["inds"].shape[0] // 2
            hit["n"] = 1
            half = {k: (v[:n] if torch.is_tensor(v) and v.ndim and v.shape[0] == 2 * n else v)
                    for k, v in batch.items()}
            return orig(self, half, None if noises is None else noises[:n], train, *a, **kw)

    setattr(owner, name, planted)
    try:
        res = _run(harness, cell)
    finally:
        setattr(owner, name, orig)
    assert hit and not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["head_train", "torso_train"])
def test_a_fault_that_starts_with_the_window_fails(harness, cell):
    """The optimizer's step leaves the state unchanged from the window's
    first step on, after set-up's steps were sound: the window's steps
    catch it."""
    def patch(c):
        c.task.optimizer.step = lambda closure=None: None

    res = _run(harness, cell, patch=patch)
    failed = _failed(res)
    assert "window_change_leaf_gap" in failed, res["checks"]
    assert all(n.startswith("window_") for n in failed), res["checks"]


def test_a_moved_frozen_head_fails(harness):
    """The torso run moves one leaf of the frozen head in the window."""
    def patch(c):
        real = c.task.train_step
        head = next(p for n, p in c.task.model.named_parameters() if n.startswith("sigma_net"))

        def step(batch):
            out = real(batch)
            with torch.no_grad():
                head.view(-1)[0] += 1e-6
            return out

        c.task.train_step = step

    res = _run(harness, "torso_train", patch=patch)
    assert _failed(res) == ["head_frozen_gap"], res["checks"]


@pytest.mark.parametrize("cell", ["head_video", "torso_live"])
def test_altered_frame_fails(harness, cell):
    res = _run(harness, cell, patch=_frame_altered)
    assert _failed(res) == ["frame_rgb_gap"]


@pytest.mark.parametrize("cell", ["head_video", "torso_live"])
def test_altered_delivered_frame_fails(harness, cell):
    """The uint8 frame a user gets departs from the frame rendered."""
    def patch(c):
        from geneface_tpu_torch.inference import radnerf_infer

        if cell == "head_video":
            real = radnerf_infer._to_u8
            radnerf_infer._to_u8 = lambda rgb: real(rgb) ^ 1
            c.restore = lambda: setattr(radnerf_infer, "_to_u8", real)
        else:
            real = c.renderer.render
            c.renderer.render = lambda cam, conds=None: real(cam, conds) ^ 1

    res = _run(harness, cell, patch=patch)
    if cell == "head_video":
        from geneface_tpu_torch.inference import radnerf_infer

        radnerf_infer._to_u8 = radnerf_infer._to_u8.__closure__[0].cell_contents
    assert _failed(res) == ["frame_u8_exact"]


def test_a_number_without_a_limit_is_read_not_compared(harness):
    spec = dict(harness.cell_spec("torso_train"))
    spec["limits"] = {k: v for k, v in TINY_LIMITS["torso_train"].items() if k != "loss_rel_gap"}
    res = harness.run_cell(spec, SEED, 0.5, False, device="cpu", config_over=TINY)
    assert [c["name"] for c in res["readings"]] == ["loss_rel_gap"]
    assert "loss_rel_gap" not in [c["name"] for c in res["checks"]]


def test_the_command_line_gives_no_result_without_a_card(harness, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "head_video", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "no result" in out.err


@pytest.mark.cuda
def test_a_cell_on_the_card(harness, card):
    """On the card: the video cell is correct, its control is not."""
    spec = harness.cell_spec("head_video")
    assert harness.run_cell(spec, SEED, 2.0, False)["correct"]
    assert not harness.run_cell(spec, SEED, 2.0, False, control=True)["correct"]
