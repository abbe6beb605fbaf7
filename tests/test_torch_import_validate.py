"""The user's path for a GeneFace checkpoint on a 64² scene:
``python -m geneface_tpu_torch.tools.validate_import`` against the JAX tool
(``tools/validate_import.py``) on the same authored checkpoint, and the
fine-tune of the imported checkpoint through ``tasks.run`` under
``egs/datasets/videos/May/lm3d_radnerf_import.yaml``.
"""

import json
import os

import numpy as np
import pytest
import yaml
from torch_import_scene import REPO, STEP, make_scene

from geneface_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_scene(tmp_path_factory.mktemp("torch_import_validate"), 64)


def test_validate_import_report_matches_jax_tool(scene, tmp_path):
    """``python -m geneface_tpu_torch.tools.validate_import`` on the authored
    checkpoint: the JAX tool's report (PASS against its own frames, the
    same PSNRs against the dataset), then FAIL against corrupted frames."""
    from geneface_tpu_torch.tools.validate_import import main
    from tools.validate_import import validate as jvalidate

    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({k: v for k, v in scene["cfg"].items() if k not in ("data_dir", "work_dir")},
                       f)
    golden = str(tmp_path / "golden")
    want = jvalidate(scene["src"], scene["data"], cfg_path, frames=2,
                     out=str(tmp_path / "jax.json"), dump_frames=golden)
    out = str(tmp_path / "port.json")
    rc = main(["--ckpt", scene["src"], "--data_dir", scene["data"], "--config", cfg_path,
               "--frames", "2", "--golden", golden, "--out", out, "--device", "cpu"])
    got = json.load(open(out))
    assert rc == 0 and got["pass"] and got["torso"] and got["grid_backend"] == "block"
    assert [f["index"] for f in got["frames"]] == [f["index"] for f in want["frames"]]
    for g, w in zip(got["frames"], want["frames"]):
        assert g["finite"] and g["psnr_vs_gt"] == w["psnr_vs_gt"]
        assert g["psnr_vs_golden"] > 60
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    for name in os.listdir(golden):
        g = np.load(os.path.join(golden, name))
        np.save(os.path.join(bad, name),
                np.clip(g + 0.25 * np.random.RandomState(0).rand(*g.shape), 0, 1))
    assert main(["--ckpt", scene["src"], "--data_dir", scene["data"], "--config", cfg_path,
                 "--frames", "2", "--golden", bad, "--out", out, "--device", "cpu"]) == 1
    assert json.load(open(out))["min_psnr_vs_golden"] < 30


def test_run_cli_fine_tunes_the_imported_checkpoint(scene, tmp_path):
    """``tools.import_checkpoint`` (the head of the torso checkpoint), then
    ``tasks.run`` under the import config resumes at the checkpoint's step
    with a fresh optimizer and trains two steps."""
    from geneface_tpu_torch.tasks.run import main
    from geneface_tpu_torch.tools.import_checkpoint import main as import_main

    work = str(tmp_path / "exp")
    cfg = dict(scene["cfg"], max_updates=STEP + 2, val_check_interval=2, tb_log_interval=1,
               num_sanity_val_steps=0, eval_max_batches=1, val_render_frame=False)
    del cfg["work_dir"]
    cfg["base_config"] = [os.path.join(REPO, "egs/datasets/videos/May/lm3d_radnerf_import.yaml")]
    path = tmp_path / "import.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert import_main(["--ckpt", scene["src"], "--config", str(path), "--out", work,
                        "--head_only"]) == 0
    imported = load_checkpoint(get_last_checkpoint(work))
    assert "torso_occ" not in imported["state"] and imported["step"] == STEP
    assert main(["--config", str(path), "--exp_name", work, "--device", "cpu"]) == STEP + 2
    ck = load_checkpoint(get_last_checkpoint(work))
    assert ck["step"] == STEP + 2 and int(ck["state"]["opt_state"]["count"]) == 2
    moved = ck["state"]["params"]["params"]["pos_embeddings"]
    assert not np.array_equal(moved, imported["state"]["params"]["params"]["pos_embeddings"])
