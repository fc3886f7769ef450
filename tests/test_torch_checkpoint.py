"""A progressive path-traced render checkpointed and resumed
(``parallel/checkpoint.py`` with ``Scene.pt_state``/``set_pt_state``):
k passes, save, load into a fresh Scene, N - k more passes equal N passes
in one run, bit for bit. Imports no JAX, so the card's case runs on a GPU
machine without it:
    python -m pytest tests/test_torch_checkpoint.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from quadray_tpu_torch import Scene
from quadray_tpu_torch.models.scenes.loader import load_scene
from quadray_tpu_torch.parallel.checkpoint import (
    load_checkpoint, save_checkpoint)

torch.set_num_threads(1)

W, H, PASSES, K = 40, 24, 3, 1


def _resume_matches_one_run(device, tmp_path):
    whole = Scene(load_scene("test18"), W, H, device=device)
    assert whole.set_pton(True)
    want = whole.render_pt_pass(PASSES)

    first = Scene(load_scene("test18"), W, H, device=device)
    first.set_pton(True)
    first.render_pt_pass(K)
    path = save_checkpoint(str(tmp_path), 7, None, None, first.pt_state())
    step, params, opt_state, pt = load_checkpoint(path, device=device,
                                                  with_pt=True)
    assert step == 7 and params == {} and opt_state is None
    assert pt["samples"] == K

    resumed = Scene(load_scene("test18"), W, H, device=device)
    resumed.set_pton(True)
    resumed.set_pt_state(pt)
    got = resumed.render_pt_pass(PASSES - K)
    assert resumed._pt_samples == whole._pt_samples == PASSES
    assert np.array_equal(got, want)
    assert torch.equal(resumed._pt_acc.view(torch.int32),
                       whole._pt_acc.view(torch.int32))
    assert torch.equal(resumed._pt_seeds, whole._pt_seeds)
    assert float(whole._pt_acc.sum()) > 0.0


def test_pt_checkpoint_resumes_bitwise(tmp_path):
    _resume_matches_one_run("cpu", tmp_path)


@pytest.mark.cuda
def test_pt_checkpoint_resumes_bitwise_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    _resume_matches_one_run("cuda", tmp_path)


def test_checkpoint_without_pt_state_loads_none(tmp_path):
    path = save_checkpoint(str(tmp_path / "a.npz"), 3, None, None)
    assert load_checkpoint(path, device="cpu", with_pt=True)[3] is None
    assert len(load_checkpoint(path, device="cpu")) == 3


def test_set_pt_state_rejects_another_frame_size():
    sc = Scene(load_scene("test18"), W, H, device="cpu")
    state = dict(acc=torch.zeros((W * H + 1, 3)),
                 seeds=torch.zeros((W * H + 1,), dtype=torch.int32),
                 samples=1)
    with pytest.raises(ValueError, match="PT state"):
        sc.set_pt_state(state)
