"""The port's training driver, ``run_training``, on the CPU: the loss
falls (as the reference's ``test_train_integration.py`` asks of its own
loop), compressed training converges, a run resumed from its checkpoint
repeats the uninterrupted run's losses bit for bit, a depth-cut
``ModelConfig`` trains, the CLI runs, and without a card the default
device raises."""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as port_train
from repro_torch.launch.train import run_training
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_loss_decreases_smoke():
    out = run_training("qwen3-14b", steps=30, batch=4, seq=64, lr=1e-3,
                       log_every=1000, device="cpu")
    assert out["final_loss"] < out["first_loss"] - 0.2
    assert len(out["losses"]) == len(out["step_s"]) == 30
    assert out["peak_device_bytes"] is None       # no card: not measured
    assert all(np.isfinite(out["losses"]))


def test_compressed_training_converges():
    ref = run_training("mamba2-370m", steps=25, batch=4, seq=64, lr=1e-3,
                       log_every=1000, device="cpu")
    cmp = run_training("mamba2-370m", steps=25, batch=4, seq=64, lr=1e-3,
                       compress=True, log_every=1000, device="cpu")
    assert cmp["final_loss"] < cmp["first_loss"] - 0.1
    assert cmp["final_loss"] < ref["final_loss"] + 0.5


def test_resumed_run_repeats_the_uninterrupted_losses(tmp_path):
    """A 20-step run checkpoints at 5, 10, 15 and 20 (keeping the last
    3); with 15 and 20 deleted — a crash after step 10's save — a second
    run resumes at 10 and its 10 losses equal the first run's last 10."""
    kw = dict(steps=20, batch=4, seq=32, ckpt_every=5, log_every=1000,
              device="cpu")
    whole = run_training("zamba2-2.7b", ckpt_dir=str(tmp_path), **kw)
    for step in (15, 20):
        shutil.rmtree(tmp_path / f"step_{step:09d}")
    resumed = run_training("zamba2-2.7b", ckpt_dir=str(tmp_path), **kw)
    assert len(resumed["losses"]) == 10
    assert resumed["losses"] == whole["losses"][10:]
    for (name, a), b in zip(whole["params"].named_parameters(),
                            resumed["params"].parameters()):
        assert torch.equal(a, b), name
    assert resumed["final_loss"] < whole["first_loss"]


def test_a_depth_cut_config_trains():
    cfg = dataclasses.replace(get_config("qwen2-vl-72b"), num_layers=1,
                              d_model=64, num_heads=4, num_kv_heads=2,
                              head_dim=16, d_ff=96, vocab_size=300,
                              m_rope_sections=(2, 3, 3))
    out = run_training(cfg, steps=3, batch=2, seq=16, log_every=1000,
                       microbatches=2, device="cpu")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["params"]["layers"][0]["attn"]["wq"].shape == (64, 64)


def test_cli_runs_the_smoke_config(capsys):
    port_train.main(["--arch", "mamba2-370m", "--device", "cpu",
                     "--steps", "3", "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert out.startswith("[train] mamba2-smoke")
    assert "[train] done: loss" in out


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("mamba2-370m", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(DataConfig(vocab_size=10, seq_len=4, global_batch=1), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_opt_state({"w": torch.zeros(2)}, AdamWConfig())
