"""The stage-1 training command line of the port on the CPU at tiny
widths: a run writes metrics, TensorBoard events, image grids, checkpoints
and an exported checkpoint that the inference command line loads; a
resumed run continues to the same state as one that was never stopped;
the flags the port does not offer are refused. Stage 2's command line is
tested in ``test_torch_stage2_cli.py``."""
import json
import os

import numpy as np
import pytest
import torch

from mgldvsr_tpu_torch.cli import infer as infer_cli
from mgldvsr_tpu_torch.cli import train as cli
from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager
from mgldvsr_tpu_torch.io.frames import read_frame, write_frame

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gt")
    rs = np.random.RandomState(0)
    for clip in ("001", "002"):
        os.makedirs(root / clip)
        for i in range(6):
            write_frame(str(root / clip / f"{i:08d}.png"),
                        (rs.rand(40, 48, 3) * 255).astype(np.uint8))
    return str(root)


def _argv(data_root, logdir, steps, *extra):
    return ["--stage", "1", "--data-root", data_root, "--tiny", "--device", "cpu",
            "--max-steps", str(steps), "--grad-accum", "2", "--ckpt-every", "2",
            "--log-every", "1", "--image-every", "2", "--logdir",
            str(logdir), *extra]


def test_run_writes_everything_and_resumes(data_root, tmp_path, capsys):
    logdir = tmp_path / "run"
    cli.main(_argv(data_root, logdir, 4, "--sample-rows"))
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in records)
    assert any(f.startswith("events.out.tfevents.") for f in os.listdir(logdir / "tb"))
    images = set(os.listdir(logdir / "images" / "train"))
    for key in ("lq", "gt", "inputs", "reconstruction", "samples", "denoise_row"):
        assert f"{key}_step00000004.png" in images
    assert read_frame(str(logdir / "images" / "train" / "gt_step00000004.png")).shape[2] == 3
    assert CheckpointManager(str(logdir / "ckpt")).all_steps() == [2, 4]
    assert {"mgld_ema.pt", "raft.pt"} <= set(os.listdir(logdir / "export"))

    cli.main(_argv(data_root, logdir, 6, "--resume"))
    assert "resumed at step 4" in capsys.readouterr().out
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5, 6]
    assert CheckpointManager(str(logdir / "ckpt")).all_steps() == [2, 4, 6]


def test_resumed_run_equals_an_uninterrupted_one(data_root, tmp_path):
    """Four steps straight, against two and a resume for two more: the same
    data stream and draws, so the same state to the bit."""
    cli.main(_argv(data_root, tmp_path / "a", 4, "--no-tb"))
    cli.main(_argv(data_root, tmp_path / "b", 2, "--no-tb"))
    cli.main(_argv(data_root, tmp_path / "b", 4, "--no-tb", "--resume"))
    a = CheckpointManager(str(tmp_path / "a" / "ckpt")).restore(4)
    b = CheckpointManager(str(tmp_path / "b" / "ckpt")).restore(4)
    assert a["step"] == b["step"] == 4
    for part in ("trainable", "ema"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    for part in ("mu", "nu"):
        assert all(torch.equal(a["opt_state"][part][k], b["opt_state"][part][k])
                   for k in a["opt_state"][part])


def test_exported_checkpoint_loads_in_the_inference_cli(data_root, tmp_path):
    logdir = tmp_path / "run"
    cli.main(_argv(data_root, logdir, 2, "--no-tb"))
    export = logdir / "export"
    out = tmp_path / "out"
    infer_cli.main(["--seqs-path", data_root, "--out-path", str(out), "--preset", "tiny",
                    "--device", "cpu", "--no-bf16", "--ddpm-steps", "2", "--num-shards", "2",
                    "--torch-ckpt", str(export / "mgld_ema.pt"),
                    "--raft-ckpt", str(export / "raft.pt")])
    frames = sorted(os.listdir(out / "001"))
    assert frames == [f"{i:08d}.png" for i in range(6)]
    assert read_frame(str(out / "001" / frames[0])).shape == (160, 192, 3)


@pytest.mark.parametrize("flag", sorted(cli.REFUSED) + ["--stage"])
def test_refused_flags(data_root, flag, capsys):
    argv = ["--data-root", data_root, "--device", "cpu"]
    # --stage 2 is refused without its two data roots
    argv += ["--stage", "2"] if flag == "--stage" else [flag]
    with pytest.raises(SystemExit):
        cli.parse_args(argv)
    err = capsys.readouterr().err
    assert "ROADMAP" in err or "--device" in err or "--lq-root" in err


def test_config_sections_and_defaults(data_root):
    args = cli.parse_args(["--data-root", data_root, "--set", "train.grad_accum=3",
                           "--set", "model.unet.use_checkpoint=True", "--device", "cpu"])
    assert args.grad_accum == 3 and cli.tower_dtype(args.device) == torch.float32
    assert args.cfg["model"]["unet"]["use_checkpoint"] is True
    cuda = cli.parse_args(["--data-root", data_root])  # cuda by default
    assert cli.tower_dtype(cuda.device) == torch.bfloat16
    with pytest.raises(KeyError):
        cli.parse_args(["--data-root", data_root, "--set", "train.no_such_key=1"])
    frozen = cli.parse_args(["--data-root", data_root, "--frozen-dtype", "bfloat16"])
    assert frozen.frozen_dtype == "bfloat16"


def test_without_cuda_the_default_device_raises(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--data-root", data_root, "--tiny", "--max-steps", "1",
                  "--logdir", str(tmp_path)])
