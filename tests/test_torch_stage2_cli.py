"""The stage-2 training command line of the port on the CPU at tiny widths:
the inference command line's latent mode writes the latents, ``--stage 2``
trains on them, writes metrics, checkpoints and an exported VAE that the
inference command line loads, and a resumed run continues to the same state
as one that was never stopped. Two faults of the JAX command line are
pinned: the decoder sees the stored latents divided by the diffusion scale
factor, and the trainer starts from the pipeline's VAE (seeded, or loaded
with ``--torch-ckpt``/``--vqgan-ckpt``), not from a fresh random one."""
import json
import os

import numpy as np
import pytest
import torch

from mgldvsr_tpu_torch.cli import infer as infer_cli
from mgldvsr_tpu_torch.cli import train as cli
from mgldvsr_tpu_torch.io.checkpoint import CheckpointManager, load_params, save_params
from mgldvsr_tpu_torch.io.frames import read_frame, write_frame
from mgldvsr_tpu_torch.train import stage2

torch.set_num_threads(1)
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "video_autoencoder_kl_64x64x4_resi.yaml")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """LQ clips of 10 frames of 8x8 (two windows), GT frames of 32x32, and
    the latents the tiny latent mode writes for the LQ clips."""
    base = tmp_path_factory.mktemp("s2")
    rs = np.random.RandomState(0)
    for clip in ("001", "002"):
        for root, size in (("lq", 8), ("gt", 32)):
            os.makedirs(base / root / clip)
            for i in range(10):
                write_frame(str(base / root / clip / f"{i:08d}.png"),
                            (rs.rand(size, size, 3) * 255).astype(np.uint8))
    infer_cli.main(["--seqs-path", str(base / "lq"), "--out-path", str(base / "lat"),
                    "--preset", "tiny", "--device", "cpu", "--no-bf16", "--ddpm-steps", "2",
                    "--mode", "latent"])
    return {k: str(base / k) for k in ("lq", "gt", "lat")}


def _argv(roots, logdir, steps, *extra):
    return ["--stage", "2", "--data-root", roots["gt"], "--lq-root", roots["lq"],
            "--latent-root", roots["lat"], "--tiny", "--device", "cpu",
            "--max-steps", str(steps), "--grad-accum", "2", "--ckpt-every", "2",
            "--log-every", "1", "--logdir", str(logdir), *extra]


def test_latent_mode_writes_the_training_latents(roots):
    names = sorted(os.listdir(os.path.join(roots["lat"], "001")))
    assert [n for n in names if n.endswith(".npy")] == [f"{i:08d}.npy" for i in range(10)]
    assert np.load(os.path.join(roots["lat"], "001", "00000003.npy")).shape == (4, 4, 4)


def test_run_writes_everything_and_resumes(roots, tmp_path, capsys):
    logdir = tmp_path / "run"
    cli.main(_argv(roots, logdir, 4))
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    for r in records:
        for key in ("loss_g", "nll_loss", "rec_loss", "temp_loss", "g_loss", "d_weight",
                    "loss_d", "logits_real", "logits_fake"):
            assert np.isfinite(r[key]), key
    assert any(f.startswith("events.out.tfevents.") for f in os.listdir(logdir / "tb"))
    assert CheckpointManager(str(logdir / "ckpt")).all_steps() == [2, 4]
    cli.main(_argv(roots, logdir, 6, "--resume"))
    assert "resumed at step 4" in capsys.readouterr().out
    records = [json.loads(line) for line in open(logdir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5, 6]
    # the exported VAE restores a clip in the inference command line
    out = tmp_path / "out"
    _write_mgld(tmp_path / "mgld.pt")
    infer_cli.main(["--seqs-path", roots["lq"], "--out-path", str(out), "--preset", "tiny",
                    "--device", "cpu", "--no-bf16", "--ddpm-steps", "2", "--num-shards", "2",
                    "--torch-ckpt", str(tmp_path / "mgld.pt"),
                    "--vqgan-ckpt", str(logdir / "export" / "vqgan.pt")])
    frames = sorted(os.listdir(out / "001"))
    assert frames == [f"{i:08d}.png" for i in range(10)]
    assert read_frame(str(out / "001" / frames[0])).shape == (32, 32, 3)


def _write_mgld(path) -> None:
    """A seeded tiny MGLD-VSR checkpoint (the towers but RAFT)."""
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights
    from mgldvsr_tpu_torch.io.torch_ckpt import mgld_state_dict
    from mgldvsr_tpu_torch.train.trainer import named_tower_parameters

    pipe = MGLDVSRPipeline(cli.tiny_pipeline_config(torch.float32), device="cpu")
    init_pipeline_weights(pipe, 5)
    save_params(str(path), {"state_dict": mgld_state_dict(dict(named_tower_parameters(pipe)))})


def test_resumed_run_equals_an_uninterrupted_one(roots, tmp_path):
    """Four micro-steps straight, against two and a resume for two more: the
    same window stream, so the same state to the bit (no draws in stage 2)."""
    cli.main(_argv(roots, tmp_path / "a", 4, "--no-tb"))
    cli.main(_argv(roots, tmp_path / "b", 2, "--no-tb"))
    cli.main(_argv(roots, tmp_path / "b", 4, "--no-tb", "--resume"))
    a = CheckpointManager(str(tmp_path / "a" / "ckpt")).restore(4)
    b = CheckpointManager(str(tmp_path / "b" / "ckpt")).restore(4)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["logvar"], b["logvar"])
    for part in ("trainable", "disc"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    for opt in ("opt_g", "opt_d"):
        assert a[opt]["count"] == b[opt]["count"] == 2
        for part in ("mu", "nu"):
            assert all(torch.equal(a[opt][part][k], b[opt][part][k]) for k in a[opt][part])


def test_decoder_sees_the_latents_divided_by_the_scale_factor(roots, tmp_path):
    """The latent mode stores scale_factor·z; the trainer's contract is z
    (the reference's get_input: lts / 0.18215). The JAX command line passes
    the stored latents straight on."""
    seen = []

    def spy(trainer):
        step = trainer.train_step

        def wrapped(state, lq, gt, latents):
            seen.append(latents.clone())
            return step(state, lq, gt, latents)

        trainer.train_step = wrapped

    args = cli.parse_args(_argv(roots, tmp_path / "run", 1, "--no-tb"))
    cli.stage2(args, on_trainer=spy)
    assert len(seen) == 1
    stored = [np.stack([np.load(os.path.join(roots["lat"], clip, f"{i:08d}.npy"))
                        for i in range(s, s + 5)]) for clip in ("001", "002") for s in (0, 5)]
    matches = [np.array_equal(seen[0].numpy(), torch.from_numpy(x).div(0.18215).numpy())
               for x in stored]
    assert sum(matches) == 1


def test_trainer_starts_from_the_pipelines_vae(roots, tmp_path):
    """The seeded pipeline's VAE (by --seed), and with --torch-ckpt and
    --vqgan-ckpt the loaded one: zero micro-steps export it unchanged; the
    trainer's frozen tensors are the pipeline's own."""
    from mgldvsr_tpu_torch.infer.pipeline import MGLDVSRPipeline
    from mgldvsr_tpu_torch.io.init_weights import init_pipeline_weights

    args = cli.parse_args(_argv(roots, tmp_path / "seeded", 0, "--no-tb", "--seed", "11"))
    pipe = cli.build_pipeline(args)
    want = {k: v.clone() for k, v in pipe.vae.state_dict().items()}
    state = cli.stage2(args, pipe=pipe)
    assert all(p is dict(pipe.vae.named_parameters())[k] for k, p in state.frozen.items())
    for k, v in state.trainable.items():
        assert torch.equal(v, want[k]), k
    # loaded: a VAE checkpoint with weights no seed gives
    other = MGLDVSRPipeline(cli.tiny_pipeline_config(torch.float32), device="cpu")
    init_pipeline_weights(other, 1234)
    vqgan = {k: v.detach().clone() for k, v in other.vae.state_dict().items()}
    save_params(str(tmp_path / "vqgan.pt"), {"state_dict": vqgan})
    _write_mgld(tmp_path / "mgld.pt")
    cli.main(_argv(roots, tmp_path / "loaded", 0, "--no-tb", "--torch-ckpt",
                   str(tmp_path / "mgld.pt"), "--vqgan-ckpt", str(tmp_path / "vqgan.pt")))
    exported = load_params(str(tmp_path / "loaded" / "export" / "vqgan.pt"))["state_dict"]
    assert set(exported) == set(vqgan)
    assert all(torch.equal(exported[k], v) for k, v in vqgan.items())


def test_shipped_stage2_config_loads():
    """configs/video_autoencoder_kl_64x64x4_resi.yaml as it is: stage 2, its
    train: values as defaults, its model: section (bf16 VAE with fusion)."""
    args = cli.parse_args(["--config", CONFIG, "--data-root", "GT", "--lq-root", "LQ",
                           "--latent-root", "LAT"])
    assert args.stage == 2 and args.grad_accum == 8 and args.lr == 4.5e-6
    assert args.num_frames == 5 and args.device == "cuda" and args.ckpt_every == 1500
    assert args.cfg["model"]["vae"] == {"dtype": "bfloat16", "enable_fusion": True}
    with pytest.raises(SystemExit):
        cli.parse_args(["--config", CONFIG, "--data-root", "GT"])
    assert stage2.Stage2Config().disc_start == 501
