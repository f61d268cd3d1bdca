"""The port's training CLI (``repro_torch.launch.train.main``) on the CPU:
periodic checkpoints with retention, then a resumed run to a larger step
count, at ``--reduced`` (split from ``test_torch_train_resume.py`` so that
``--dist loadfile`` spreads them)."""
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import train as ptrain


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    p = str(tmp_path / "cli.msgpack")
    args = ["--arch", "xmgn-drivaer", "--reduced", "--samples", "3",
            "--device", "cpu", "--ckpt", p]
    ptrain.main(args + ["--steps", "2", "--ckpt-every", "1",
                        "--keep-ckpts", "2", "--total-steps", "3"])
    assert [s for s, _ in ckpt.retained_steps(p)] == [1]
    assert ckpt.restore(p)["step"] == 2
    capsys.readouterr()
    ptrain.main(args + ["--steps", "3", "--resume", p])
    assert "resumed" in capsys.readouterr().out
    assert ckpt.restore(p)["step"] == 3
