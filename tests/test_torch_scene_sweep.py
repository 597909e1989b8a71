"""The port's scene sweep (gflow_tpu_torch.parallel.scene_sweep.fit_scenes)
on the CPU: 2 scenes of tests/synth.make_sequence (64x48, 3 frames) fitted
(2 fitted) in 2 spawned worker processes on ["cpu", "cpu"], each scene's log
directory and checkpoints held against a direct fit_video call with the
same seed in this process, with torch's threads capped to the workers'
share. Checkpoint arrays equal to atol 1e-6 (the same code and inputs on
the same CPU; a CPU reduction may split its work otherwise)."""
import os

import numpy as np
import torch

from gflow_tpu_torch.parallel.scene_sweep import fit_scenes
from gflow_tpu_torch.pipeline.fit_video import main as fit_main
from tests.synth import make_sequence

FIT = dict(num_points=150, iterations_first=12, iterations_after=6, traj_num=0, seed=3)


def test_sweep_two_scenes_matches_direct_fits(tmp_path):
    seqs = []
    for i, name in enumerate(("a", "b")):
        root = tmp_path / name
        root.mkdir()
        seqs.append(make_sequence(root, n_frames=3, W=64, H=48, seed=11 + i))
    res = fit_scenes(seqs, fit_kwargs=FIT, devices=["cpu", "cpu"])
    assert sorted(res) == sorted(map(str, seqs))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 2))
    try:
        for seq in seqs:
            d = res[str(seq)]
            assert d.startswith(f"{seq}_logs")
            ckpts = sorted(os.listdir(os.path.join(d, "ckpt")))
            assert len(ckpts) == 2  # as tests/test_scene_sweep.py: 3 frames, 2 fitted
            direct = fit_main(sequence_path=seq, device="cpu",
                              logs_suffix=str(tmp_path / "direct" / seq.name), **FIT)
            assert sorted(os.listdir(os.path.join(direct.dir, "ckpt"))) == ckpts
            for c in ckpts:
                got, want = (np.load(os.path.join(x, "ckpt", c)) for x in (d, direct.dir))
                assert got.files == want.files
                for k in want.files:
                    np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    finally:
        torch.set_num_threads(threads)
