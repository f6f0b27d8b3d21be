"""The sharded edit round (``batch_mode="shard"``) and ``launch
--distributed`` of the port, on the CPU with the tiny networks.

- Two gloo ranks (``dist.spawn_local``, tests/torch_parallel_ranks.py) run
  one guidance call on tests/test_guidance.py::TestBatchedReuse's setup (4
  views at 32^2 in camera batches of 2, 2 DDIM steps): the shard result
  against the port's ``"vmap"`` within 1e-6, the same on both ranks; and,
  with JAX's draws and cross-view states handed over (as
  tests/test_torch_edit_modes.py does for ``"vmap"``), against JAX's
  ``"shard"`` mode on the 8 virtual devices within 1e-4.
- Without a process group ``"shard"`` is ``"vmap"``, bit for bit.
- ``torch.distributed.run --nproc_per_node=2 -m dge_tpu_torch.launch
  --train --smoke --cpu --distributed ... batch_mode=shard``: exit 0, one
  trial directory, the two ranks' scene checksums equal."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dge_tpu.parallel.mesh import stack_cameras as j_stack
from dge_tpu.systems import guidance as JG
from dge_tpu.systems.guidance import _gather_cams
from dge_tpu_torch.diffusion import ddim as TD
from dge_tpu_torch.parallel import dist as D
from tests import torch_parallel_ranks as ranks
from tests.test_parallel import ring_cameras
from tests.test_torch_diffusion import jax_tiny_models, port_models_from
from tests.test_torch_edit import jax_draws
from tests.test_torch_edit_modes import VKW, _inputs, _port_call
from tests.test_torch_models import port_state
from tests.test_torch_parallel import _cam_leaves
from tests.test_torch_render import write_synthetic_capture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's tiny models and shard-mode call; the port's weights, the
    inputs and JAX's draws and cross-view states written for the ranks."""
    jm = jax_tiny_models()
    tm = port_models_from(jm)
    jcams = ring_cameras(4, height=32, width=32)
    key = jax.random.PRNGKey(3)
    jg = JG.DGEGuidance(JG.GuidanceConfig(**VKW, batch_mode="shard"), jm)
    want = np.asarray(jg(*_inputs(), j_stack(jcams), key, max_step=400))
    ts = TD.inference_timesteps(
        tm.schedule._replace(num_train_timesteps=399), 2)
    draws = jax_draws(key, (4, 32, 32, 4), ts, 2, 2)
    z = dict(zip(("rgb", "cond", "pos", "neg"), _inputs()),
             **_cam_leaves("c4_", j_stack(jcams)),
             n_normals=len(draws.normals), n_offsets=len(draws.offsets))
    z.update({f"normal_{i}": x for i, x in enumerate(draws.normals)})
    jall = j_stack(jcams)
    lat_h, lat_w = draws.normals[0].shape[1:3]
    for j, off in enumerate(draws.offsets):
        z[f"offsets_{j}"] = off
        keys = _gather_cams(jall,
                            jax.numpy.asarray(off + np.arange(0, 4, 2)))
        for i in range(2):
            cv = port_state(JG.make_cross_view_state(
                _gather_cams(jall, jax.numpy.arange(2 * i, 2 * i + 2)), keys,
                jax.numpy.asarray(off[i]), lat_h, lat_w, 1 if i == 0 else 2,
                1.0, "banded"))
            p = f"cv_{j}_{i}_"
            z[p + "closest"] = cv.closest_cam.numpy()
            z[p + "blend"] = cv.blend_w1.numpy()
            z[p + "sizes"] = np.array(sorted(cv.epi_lines))
            for s in cv.epi_lines:
                z[f"{p}lines_{s}"] = cv.epi_lines[s].numpy()
                z[f"{p}pts_{s}"] = cv.epi_pts[s].numpy()
    d = tmp_path_factory.mktemp("edit")
    path, weights = str(d / "inputs.npz"), str(d / "weights.pt")
    np.savez(path, **z)
    torch.save({"unet": tm.unet.state_dict(), "vae": tm.vae.state_dict(),
                "text_encoder": tm.text_encoder.state_dict()}, weights)
    return dict(path=path, weights=weights, want=want, tm=tm, jcams=jcams)


def test_shard_matches_vmap_on_two_ranks(setup):
    out = D.spawn_local(ranks.world2_edit, 2, device="cpu",
                        args=(setup["path"], setup["weights"], False))
    for o in out:
        err = float(np.abs(o["shard"] - o["vmap"]).max())
        print(f"shard (2 ranks) vs vmap: {err:.3g}")
        assert err <= 1e-6, err
    np.testing.assert_array_equal(out[0]["shard"], out[1]["shard"])


def test_shard_matches_jax_on_two_ranks(setup):
    out = D.spawn_local(ranks.world2_edit, 2, device="cpu",
                        args=(setup["path"], setup["weights"], True))
    err = float(np.abs(out[0]["shard"] - setup["want"]).max())
    print(f"port shard (2 ranks) vs JAX shard: {err:.3g}")
    assert err < 1e-4, err
    np.testing.assert_array_equal(out[0]["shard"], out[1]["shard"])


def test_shard_without_a_group_is_vmap(setup):
    shard = _port_call(setup["tm"], "shard", setup["jcams"])
    vmap = _port_call(setup["tm"], "vmap", setup["jcams"])
    np.testing.assert_array_equal(shard, vmap)


def test_cli_train_distributed_shard(tmp_path):
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=4)
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "dge_tpu_torch.launch", "--train",
         "--smoke", "--cpu", "--distributed", "--gs_source", ply, "--source",
         capture, "--out", str(out), "data.height=32", "data.width=32",
         "data.max_view_num=4", "system.model_size=tiny",
         "system.guidance.camera_batch_size=2",
         "system.guidance.diffusion_steps=2",
         "system.guidance.resize_target=64", "system.edit.max_steps=3",
         "system.edit.tile_px=16", "system.edit.chunk=16",
         "system.guidance.batch_mode=shard"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log[-4000:]
    assert re.search(r"rank 1 / world 2, device cpu, backend gloo", log)
    sums = {r: c for c, r in re.findall(
        r"scene checksum (\w+) \(rank (\d) of 2\)", log)}
    assert set(sums) == {"0", "1"} and len(set(sums.values())) == 1, log
    trials = os.listdir(out / "dge")
    assert len(trials) == 1, trials
    assert os.path.exists(out / "dge" / trials[0] / "last.ply")
