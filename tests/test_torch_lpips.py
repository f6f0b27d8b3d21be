"""The port's LPIPS network (``dge_tpu_torch/models/lpips.py``) against the
JAX one (``dge_tpu/models/lpips.py``): the same images through both with the
JAX parameters carried across (``lpips_params_from_jax``), a torchvision
layout VGG16 state dict loaded by both, and the ``full_eval`` tool's
``lpips`` against the JAX tool's on one ``--vgg_checkpoint`` file. The port
runs on the CPU. Tolerance: 1e-5 relative (the same float32 convolutions in
another order of summation); between the two tools 1e-4 relative, since
their renders also differ by float32 rounding."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dge_tpu.diffusion.weights import convert_vgg16_torchvision
from dge_tpu.models import lpips as JL
from dge_tpu_torch.models import lpips as TL
from dge_tpu_torch.tools import full_eval as TFE
from tests.test_torch_eval import jax_full_eval
from tests.test_torch_render import write_synthetic_capture

TV_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def image_pair(rng, shape):
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


def torchvision_state_dict(seed):
    """A random VGG16 state dict in torchvision's layout, classifier
    included (it is not used)."""
    gen = torch.Generator().manual_seed(seed)
    sd, c_in = {}, 3
    convs = iter(TV_CONVS)
    for ch, n in TL.VGG16_STAGES:
        for _ in range(n):
            i = next(convs)
            sd[f"features.{i}.weight"] = torch.randn(
                ch, c_in, 3, 3, generator=gen) * (2.0 / (9 * c_in)) ** 0.5
            sd[f"features.{i}.bias"] = 0.01 * torch.randn(ch, generator=gen)
            c_in = ch
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    sd["classifier.0.bias"] = torch.zeros(4)
    return sd


@pytest.mark.parametrize("size", [32, 64])
def test_lpips_matches_jax_on_converted_weights(size):
    """Random JAX parameters carried across: one image and a batch of two,
    within 1e-5 relative; the port's own random init is seeded by its
    generator and gives a different, finite distance."""
    rng = np.random.default_rng(size)
    fn_j, params = JL.make_perceptual_fn(rng=jax.random.PRNGKey(size),
                                         image_size=size)
    params = jax.tree_util.tree_map(np.asarray, params)
    fn_t, sd = TL.make_perceptual_fn(params=TL.lpips_params_from_jax(params),
                                      device="cpu")
    assert sorted(k for k in sd if k.startswith("vgg.")) == sorted(
        f"vgg.features.{i}.{w}" for i in TV_CONVS for w in ("weight", "bias"))
    for shape in ((size, size, 3), (2, size, size, 3)):
        a, b = image_pair(rng, shape)
        want = float(fn_j(jnp.asarray(a), jnp.asarray(b)))
        got = fn_t(torch.from_numpy(a), torch.from_numpy(b))
        assert got.shape == () and want > 0
        assert float(got) == pytest.approx(want, rel=1e-5), shape
    a, b = image_pair(rng, (size, size, 3))
    fn_r, _ = TL.make_perceptual_fn(generator=torch.Generator().manual_seed(7),
                                   device="cpu")
    fn_r2, _ = TL.make_perceptual_fn(
        generator=torch.Generator().manual_seed(7), device="cpu")
    x, y = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(fn_r(x, y), fn_r2(x, y))
    assert np.isfinite(float(fn_r(x, y))) and float(fn_r(x, x)) == 0.0


def test_lpips_defaults_to_the_card(monkeypatch):
    """Without ``device`` the network is built for the card: with no card
    present that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TL.make_perceptual_fn(generator=torch.Generator().manual_seed(0))


def test_torchvision_state_dict_loads():
    """A torchvision-layout VGG16 state dict loads into the port as it is
    and gives the distance the JAX module gives with
    ``convert_vgg16_torchvision`` of the same dict and its default heads
    (1e-5 relative); a dict without a conv is refused."""
    sd = torchvision_state_dict(3)
    vgg = TL.VGG16Features()
    vgg.load_torchvision(sd)
    assert torch.equal(vgg.features[28].weight, sd["features.28.weight"])
    fn_t, _ = TL.make_perceptual_fn(params=TL.params_from_torchvision(sd),
                                   device="cpu")
    base = dict(JL.make_perceptual_fn(image_size=32)[1])
    base["vgg"] = convert_vgg16_torchvision(
        {k: v.numpy() for k, v in sd.items()})
    fn_j, _ = JL.make_perceptual_fn(params=base)
    a, b = image_pair(np.random.default_rng(1), (48, 40, 3))
    want = float(fn_j(jnp.asarray(a), jnp.asarray(b)))
    assert float(fn_t(torch.from_numpy(a), torch.from_numpy(b))) == \
        pytest.approx(want, rel=1e-5)
    del sd["features.14.bias"]
    with pytest.raises(RuntimeError, match="features.14.bias"):
        TL.VGG16Features().load_torchvision(sd)


def test_full_eval_lpips_matches_reference_tool(tmp_path, capsys):
    """The port's tool writes a finite ``lpips``; given the same
    ``--vgg_checkpoint`` file it equals the JAX tool's within 1e-4
    relative. Without a checkpoint it says its features are random."""
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=2)
    ckpt = str(tmp_path / "vgg16.pth")
    torch.save(torchvision_state_dict(5), ckpt)
    common = ["--pairs", f"{ply}:{capture}", "--height", "32", "--width",
              "32", "--vgg_checkpoint", ckpt]
    jout = str(tmp_path / "jax")
    jax_full_eval().main(common + ["--out", jout])
    import json
    with open(os.path.join(jout, "results.json")) as f:
        want = json.load(f)["capture"]["lpips"]
    got = TFE.main(common + ["--out", str(tmp_path / "port"), "--cpu"])
    got = got["capture"]["lpips"]
    assert want > 0 and np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-4)
    capsys.readouterr()
    rand = TFE.main(["--pairs", f"{ply}:{capture}", "--height", "32",
                     "--width", "32", "--out", str(tmp_path / "rand"),
                     "--cpu"])["capture"]["lpips"]
    assert np.isfinite(rand) and rand >= 0.0
    assert "random-init features" in capsys.readouterr().out
