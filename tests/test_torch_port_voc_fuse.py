"""Parent-training helpers of the port against the JAX package on the CPU:
the VOC-2012 index (both ``void`` modes) on a synthetic VOC tree and the
``fix_scale_crop`` validation protocol (bit-equal), the single-channel
stack ROI-align (values 1e-6, gradients 1e-5), and the frozen-norm fusion
(the fused model's features within 1e-5 of the unfused ones, relative to
each map's largest magnitude) with the bilinear upsampling kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from e_osvos_tpu.data.voc import VOC2012Index as JVOC2012Index
from e_osvos_tpu.data.voc import fix_scale_crop as j_fix_scale_crop
from e_osvos_tpu.models.fuse import (
    bilinear_upsample_kernel as j_bilinear_upsample_kernel,
)
from e_osvos_tpu.ops.roi_align import stack_roi_align_1ch as j_roi_align_1ch
from e_osvos_torch import config
from e_osvos_torch.cli.common import build_indexes
from e_osvos_torch.data.voc import VOC2012Index, fix_scale_crop
from e_osvos_torch.models.deeplab import init_weights
from e_osvos_torch.models.fuse import (
    bilinear_upsample_kernel,
    fuse_frozen_norms,
)
from e_osvos_torch.models.resnet import ResNet
from e_osvos_torch.ops.roi_align import stack_roi_align_1ch
from e_osvos_torch.utils.png import davis_palette

NAMES = ["2007_000032", "2007_000039", "2008_000123"]


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """VOCdevkit/VOC2012 with three images (one missing its label, so the
    index skips it), labels over classes 0..20 and the 255 border."""
    root = tmp_path_factory.mktemp("voc")
    base = root / "VOCdevkit" / "VOC2012"
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        (base / d).mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, name in enumerate(NAMES):
        h, w = 30 + 4 * i, 44 - 3 * i
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(img).save(base / "JPEGImages" / f"{name}.jpg",
                                  quality=90)
        if i == 2:
            continue
        lab = np.zeros((h, w), np.uint8)
        lab[5:20, 6:25] = 255
        lab[7:18, 8:23] = 3 + 7 * i
        lab[1:4, 30:36] = 20
        png = Image.fromarray(lab, mode="P")
        png.putpalette(davis_palette().ravel().tolist())
        png.save(base / "SegmentationClass" / f"{name}.png")
    (base / "ImageSets" / "Segmentation" / "train.txt").write_text(
        "\n".join(NAMES) + "\n")
    return root


@pytest.mark.parametrize("void", ["background", "ignore"])
def test_voc_index_matches_jax(voc_tree, void):
    got = VOC2012Index(str(voc_tree), "train", void=void)
    want = JVOC2012Index(str(voc_tree), "train", void=void)
    assert list(got.sequences) == list(want.sequences) == NAMES[:2]
    for name, seq in got.sequences.items():
        assert seq.image_paths == want.sequences[name].image_paths
        assert seq.object_groups[0].object_ids == (1,)
        np.testing.assert_array_equal(got.get_image(name, 0),
                                      want.get_image(name, 0))
        label = got.get_label(name, 0)
        np.testing.assert_array_equal(label, want.get_label(name, 0))
        assert set(np.unique(label)) == ({0, 1, 255} if void == "ignore"
                                         else {0, 1})
    with pytest.raises(ValueError):
        VOC2012Index(str(voc_tree), "train", void="foreground")


def test_voc_dataset_name_builds_its_index(voc_tree):
    cfg = config.parse_cli([
        "with", "VOC2012", f"datasets.train.root={voc_tree}",
        "voc.void=ignore", "device=cpu"])
    (index,) = build_indexes(cfg, "train")
    assert isinstance(index, VOC2012Index) and index.void == "ignore"
    assert list(index.sequences) == NAMES[:2]


@pytest.mark.parametrize("hw, crop", [((30, 44), 24), ((41, 27), 32),
                                      ((20, 20), 25)])
def test_fix_scale_crop_matches_jax(hw, crop):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    lab = rng.choice([0, 1, 255], size=hw).astype(np.uint8)
    got = fix_scale_crop(img, lab, crop)
    want = j_fix_scale_crop(img, lab, crop)
    for g, w in zip(got, want):
        assert g.shape[:2] == (crop, crop) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_stack_roi_align_1ch_matches_jax():
    """Boxes inside, across and beyond the maps' edges, three maps."""
    rng = np.random.RandomState(2)
    maps = rng.rand(3, 17, 23).astype(np.float32)
    boxes = np.array([[2.0, 3.0, 12.5, 9.0], [-4.0, -2.0, 6.0, 20.0],
                      [15.2, 1.1, 30.0, 16.9], [5.0, 5.0, 5.5, 5.5],
                      [0.0, 0.0, 23.0, 17.0]], np.float32)
    idx = np.array([0, 2, 1, 1, 2], np.int32)
    cot = rng.randn(5, 7, 9).astype(np.float32)

    def j_fn(m):
        return j_roi_align_1ch(m, jnp.asarray(boxes), jnp.asarray(idx), (7, 9))

    want, j_vjp = jax.vjp(j_fn, jnp.asarray(maps))
    (j_grad,) = j_vjp(jnp.asarray(cot))
    m = torch.tensor(maps, requires_grad=True)
    got = stack_roi_align_1ch(m, torch.from_numpy(boxes),
                              torch.from_numpy(idx), (7, 9))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    (grad,) = torch.autograd.grad(got, m, torch.from_numpy(cot))
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), atol=1e-5)


def test_bilinear_kernel_matches_jax():
    for size, cin, cout in ((4, 3, 3), (3, 2, 4), (5, 1, 1)):
        np.testing.assert_array_equal(bilinear_upsample_kernel(size, cin, cout),
                                      j_bilinear_upsample_kernel(size, cin,
                                                                 cout))


def test_fused_forward_matches_unfused():
    """Frozen-BN scales folded into the convolutions before them: the
    trunk's C2..C5 unchanged, every folded scale 1 and the convolutions'
    kernels changed; a second fusion changes nothing."""
    model = ResNet("resnet10", "frozen_bn", (False, False, False),
                   torch.float32)
    init_weights(model, 0)
    g = torch.Generator().manual_seed(1)
    state = {k: v + 0.3 * torch.randn(v.shape, generator=g)
             if k.endswith((".scale", ".bias")) else v.clone()
             for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    x = torch.randn(2, 3, 32, 32, generator=g)
    with torch.no_grad():
        ref = model(x)
        fused = fuse_frozen_norms(state)
        model.load_state_dict(fused)
        out = model(x)
    for k in ref:
        err = (out[k] - ref[k]).abs().max() / ref[k].abs().max()
        assert float(err) < 1e-5, k
    scales = [k for k in fused if k.endswith(".scale")]
    assert len(scales) == 17
    assert all(torch.equal(fused[k], torch.ones_like(fused[k]))
               for k in scales)
    assert not torch.equal(fused["stem_conv.weight"],
                           state["stem_conv.weight"])
    again = fuse_frozen_norms(fused)
    assert all(torch.equal(again[k], fused[k]) for k in fused)
