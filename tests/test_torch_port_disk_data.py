"""The port's disk data path against the JAX package's: the synthetic tree
functions write the same bytes, the DAVIS and YouTube-VOS indexes hold the
same entries in both ``multi_object`` modes, frames and labels decode to
the same arrays with the native decoder and with it forced off (the JAX
package then decodes with cv2, the port with PIL), and the split helpers
agree."""

import json
import os

import numpy as np
import pytest

from e_osvos_tpu.data import datasets as j_datasets
from e_osvos_tpu.data import loader as j_loader
from e_osvos_tpu.data import native as j_native
from e_osvos_tpu.data import splits as j_splits
from e_osvos_tpu.data import synthetic_disk as j_disk
from e_osvos_torch.data import datasets, loader, native, splits
from e_osvos_torch.data import synthetic_disk as disk

YT_KW = dict(num_videos=3, t_frames=3)
BREADTH_KW = dict(num_sequences=3, t_frames=2)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Each ``build_*`` tree from the port and from the JAX package."""
    base = tmp_path_factory.mktemp("trees")
    out = {}
    for name, port_fn, jax_fn, kw in (
            ("480p", disk.build_480p_tree, j_disk.build_480p_tree, {}),
            ("ytvos", disk.build_ytvos_tree, j_disk.build_ytvos_tree, YT_KW),
            ("breadth", disk.build_breadth_tree, j_disk.build_breadth_tree,
             BREADTH_KW)):
        port_root, jax_root = str(base / f"{name}_port"), str(base / f"{name}_jax")
        os.makedirs(port_root)
        os.makedirs(jax_root)
        assert port_fn(port_root, **kw) == jax_fn(jax_root, **kw)
        out[name] = (port_root, jax_root)
    return out


@pytest.mark.parametrize("name", ["480p", "ytvos", "breadth"])
def test_tree_functions_write_the_same_bytes(trees, name):
    port_root, jax_root = trees[name]
    got, want = _tree_bytes(port_root), _tree_bytes(jax_root)
    assert sorted(got) == sorted(want) and got == want
    if name == "480p":
        assert len([p for p in got if p.endswith(".jpg")]) == 2 * 67


def _entries(index):
    return {name: (seq.name, seq.image_paths, seq.label_paths,
                   [(g.object_ids, g.support_frame) for g in seq.object_groups],
                   seq.num_objects)
            for name, seq in index.sequences.items()}


@pytest.mark.parametrize("mode", ["single_id", "all"])
def test_davis_index_matches_jax(trees, mode):
    root = trees["480p"][0]
    got = datasets.DAVISIndex(root, split="val", multi_object=mode)
    want = j_datasets.DAVISIndex(root, split="val", multi_object=mode)
    assert list(got.sequences) == ["crossing", "drift"]
    assert _entries(got) == _entries(want)
    groups = got.sequences["crossing"].object_groups
    assert len(groups) == (2 if mode == "single_id" else 1)


@pytest.mark.parametrize("mode", ["single_id", "all"])
def test_ytvos_index_matches_jax(trees, mode):
    root = trees["ytvos"][0]
    got = datasets.YouTubeVOSIndex(root, split="valid", multi_object=mode)
    want = j_datasets.YouTubeVOSIndex(root, split="valid", multi_object=mode)
    assert _entries(got) == _entries(want)
    # odd videos' second object enters at stem index 2: its own group
    support = {g.support_frame for s in got.sequences.values()
               for g in s.object_groups}
    assert support == {0, 2}


def test_breadth_index_matches_jax(trees):
    root = trees["breadth"][0]
    assert _entries(datasets.DAVISIndex(root)) == _entries(
        j_datasets.DAVISIndex(root))


@pytest.fixture(params=["native", "fallback"])
def decoder(request, monkeypatch):
    """The native decoder on both sides, or forced off on both."""
    if request.param == "fallback":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(j_native, "available", lambda: False)
    else:
        assert native.available() and j_native.available()
    return request.param


def test_decoders_match_jax(trees, decoder):
    root = trees["480p"][0]
    index = datasets.DAVISIndex(root)
    j_index = j_datasets.DAVISIndex(root)
    assert datasets.decoder() == ("native" if decoder == "native" else "PIL")
    for name in ("drift", "crossing"):
        seq = index.sequences[name]
        for t in (0, 1, 66):
            img = datasets.load_image(seq.image_paths[t])
            assert img.dtype == np.uint8 and img.shape == (480, 854, 3)
            np.testing.assert_array_equal(
                img, j_datasets.load_image(seq.image_paths[t]))
            label = datasets.load_label(seq.label_paths[t])
            np.testing.assert_array_equal(
                label, j_datasets.load_label(seq.label_paths[t]))
        assert set(np.unique(index.get_label(name, 0))) == set(
            range(len(seq.object_groups) + 1))
    frames = loader.load_frames(index, "crossing")
    assert frames.shape == (67, 480, 854, 3)
    np.testing.assert_array_equal(frames,
                                  j_loader.load_frames(j_index, "crossing"))


def test_native_and_fallback_decode_alike(trees, monkeypatch):
    """The native decoder and PIL decode the synthetic tree alike."""
    root = trees["ytvos"][0]
    index = datasets.YouTubeVOSIndex(root)
    name = sorted(index.sequences)[1]
    frames = loader.load_frames(index, name)
    labels = [index.get_label(name, t) for t in range(len(frames))]
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(frames, loader.load_frames(index, name))
    for t, label in enumerate(labels):
        np.testing.assert_array_equal(label, index.get_label(name, t))


def test_preloaded_index(trees):
    index = datasets.DAVISIndex(trees["480p"][0], sequences=["drift"])
    pre = datasets.PreloadedIndex(index)
    assert pre.sequences is index.sequences
    for t in (0, 5):
        np.testing.assert_array_equal(pre.get_image("drift", t),
                                      index.get_image("drift", t))
        np.testing.assert_array_equal(pre.get_label("drift", t),
                                      index.get_label("drift", t))


def test_split_files_match_jax(tmp_path):
    for ds, split in (("DAVIS-2017", "val"), ("DAVIS-2016", "train"),
                      ("YouTube-VOS", "train_dev_random_123_val")):
        path = datasets.shipped_split_path(ds, split)
        assert path and path == j_datasets.shipped_split_path(ds, split)
        assert datasets.read_split_file(path) == j_datasets.read_split_file(
            path)
    assert datasets.shipped_split_path("DAVIS-2017", "nope") is None
    f = tmp_path / "s.txt"
    f.write_text("a\n\n b \nc\n")
    assert datasets.read_split_file(str(f)) == ["a", "b", "c"]


@pytest.mark.parametrize("seed", [0, 123])
def test_category_balanced_split_matches_jax(tmp_path, seed):
    rng = np.random.RandomState(seed)
    cats = ["cat", "dog", "person", "zebra", "kite"]
    videos = {f"v{i:03d}": {"objects": {
        str(o + 1): {"category": cats[rng.randint(len(cats)) if o else i % 3],
                     "frames": ["00000"]}
        for o in range(1 + rng.randint(3))}} for i in range(40)}
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"videos": videos}))
    got = splits.category_balanced_split(str(meta), num_val=9, seed=seed)
    assert got == j_splits.category_balanced_split(str(meta), num_val=9,
                                                   seed=seed)
    train, val = got
    assert len(val) == 9 and not set(train) & set(val)
    splits.write_split_files(str(tmp_path / "out"), train, val)
    j_splits.write_split_files(str(tmp_path / "j_out"), train, val)
    for part in ("train", "val"):
        name = f"train_dev_random_123_{part}.txt"
        assert ((tmp_path / "out" / name).read_bytes()
                == (tmp_path / "j_out" / name).read_bytes())
