"""The port's AVE data layer against the JAX package's: the synthetic and
on-disk datasets (bit-identical arrays for the same index and seed, both
image decode paths), the transforms, and the prefetching BatchLoader (the
same index batches in the same order, its exceptions, its tensors).

No JAX computation here: the JAX package's data modules are numpy.
"""

from __future__ import annotations

import importlib.util
import pathlib
import threading

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _make_mini_datasets():
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", ROOT / "tools" / "make_mini_datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("learnable", [False, True])
def test_synthetic_ave_dataset_matches_jax(seed, learnable):
    from avmoe_tpu.data.ave import SyntheticAVEDataset as JSynth

    from avmoe_tpu_torch.data.ave import SyntheticAVEDataset

    kw = dict(length=16, num_segments=3, audio_len=4000, img_size=32, num_classes=28,
              seed=seed, learnable=learnable, sample_rate=4000)
    ours, ref = SyntheticAVEDataset(**kw), JSynth(**kw)
    assert len(ours) == len(ref) == 16
    for idx in (0, 5, 15):
        _same(ours[idx], ref[idx])


def test_synthetic_ave_dataset_full_geometry_matches_jax():
    from avmoe_tpu.data.ave import SyntheticAVEDataset as JSynth

    from avmoe_tpu_torch.data.ave import SyntheticAVEDataset

    item = SyntheticAVEDataset(seed=1)[3]
    assert item["wave"].shape == (10, 32_000) and item["images"].shape == (10, 192, 192, 3)
    assert item["labels"].shape == (10, 29)
    _same(item, JSynth(seed=1)[3])


@pytest.fixture(scope="module")
def ave_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ave")
    _make_mini_datasets().make_ave(str(root), n=5, img=48)
    return str(root)


@pytest.mark.parametrize("pil", [False, True])
@pytest.mark.parametrize("split", ["train", "test"])
def test_ave_dataset_matches_jax(ave_tree, monkeypatch, split, pil):
    from avmoe_tpu.data.ave import AVEDataset as JAVE

    from avmoe_tpu_torch.data.ave import AVEDataset

    monkeypatch.setenv("AVMOE_PIL_DECODE", "1" if pil else "0")
    ours, ref = AVEDataset(ave_tree, split, img_size=64), JAVE(ave_tree, split, img_size=64)
    assert len(ours) == len(ref) == (3 if split == "train" else 2)
    assert ours.video_ids == ref.video_ids
    for idx in range(len(ours)):
        item = ours[idx]
        assert item["images"].shape == (10, 64, 64, 3)
        assert item["wave"].shape == (10, 32_000)
        _same(item, ref[idx])


def test_ave_dataset_decode_paths_differ(ave_tree, monkeypatch):
    """The two decode paths are really two: cv2's and PIL's resizes differ
    at the pixel level (each path is checked against JAX's own above)."""
    from avmoe_tpu_torch.data.ave import AVEDataset

    ds = AVEDataset(ave_tree, "train", img_size=64)
    fast = ds[0]["images"]
    monkeypatch.setenv("AVMOE_PIL_DECODE", "1")
    assert np.abs(fast - ds[0]["images"]).max() > 1e-3


def test_ave_dataset_missing_root():
    from avmoe_tpu_torch.data.ave import AVEDataset

    with pytest.raises(FileNotFoundError, match="labels.h5"):
        AVEDataset("/nonexistent/ave_root", "train")


def test_transforms_match_jax(ave_tree, monkeypatch):
    from avmoe_tpu.data import transforms as J

    from avmoe_tpu_torch.data import transforms as P

    rng = np.random.RandomState(0)
    u8 = (rng.rand(6, 5, 3) * 255).astype(np.uint8)
    unit = rng.rand(6, 5, 3).astype(np.float32)
    for arr in (u8, unit):
        np.testing.assert_array_equal(P.normalize_image(arr), J.normalize_image(arr))
    pcm = rng.randint(-32768, 32767, size=(3, 100)).astype(np.int16)
    np.testing.assert_array_equal(P.int16_to_float32(pcm), J.int16_to_float32(pcm))
    wave = rng.randn(2, 700).astype(np.float32)
    for n in (500, 700, 1000):
        out = P.pad_or_trim_wave(wave, n)
        assert out.shape == (2, n)
        np.testing.assert_array_equal(out, J.pad_or_trim_wave(wave, n))
    jpg = str(pathlib.Path(ave_tree) / "frames" / "mini_vid_00" / "0001.jpg")
    for pil, size in ((False, (32, 32)), (False, (96, 80)), (True, (32, 32))):
        monkeypatch.setenv("AVMOE_PIL_DECODE", "1" if pil else "0")
        img = P.load_image(jpg, size)
        assert img.shape == (size[1], size[0], 3) and img.dtype == np.float32
        np.testing.assert_array_equal(img, J.load_image(jpg, size))


# ---------------------------------------------------------------------------
# BatchLoader
# ---------------------------------------------------------------------------


class IndexDataset:
    """Items that name their index: {'idx': (1,) int64, 'x': (2, 3) float32}."""

    def __init__(self, n: int, fail_at: int = -1):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"bad item {i}")
        return {"idx": np.array([i], np.int64), "x": np.full((2, 3), i, np.float32)}


def _epochs(loader, n: int = 3):
    return [[b["idx"][:, 0].tolist() for b in loader] for _ in range(n)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_loader_order_matches_jax(shuffle, drop_last):
    from avmoe_tpu.data.loader import BatchLoader as JLoader

    from avmoe_tpu_torch.data.loader import BatchLoader

    ds = IndexDataset(11)
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=3, seed=5)
    ours, ref = BatchLoader(ds, 4, **kw), JLoader(ds, 4, **kw)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    got, want = _epochs(ours), _epochs(ref)
    assert got == want
    if shuffle:
        assert got[0] != got[1]


@pytest.mark.parametrize("index", [0, 1, 2])
def test_batch_loader_multihost_slices_match_jax(index):
    from avmoe_tpu.data.loader import BatchLoader as JLoader

    from avmoe_tpu_torch.data.loader import BatchLoader

    ds = IndexDataset(14)
    kw = dict(shuffle=True, seed=2, num_workers=2, process_index=index, process_count=3)
    ours, ref = BatchLoader(ds, 6, **kw), JLoader(ds, 6, **kw)
    got = _epochs(ours)
    assert got == _epochs(ref)
    assert all(len(b) == 2 for ep in got for b in ep)


def test_batch_loader_argument_checks():
    from avmoe_tpu_torch.data.loader import BatchLoader

    with pytest.raises(ValueError, match="multiple"):
        BatchLoader(IndexDataset(8), 5, process_count=2)
    with pytest.raises(ValueError, match="drop_last"):
        BatchLoader(IndexDataset(8), 4, process_count=2, drop_last=False)


def test_batch_loader_reraises_worker_exception():
    from avmoe_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(IndexDataset(12, fail_at=6), 2, num_workers=2)
    seen = []
    with pytest.raises(KeyError, match="bad item 6"):
        for b in loader:
            seen.append(b["idx"][:, 0].tolist())
    assert seen == [[0, 1], [2, 3], [4, 5]]


def test_batch_loader_tensors_and_early_exit():
    """CPU tensors pass through unchanged (dtypes kept, unpinned); a
    consumer that stops early leaves no producer thread behind."""
    from avmoe_tpu_torch.data.loader import BatchLoader

    before = threading.active_count()
    loader = BatchLoader(IndexDataset(40), 4, num_workers=2, prefetch=1, device="cpu")
    for b in loader:
        assert b["idx"].dtype == torch.int64 and b["x"].dtype == torch.float32
        assert b["x"].device.type == "cpu" and b["x"].shape == (4, 2, 3)
        assert not b["x"].is_pinned()
        torch.testing.assert_close(b["x"][:, 0, 0], b["idx"][:, 0].float())
        break
    assert threading.active_count() == before
    assert [len(ep) for ep in _epochs(loader, 2)] == [10, 10]
