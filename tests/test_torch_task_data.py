"""The port's AVVP, AVQA and AVS data layer against the JAX package's: the
synthetic and on-disk datasets (the same arrays for the same index and seed,
the string fields equal) on `tools/make_mini_datasets.py` trees, the AVVP
annotation grids, the AVQA vocabularies, `save_mask`'s PNGs read back by
PIL, `archive_sources`, and the BatchLoader's string fields.

No JAX computation here: the JAX package's data modules are numpy (its
readers use pandas and PIL, which this host has).
"""

from __future__ import annotations

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(2)


def _make_mini_datasets():
    spec = importlib.util.spec_from_file_location(
        "make_mini_datasets", ROOT / "tools" / "make_mini_datasets.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], str):
            assert isinstance(a[k], str) and a[k] == b[k], k
            continue
        a_k, b_k = np.asarray(a[k]), np.asarray(b[k])
        assert a_k.dtype == b_k.dtype and a_k.shape == b_k.shape, k
        np.testing.assert_array_equal(a_k, b_k, err_msg=k)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    mk = _make_mini_datasets()
    root = tmp_path_factory.mktemp("task_data")
    mk.make_avvp(str(root / "avvp"), n=5, img=40)
    mk.make_avqa(str(root / "avqa"), n=4, img=40)
    mk.make_avs(str(root / "s4"), "s4", n=4, img=40)
    mk.make_avs(str(root / "ms3"), "ms3", n=4, img=40)
    return root


# -- synthetic datasets -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_avvp_matches_jax(seed):
    from avmoe_tpu.data.avvp import SyntheticAVVPDataset as J

    from avmoe_tpu_torch.data.avvp import SyntheticAVVPDataset

    kw = dict(length=12, num_segments=3, audio_len=800, img_size=16, st_dim=8, seed=seed)
    ours, ref = SyntheticAVVPDataset(**kw), J(**kw)
    assert len(ours) == len(ref) == 12
    for idx in range(12):      # some draw no label and take the fallback
        _same(ours[idx], ref[idx])


@pytest.mark.parametrize("seed", [0, 2])
def test_synthetic_avqa_matches_jax(seed):
    from avmoe_tpu.data.avqa import SyntheticAVQADataset as J

    from avmoe_tpu_torch.data.avqa import SyntheticAVQADataset

    kw = dict(length=10, num_segments=2, audio_len=600, img_size=16, qst_vocab=20,
              max_qst_len=6, answer_vocab=5, seed=seed)
    ours, ref = SyntheticAVQADataset(**kw), J(**kw)
    for idx in (0, 4, 9):
        _same(ours[idx], ref[idx])


@pytest.mark.parametrize("setting, split", [("s4", "train"), ("s4", "val"), ("ms3", "train")])
def test_synthetic_avs_matches_jax(setting, split):
    from avmoe_tpu.data.avs import SyntheticAVSDataset as J

    from avmoe_tpu_torch.data.avs import SyntheticAVSDataset

    kw = dict(length=4, num_segments=3, audio_len=500, img_size=24, mask_size=20,
              setting=setting, split=split, seed=1)
    ours, ref = SyntheticAVSDataset(**kw), J(**kw)
    for idx in (0, 3):
        _same(ours[idx], ref[idx])
    assert ours[0]["mask"].shape == ((20, 20) if (setting, split) == ("s4", "train")
                                     else (3, 20, 20))


# -- on-disk readers ----------------------------------------------------------


@pytest.mark.parametrize("csv", ["train.csv", "val.csv"])
def test_llp_dataset_matches_jax(trees, csv):
    from avmoe_tpu.data.avvp import LLPDataset as J

    from avmoe_tpu_torch.data.avvp import LLPDataset

    root = str(trees / "avvp")
    ours, ref = LLPDataset(root, os.path.join(root, csv), 32), J(root, os.path.join(root, csv), 32)
    assert len(ours) == len(ref) > 0
    assert ours.filenames == list(ref.df["filename"])
    for idx in range(len(ours)):
        _same(ours[idx], ref[idx])


@pytest.mark.parametrize("which", ["audio", "visual"])
def test_parse_eval_annotations_matches_jax(trees, which):
    from avmoe_tpu.data.avvp import parse_eval_annotations as J

    from avmoe_tpu_torch.data.avvp import parse_eval_annotations

    path = str(trees / "avvp" / f"AVVP_eval_{which}.csv")
    ours, ref = parse_eval_annotations(path), J(path)
    assert set(ours) == set(ref) and ours
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].sum() > 0


def test_parse_eval_annotations_sums_rows_of_one_clip(tmp_path):
    from avmoe_tpu.data.avvp import parse_eval_annotations as J

    from avmoe_tpu_torch.data.avvp import parse_eval_annotations

    path = tmp_path / "eval.csv"
    path.write_text("filename\tonset\toffset\tevent_labels\n"
                    "clipA_0_10\t0\t3\tDog\nclipA_0_10\t5\t10\tDog\nclipA_0_10\t2\t4\tCat\n"
                    "clipB_0_10\t1\t2\tClapping\n")
    ours, ref = parse_eval_annotations(str(path)), J(str(path))
    assert set(ours) == set(ref) == {"clipA_0_10", "clipB_0_10"}
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("split", ["train", "val"])
def test_avqa_dataset_matches_jax_read_in_order(trees, split):
    """The negative frames come from the dataset's own seeded generator, so
    the two readers agree item by item when read in the same order."""
    from avmoe_tpu.data.avqa import AVQADataset as J

    from avmoe_tpu_torch.data.avqa import AVQADataset

    root = str(trees / "avqa")
    label, train = (os.path.join(root, f"avqa-{s}.json") for s in (split, "train"))
    kw = dict(img_size=32, seed=3, ques_vocab_file=os.path.join(root, "ques_vocab.txt"),
              ans_vocab_file=os.path.join(root, "ans_vocab.txt"))
    ours, ref = AVQADataset(root, label, train, **kw), J(root, label, train, **kw)
    assert (ours.ques_vocab, ours.ans_vocab, ours.video_list) == (
        ref.ques_vocab, ref.ans_vocab, ref.video_list)
    for idx in list(range(len(ours))) * 2:
        _same(ours[idx], ref[idx])


def test_avqa_vocabularies_match_jax(trees, tmp_path):
    from avmoe_tpu.data import avqa as J

    from avmoe_tpu_torch.data import avqa as P

    root = trees / "avqa"
    train = str(root / "avqa-train.json")
    assert P.build_vocabs(train) == J.build_vocabs(train)
    blank = tmp_path / "blank.txt"
    blank.write_text("<pad>\n\n a b\nlast")           # interior blank line, no final newline
    assert P.load_vocab_file(str(blank)) == J.load_vocab_file(str(blank)) == [
        "<pad>", "", " a b", "last"]
    q, a = str(root / "ques_vocab.txt"), str(root / "ans_vocab.txt")
    for files in ((None, None), (q, None), (None, a), (q, a)):
        assert P.resolve_vocabs(train, *files) == J.resolve_vocabs(train, *files)
    sample = {"question_content": "Is the <Object> left of the <Object>?",
              "templ_values": "['cello', 'piano']"}
    assert P.parse_question(sample) == J.parse_question(sample) == [
        "Is", "the", "cello", "left", "of", "the", "piano"]


@pytest.mark.parametrize("setting, split", [("s4", "train"), ("s4", "val"), ("ms3", "train"),
                                            ("ms3", "val")])
def test_avs_datasets_match_jax(trees, setting, split):
    from avmoe_tpu.data import avs as J

    from avmoe_tpu_torch.data import avs as P

    name = "S4Dataset" if setting == "s4" else "MS3Dataset"
    root = str(trees / setting)
    ours = getattr(P, name)(root, split, img_size=32, mask_size=24)
    ref = getattr(J, name)(root, split, img_size=32, mask_size=24)
    assert len(ours) == len(ref) > 0
    for idx in range(len(ours)):
        _same(ours[idx], ref[idx])
    item = ours[0]
    assert item["mask"].shape == ((24, 24) if (setting, split) == ("s4", "train")
                                  else (5, 24, 24))
    assert set(np.unique(item["mask"])) <= {0.0, 1.0}


# -- save_mask, archive_sources ---------------------------------------------------


def test_save_mask_pngs_equal_jax(tmp_path):
    from PIL import Image

    from avmoe_tpu.metrics.avs import save_mask as jax_save

    from avmoe_tpu_torch.metrics.avs import save_mask

    rng = np.random.RandomState(0)
    logits = rng.randn(3, 19, 26).astype(np.float32) * 3
    logits[1] = -50.0                                     # an all-background mask
    names = ["batch0_0", "batch0_1", "batch1_0"]
    save_mask(logits, str(tmp_path / "port"), names)
    jax_save(logits, str(tmp_path / "jax"), names)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(f"{n}.png" for n in names)
    for n in names:
        with Image.open(tmp_path / "port" / f"{n}.png") as a, \
                Image.open(tmp_path / "jax" / f"{n}.png") as b:
            assert a.mode == b.mode == "L" and a.size == b.size == (26, 19)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert set(np.unique(np.asarray(a))) <= {0, 255}


def test_archive_sources_copies_the_port_and_its_cuda_sources(tmp_path):
    from avmoe_tpu_torch.utils.runtime import archive_sources

    pkg = ROOT / "avmoe_tpu_torch"
    want = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*")
                  if p.suffix in (".py", ".cu", ".cuh") and "__pycache__" not in p.parts
                  and "_build" not in p.parts)
    n = archive_sources(str(tmp_path))
    got = sorted(str(p.relative_to(tmp_path / "sources"))
                 for p in (tmp_path / "sources").rglob("*") if p.is_file())
    assert n == len(got) and got == want
    assert "csrc/window_attention.cu" in got and "cli/train_avs.py" in got
    assert (tmp_path / "sources" / "models" / "avs.py").read_bytes() == (
        pkg / "models" / "avs.py").read_bytes()


# -- the loader's string fields -----------------------------------------------------


def test_loader_keeps_string_fields_on_the_host():
    """AVQA's question types and AVS's categories and video names stay numpy
    string arrays, as the JAX loader keeps them; the numeric fields become
    tensors."""
    from avmoe_tpu.data.loader import BatchLoader as JLoader

    from avmoe_tpu_torch.data.loader import BatchLoader

    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.float32), "n": np.int32(i),
                    "qtype_str": f"[' Audio', ' q{i}']", "video": f"vid{i}"}

    ours = list(BatchLoader(Items(), 2, drop_last=False, num_workers=2, device="cpu"))
    ref = list(JLoader(Items(), 2, drop_last=False, num_workers=2))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert torch.is_tensor(a["x"]) and torch.is_tensor(a["n"])
        assert a["n"].dtype == torch.int32
        np.testing.assert_array_equal(a["x"].numpy(), b["x"])
        for k in ("qtype_str", "video"):
            assert isinstance(a[k], np.ndarray) and a[k].dtype.kind == "U"
            np.testing.assert_array_equal(a[k], b[k])
