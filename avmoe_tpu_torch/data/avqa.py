"""MUSIC-AVQA dataset: frames, waveform, tokenized questions, answers.

Counterpart of `avmoe_tpu/data/avqa.py`, reading the same on-disk layout:

  * train / val / test JSON lists of questions with 'question_content'
    (templated: each '<...>' word takes the next of 'templ_values'),
    'anser', 'video_id' and 'type';
  * the question and answer vocabularies: the shipped `ques_vocab.txt` /
    `ans_vocab.txt` (one token a line) where given, else built from the
    train JSON in first-seen order;
  * `frames/<video>/<8-digit index>.jpg`: 10 frames picked evenly over the
    video's frames; `wave/<video>.npy`, (10, L) or flat;
  * negative frames: one frame of another video per segment, drawn from the
    dataset's own seeded generator (so the items depend on the order in
    which they are read, as in the JAX reader).

`SyntheticAVQADataset` makes random data of the same schema, seeded per
index. Both yield dicts of numpy arrays and the question type as a string,
equal to the JAX package's for the same reads.
"""

from __future__ import annotations

import ast
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from avmoe_tpu_torch.data.transforms import load_image, pad_or_trim_wave


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def parse_question(sample: Dict) -> List[str]:
    """The question's words, '?' stripped, template slots filled in order."""
    words = sample["question_content"].rstrip().split(" ")
    words[-1] = words[-1][:-1]
    values = ast.literal_eval(sample["templ_values"])
    out, p = [], 0
    for w in words:
        if "<" in w:
            out.append(values[p])
            p += 1
        else:
            out.append(w)
    return out


def build_vocabs(train_json: str) -> Tuple[List[str], List[str]]:
    """(question vocab with '<pad>' first, answer vocab), first-seen order."""
    ques_vocab, ans_vocab = ["<pad>"], []
    for s in _load_json(train_json):
        for w in parse_question(s):
            if w not in ques_vocab:
                ques_vocab.append(w)
        if s["anser"] not in ans_vocab:
            ans_vocab.append(s["anser"])
    return ques_vocab, ans_vocab


def load_vocab_file(path: str) -> List[str]:
    """One token a line, kept verbatim but for the newline: a blank interior
    line is a token (dropping it would shift every later index against a
    checkpoint's embedding order); only a final newline ends the file."""
    with open(path) as f:
        tokens = [line.rstrip("\n") for line in f]
    if tokens and tokens[-1] == "":
        tokens.pop()
    return tokens


def resolve_vocabs(train_json: str, ques_vocab_file: Optional[str] = None,
                   ans_vocab_file: Optional[str] = None) -> Tuple[List[str], List[str]]:
    """Shipped vocab files win over the build from the train JSON; each side
    falls back on its own."""
    ques = load_vocab_file(ques_vocab_file) if ques_vocab_file else None
    ans = load_vocab_file(ans_vocab_file) if ans_vocab_file else None
    if ques is None or ans is None:
        built_q, built_a = build_vocabs(train_json)
        ques = ques if ques is not None else built_q
        ans = ans if ans is not None else built_a
    return ques, ans


class AVQADataset:
    NUM_SEGMENTS = 10
    AUDIO_LEN = 32_000
    MAX_QST_LEN = 14

    def __init__(self, root: str, label_json: str, train_json: str, img_size: int = 192,
                 seed: int = 0, ques_vocab_file: Optional[str] = None,
                 ans_vocab_file: Optional[str] = None):
        self.root = root
        self.img_size = img_size
        self.ques_vocab, self.ans_vocab = resolve_vocabs(train_json, ques_vocab_file,
                                                         ans_vocab_file)
        self.word_to_ix = {w: i for i, w in enumerate(self.ques_vocab)}
        self.samples = _load_json(label_json)
        self.video_list = sorted({s["video_id"] for s in self.samples})
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def _frames(self, video: str, idx: Optional[int] = None) -> np.ndarray:
        frame_dir = os.path.join(self.root, "frames", video)
        total = len(glob.glob(os.path.join(frame_dir, "*.jpg")))
        picks = np.linspace(1, total, num=self.NUM_SEGMENTS, dtype=int)
        if idx is not None:
            picks = picks[idx: idx + 1]
        size = (self.img_size, self.img_size)
        return np.stack([load_image(os.path.join(frame_dir, f"{p:08d}.jpg"), size)
                         for p in picks])

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.samples[i]
        video = s["video_id"]
        frames = self._frames(video)
        vid_idx = self.video_list.index(video)
        nega = []
        for _ in range(self.NUM_SEGMENTS):
            while True:
                j = self.rng.randint(len(self.video_list))
                if j != vid_idx:
                    break
            nega.append(self._frames(self.video_list[j],
                                     self.rng.randint(self.NUM_SEGMENTS))[0])
        wave = np.load(os.path.join(self.root, "wave", f"{video}.npy"))
        wave = pad_or_trim_wave(wave.reshape(self.NUM_SEGMENTS, -1).astype(np.float32),
                                self.AUDIO_LEN)
        words = parse_question(s)[: self.MAX_QST_LEN]
        words += ["<pad>"] * (self.MAX_QST_LEN - len(words))
        return {
            "wave": wave,
            "visual_posi": frames.astype(np.float32),
            "visual_nega": np.stack(nega).astype(np.float32),
            "question": np.array([self.word_to_ix.get(w, 0) for w in words], np.int32),
            "answer": np.int32(self.ans_vocab.index(s["anser"])),
            "qtype_str": s.get("type", ""),
        }


class SyntheticAVQADataset:
    QTYPES = [
        "[' Audio', ' Counting']", "[' Audio', ' Comparative']",
        "[' Visual', ' Counting']", "[' Visual', ' Localization']",
        "[' Audio-Visual', ' Existential']", "[' Audio-Visual', ' Counting']",
        "[' Audio-Visual', ' Localization']", "[' Audio-Visual', ' Comparative']",
        "[' Audio-Visual', ' Temporal']",
    ]

    def __init__(self, length: int = 16, num_segments: int = 10, audio_len: int = 32_000,
                 img_size: int = 192, qst_vocab: int = 93, max_qst_len: int = 14,
                 answer_vocab: int = 42, seed: int = 0):
        self.length = length
        self.num_segments = num_segments
        self.audio_len = audio_len
        self.img_size = img_size
        self.qst_vocab = qst_vocab
        self.max_qst_len = max_qst_len
        self.answer_vocab = answer_vocab
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 104729 + idx)
        T, S = self.num_segments, self.img_size
        return {
            "wave": rng.randn(T, self.audio_len).astype(np.float32) * 0.1,
            "visual_posi": rng.rand(T, S, S, 3).astype(np.float32),
            "visual_nega": rng.rand(T, S, S, 3).astype(np.float32),
            "question": rng.randint(0, self.qst_vocab, self.max_qst_len).astype(np.int32),
            "answer": np.int32(rng.randint(self.answer_vocab)),
            "qtype_str": self.QTYPES[idx % len(self.QTYPES)],
        }
