"""VCTK datasets (``buddy_tpu/data/vctk.py``), numpy only.

* ``VCTKTrain``: an endless stream of random training crops from
  ``path/<speaker>/*.wav``, the discarded and the test speakers left out;
* ``VCTKTest``: a fixed utterance list from the test speakers, preloaded;
* ``VCTKTestPaired``: clean/RIR pairs for dereverberation benchmarks under
  ``path/clean/<speaker>`` and ``path/rir/<speaker>``; each RIR is cropped at
  its direct path (the argmax of its magnitude) and peak-normalised.

They draw from Python's ``random`` and numpy's global generator as the JAX
package's classes do, so for the same files and seed they give the same
segments.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Iterator, List, Tuple

import numpy as np

from buddy_tpu_torch.data.audio_io import read_wav


def _scan_speakers(path: str, speakers_discard, speakers_test, *, keep_test: bool):
    files: List[str] = []
    for s in sorted(os.listdir(path)):
        if s in speakers_discard:
            continue
        is_test = s in speakers_test
        if is_test != keep_test:
            continue
        files.extend(sorted(glob.glob(os.path.join(path, s, "*.wav"))))
    return files


class VCTKTrain:
    """Endless random training segments: a file drawn with
    ``random.Random(seed)``, then a crop at an offset from numpy's global
    generator (seeded with ``seed`` here), or a wrap-pad where the file is
    shorter than the segment."""

    def __init__(self, fs=16000, segment_length=65536, path="",
                 speakers_discard=(), speakers_test=(), normalize=False, seed=0,
                 **_unused):
        random.seed(seed)
        np.random.seed(seed)
        self.train_samples = _scan_speakers(path, speakers_discard,
                                            speakers_test, keep_test=False)
        assert len(self.train_samples) > 0, \
            "error in dataloading: empty or nonexistent folder"
        self.segment_length = int(segment_length)
        self.fs = fs
        if normalize:
            raise NotImplementedError("normalization not implemented yet")
        self._rng = random.Random(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.sample_segment()

    def sample_segment(self) -> np.ndarray:
        file = self.train_samples[self._rng.randint(0, len(self.train_samples) - 1)]
        data, sr = read_wav(file)
        assert sr == self.fs, "wrong sampling rate"
        L = len(data)
        if L > self.segment_length:
            idx = np.random.randint(0, L - self.segment_length)
            return data[idx: idx + self.segment_length]
        idx = np.random.randint(0, max(self.segment_length - L, 1))
        return np.pad(data, (idx, self.segment_length - L - idx), "wrap")


class VCTKTest:
    """Fixed in-memory test set from the test speakers."""

    def __init__(self, fs=16000, segment_length=65536, path="",
                 speakers_discard=(), speakers_test=(), normalize=False,
                 seed=0, num_examples=8, shuffle=True, **_unused):
        random.seed(seed)
        np.random.seed(seed)
        samples = sorted(_scan_speakers(path, speakers_discard, speakers_test,
                                        keep_test=True))
        assert len(samples) >= num_examples, \
            "error in dataloading: not enough examples"
        if num_examples > 0:
            samples = (random.sample(samples, num_examples) if shuffle
                       else samples[:num_examples])
        self.test_samples = samples
        self.segment_length = int(segment_length)
        self.fs = fs
        if normalize:
            raise NotImplementedError("normalization not implemented yet")

        self.test_audio, self.filenames = [], []
        for file in samples:
            self.filenames.append(os.path.basename(file))
            data, sr = read_wav(file)
            assert sr == self.fs, "wrong sampling rate"
            L = len(data)
            if self.segment_length > 0:
                if L > self.segment_length:
                    idx = np.random.randint(0, L - self.segment_length)
                    seg = data[idx: idx + self.segment_length]
                else:
                    idx = np.random.randint(0, max(self.segment_length - L, 1))
                    seg = np.pad(data, (idx, self.segment_length - L - idx), "wrap")
            else:
                seg = data
            self.test_audio.append(seg)

    def __getitem__(self, idx) -> Tuple[np.ndarray, str]:
        return self.test_audio[idx], self.filenames[idx]

    def __len__(self):
        return len(self.test_samples)


class VCTKTestPaired:
    """Clean/RIR pairs under ``path/clean/<spk>`` + ``path/rir/<spk>``."""

    def __init__(self, fs=16000, segment_length=65536, path="",
                 speakers_discard=(), speakers_test=(), normalize=False,
                 seed=0, num_examples=8, shuffle=True, **_unused):
        random.seed(seed)
        np.random.seed(seed)
        test_samples, rir_samples = [], []
        for s in sorted(os.listdir(os.path.join(path, "clean"))):
            if s in speakers_discard or s not in speakers_test:
                continue
            new = sorted(glob.glob(os.path.join(path, "clean", s, "*.wav")))
            test_samples.extend(new)
            for file in new:
                fid = os.path.splitext(os.path.basename(file))[0]
                rir_samples.append(os.path.join(path, "rir", s, fid + ".wav"))

        assert len(test_samples) >= num_examples, \
            "error in dataloading: not enough examples"
        assert len(test_samples) == len(rir_samples), \
            "error in dataloading: the rir files are not paired"
        if num_examples > 0:
            test_samples = test_samples[:num_examples]
            rir_samples = rir_samples[:num_examples]

        self.segment_length = int(segment_length)
        self.fs = fs
        if normalize:
            raise NotImplementedError("normalization not implemented yet")

        self.test_samples = test_samples
        self.test_audio, self.test_rir, self.filenames = [], [], []
        for file, file_rir in zip(test_samples, rir_samples):
            self.filenames.append(os.path.basename(file))
            data, sr = read_wav(file)
            rir, sr_r = read_wav(file_rir)
            assert sr == self.fs and sr_r == self.fs, "wrong sampling rate"
            direct = int(np.argmax(np.abs(rir)))
            rir = rir[direct:]
            rir = rir / np.abs(rir).max()
            self.test_audio.append(data)
            self.test_rir.append(rir)

    def __getitem__(self, idx) -> Tuple[np.ndarray, np.ndarray, str]:
        return self.test_audio[idx], self.test_rir[idx], self.filenames[idx]

    def __len__(self):
        return len(self.test_samples)
