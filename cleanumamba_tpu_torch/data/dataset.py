"""Paired clean/noisy datasets (the port's own copy of
``cleanumamba_tpu/data/dataset.py``; numpy only).

Parity with the reference's dataset layer (its src/util/
dataset.py): ``CleanNoisyPairDataset`` pairs ``training_set/clean/
fileid_{i}.wav`` with ``training_set/noisy/fileid_{i}.wav`` (:33-50), test
pairing by sorted order (:59-73), random ``crop_length_sec`` crops with
repeat-padding of short clips (:119-134); ``NoisyOnlyDataset`` for
inference-only folders (:187-208).

Plus a :class:`SyntheticDenoiseDataset` (procedural speech-like harmonics +
coloured noise) so training/benchmarks run in environments without the
DNS-Challenge download — the reference hard-codes a local DNS path
(dataset.py:170-171).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from cleanumamba_tpu_torch.data.wavio import read_wav


class CleanNoisyPairDataset:
    """Directory-backed paired dataset.

    subset="training": pairs by fileid_{i}.wav naming.
    subset="testing":  pairs clean/noisy by aligned sorted listing (the DNS
    no-reverb test set convention, reference dataset.py:59-73).
    """

    def __init__(
        self,
        root: str,
        subset: str = "training",
        crop_length_sec: float = 10.0,
        sample_rate: int = 16000,
        dataset: str = "dns",
    ):
        self.root = root
        self.subset = subset
        self.sample_rate = sample_rate
        self.crop_len = int(crop_length_sec * sample_rate)
        if dataset == "VCTK-DEMAND":
            # VCTK-DEMAND pairs clean/noisy by identical filenames under
            # training_set/, regardless of subset (reference dataset.py:51-54).
            base = os.path.join(root, "training_set")
            clean_dir = os.path.join(base, "clean")
            noisy_dir = os.path.join(base, "noisy")
            names = sorted(os.listdir(clean_dir))
            self.pairs = [
                (os.path.join(clean_dir, n), os.path.join(noisy_dir, n)) for n in names
            ]
        elif dataset != "dns":
            raise ValueError(f"unknown dataset variant: {dataset!r}")
        elif subset == "training":
            # DNS convention: fileid_{i}.wav with contiguous ids
            # (reference dataset.py:55-57).
            base = os.path.join(root, "training_set")
            clean_dir = os.path.join(base, "clean")
            noisy_dir = os.path.join(base, "noisy")
            n_clean = len(os.listdir(clean_dir))
            n_noisy = len(os.listdir(noisy_dir))
            if n_clean != n_noisy:
                raise ValueError(
                    f"clean/noisy counts differ: {n_clean} vs {n_noisy}")
            self.pairs = [
                (os.path.join(clean_dir, f"fileid_{i}.wav"),
                 os.path.join(noisy_dir, f"fileid_{i}.wav"))
                for i in range(n_clean)
            ]
            if n_clean and not os.path.exists(self.pairs[0][0]):
                # tolerate non-fileid naming by same-name pairing
                names = sorted(os.listdir(clean_dir))
                self.pairs = [
                    (os.path.join(clean_dir, n), os.path.join(noisy_dir, n))
                    for n in names
                ]
        elif subset == "testing":
            base = os.path.join(root, "datasets", "test_set", "synthetic", "no_reverb")
            if not os.path.isdir(base):
                base = root
            clean_dir = os.path.join(base, "clean")
            noisy_dir = os.path.join(base, "noisy")
            cleans = sorted(os.listdir(clean_dir))
            noisys = sorted(os.listdir(noisy_dir))
            # DNS naming embeds a shared fileid suffix; align by sorted order
            # keyed on the trailing id (reference sortkey, dataset.py:59-66)
            def sortkey(n):
                stem = os.path.splitext(n)[0]
                tail = stem.split("_")[-1]
                return int(tail) if tail.isdigit() else stem

            cleans = sorted(cleans, key=sortkey)
            noisys = sorted(noisys, key=sortkey)
            assert len(cleans) == len(noisys)
            self.pairs = [
                (os.path.join(clean_dir, c), os.path.join(noisy_dir, n))
                for c, n in zip(cleans, noisys)
            ]
        else:
            raise ValueError(subset)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        clean_path, noisy_path = self.pairs[idx]
        clean, _ = read_wav(clean_path, self.sample_rate)
        noisy, _ = read_wav(noisy_path, self.sample_rate)
        n = min(len(clean), len(noisy))
        clean, noisy = clean[:n], noisy[:n]
        if self.subset == "training":
            clean, noisy = _crop_pair(clean, noisy, self.crop_len, rng)
        return clean, noisy


def _crop_pair(clean, noisy, crop_len, rng=None):
    """Random crop; repeat-pad short clips (reference dataset.py:119-134)."""
    rng = rng or np.random.default_rng()
    n = len(clean)
    if n < crop_len:
        reps = -(-crop_len // n)
        clean = np.tile(clean, reps)[:crop_len]
        noisy = np.tile(noisy, reps)[:crop_len]
    else:
        start = int(rng.integers(0, n - crop_len + 1))
        clean = clean[start : start + crop_len]
        noisy = noisy[start : start + crop_len]
    return clean, noisy


class NoisyOnlyDataset:
    """Folder of noisy wavs for bulk inference (reference dataset.py:187-208)."""

    def __init__(self, directory: str, sample_rate: int = 16000):
        self.paths = sorted(
            os.path.join(directory, n)
            for n in os.listdir(directory)
            if n.lower().endswith(".wav")
        )
        self.sample_rate = sample_rate

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        audio, _ = read_wav(self.paths[idx], self.sample_rate)
        return audio, self.paths[idx]


class SyntheticDenoiseDataset:
    """Procedural speech-like clean signals + coloured noise at random SNR.

    Deterministic per (seed, idx) so validation sets are reproducible.
    """

    def __init__(
        self,
        n_items: int = 1024,
        crop_length_sec: float = 10.0,
        sample_rate: int = 16000,
        snr_range: Tuple[float, float] = (0.0, 15.0),
        seed: int = 0,
    ):
        self.n_items = n_items
        self.sr = sample_rate
        self.crop_len = int(crop_length_sec * sample_rate)
        self.snr_range = snr_range
        self.seed = seed

    def __len__(self):
        return self.n_items

    def __getitem__(self, idx: int):
        rng = np.random.default_rng((self.seed, idx))
        t = np.arange(self.crop_len) / self.sr
        clean = np.zeros(self.crop_len, np.float32)
        # a few "syllables": AM harmonics with random f0 drift
        n_seg = max(1, int(self.crop_len / self.sr * 3))
        for _ in range(n_seg):
            f0 = rng.uniform(80, 300)
            start = int(rng.integers(0, self.crop_len))
            dur = int(rng.uniform(0.1, 0.4) * self.sr)
            seg = slice(start, min(start + dur, self.crop_len))
            tt = t[seg] - t[seg.start]
            env = np.hanning(len(tt)).astype(np.float32)
            sig = sum(
                rng.uniform(0.2, 1.0) / (k + 1) * np.sin(2 * np.pi * f0 * (k + 1) * tt + rng.uniform(0, 6.28))
                for k in range(5)
            )
            clean[seg] += (env * sig).astype(np.float32)
        peak = np.abs(clean).max() + 1e-6
        clean *= rng.uniform(0.2, 0.8) / peak
        # coloured noise
        noise = rng.normal(size=self.crop_len).astype(np.float32)
        kernel = np.exp(-np.arange(8) / rng.uniform(1.0, 4.0)).astype(np.float32)
        noise = np.convolve(noise, kernel / kernel.sum(), mode="same")
        snr_db = rng.uniform(*self.snr_range)
        p_clean = np.mean(clean**2) + 1e-12
        p_noise = np.mean(noise**2) + 1e-12
        noise *= np.sqrt(p_clean / (p_noise * 10 ** (snr_db / 10.0)))
        return clean, (clean + noise).astype(np.float32)


def make_loader(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    prefetch: int = 2,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite (training) or single-pass iterator of (clean, noisy) batches,
    with per-host sharding (replaces DistributedSampler, reference
    dataset.py:178-180) and background-thread prefetch."""

    def gen():
        rng = np.random.default_rng(seed)
        epoch = 0
        while True:
            idxs = np.arange(len(dataset))[shard_index::num_shards]
            if shuffle:
                rng.shuffle(idxs)
            for i in range(0, len(idxs) - (batch_size - 1 if drop_last else 0), batch_size):
                batch = [dataset[int(j)] for j in idxs[i : i + batch_size]]
                if len(batch) < batch_size and drop_last:
                    break
                clean = np.stack([b[0] for b in batch])
                noisy = np.stack([b[1] for b in batch])
                yield clean, noisy
            epoch += 1
            if not shuffle:
                return

    if prefetch <= 0:
        return gen()
    return _prefetch_iterator(gen(), prefetch)


def make_training_loader(dataset, batch_size: int, seed: int = 0,
                         n_threads: int = 4, prefer_native: bool = True,
                         num_shards: int = 1, shard_index: int = 0):
    """Training loader that uses the C++ decode/crop/batch pipeline
    (data/native/wavloader.cpp) when the dataset is file-backed and the
    toolchain is present; otherwise the Python loader.  ``num_shards`` /
    ``shard_index``: draw only from items ``shard_index::num_shards`` (one
    shard per data-parallel rank)."""
    if prefer_native and isinstance(dataset, CleanNoisyPairDataset) and dataset.subset == "training":
        try:
            from cleanumamba_tpu_torch.data.native_loader import NativeWavLoader, native_available

            if native_available():
                pairs = dataset.pairs[shard_index::num_shards]
                clean_paths = [c for c, _ in pairs]
                noisy_paths = [n for _, n in pairs]
                return NativeWavLoader(
                    clean_paths, noisy_paths, dataset.crop_len, batch_size,
                    n_threads=n_threads, seed=seed,
                )
        except Exception:
            pass
    return make_loader(dataset, batch_size, seed=seed, num_shards=num_shards,
                       shard_index=shard_index)


def _prefetch_iterator(it, depth: int):
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item
