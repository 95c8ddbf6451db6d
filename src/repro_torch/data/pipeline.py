"""Deterministic synthetic data (``repro/data/pipeline.py``'s
``SyntheticLM``, ``SyntheticImages`` and ``Pipeline``), numpy only.

A seeded counter-based generator yields identical global batches for a
given (seed, step) regardless of host count, bit for bit the reference's:
the port's and the reference's loss curves start from the same tokens
and images.  Batches are numpy arrays; the train step moves them to its
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """A structured token stream: x[t+1] = (a * x[t] + drift) % V, with a
    per-sequence drift and 10% uniform noise, so a model visibly learns."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, *, host_index: int = 0,
                 host_count: int = 1) -> dict:
        """Host-sharded global batch for ``step``: int32 ``tokens`` and
        ``labels`` (the tokens shifted by one), (per_host, seq_len)."""
        assert self.global_batch % host_count == 0
        per_host = self.global_batch // host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_index]))
        v = self.vocab
        a = 6364136223846793005 % v | 1
        x = np.empty((per_host, self.seq_len + 1), np.int64)
        x[:, 0] = rng.integers(0, v, per_host)
        drift = rng.integers(1, v, (per_host, 1))
        noise = rng.random((per_host, self.seq_len)) < 0.1
        rand = rng.integers(0, v, (per_host, self.seq_len))
        for t in range(self.seq_len):
            nxt = (a * x[:, t] + drift[:, 0]) % v
            x[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class SyntheticImages:
    img: tuple[int, int, int]
    num_classes: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, *, host_index: int = 0,
                 host_count: int = 1) -> dict:
        per_host = self.global_batch // host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, host_index]))
        labels = rng.integers(0, self.num_classes, per_host)
        h, w, c = self.img
        # class-dependent blobs so the CNN can actually learn
        base = rng.standard_normal((per_host, h, w, c)).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        for i in range(per_host):
            cy = (labels[i] * 7919) % h
            cx = (labels[i] * 104729) % w
            blob = np.exp(-(((yy - cy) % h) ** 2 + ((xx - cx) % w) ** 2)
                          / (0.02 * h * w))
            base[i] += 3.0 * blob[..., None]
        return {"images": base, "labels": labels.astype(np.int32)}


class Pipeline:
    """Step-indexed iterator with simple lookahead prefetch and exact
    resume (state == step)."""

    def __init__(self, source, start_step: int = 0, host_index: int = 0,
                 host_count: int = 1):
        self.source = source
        self.step = start_step
        self.host_index = host_index
        self.host_count = host_count
        self._next = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._next is not None:
            batch, self._next = self._next, None
        else:
            batch = self.source.batch_at(self.step,
                                         host_index=self.host_index,
                                         host_count=self.host_count)
        self.step += 1
        # cheap lookahead (numpy generation overlaps the device step)
        self._next = self.source.batch_at(self.step,
                                          host_index=self.host_index,
                                          host_count=self.host_count)
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
        self._next = None
