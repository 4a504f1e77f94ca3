"""The port's worlds (`launch.mesh`) and the train launcher's batches
under a mesh, on the CPU:

  * `pick_backend` takes NCCL when every rank on this host has a card of
    its own (torchrun's LOCAL_WORLD_SIZE, else the whole world), and
    refuses two ranks on one card;
  * `rank_device` names the current card for a bare 'cuda', so a thread
    started later (the launcher's prefetcher) copies to the rank's card;
  * at 2x1 each rank's prefetched batches lie on `mesh.device` and are
    that rank's rows of the batch one process would draw;
  * a rank that dies without raising fails the caller of `run_world`.
"""
import argparse
import os

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import lm_batches, lm_corpus
from repro_torch.launch.mesh import pick_backend, rank_device, run_world

import torch_dist_ranks as ranks


def _world(shape, fn, *args):
    """run_world without PYTHONPATH in the ranks' environment (it would
    load `src/sitecustomize.py`, which imports JAX)."""
    saved = os.environ.pop("PYTHONPATH", None)
    try:
        return run_world(shape, fn, *args, device="cpu", timeout=120)
    finally:
        if saved is not None:
            os.environ["PYTHONPATH"] = saved


@pytest.mark.parametrize("local, world, ok", [
    (None, 4, True), (None, 8, False), ("4", 8, True), ("8", 8, False)])
def test_nccl_counts_the_cards_of_this_host(monkeypatch, local, world, ok):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    cuda = torch.device("cuda")
    if ok:
        assert pick_backend(cuda, world) == "nccl"
    else:
        with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
            pick_backend(cuda, world)
    assert pick_backend(cuda, world, "gloo") == "gloo"
    assert pick_backend(torch.device("cpu"), world) == "gloo"


def test_rank_device_names_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert rank_device("cuda") == torch.device("cuda", 3)
    assert rank_device("cuda:1") == torch.device("cuda", 1)
    assert rank_device("cpu") == torch.device("cpu")


def test_launcher_batches_land_on_each_ranks_device():
    args = argparse.Namespace(steps=3, batch=4, seq=8, seed=5)
    corpus = lm_corpus(97, 5_000, seed=5)
    whole = list(lm_batches(corpus, args.steps, args.batch, args.seq,
                            seed=args.seed))
    got = _world((2, 1), ranks.launcher_batches, args, corpus)
    for r, (dev, batches) in enumerate(got):
        assert dev == "cpu"
        assert len(batches) == args.steps
        for b, w in zip(batches, whole):
            for k, (leaf_dev, v) in b.items():
                assert leaf_dev == dev
                np.testing.assert_array_equal(v, w[k][2 * r:2 * r + 2])


def test_a_rank_that_dies_fails_the_caller():
    with pytest.raises(RuntimeError, match="rank 1: .*exit code 3"):
        _world((1, 2), ranks.exit_on_rank, 1)
