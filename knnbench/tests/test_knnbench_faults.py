"""A whole run, without the look for a card, with the program's timed path
broken underneath: ``correct`` has to come out false. Once for each fault
the cells can have: an answer altered where it is produced, and half of the
batch's answers left out. The sound run beside them comes out true."""

import time

import pytest
import torch

from knnbench.harness import run_cell

from .conftest import tiny_cell

import tpu_knn_torch.methods.seq_search as SS

#: the function of the program that produces each cell's answers
PRODUCER = {
    "sift128-l2-knn10-b2048": "_knn_device_twopass",
    "sift128-l2-knn100-b2048": "_knn_device_twopass",
    "splade1m-ip-knn10-b2048": "_knn_device",
    "sift128-l2-range-b2048": "_range_collect_device",
}


def _altered(d, ids):
    """Another row's id in every query's first slot."""
    ids = ids.clone()
    ids[:, 0] = torch.where(ids[:, 0] >= 0, ids[:, -1], ids[:, 0])
    ids[:, -1] = -1
    return d, ids


def _half_left_out(d, ids):
    d, ids = d.clone(), ids.clone()
    half = d.shape[0] // 2
    d[half:], ids[half:] = float("inf"), -1
    return d, ids


def _break(name, fault, monkeypatch):
    orig = getattr(SS, PRODUCER[name])

    def broken(*args, **kwargs):
        out = orig(*args, **kwargs)
        if PRODUCER[name] == "_range_collect_device":  # ([Q, cap] dists, positions)
            dk, pos = out
            if fault is _altered:
                pos = torch.where(pos >= 0, (pos + 1) % args[2].ids.shape[0], pos)
                return dk, pos
            return fault(dk, pos)
        d, ids = fault(out[0], out[1])
        return (d, ids) + tuple(out[2:])

    monkeypatch.setattr(SS, PRODUCER[name], broken)


def _run(name):
    res, _ = run_cell(tiny_cell(name), 31, 0.3, False, "cpu", time.perf_counter())
    return res


@pytest.mark.parametrize("name", sorted(PRODUCER))
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_altered, _half_left_out], ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("name", sorted(PRODUCER))
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    _break(name, fault, monkeypatch)
    res = _run(name)
    assert not res["correct"], res["checks"]
