"""The port's checkpoint manager (repro_torch.checkpoint) on the cases
of the JAX package's tests/test_checkpoint.py: an atomic roundtrip, an
async save, retention of the newest and the best, a shape mismatch that
fails loudly — and, for torch's mutable tensors, that an async save
keeps the state as it was when it was queued.  Elastic re-sharding is
the distributed slice's (ROADMAP A.14) and raises.  No JAX here: the
manager's format is numpy's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: E402
                                            flatten_with_paths)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros(4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _template(state):
    return {k: _template(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in state.items()}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(10, st, metric=1.5, extra={"note": "x"})
    restored, meta = mgr.restore(_template(st))
    assert meta["step"] == 10 and meta["metric"] == 1.5
    assert meta["extra"] == {"note": "x"}
    a, b = flatten_with_paths(st), flatten_with_paths(restored)
    assert set(a) == set(b) == {"params/w", "params/b", "step"}
    for k in a:
        assert b[k].dtype == a[k].dtype and torch.equal(a[k], b[k])
    # no temporary directory is left behind
    assert sorted(os.listdir(tmp_path)) == ["step_00000010"]


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    want = st["params"]["w"].clone()
    mgr.save_async(3, st)
    st["params"]["w"].add_(1.0)         # the caller goes on in place
    mgr.wait()
    assert mgr.latest_step() == 3
    arrays, _ = mgr.load(step=3)
    np.testing.assert_array_equal(arrays["params/w"], want.numpy())


def test_retention_keeps_latest_and_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_latest=2, keep_best=1)
    st = _state()
    for step, metric in [(1, 0.5), (2, 5.0), (3, 4.0), (4, 3.0)]:
        mgr.save(step, st, metric=metric)
    steps = sorted(s for s, _ in mgr._steps())
    assert steps == [1, 3, 4]  # 3,4 newest; 1 is best-metric
    assert mgr.has_step(1) and not mgr.has_step(2)


def test_shape_mismatch_fails_loudly(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    bad = _template(_state())
    bad["params"]["w"] = torch.empty((9, 4), device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad)
    missing = _template(_state())
    missing["params"]["extra"] = torch.empty(2, device="meta")
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(missing)


def test_restore_places_and_refuses_shardings(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(1, st)
    restored, _ = mgr.restore(st)            # a live template keeps its device
    assert restored["params"]["w"].device.type == "cpu"
    # shardings must mirror the template (the placement itself:
    # tests/test_torch_elastic.py, on gloo ranks)
    with pytest.raises(KeyError, match="step"):
        mgr.restore(st, shardings={"params": None})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).load()
