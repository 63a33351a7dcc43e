"""``correct`` comes out false where it should: the control (the reference
with the mismatch budget one lower, in the program's place) and the
faults a matching cell can have, planted under the timed path of a whole
run that skips the look for a chip."""

import dataclasses
import io
import time

import numpy as np
import pytest

from benchmark.bench_testing import result_line, tiny_copy
from benchmark.harness import runner


def _run(tmp_path, config="bigtest-w20", **kw):
    root, bench, cell = tiny_copy(tmp_path, config)
    out, err = io.StringIO(), io.StringIO()
    rc = runner.run(root, cell, 2**31 + 3, 0.5, False, t_start=time.perf_counter(),
                    device="cpu", bench_dir=bench, out=out, err=err, **kw)
    assert rc == 0, err.getvalue()
    return result_line(out.getvalue())


@pytest.mark.parametrize("config", ["bigtest-w20", "docs-w15"])
def test_the_control_is_not_correct(tmp_path, config):
    line = _run(tmp_path, config, control="budget-1")
    assert not line["correct"]
    assert line["compared"]["reads_differing"]["value"] > 0


def _half(mr):
    """Half of the batch left out: the rows of its second half of reads."""
    keep = mr.read_row < (int(mr.read_row.max()) + 1) // 2
    return dataclasses.replace(mr, **{f.name: getattr(mr, f.name)[keep]
                                      for f in dataclasses.fields(mr)})


def _altered(mr):
    """An answer altered where it is produced: one mismatch more on every
    50th row."""
    nmiss = mr.nmiss.copy()
    nmiss[::50] += 1
    return dataclasses.replace(mr, nmiss=nmiss)


def _doubled(mr):
    """A row reported twice."""
    return dataclasses.replace(mr, **{f.name: np.concatenate([getattr(mr, f.name)[:1],
                                                              getattr(mr, f.name)])
                                      for f in dataclasses.fields(mr)})


@pytest.mark.parametrize("fault", [_half, _altered, _doubled])
def test_a_fault_is_not_correct(tmp_path, monkeypatch, fault):
    from muscato_tpu_torch.engine import pipeline

    real = pipeline.run_matching_indexed
    monkeypatch.setattr(pipeline, "run_matching_indexed",
                        lambda *a, **kw: fault(real(*a, **kw)))
    line = _run(tmp_path)
    assert not line["correct"]
    assert line["compared"]["reads_differing"]["value"] > 0
