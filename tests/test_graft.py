"""Driver entry points: single-chip compile check + multi-chip dry run."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    count_res, fill_res, bvh_res = jax.jit(fn)(*args)
    assert bool(count_res.ok) and bool(fill_res.ok)
    assert int(count_res.count) >= 0
    assert count_res.pairs is None
    assert int(fill_res.count) == int(count_res.count)
    for res in (fill_res, bvh_res):
        assert int(res.count) >= 0
        assert res.pairs.shape[1] == 2


def test_dryrun_multichip():
    if jax.device_count() < 8:
        pytest.skip("needs 8 (virtual) devices")
    import __graft_entry__ as g

    g.dryrun_multichip(8)  # asserts bit-parity with single-device inside
