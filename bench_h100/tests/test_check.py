"""The numbers that decide ``correct``, on made-up answers: a few entries
across a branch stay a small share, a column gone wrong shows in
``column_off`` however many columns there are, and a non-finite answer
departs without bound."""

from __future__ import annotations

import math

import pytest
import torch

from bench_h100 import check

GROUPS = {"state_off": ("share", slice(0, 2)),
          "column_off": ("column", slice(0, 2)),
          "state_gap": ("gap", slice(0, 2)),
          "loglambda_off": ("off", slice(2, 3))}
TOL = {"state_off": 1e-3, "column_off": 1e-3, "loglambda_off": 1e-3}


def _acc():
    return check.GapSum(GROUPS, TOL, torch.tensor([300.0, 1e-3, 1.0]))


def _answers(ncol=100, nlev=10):
    g = torch.Generator().manual_seed(3)
    ref = torch.stack([250 + 50 * torch.rand(ncol, nlev, generator=g),
                       1e-3 * torch.rand(ncol, nlev, generator=g),
                       5 + 5 * torch.rand(ncol, nlev, generator=g)])
    return ref


def test_equal_answers_read_zero():
    acc = _acc()
    ref = _answers()
    acc.add(ref.clone(), ref)
    assert acc.gaps() == {"state_off": 0.0, "column_off": 0.0,
                          "state_gap": 0.0, "loglambda_off": 0.0}


def test_a_few_branch_flips_stay_a_small_share():
    acc = _acc()
    ref = _answers()
    prog = ref.clone()
    prog[1, 7, 3] += 0.5e-3         # half the field's scale, one entry
    prog[1, 40, 0] -= 0.3e-3
    acc.add(prog, ref)
    gaps = acc.gaps()
    assert gaps["state_off"] == pytest.approx(2 / 2000)
    assert gaps["column_off"] == pytest.approx(1 / 20)
    assert gaps["state_gap"] == pytest.approx(0.5)


def test_one_column_gone_wrong_shows_in_column_off():
    acc = _acc()
    ref = _answers(ncol=1000)
    prog = ref.clone()
    prog[:, 5] *= 1.1
    acc.add(prog, ref)
    gaps = acc.gaps()
    assert gaps["state_off"] == pytest.approx(1 / 1000)
    assert gaps["column_off"] > 0.9
    assert gaps["loglambda_off"] == pytest.approx(10 / 10000)


def test_shares_add_over_blocks_and_columns_take_the_worst():
    acc = _acc()
    ref = _answers()
    prog = ref.clone()
    prog[0, :, :5] += 1.0           # 1/300 of T's scale, half the levels
    acc.add(prog, ref)
    acc.add(ref.clone(), ref)
    gaps = acc.gaps()
    assert gaps["state_off"] == pytest.approx(500 / 4000)
    assert gaps["column_off"] == pytest.approx(5 / 20)


def test_a_nonfinite_answer_departs_without_bound():
    acc = _acc()
    ref = _answers()
    prog = ref.clone()
    prog[1, 0, 0] = math.nan
    acc.add(prog, ref)
    assert acc.gaps()["state_gap"] == math.inf
    assert acc.gaps()["state_off"] == pytest.approx(1 / 2000)
