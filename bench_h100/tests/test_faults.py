"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped (the program steps on the CPU, its
plain path, at a few columns); the rest of a run is driven as on the card,
with the cell's step wrapped by each fault a column cell can have."""

from __future__ import annotations

import pytest
import torch

from bench_h100 import harness

SEED = 2**35 + 11


def unchanged(step):
    """A step that returns its state unchanged (P3: with the log lambda
    the step computed)."""
    def faulty(carry):
        out = step(carry)
        return carry if torch.is_tensor(carry) else (carry[0], out[1])
    return faulty


def half(step):
    """A step that advances the first half of the columns and leaves the
    rest as they were."""
    def faulty(carry):
        out = step(carry)
        if torch.is_tensor(carry):
            n = carry.shape[1] // 2
            return torch.cat([out[:, :n], carry[:, n:]], dim=1)
        n = carry[0].rho.shape[0] // 2
        state = type(carry[0])(*(torch.cat([o[:n], c[n:]])
                                 for o, c in zip(out[0], carry[0])))
        return state, out[1]
    return faulty


def altered(step):
    """A step whose answers for one column come out 10 % off."""
    def faulty(carry):
        out = step(carry)
        if torch.is_tensor(out):
            out = out.clone()
            out[:, 1] *= 1.1
            return out
        state = type(out[0])(*(f.clone() for f in out[0]))
        for f in state:
            f[1] *= 1.1
        return state, out[1]
    return faulty


CASES = [("1m_linavg", 6, 0.5), ("p3_gl16", 2, 0.1)]


@pytest.fixture(autouse=True)
def _first_window_step(monkeypatch):
    # the checked window step is the first: a CPU window holds few P3 steps
    monkeypatch.setattr(harness, "SAMPLE_STEPS", 1)


@pytest.mark.parametrize("cell,ncol,seconds", CASES)
def test_a_sound_run_is_correct(cell, ncol, seconds):
    result = harness.run(cell, SEED, seconds, False, 0.0, device="cpu",
                         ncol=ncol)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [unchanged, half, altered])
@pytest.mark.parametrize("cell,ncol,seconds", CASES)
def test_a_broken_step_is_not_correct(cell, ncol, seconds, fault):
    result = harness.run(cell, SEED, seconds, False, 0.0, device="cpu",
                         ncol=ncol, fault=fault)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0
