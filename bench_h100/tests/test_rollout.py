"""Each cell's closed loop stays finite for as many steps as its window
holds, on the CPU at a few of its columns (the program's plain path, which
the card's kernels equal bit for bit). The window restarts from the seeded
state every ``episode_steps`` steps, so a window is its first episode
repeated: the test runs one whole episode and checks every step."""

from __future__ import annotations

import pytest
import torch

from bench_h100 import harness

COLUMNS = {"1m_linavg": 64, "1m_inst": 64, "p3_gl16": 4, "p3_gl40": 2}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_an_episode_stays_finite(name):
    _, workload, config, _ = harness.load_cell(name)
    cell = harness.load_driver(config["kind"]).Cell(
        config, workload, torch.device("cpu"), ncol=COLUMNS[name])
    initial = cell.initial(2**34 + 1)
    carry = cell.restart(initial, cell.step(initial))
    episode = workload["step"]["episode_steps"]
    assert episode > 0
    for i in range(episode):
        carry = cell.step(carry)
        assert cell.finite(carry), f"step {i + 1}"
