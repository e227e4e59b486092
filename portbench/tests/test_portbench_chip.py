"""On the card: one short run of a cell end to end, through the command
the driver runs.  Skipped where there is no card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.conftest import BIG_SEED

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.chip
def test_a_training_cell_runs_and_is_correct(card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mixtral-train-s4096", "--seed", str(BIG_SEED), "--seconds", "3",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"flash_roofline.train", "mfu.train",
                                    "device_idle_share.train"}
