"""A run with the timed path broken underneath comes out not correct:
each fault the cells can have is planted in the program (``bench/lib/
faults.py``), the look for a card is skipped, and the rest of a run is
driven at smoke size against the cell's own limits."""
import pytest
import torch

from bench.lib import cell, faults
from bench.lib.manifest import Manifest

CASES = [("qwen3_8b.train_4k", "frozen_state"),
         ("qwen3_8b.train_4k", "half_batch"),
         ("qwen3_8b.docqa_c32", "altered_token")]


def _run(root, workload, seed=21):
    return cell.execute(Manifest(root), workload, seed, 0.5, False,
                        torch.device("cpu"), 0.0)


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_is_not_correct(smoke_root, workload, fault):
    sound = _run(smoke_root, workload)["checks"]
    with faults.FAULTS[fault]():
        r = _run(smoke_root, workload)
    assert not r["correct"], r["checks"]
    # the fault fails a number that the sound run reads far below it
    assert any(c["value"] > c["limit"] and
               c["value"] >= 10 * sound[n]["value"]
               for n, c in r["checks"].items()), (sound, r["checks"])
