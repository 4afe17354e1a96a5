"""On the card, at a size a test run holds: a sound run of each cell is
correct, and each cell's control (the reference in the precision below the
configuration's, or the program's own lower-precision path, in the
program's place) is not.  Run on the chip with
``python -m pytest portbench/tests -m card``; skips without a card."""

import pytest

from portbench.tests import tiny


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


def _run(setup, cell, seed, variant):
    import time

    import torch

    from portbench import harness

    base, bench, names = setup
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == names[cell])
    # a cell on more cards than the machine has runs its shards on one
    devices = None if torch.cuda.device_count() >= chips \
        else ["cuda:0"] * chips
    return harness.run_cell(bench, names[cell], seed, 0.5, False, "cuda",
                            time.perf_counter(), variant=variant, base=base,
                            devices=devices)


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_program_is_correct_and_the_control_is_not(setup, cell, seed):
    line, _ = _run(setup, cell, seed, None)
    assert line["correct"], line["checks"]
    line, _ = _run(setup, cell, seed, "control")
    assert not line["correct"], line["checks"]
