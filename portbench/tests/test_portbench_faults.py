"""A run with the timed path broken underneath comes out not correct: the
harness's run of each cell (at the tiny size, on the CPU, past its look
for a card) with each fault the cell can have planted in the program
(``portbench/faults.py``). One card and batches of one: no exchange
between cards to leave out, no half of a batch."""

import pytest

from portbench import faults
from portbench.tests.conftest import run_tiny

ROLLOUTS = ["config4.rollout"]
TRAINS = ["config4.train"]


@pytest.mark.parametrize("name", ROLLOUTS + TRAINS)
def test_sound_run_is_correct(name):
    result = run_tiny(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", ["rollout_state_unchanged", "rollout_answer_altered"])
@pytest.mark.parametrize("name", ROLLOUTS)
def test_rollout_fault_is_caught(name, fault):
    with faults.planted(fault):
        assert not run_tiny(name)["correct"]


@pytest.mark.parametrize("name", TRAINS)
def test_train_state_unchanged_is_caught(name):
    with faults.planted("train_state_unchanged"):
        assert not run_tiny(name)["correct"]


@pytest.mark.parametrize("name", TRAINS)
def test_train_answer_altered_is_caught(name):
    with faults.planted("train_loss_altered"):
        assert not run_tiny(name)["correct"]


def test_a_fault_is_taken_out_again():
    import cosmology_gnn_simulation_tpu_torch.rollout as port_rollout
    import cosmology_gnn_simulation_tpu_torch.training.trainer as port_trainer
    before = (port_rollout.integrate_step, port_trainer.Optimizer.__dict__["apply"])
    for name in faults.FAULTS:
        with faults.planted(name):
            pass
    assert (port_rollout.integrate_step, port_trainer.Optimizer.__dict__["apply"]) == before
