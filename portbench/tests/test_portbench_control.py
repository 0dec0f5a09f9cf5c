"""The control, the reference in the precision below the configurations'
(float8 e4m3 operands for their bf16), put in the program's place in the
harness's run of each cell, comes out not correct at the tiny size on the
CPU, as it does at the cells' own sizes on the card
(``portbench/control.py``)."""

import pytest
import torch

from portbench.tests.conftest import run_tiny


@pytest.mark.parametrize("name", ["config4.rollout", "config4.train"])
def test_control_fails_a_limit(name):
    result = run_tiny(name, control=torch.float8_e4m3fn)
    assert not result["correct"], result["checks"]
    readings = result["readings"]
    assert {k: c["value"] for k, c in result["checks"].items()} == readings["control"]
    assert all(v <= result["checks"][k]["limit"] for k, v in readings["program"].items())
