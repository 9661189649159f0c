"""The port's signorini app on its two mesh obstacles and the boxes app in
float32 on the CPU against their goldens, held as
tests/test_torch_app_goldens.py holds the other contact apps (x after step 1,
then one step from the golden's state at each later held step; the mesh
obstacles' bakes and the boxes' self-collision sweeps make these the slowest
on the CPU, so they have a file of their own)."""

import pytest
import torch

import chip_smoke
from test_torch_app_goldens import SLOW, one_step_holds

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


@pytest.mark.parametrize("name", SLOW)
def test_one_step_holds_its_golden(name):
    one_step_holds(name)
