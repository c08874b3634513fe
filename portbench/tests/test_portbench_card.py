"""The harness on the card at a small size: a traced run reads kernels,
busy time and rooflines, and the control comes out not correct. Skips
without a CUDA device (decided in the test)."""
import pytest
import torch

from portbench.core import harness
from portbench_util import tiny


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [0, 2])
def test_traced_run_on_the_card(workers):
    _card()
    out = harness.run_cell(tiny(check_workers=workers), 2**31 + 3, 1.0,
                           True, device="cuda")
    assert out["correct"] is True, out["checks"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert out["breakdown"]["device_ops"]
    for name in ("p1_blocks_roofline", "trellis_ac_roofline"):
        assert 0 < out["metrics"][name]["value"] <= 100


@pytest.mark.cuda
def test_control_on_the_card():
    _card()
    out = harness.run_cell(tiny(), 2**31 + 4, 0.5, False,
                           device="cuda", control=True)
    assert out["correct"] is False
    assert out["checks"]["bad_coefs"]["value"] > 0
