"""chip_smoke.py needs a card: without CUDA its forms exit non-zero
and print no result.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds only where there is no CUDA device")
@pytest.mark.parametrize("mode", [[], ["--kernels"],
                                  ["--measure", "--tree", "."]],
                         ids=["smoke", "kernels", "measure_tree"])
def test_chip_smoke_refuses_without_a_card(mode):
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), *mode],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode != 0 and not r.stdout
    assert "CUDA is not available" in r.stderr
