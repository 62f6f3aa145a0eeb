"""
Fixtures of the benchmark's tests: a copy of ``BENCHMARK.json`` and
``port_bench/`` with the cells cut to a size the CPU runs in a second, and
the card for the tests marked ``cuda``, which skip without one.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the cells at a size the CPU runs in a second: same networks' spacing
# (2^20 / 2^16 = 16 columns an observation; 10^4 / 10^3 = 10), fewer columns
TINY = {"l96-1m": {"grid": 4096, "n_obs": 256, "ens_size": 20},
        "l96-10k": {"grid": 640, "n_obs": 64, "ens_size": 10}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda:0")


def copy_benchmark(dest: Path, sizes=TINY) -> Path:
    """``BENCHMARK.json`` and ``port_bench/`` copied under ``dest``, each
    configuration updated with ``sizes``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", dest / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, upd in sizes.items():
        path = dest / "port_bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(upd)
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return copy_benchmark(tmp_path)
