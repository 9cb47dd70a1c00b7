"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at smoke
sizes, run by ``harness.run`` on the CPU (the card-only look in ``run.py``
skipped), with the port's plain PyTorch path under every kernel call.

    python -m pytest -q bench/tests            # here, on the CPU
    python -m pytest -q -m gpu bench/tests     # on the card
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# a few threads a test process, so that tests run side by side (pytest -n)
# do not starve each other's short windows
torch.set_num_threads(2)

# glm4-9b's shape at smoke width and depth, and traffic small enough for the
# CPU's plain path
SMOKE_ARCH = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=256, vocab=512)
SMOKE_MIX = {"prefill_1500": dict(prompt_len=64, pool=8, check_requests=3),
             "decode_b16": dict(batch=4, prompt_len=16, new_tokens=8,
                                check_sequences=3),
             "offline_b256": dict(batch=16, pool=2)}


def smoke_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` copied to ``dest``, glm4-9b and the
    larger mixes cut to smoke sizes."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    cfg_path = dest / "bench" / "configs" / "glm4-9b.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["arch"].update(SMOKE_ARCH)
    cfg_path.write_text(json.dumps(cfg))
    for name, over in SMOKE_MIX.items():
        path = dest / "bench" / "workloads" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **over}))
    return dest


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory) -> Path:
    return smoke_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="session")
def cells():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]
