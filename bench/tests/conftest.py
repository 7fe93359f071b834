"""Fixtures of the benchmark's own tests: the repository root and the
port on the path, a tiny copy of each cell in a temporary folder, and
the ``cuda`` fixture that skips a test without a card."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def make_tiny_root(root: Path, width: int = 64) -> Path:
    """BENCHMARK.json and the files of its cells under ``root``, at a size
    the CPU runs in seconds: the cells' names, traffic kinds and limits,
    a two-layer model of ``width`` (four heads) with 8 experts (capacity
    factor 0.5, so that calls drop assignments) and small batches."""
    bench = root / "bench"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((ROOT / "bench/configs/olmoe-1b-7b-d8.json").read_text())
    cfg.update(name="tiny", hidden_size=width, intermediate_size=width // 2,
               num_attention_heads=4, num_key_value_heads=4,
               head_dim=width // 4,
               num_hidden_layers=2, num_experts=8, num_experts_per_tok=2,
               vocab_size=128, capacity_factor=0.5)
    cfg.pop("port_arch")
    (bench / "configs/tiny.json").write_text(json.dumps(cfg))
    train = json.loads((ROOT / "bench/traffic/lm-8x256.json").read_text())
    train.update(batch=4, seq=32)
    (bench / "traffic/lm-tiny.json").write_text(json.dumps(train))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = {"olmoe-train-d8": "lm-tiny"}
    spec["configs"] = [dict(spec["configs"][0], name="tiny",
                            file="bench/configs/tiny.json")]
    spec["workloads"] = [dict(w, config="tiny", traffic=traffic[w["name"]])
                         for w in spec["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for w in spec["workloads"]:
        shutil.copy(ROOT / f"bench/limits/{w['name']}.json",
                    bench / f"limits/{w['name']}.json")
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def card_root(tmp_path_factory):
    """The tiny cells at width 256: head dim 64, which the kernels take,
    and round-off of a size that stands for the cells'."""
    return make_tiny_root(tmp_path_factory.mktemp("card"), width=256)


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
