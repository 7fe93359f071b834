"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor any module of the reference package ``repro``, and
``chip_smoke.py`` imports neither; its entry points refuse to run
without a GPU unless given ``device="cpu"``; and ``chip_smoke.py`` fails
(and prints no result) where there is no card, and where it stands
without the rest of the repository."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
missing = sorted(set(sys.argv[1:]) - set(names))
print(len(names), missing, bad)
sys.exit(1 if bad or missing else 0)
"""

# every module of the port; the probe imports all it finds and fails if
# one of these is not among them
MODULES = [
    "repro_torch.bridge", "repro_torch.checkpoint.manager",
    "repro_torch.configs.internvl2_76b", "repro_torch.configs.jamba_1_5_large",
    "repro_torch.configs.seamless_m4t_v2",
    "repro_torch.configs.olmoe_1b_7b", "repro_torch.configs.rwkv6_1b6",
    "repro_torch.configs.phi3_5_moe_42b",
    "repro_torch.core.config", "repro_torch.core.cost_model",
    "repro_torch.core.device", "repro_torch.core.elimination",
    "repro_torch.core.graph", "repro_torch.core.scan",
    "repro_torch.core.search", "repro_torch.core.sharding",
    "repro_torch.core.stages",
    "repro_torch.core.strategies", "repro_torch.data.pipeline",
    "repro_torch.device", "repro_torch.kernels.build",
    "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.mamba_scan", "repro_torch.kernels.mha_chunked",
    "repro_torch.kernels.moe_dispatch",
    "repro_torch.kernels.dispatch",
    "repro_torch.kernels.ops", "repro_torch.kernels.paged_decode_attention",
    "repro_torch.kernels.ref", "repro_torch.kernels.rwkv6_scan",
    "repro_torch.kernels.work", "repro_torch.launch.dryrun",
    "repro_torch.launch.op_analysis",
    "repro_torch.launch.mesh", "repro_torch.launch.profile",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.models.encdec", "repro_torch.models.graph_export",
    "repro_torch.models.layers", "repro_torch.models.lm",
    "repro_torch.models.plan",
    "repro_torch.models.moe", "repro_torch.models.recurrent",
    "repro_torch.optim.adamw", "repro_torch.plans.parallel_plan",
    "repro_torch.plans.search", "repro_torch.plans.shardings",
    "repro_torch.profiling", "repro_torch.profiling.calibration",
    "repro_torch.profiling.microbench", "repro_torch.profiling.profile",
    "repro_torch.serve.engine",
    "repro_torch.serve.fns", "repro_torch.tracing", "repro_torch.train.step",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_neither_jax_nor_repro():
    r = subprocess.run([sys.executable, "-c", _PROBE, *MODULES], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("[] []")


def test_chip_smoke_imports_neither_jax_nor_repro():
    """Every import statement of ``chip_smoke.py``, at any depth: the port
    and the standard library only."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert any(n.startswith("repro_torch") for n in names)
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "repro"))
    assert bad == []


def test_entry_points_need_a_gpu_or_an_explicit_cpu():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        from repro_torch import configs
        from repro_torch.models import lm
        arch = configs.reduced("llama3.2-1b")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.init_lm(arch, generator=torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.init_paged_cache(arch, 3, 4, 2)
        from repro_torch.launch import train
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--steps", "1", "--width", "64", "--depth", "2",
                        "--vocab", "64", "--ckpt-every", "0"])


@pytest.mark.parametrize("extra", [[], ["--kv-block-size", "0"],
                                   ["--kv-block-size", "0",
                                    "--prefill-chunk-tokens", "0"]],
                         ids=["paged", "dense", "dense-stall"])
def test_serve_launcher_serves_olmoe_on_cpu(extra, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--batch",
                      "2", "--requests", "3", "--prompt-len", "9", "--gen",
                      "3", "--width", "64", "--depth", "2", "--vocab", "64",
                      "--experts", "4"] + (extra or ["--kv-block-size", "4"]))
    assert sorted(c.uid for c in out["completions"]) == [0, 1, 2]
    assert all(len(c.tokens) == 3 for c in out["completions"])
    first = capsys.readouterr().out.splitlines()[0]
    assert ("kv=dense" in first) == bool(extra)
    assert "kv=paged(bs=4" in first or extra


@pytest.mark.parametrize("extra", [["--kv-block-size", "4"],
                                   ["--kv-block-size", "0"],
                                   ["--kv-block-size", "0",
                                    "--prefill-chunk-tokens", "0"]],
                         ids=["paged", "dense", "dense-stall"])
def test_serve_launcher_serves_jamba_on_cpu(extra, capsys):
    """Reduced jamba (Mamba + attention + MoE); on a paged, chunked engine
    the prefix cache it asks for by default stays off."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", "jamba-1.5-large-398b",
                      "--batch", "2", "--requests", "3", "--prompt-len", "9",
                      "--gen", "3", "--width", "128", "--depth", "2",
                      "--vocab", "64", "--experts", "4"] + extra)
    assert sorted(c.uid for c in out["completions"]) == [0, 1, 2]
    assert all(len(c.tokens) == 3 for c in out["completions"])
    printed = capsys.readouterr().out
    assert "prefix cache" not in printed
    dense = extra[extra.index("--kv-block-size") + 1] == "0"
    assert ("kv=dense" in printed.splitlines()[0]) == dense


def test_serve_launcher_runs_on_cpu_when_asked():
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--batch", "2", "--requests", "3",
                      "--prompt-len", "9", "--gen", "3", "--kv-block-size",
                      "4", "--width", "128", "--depth", "2", "--vocab", "64"])
    assert sorted(c.uid for c in out["completions"]) == [0, 1, 2]
    assert all(len(c.tokens) == 3 for c in out["completions"])


def _chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_env() if cwd == ROOT else None,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = _chip_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _chip_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
