"""The port imports neither jax nor flax, and its chip smoke test refuses to
run without a card.

Checked in fresh subprocesses: this suite's conftest imports jax into the
test process itself.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LIST_AND_IMPORT = r"""
import importlib, json, pkgutil, sys
import percivaltts_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(json.dumps({"modules": mods,
                  "leaked": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "jaxlib"))}))
"""


def _run(code_or_args, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_port_modules_import_without_jax_or_flax():
    proc = _run(_LIST_AND_IMPORT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {
        "percivaltts_tpu_torch._build",
        "percivaltts_tpu_torch.cli",
        "percivaltts_tpu_torch.eval.serve",
        "percivaltts_tpu_torch.models.critic",
        "percivaltts_tpu_torch.models.generators",
        "percivaltts_tpu_torch.ops.lstm_cuda",
        "percivaltts_tpu_torch.training.losses",
        "percivaltts_tpu_torch.training.lse",
        "percivaltts_tpu_torch.training.ondevice",
        "percivaltts_tpu_torch.training.state",
        "percivaltts_tpu_torch.training.wgan",
        "percivaltts_tpu_torch.weights",
    } <= set(out["modules"])
    assert out["leaked"] == []


def test_port_sources_name_no_jax_import():
    root = os.path.join(REPO, "percivaltts_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    assert words[1].split(".")[0] not in ("jax", "flax", "jaxlib"), (p, line)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(where, tmp_path):
    """No CUDA here: the script exits non-zero and prints no result line.
    Alone in a directory (no package beside it) it fails the same way."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
            text=True, timeout=120,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        )
    else:
        proc = _run([script])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
