"""The PyTorch port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` loads neither JAX nor the JAX package, and ``chip_smoke.py``
refuses to run without a card or without the repository beside it."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(mods))
"""


def _env():
    # a subprocess: tests/conftest.py has imported repro.core into this one
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_and_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         env=_env(), cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_port_sources_name_no_jax():
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "import repro ")), f"{path}: {s}"


def test_chip_smoke_fails_without_card_or_repository(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], env=_env(),
                             cwd=cwd, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
