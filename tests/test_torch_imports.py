"""plangen_tpu_torch imports torch and never jax (the card machine has none)."""

import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_port_never_imports_jax():
    import plangen_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        plangen_tpu_torch.__path__, prefix="plangen_tpu_torch.")]
    assert "plangen_tpu_torch.ops.decode_attention" in names
    code = (
        "import importlib, sys\n"
        f"for name in {['plangen_tpu_torch'] + names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_never_imports_jax_and_needs_a_card():
    """Without a CUDA device chip_smoke.py exits non-zero, prints no result,
    and by then has imported no jax."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    code = (
        "import runpy, sys\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code != 0, e.code\n"
        "assert 'jax' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"ok"' not in out.stdout
